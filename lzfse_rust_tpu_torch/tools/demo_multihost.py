"""Several processes ("hosts") decode shards of one batch, and the ordered
gather crosses the process boundary.

    python3 -m lzfse_rust_tpu_torch.tools.demo_multihost [--hosts 2] [--device cuda|cpu]

Port of the JAX package's ``tools/demo_multihost.py``. The tool starts
``--hosts`` worker processes of itself, which join one
``torch.distributed`` group over ``tcp://127.0.0.1`` (NCCL on cards, gloo
with ``--device cpu``). The global batch holds two blocks for each of the
group's devices, each block from its own seeded input
(``parallel/dryrun.example_block``); every process decodes only its
contiguous share of it on its own mesh (one card, rank r on ``cuda:r``; or
``LOCAL_CPU`` CPU shards) with ``sharded_entropy_decode`` and
``sharded_rebuild``, then ``gather_compressed`` all-gathers the padded
outputs and their lengths across the group. Every process checks that it
holds every block's length in order; process 0 checks every block's bytes
against the spec layer. Each prints one JSON line; the tool exits 0 when
all do.

NCCL refuses two ranks on one card ("Duplicate GPU detected"), so on cards
the tool needs at least as many CUDA devices as processes; with fewer it
raises and says why. It never switches to gloo on its own.
"""

from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from .common import require_card

ROOT = pathlib.Path(__file__).resolve().parents[2]
LOCAL_CPU = 2      # CPU shards per process with --device cpu
TIMEOUT_S = 600


def _args(argv) -> dict:
    args = list(argv)
    out = {"hosts": 2, "device": "cuda"}
    for key in ("hosts", "device"):
        flag = f"--{key}"
        if flag in args:
            out[key] = args[args.index(flag) + 1]
    out["hosts"] = int(out["hosts"])
    if out["device"] not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {out['device']}")
    return out


def worker(rank: int, hosts: int, port: int, device: str) -> None:
    import torch.distributed as dist

    from ..parallel.dryrun import example_arrays, example_block
    from ..parallel.mesh import (gather_compressed, make_mesh,
                                 sharded_entropy_decode, sharded_rebuild)
    from ..spec import container as spec_container

    if device == "cuda":
        torch.cuda.set_device(rank)
        mesh = make_mesh([rank])
        backend = "nccl"
    else:
        mesh = make_mesh(["cpu"] * LOCAL_CPU)
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=hosts, rank=rank)
    try:
        n_dev = hosts * mesh.size
        B = 2 * n_dev
        per = B // hosts
        made = [example_block(seed=b, n_bytes=5000 + 700 * b)
                for b in range(B)]
        mine = [d for _, _, d in made[rank * per:(rank + 1) * per]]
        n_lit = max((d.block.literal.num + 3) // 4 for _, _, d in made)
        n_lmd = max(d.block.lmd.num for _, _, d in made)
        n_raw = np.array([len(r) for r, _, _ in made], np.int32)
        n_out = -(-int(n_raw.max()) // 4096) * 4096

        t0 = time.perf_counter()
        literals, lmds, ok = sharded_entropy_decode(
            mesh, example_arrays(mine), n_lit, n_lmd)
        if not bool(ok.all()):
            raise RuntimeError(f"host {rank}: a block failed its stream check")
        out, rok = sharded_rebuild(mesh, literals.cpu().numpy(),
                                   lmds.cpu().numpy(),
                                   n_raw[rank * per:(rank + 1) * per], n_out)
        if not bool(rok.all()):
            raise RuntimeError(f"host {rank}: a container failed its rebuild")
        t_decode = time.perf_counter() - t0

        t0 = time.perf_counter()
        blocks, lens = gather_compressed(
            mesh, out, torch.from_numpy(n_raw[rank * per:(rank + 1) * per]),
            group=dist.group.WORLD)
        blocks, lens = blocks.cpu().numpy(), lens.cpu().numpy()
        t_gather = time.perf_counter() - t0
        if not np.array_equal(lens, n_raw):
            raise RuntimeError(f"host {rank}: gathered lengths {lens}, "
                               f"expected {n_raw}")
        if rank == 0:
            for b, (_, c, _) in enumerate(made):
                if blocks[b, :lens[b]].tobytes() != \
                        spec_container.decode_bytes(c):
                    raise RuntimeError(f"block {b} differs from the spec "
                                       f"layer")
        print(json.dumps({"host": rank, "hosts": hosts, "backend": backend,
                          "devices": n_dev, "blocks": B,
                          "local_devices": [str(d) for d in mesh.devices],
                          "decode_wall_s": t_decode,
                          "gather_wall_s": t_gather, "ok": True}),
              flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(hosts: int, device: str) -> list[dict]:
    """Start ``hosts`` workers, wait for them (killing any left at the time
    limit), and return their JSON lines; raises when one fails."""
    if device == "cuda" and torch.cuda.device_count() < hosts:
        raise RuntimeError(
            f"demo_multihost: {hosts} processes on NCCL need {hosts} CUDA "
            f"devices (NCCL refuses two ranks on one card: 'Duplicate GPU "
            f"detected'); this machine has {torch.cuda.device_count()}")
    port = _free_port()
    env = {**os.environ, "GLOO_SOCKET_IFNAME": os.environ.get(
        "GLOO_SOCKET_IFNAME", "lo"), "NCCL_SOCKET_IFNAME": os.environ.get(
        "NCCL_SOCKET_IFNAME", "lo")}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "lzfse_rust_tpu_torch.tools.demo_multihost",
         "--worker", str(r), str(hosts), str(port), device],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(hosts)]
    rows, errors = [], []
    try:
        deadline = time.monotonic() + TIMEOUT_S
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=max(deadline - time.monotonic(),
                                                 1))
            rows += [json.loads(line) for line in out.splitlines()
                     if line.startswith("{")]
            if p.returncode:
                errors.append(f"host {r} exit {p.returncode}: {err[-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errors or len(rows) != hosts:
        raise RuntimeError("demo_multihost: " + "; ".join(
            errors or [f"{len(rows)} of {hosts} hosts reported"]))
    return rows


def main(argv=None) -> int:
    args = _args(sys.argv[1:] if argv is None else argv)
    if args["device"] == "cuda":
        require_card("demo_multihost")
    for row in run(args["hosts"], args["device"]):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        worker(int(sys.argv[i + 1]), int(sys.argv[i + 2]),
               int(sys.argv[i + 3]), sys.argv[i + 4])
    else:
        sys.exit(main())
