"""The multi-device dry run: every sharded stage of the codec on tiny shapes.

Counterpart of the JAX package's ``__graft_entry__.py`` (``entry`` and
``dryrun_multichip``). The inputs are made in the repository: a seeded text
input (``utils/corpus.py``) encoded by the port's native encoder, whose one
FSE block is tiled over the batch.

    python3 -m lzfse_rust_tpu_torch.parallel.dryrun [n_devices] [--device cpu]

On a card the mesh takes ``n_devices`` CUDA devices, reusing them in turn
when there are fewer (``cuda:0`` four times on one card); on the CPU it is
``["cpu"] * n_devices``. Every check raises ``RuntimeError`` when it fails.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..base import constants as C
from ..models.decoder import TorchDecoder, _parse_container
from ..models.encoder import TorchEncoder
from ..ops import table_build as TB
from ..spec import container as spec_container
from ..spec import fse as SF
from ..spec.tables import DecoderTables
from ..utils import corpus as CP
from .mesh import (_entropy_pipeline, _match_find_batch, gather_compressed,
                   make_mesh, sharded_entropy_decode, sharded_match_find,
                   sharded_pallas_entropy_decode, sharded_rebuild)

LMD_OFF = (0, C.L_STATES, C.L_STATES + C.M_STATES)


def _check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def example_block(seed: int = 0, n_bytes: int = 6000):
    """(raw, container, its one FSE block as the decoder parses it) for a
    seeded text input of ``n_bytes``."""
    raw = CP.make_raw("text", n_bytes, np.random.default_rng(seed))
    container = CP.encode(raw)
    blocks: list = []
    _parse_container(container, 0, blocks)
    _check(len(blocks) == 1 and container[:4] == b"bvx2",
           f"expected one FSE block, got {len(blocks)}")
    return raw, container, blocks[0]


def example_arrays(blocks: list) -> dict:
    """``_entropy_pipeline``'s arguments (numpy, batch-leading) for the
    parsed FSE blocks ``blocks``, one a row: payloads zero-padded to the
    longest plus 8 bytes, the L/M/D states with their class offsets."""
    B = len(blocks)

    def payload(ps):
        a = np.zeros((B, max(map(len, ps)) + 8), np.uint8)
        for b, p in enumerate(ps):
            a[b, :len(p)] = np.frombuffer(p, np.uint8)
        return a

    def per_block(f):
        return np.array([f(d) for d in blocks], np.int32)

    return dict(
        weights=per_block(lambda d: d.weights),
        lit_payload=payload([d.lit_payload for d in blocks]),
        lmd_payload=payload([d.lmd_payload for d in blocks]),
        lit_states=per_block(lambda d: d.block.literal.state),
        lit_pos=per_block(lambda d: len(d.lit_payload) * 8
                          - d.block.literal.bits),
        lit_num=per_block(lambda d: d.block.literal.num),
        lmd_states=per_block(lambda d: np.add(d.block.lmd.state, LMD_OFF)),
        lmd_pos=per_block(lambda d: len(d.lmd_payload) * 8 - d.block.lmd.bits),
        lmd_num=per_block(lambda d: d.block.lmd.num))


def kernel_arrays(d, B: int, n_lit: int, n_lmd: int) -> dict:
    """``sharded_pallas_entropy_decode``'s arguments (the JAX kernels'
    layout) for ``B`` copies of the block ``d``, decoding ``n_lit``
    literal steps and ``n_lmd`` L/M/D steps."""
    weights = torch.from_numpy(np.tile(np.asarray(d.weights, np.int32),
                                       (B, 1)))
    v, u3, tot = (t.numpy() for t in TB.build_decode_tables_v3(weights))

    def stream(p, states, bits, offs, num):
        words = np.frombuffer(p + bytes(-len(p) % 4 + 16), "<i4")
        st = np.zeros((B, 128), np.int32)
        st[:, :len(states)] = np.add(states, offs)
        return (np.tile(words, (B, 1)), st,
                np.full((B, 128), len(p) * 8 - bits, np.int32),
                np.full((B, 128), num, np.int32))

    lw, ls, lp, ln = stream(d.lit_payload, d.block.literal.state,
                            d.block.literal.bits, (0, 0, 0, 0), 4 * n_lit)
    mw, ms, mp, mn = stream(d.lmd_payload, d.block.lmd.state,
                            d.block.lmd.bits, LMD_OFF, n_lmd)
    return dict(u3_tabs=u3, v_tabs=v, lit_words=lw, lmd_words=mw,
                lit_states=ls, lit_pos=lp, lit_num=ln, lit_tot=tot,
                lmd_states=ms, lmd_pos=mp, lmd_num=mn)


def _sync(mesh) -> None:
    """Wait for every CUDA device of the mesh."""
    for dev in set(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def mesh_devices(n_devices: int, device: str = "cuda") -> list:
    """``n_devices`` devices of ``device``'s type: the CUDA devices in turn
    (repeated when there are fewer), or the CPU ``n_devices`` times."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: device 'cuda' requested "
                               "but CUDA is not available")
        count = torch.cuda.device_count()
        return [torch.device("cuda", i % count) for i in range(n_devices)]
    return [torch.device(device)] * n_devices


def entry(device: str = "cuda"):
    """(fn, example_args): one shard's entropy-decode step
    (``_entropy_pipeline`` at the example block's step counts) and its
    arguments, 8 copies of the example block, on ``device``."""
    _, _, d = example_block()
    arrays = example_arrays([d] * 8)
    n_lit = (d.block.literal.num + 3) // 4
    n_lmd = d.block.lmd.num

    def fn(*args):
        return _entropy_pipeline(*args, n_lit_steps=n_lit, n_lmd_steps=n_lmd)

    keys = ("weights", "lit_payload", "lmd_payload", "lit_states", "lit_pos",
            "lit_num", "lmd_states", "lmd_pos", "lmd_num")
    return fn, tuple(torch.from_numpy(arrays[k]).to(device) for k in keys)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """The full sharded codec step over an ``n_devices`` mesh on tiny
    shapes: the portable entropy decode, the container-parallel rebuild,
    the sorted match finder against its unsharded call, the ordered
    gather, the serving decode kernels against the spec layer's literal and
    L/M/D prefixes, then ``TorchDecoder`` and ``TorchEncoder`` with the
    mesh against the raw input and the native encoder. Returns what it
    checked, with the wall milliseconds of the sharded match finder (the
    sorted path, torch ops; its devices synchronised after it)."""
    mesh = make_mesh(mesh_devices(n_devices, device))
    raw, container, d = example_block()
    B = max(n_devices, 2) * 2   # blocks, divisible by the mesh size

    # data-parallel entropy decode, then one container per batch row
    n_lit = (d.block.literal.num + 3) // 4
    n_lmd = d.block.lmd.num
    literals, lmds, ok = sharded_entropy_decode(
        mesh, example_arrays([d] * B), n_lit, n_lmd)
    _check(bool(ok.all()), "the sharded entropy decode flagged a block")
    rows = lmds.cpu().numpy()
    consumed = int(rows[0, :, 0].sum())
    out, rok = sharded_rebuild(
        mesh, literals.cpu().numpy()[:, :max(consumed, 1)], rows,
        np.full(B, len(raw), np.int32), n_out=-(-len(raw) // 4096) * 4096)
    _check(bool(rok.all()), "the sharded rebuild flagged a container")
    out = out.cpu().numpy()
    _check(all(out[b, :len(raw)].tobytes() == raw for b in range(B)),
           "the sharded decode differs from the raw input")

    # the encode frontend: windows sharded, against the unsharded call
    rng = np.random.default_rng(5)
    n_win = 8192
    wins = np.zeros((B, n_win), np.uint8)
    n_real = np.zeros(B, np.int32)
    for b in range(B):
        text = CP.make_raw(("text", "html")[b % 2], n_win - 128, rng)
        wins[b, :len(text)] = np.frombuffer(text, np.uint8)
        n_real[b] = len(text) - 64 * (b % 3)
    t = time.perf_counter()
    got = sharded_match_find(mesh, wins, n_real)
    _sync(mesh)
    match_ms = (time.perf_counter() - t) * 1e3
    want = _match_find_batch(torch.from_numpy(wins).to(mesh.devices[0]),
                             torch.from_numpy(n_real).to(mesh.devices[0]),
                             False)
    _check(all(torch.equal(g, w) for g, w in zip(got, want)),
           "the sharded match finder differs from the unsharded one")

    # the ordered gather
    padded = rng.integers(0, 256, (B, 256), dtype=np.uint8)
    lengths = np.arange(B, dtype=np.int32) + 7
    g_blocks, g_lens = gather_compressed(mesh, padded, lengths)
    _check(np.array_equal(g_blocks.cpu().numpy(), padded)
           and np.array_equal(g_lens.cpu().numpy(), lengths),
           "the gather lost the batch order")

    # the serving decode kernels, against the spec layer's prefixes
    steps = 8
    Bp = 2 * n_devices
    lits, lm, dd, *_ = sharded_pallas_entropy_decode(
        mesh, kernel_arrays(d, Bp, steps, steps), steps, steps, epoch=8)
    tabs = DecoderTables(np.asarray(d.weights))
    want_l = SF.decode_literals(d.lit_payload, tabs, d.block.literal)
    want_r = SF.decode_lmds(d.lmd_payload, tabs, d.block.lmd)
    got_l = lits.cpu().numpy().view(np.uint8).reshape(Bp, 4 * steps)
    lm = lm.cpu().numpy().reshape(Bp, steps)
    dd = dd.cpu().numpy().reshape(Bp, steps)
    _check((got_l == want_l[:4 * steps]).all(),
           "the sharded literal kernel differs from the spec layer")
    _check(((lm & 0xFFFF) == want_r[:steps, 0]).all()
           and ((lm >> 16) == want_r[:steps, 1]).all()
           and (dd == want_r[:steps, 2]).all(),
           "the sharded L/M/D kernel differs from the spec layer")

    # the serving paths with the mesh
    small = CP.encode(CP.make_raw("html", 900, rng))
    sources = [container, small]
    dec = TorchDecoder(mesh.devices[0].type, mesh=mesh)
    stats: dict = {}
    _check(dec.decode_many(sources, stats)
           == [spec_container.decode_bytes(s) for s in sources]
           and stats.get("fallbacks", 0) == 0,
           "TorchDecoder(mesh=) differs from the spec layer")
    src_e = CP.make_raw("text", 20_000, rng)
    enc = TorchEncoder(mesh.devices[0].type, mesh=mesh)
    _check(enc.encode_many([src_e]) == [CP.encode(src_e)],
           "TorchEncoder(mesh=) differs from the native encoder")
    return {"devices": [str(x) for x in mesh.devices], "blocks": B,
            "windows": B, "window_bytes": n_win, "kernel_blocks": Bp,
            "containers": len(sources), "match_find_ms": match_ms}


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    n = int(args[0]) if args else 8
    print(f"dryrun_multichip: ok {dryrun_multichip(n, device)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
