"""The benchmark of lzfse_rust_tpu_torch (the PyTorch and CUDA port).

    python3 benchmark/run.py --workload snappy.decode --seed 7 --seconds 20 \
        --trace 0

Runs one cell of ``BENCHMARK.json`` on the machine it is started on, from
the root of a checkout. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (with a profiled sub-window
after the measured one). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each number the
check compared beside its limit; the same numbers end standard error.

Exits non-zero, with no result, without CUDA or with fewer cards than the
cell asks for, and when a module of JAX or of the JAX package is loaded
once the window has closed. Builds and caches stay inside the checkout:
the program's ``build/`` and the directories set below.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Kernel caches at fixed paths in the checkout; libraries that could
    load JAX told not to."""
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    from benchmark import harness, registry

    cell = registry.cell(args.workload)
    # the inputs are made while torch loads
    inputs = harness.Inputs(cell.config, args.seed)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on a card",
              file=sys.stderr)
        inputs.close()
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        inputs.close()
        return 2
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), "cuda", T_PROCESS,
                                     inputs=inputs)
    lines.append(_card())
    return emit(result, lines)


def emit(result: dict, lines: list[str]) -> int:
    """Print the lines, then the result line and each check beside its
    limit; or, when a module of JAX or the JAX package is loaded by now
    (the window, the check and every reader have run), name it on
    standard error and print no result (exit 3)."""
    for line in lines:
        print(line, flush=True)
    from benchmark import harness
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr, flush=True)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    return 0


def _card() -> str:
    import subprocess
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return "card " + (smi.stdout.strip().replace("\n", "; ")
                          or f"nvidia-smi exit {smi.returncode}")
    except (OSError, subprocess.SubprocessError) as exc:
        return f"card nvidia-smi: {exc}"


if __name__ == "__main__":
    sys.exit(main())
