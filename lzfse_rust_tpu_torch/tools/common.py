"""What every measurement tool of the port does first, and the timing the
probe tools share.

Each tool prints the card's name and power limit (as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them) and
raises when there is no CUDA device: no tool falls back to the CPU or to a
plain version.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable

import torch

from ..utils import corpus as CP
from ..utils.timing import cuda_ms


class NoCardError(RuntimeError):
    """A tool was asked to run without a CUDA device."""


def card_line() -> str:
    """The card's name and power limit from ``nvidia-smi``."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (FileNotFoundError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"
    return smi.stdout.strip() or f"nvidia-smi: exit {smi.returncode}"


def require_card(tool: str) -> str:
    """Print the card line; raise ``NoCardError`` without a CUDA device.
    Returns ``torch.cuda.get_device_name(0)``."""
    print(card_line(), flush=True)
    if not torch.cuda.is_available():
        raise NoCardError(f"{tool} measures the CUDA device and needs one; "
                          f"torch.cuda.is_available() is False")
    return torch.cuda.get_device_name(0)


def per_step_ms(run: Callable[[int], object], n_steps: int,
                reps: int = 3) -> float:
    """Milliseconds per step of ``run(n)``, as the TPU probes time it:
    (t(n) - t(n/8)) / (7n/8), which cancels the launch's fixed cost. Each
    t is the mean of ``reps`` launches between two CUDA events, after one
    warm-up launch."""
    lo = n_steps // 8
    t_lo = cuda_ms(lambda: run(lo), reps=reps, warmup=1)
    t_hi = cuda_ms(lambda: run(n_steps), reps=reps, warmup=1)
    return (t_hi - t_lo) / (n_steps - lo)


def serving_pairs(seed: int = 0):
    """The seeded serving batch, ``(raw, container)`` pairs, with its
    generation time printed."""
    t = time.perf_counter()
    pairs = CP.serving_batch(seed=seed)
    print(f"serving batch seed {seed}: {len(pairs)} containers, "
          f"{sum(len(r) for r, _ in pairs)} raw bytes, made in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    return pairs


def decode_inputs(seed: int = 0):
    """(decoder, pairs, literal kwargs, L/M/D kwargs, raw bytes): both
    decode kernels' arguments for the serving batch on the card, as
    ``TorchDecoder.decode_many`` passes them."""
    from ..models.decoder import TorchDecoder
    pairs = serving_pairs(seed)
    dec = TorchDecoder("cuda")
    lit, lmd = dec.kernel_args([c for _, c in pairs])
    return dec, pairs, lit, lmd, sum(len(r) for r, _ in pairs)


def second_smallest(xs):
    """The second-smallest of several runs (the smallest when there is
    one): host contention only adds time, and one lucky run is not kept."""
    xs = sorted(xs)
    return xs[1] if len(xs) > 1 else xs[0]
