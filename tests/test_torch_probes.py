"""The port's probe kernels against the JAX tools' Pallas probe kernels.

``probe_step_ref``, ``probe_chain_ref`` and ``probe_tput_ref`` (the plain
versions the CUDA probe kernels are held to on the card) must give the
tile that the Pallas kernels of ``tools/microbench_step.py`` and
``tools/microbench_vpu.py`` give in interpret mode, bit for bit, for every
body those tools time.

The tools build their kernels inside functions (``timed``, ``run`` and
``main``'s local ``run_tp``) and time them at once. The tests reach them
without editing the tools: ``pl.pallas_call`` is replaced by a recorder
that keeps each kernel and its call arguments and returns zeros, the tool
runs through (printing meaningless times), and each recorded kernel is
replayed with the real ``pl.pallas_call`` in interpret mode, at 3 steps,
on seeded inputs. The collapsed lookups are held against the tool's select
trees directly.
"""

import functools
import importlib.util
import os
import pathlib
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from lzfse_rust_tpu_torch.ops import cuda_probes as P
from lzfse_rust_tpu_torch.tools import microbench_step as PS
from lzfse_rust_tpu_torch.tools import microbench_vpu as PV

TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"
N_STEPS = 3
I32 = np.iinfo(np.int32)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"_tpu_tool_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _step_makers(ms) -> dict:
    """Port step body -> the TPU tool's kernel maker."""
    return {"current": ms.current_step, "indep_roll": ms.indep_roll_step,
            "gathers_only": ms.gathers_only, "lookup_only": ms.lookup_only,
            "fast": ms.fast_step, "fast_nosplit": ms.fast_step_nosplit,
            "lookup_8ch": ms.lookup_only_n(8),
            "lookup_16ch": ms.lookup_only_n(16),
            "lookup_32ch": ms.lookup_only_n(32),
            "pair_64": ms.pair_step_64}


@pytest.fixture(scope="module")
def tools():
    """The TPU tools, imported with the environment they change restored
    afterwards."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_COMPILATION_CACHE_DIR",
                  os.environ.get("JAX_COMPILATION_CACHE_DIR", "/tmp/jaxcache"))
        yield _load("microbench_step"), _load("microbench_vpu")


@pytest.fixture(scope="module")
def recorded(tools):
    """Every kernel the two tools hand to ``pl.pallas_call``: (kernel
    partial, call kwargs) by ("step", body, n_vregs) and by VPU row."""
    ms, mv = tools
    rec = []

    def record(kernel, **kw):
        rec.append((kernel, kw))
        out = kw["out_shape"]
        return lambda *args: jnp.zeros(out.shape, out.dtype)

    # a clock whose intervals grow, so the tools' timing arithmetic never
    # divides by zero
    ticks = iter(range(1, 1 << 30))
    clock = types.SimpleNamespace(time=lambda: next(ticks) ** 2)
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", record)
        mp.setattr(ms, "time", clock)
        for body, make in _step_makers(ms).items():
            for nv in (1, 2):
                ms.timed(body, make, 16, n_vregs=nv,
                         tab_words=P.STEP_BODIES[body])
                got[("step", body, nv)] = rec[-1]
        start = len(rec)
        mv.main()
    vpu = rec[start:]
    # two compiles (n/8 and n steps) per row, rows in the port's table order
    assert len(vpu) == 2 * len(PV.ROWS)
    for r, row in enumerate(PV.ROWS):
        got[(row.kind, row.body)] = vpu[2 * r]
    return got


def _replay(entry, *args):
    kernel, kw = entry
    fn = pl.pallas_call(functools.partial(kernel.func, n_steps=N_STEPS),
                        interpret=True, **kw)
    return np.asarray(fn(*args))


def _draw(rng, shape, lo, hi):
    return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n_vregs", [1, 2])
@pytest.mark.parametrize("body", list(P.STEP_BODIES))
def test_step_plain_equals_pallas(recorded, body, n_vregs):
    """One vreg: the TPU tool's input ranges; two vregs: any int32 (signed
    shifts, wrap-around)."""
    rng = np.random.default_rng(100 + list(P.STEP_BODIES).index(body))
    tw = P.STEP_BODIES[body]
    if n_vregs == 1:
        tab = _draw(rng, (8, P.G * tw), 0, 1024)
        chunk = _draw(rng, (8, P.G * 256), 0, I32.max)
        x = _draw(rng, (8, 128), 0, 128)
    else:
        tab = _draw(rng, (8, P.G * tw), I32.min, I32.max + 1)
        chunk = _draw(rng, (8, P.G * 256), I32.min, I32.max + 1)
        x = _draw(rng, (16, 128), I32.min, I32.max + 1)
    want = _replay(recorded[("step", body, n_vregs)], tab, chunk, x)
    got = P.probe_step(body, _t(tab), _t(chunk), _t(x), N_STEPS)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("wide", [False, True], ids=["tool", "wide"])
@pytest.mark.parametrize("row", PV.ROWS, ids=lambda r: r.body)
def test_vpu_plain_equals_pallas(recorded, row, wide):
    """Chain (``run``) and throughput (``run_tp``) bodies, at the tool's
    input ranges and at any int32."""
    rng = np.random.default_rng(200 + PV.ROWS.index(row))
    lo, hi = (I32.min, I32.max + 1) if wide else (0, 128)
    tab = _draw(rng, (8, 1024), lo, hi)
    x = _draw(rng, (8, 128), lo, hi)
    want = _replay(recorded[(row.kind, row.body)], tab, x)
    fn = P.probe_chain if row.kind == "chain" else P.probe_tput
    got = fn(row.body, _t(tab), _t(x), N_STEPS)
    np.testing.assert_array_equal(got.numpy(), want)


def test_row_tables_follow_the_tpu_tools(tools):
    """The port's rows carry the TPU tools' names, step counts, vregs and
    table widths, in their order."""
    ms, _ = tools
    src = (TOOLS / "microbench_step.py").read_text()
    for row in PS.ROWS + PS.MULTISYM_ROWS:
        assert f'"{row.name}"' in src
        assert P.STEP_BODIES[row.body] in (1024, 2048, 4096, 9216)
    assert [r.n_steps for r in PS.ROWS] == [20_000] * 9
    assert [r.n_vregs for r in PS.ROWS] == [1, 1, 2, 2, 1, 1, 1, 2, 1]
    assert [r.n_steps for r in PS.MULTISYM_ROWS] == [20_000, 20_000, 10_000,
                                                     10_000]
    vsrc = (TOOLS / "microbench_vpu.py").read_text()
    for row in PV.ROWS:
        assert f'"{row.name}"' in vsrc
    assert set(P.CHAIN_BODIES) | set(P.TPUT_BODIES) == {r.body for r in PV.ROWS}


@pytest.mark.parametrize("name,n_chunks,tw", [
    ("lookup_sec", 8, 1024), ("lookup_chunks", 8, 1024),
    ("lookup_chunks", 16, 2048), ("lookup_chunks", 32, 4096),
    ("lookup_chunks", 64, 9216), ("chunk_word", 2, 256),
    ("chunk_word_128", 1, 256)])
def test_collapsed_lookup_equals_select_tree(tools, name, n_chunks, tw):
    """The TPU tool's 128-lane gathers and select merges equal the port's
    direct index ``tab[r, sec * tw + c * 128 + (idx & 127)]``, on seeded
    indices inside the table and of any int32."""
    ms, _ = tools
    rng = np.random.default_rng(7)
    tab = _draw(rng, (8, P.G * tw), I32.min, I32.max + 1)
    idx = np.concatenate([_draw(rng, (4, 128), 0, n_chunks * 128),
                          _draw(rng, (4, 128), I32.min, I32.max + 1)])
    sec = np.broadcast_to(np.arange(128, dtype=np.int32) >> 4, (8, 128))
    extra = (n_chunks, tw) if name == "lookup_chunks" else ()
    want = getattr(ms, name)(jnp.asarray(tab), jnp.asarray(idx),
                             jnp.asarray(sec), *extra)
    R = P._Row(_t(tab), _t(tab), 8)
    s = _t(idx).long()
    got = (R.lookup(s, n_chunks, tw) if name.startswith("lookup")
           else getattr(R, name)(s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int64))


def test_step_memory_rejects_an_unknown_body_before_loading_the_library(
        monkeypatch):
    monkeypatch.setattr(P.cuda_lib, "lib", lambda: pytest.fail("loaded"))
    with pytest.raises(ValueError, match="unknown body"):
        P.step_memory("nope")


def test_wrappers_validate_and_have_no_path_for_other_devices():
    z = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    with pytest.raises(ValueError, match="unknown body"):
        P.probe_step("nope", z(8, 8192), z(8, 2048), z(8, 128), 1)
    with pytest.raises(ValueError, match="must be"):
        P.probe_step("current", z(8, 8192), z(8, 2048), z(12, 128), 1)
    with pytest.raises(ValueError, match="tab must be"):
        P.probe_chain("add", z(8, 512), z(8, 128), 1)
    with pytest.raises(TypeError, match="int32"):
        P.probe_tput("roll_x8", z(8, 1024).long(), z(8, 128), 1)
    m = lambda *s: torch.zeros(s, dtype=torch.int32, device="meta")  # noqa: E731
    before = dict(P.launches)
    with pytest.raises(ValueError, match="no kernel"):
        P.probe_chain("add", m(8, 1024), m(8, 128), 1)
    with pytest.raises(ValueError, match="no kernel"):
        P.probe_step("current", m(8, 8192), m(8, 2048), m(8, 128), 1)
    assert P.launches == before
