"""The span recorder of TorchDecoder and TorchEncoder, on the CPU.

Under ``torch.profiler`` every call opens one ``lzfse.decode_many`` (or
``lzfse.encode_many``) range on its thread with one range a stage nested
in it, in call order; with no profiler session no profiler function is
called. Every stage's ``stats["detail_cpu"]`` keeps ``0 <= sys <= user +
sys <= wall + 2 ms`` (and one step of the CPU clock, where it steps by
scheduler ticks), and the wall keys are what they were. The
benchmark's readers of those counters and its idle-gap naming are held to
hand-made inputs.
"""

import json
import pathlib
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lzfse_rust_tpu_torch import TorchDecoder, TorchEncoder
from lzfse_rust_tpu_torch.utils import corpus
from lzfse_rust_tpu_torch.utils import timing

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import cpu_account, harness, registry  # noqa: E402
from benchmark import trace as TR  # noqa: E402

DECODE_STAGES = {"parse", "prep", "device", "flatten", "rebuild"}
PREP = {"prep_tables", "prep_gather", "prep_small", "prep_upload"}
ENCODE_STAGES = {"small", "frontend", "emit_prep", "emit_dispatch",
                 "emit_kernels", "pack"}
# decoder options: (keyword arguments, stage ranges in call order)
DECODERS = {
    "default": ({}, ["parse", "prep.tables", "prep.gather", "prep.small",
                     "prep.upload", "device", "flatten", "rebuild"]),
    "device_rebuild": ({"use_native_rebuild": False},
                       ["parse", "prep.tables", "prep.gather", "prep.small",
                        "prep.upload", "device", "flatten", "rebuild",
                        "out_copy", "rebuild"]),
    "scan": ({"use_kernels": False},
             ["parse", "prep", "device", "flatten", "rebuild"]),
}
# encoder options: (keyword arguments, stage ranges in call order); a stage
# that runs across two functions has a range in each
WINDOWS = ["small", "win_prep", "win_prep", "matchfind", "arbitrate", "merge"]
ENCODERS = {
    "default": ({}, ["small", "frontend", "emit_prep", "emit_dispatch",
                     "emit_kernels", "pack"]),
    "device_frontend": ({"frontend": "device"},
                        WINDOWS + ["select", "emit_prep", "emit_prep",
                                   "emit_dispatch", "emit_kernels", "pack"]),
    "host_emission": ({"device_emission": False}, WINDOWS + ["select_emit"]),
}


def _pairs(seed: int, n_fse: int = 3):
    return corpus.small_batch(seed=seed, n_fse=n_fse, lo=3_000, hi=12_000)


def _traced(fn, tmp_path) -> list:
    """The ``lzfse.*`` ranges of ``fn()`` under a CPU profiler session,
    read back from its chrome trace, by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e for e in events if e.get("ph") == "X"
                   and str(e.get("name", "")).startswith("lzfse.")),
                  key=lambda e: float(e["ts"]))


def _nested_in_order(spans: list, call: str, op: str) -> list:
    """Stage names of the one ``call`` range's children, checked to lie in
    it, on its thread, one after another."""
    [outer] = [e for e in spans if e["name"] == call]
    o0 = float(outer["ts"])
    o1 = o0 + float(outer["dur"])
    stages = [e for e in spans if e is not outer]
    end = o0
    for e in stages:
        a = float(e["ts"])
        b = a + float(e["dur"])
        assert e["tid"] == outer["tid"]
        assert e["name"].startswith(f"lzfse.{op}.")
        assert o0 <= a and b <= o1 and a >= end
        end = b
    return [e["name"][len(f"lzfse.{op}."):] for e in stages]


@pytest.fixture(scope="module")
def slack():
    """2 ms, and one step of the thread CPU clock where it steps by ticks
    (a tick it strikes is charged whole to the stage it struck)."""
    return 2e-3 + cpu_account.clock_step_s()


def _check_cpu(stats: dict, stages: set, slack: float) -> None:
    cpu = stats["detail_cpu"]
    assert set(cpu) - {"detail_prep"} == stages
    for key in stages:
        c = cpu[key]
        assert 0 <= c["sys"] <= c["user"] + c["sys"] <= stats[key] + slack
        assert c["user"] >= 0
    assert cpu_account.bounds_bad(stats, slack) == 0


@pytest.mark.parametrize("option", sorted(DECODERS))
def test_decode_spans_nest_in_call_order(option, tmp_path):
    kw, order = DECODERS[option]
    pairs = _pairs(61, n_fse=1)   # the profiler slows every torch op
    dec = TorchDecoder("cpu", **kw)
    stats: dict = {}
    box = {}
    spans = _traced(lambda: box.update(
        out=dec.decode_many([c for _, c in pairs], stats)), tmp_path)
    assert box["out"] == [r for r, _ in pairs]
    assert _nested_in_order(spans, "lzfse.decode_many", "decode") == order
    # every wall key has its range, and no range is without its key
    assert {s.split(".")[0] for s in order} == {
        k for k, v in stats.items() if isinstance(v, float)}


@pytest.mark.parametrize("option", sorted(ENCODERS))
def test_encode_spans_nest_in_call_order(option, tmp_path):
    kw, order = ENCODERS[option]
    raws = [r for r, _ in _pairs(62, n_fse=1)]
    stats: dict = {}
    box = {}
    spans = _traced(lambda: box.update(
        out=TorchEncoder("cpu", **kw).encode_many(raws, stats)), tmp_path)
    assert TorchDecoder("cpu").decode_many(box["out"]) == raws
    assert _nested_in_order(spans, "lzfse.encode_many", "encode") == order
    assert set(order) == {k for k, v in stats.items()
                          if isinstance(v, float)}


def test_no_profiler_call_without_a_session(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a profiler range without a session")

    assert not torch.autograd.profiler._is_profiler_enabled
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    pairs = _pairs(63)
    raws = [r for r, _ in pairs]
    for kw, _ in DECODERS.values():
        stats: dict = {}
        assert TorchDecoder("cpu", **kw).decode_many(
            [c for _, c in pairs], stats) == raws
        assert DECODE_STAGES <= set(stats)
    stats = {}
    blobs = TorchEncoder("cpu").encode_many(raws, stats)
    assert TorchDecoder("cpu").decode_many(blobs) == raws
    assert ENCODE_STAGES <= set(stats)


def test_no_clock_read_without_stats(monkeypatch):
    def boom():
        raise AssertionError("a CPU clock read without stats")

    monkeypatch.setattr(timing, "_thread_cpu", boom)
    pairs = _pairs(64)
    raws = [r for r, _ in pairs]
    assert TorchDecoder("cpu").decode_many([c for _, c in pairs]) == raws
    assert TorchDecoder("cpu").decode_many(
        TorchEncoder("cpu").encode_many(raws)) == raws


@pytest.mark.parametrize("option", sorted(DECODERS))
def test_decode_cpu_within_wall(option, slack):
    kw, _ = DECODERS[option]
    pairs = _pairs(65)
    dec = TorchDecoder("cpu", **kw)
    for _ in range(2):   # the second call reuses the staging buffers
        stats: dict = {}
        dec.decode_many([c for _, c in pairs], stats)
        _check_cpu(stats, {k for k, v in stats.items()
                           if isinstance(v, float)}, slack)


def test_encode_cpu_within_wall(slack):
    raws = [r for r, _ in _pairs(66)]
    stats: dict = {}
    TorchEncoder("cpu").encode_many(raws, stats)
    _check_cpu(stats, ENCODE_STAGES, slack)


def test_existing_stats_keys_keep_their_meaning(slack):
    pairs = _pairs(67)
    stats: dict = {}
    TorchDecoder("cpu").decode_many([c for _, c in pairs], stats)
    assert DECODE_STAGES | {"detail_prep"} <= set(stats)
    assert {k for k, v in stats.items() if isinstance(v, float)} == \
        DECODE_STAGES
    assert set(stats["detail_prep"]) == PREP
    assert stats["prep"] == pytest.approx(sum(stats["detail_prep"].values()))
    cpu = stats["detail_cpu"]
    assert set(cpu["detail_prep"]) == PREP
    for part in ("user", "sys"):
        assert cpu["prep"][part] == pytest.approx(
            sum(v[part] for v in cpu["detail_prep"].values()))
    for key, wall in stats["detail_prep"].items():
        c = cpu["detail_prep"][key]
        assert 0 <= c["sys"] <= c["user"] + c["sys"] <= wall + slack


# --- the benchmark's readers and gap names -----------------------------------

def _call(i: int, walls: dict, cpu: dict | None) -> harness.Call:
    stats = dict(walls)
    if cpu is not None:
        stats["detail_cpu"] = cpu
    return harness.Call(0, i, float(i), i + 0.5, 1, stats)


def _run(calls, cell: str = "snappy.decode") -> harness.Run:
    return harness.Run(registry.cell(cell), None, 1.0,
                       harness.Window(0.0, 100.0, calls=calls))


def _readers() -> dict:
    cell = registry.cell("snappy.decode")
    return {m.name: registry.reader(m) for m in cell.per_layer}


WALLS = [{"parse": 0.010, "prep": 0.030, "device": 0.005, "flatten": 0.004,
          "rebuild": 0.100},
         {"parse": 0.020, "prep": 0.020, "device": 0.005, "flatten": 0.006,
          "rebuild": 0.060}]
CPUS = [{"parse": {"user": 0.006, "sys": 0.001},
         "prep": {"user": 0.020, "sys": 0.003},
         "device": {"user": 0.001, "sys": 0.0},
         "flatten": {"user": 0.003, "sys": 0.0005},
         "rebuild": {"user": 0.040, "sys": 0.010}, "detail_prep": {}},
        {"parse": {"user": 0.015, "sys": 0.002},
         "prep": {"user": 0.010, "sys": 0.001},
         "device": {"user": 0.002, "sys": 0.0},
         "flatten": {"user": 0.005, "sys": 0.0},
         "rebuild": {"user": 0.030, "sys": 0.0045}, "detail_prep": {}}]


@pytest.mark.parametrize("name, want", [
    # (10+30-7-23) and (20+20-17-11) ms, then their mean
    ("decode.front_wait_ms", (10.0 + 12.0) / 2),
    # (4+100-3.5-50) and (6+60-5-34.5)
    ("decode.rebuild_wait_ms", (50.5 + 26.5) / 2),
    # 0.5+10 and 0+4.5
    ("decode.rebuild_sys_ms", (10.5 + 4.5) / 2)])
def test_readers_of_the_cpu_counters(name, want):
    read = _readers()[name]
    calls = [_call(i, w, c) for i, (w, c) in enumerate(zip(WALLS, CPUS))]
    assert read(_run(calls)) == pytest.approx(want)
    # a program without the recorder, or one call without it: no reading
    assert read(_run([_call(i, w, None) for i, w in enumerate(WALLS)])) \
        is None
    assert read(_run([calls[0], _call(1, WALLS[1], None)])) is None
    assert read(_run([])) is None


def test_account_sets_calling_cpu_against_the_process():
    calls = [_call(i, w, c) for i, (w, c) in enumerate(zip(WALLS, CPUS))]
    line = cpu_account.account(
        [harness.Window(0.0, 100.0, calls=calls)],
        {"utime_s": 1.0, "stime_s": 0.5}, {"utime_s": 1.3, "stime_s": 0.7},
        0.01)
    fields = dict(kv.split("=") for kv in line.split()[1:])
    assert fields["calls"] == "2" and fields["recorded"] == "2"
    assert float(fields["calling_cpu_s"]) == pytest.approx(0.154, abs=1e-3)
    assert float(fields["process_cpu_s"]) == pytest.approx(0.5)
    assert fields["bounds_bad"] == "0"
    assert fields["bounds_bad_step"] == "0"
    assert fields["clock_step_ms"] == "10.000"
    # flatten: 8.5 ms of CPU over 10 ms of wall, the largest share
    assert fields["stage_cpu_over_wall"] == "0.8500@flatten"
    assert float(fields["window_GBps"]) == pytest.approx(2 / 1.5 / 1e9)
    over = dict(WALLS[0], rebuild=0.040, detail_cpu=CPUS[0])   # 50 in 40 ms
    assert cpu_account.bounds_bad(over) == 1
    assert cpu_account.bounds_bad(over, 0.010 + 2e-3) == 0
    assert 0 < cpu_account.clock_step_s() < 0.1


def test_gap_named_by_the_stage_inside_the_call():
    def x(name, cat, a, b):
        return {"ph": "X", "name": name, "cat": cat, "ts": a, "dur": b - a}

    events = [x(TR.WINDOW, "user_annotation", 0, 1000),
              x("Memcpy DtoH", "gpu_memcpy", 0, 100),
              x("Memcpy HtoD", "gpu_memcpy", 900, 1000),
              x("benchmark.call", "user_annotation", 50, 950),
              x("lzfse.decode_many", "user_annotation", 60, 940),
              x("lzfse.decode.device", "user_annotation", 60, 110),
              x("lzfse.decode.flatten", "user_annotation", 110, 300),
              x("lzfse.decode.rebuild", "user_annotation", 300, 800)]
    trace = TR.reduce_events(events)
    [[name, seconds]] = trace.idle_gaps
    assert name.startswith("host_lzfse.decode.rebuild:")
    assert seconds == pytest.approx(800e-6)
