"""The harness's arithmetic, lookups and result line, on the CPU.

    python -m pytest benchmark/tests -q

The driver's ``pytest tests/`` does not collect these; the test that needs
a card is marked ``cuda`` and skips without one.
"""

from __future__ import annotations

import ast
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
sys.path.insert(0, str(ROOT))

from benchmark import harness, registry, roofline  # noqa: E402
from benchmark import trace as TR  # noqa: E402
from benchmark.reference import check as CK  # noqa: E402
from benchmark.reference import constants as C  # noqa: E402
from benchmark.reference import fse as F  # noqa: E402

EOS = C.MAGIC_EOS.to_bytes(4, "little")
TINY = {"name": "tiny", "replicas": 2,
        "files": [["a", "text", 30000], ["b", "html", 9000],
                  ["c", "binary", 20000], ["d", "random", 5000],
                  ["e", "urls", 3000]]}


def tiny_tree(tmp: pathlib.Path) -> pathlib.Path:
    """A copy of the benchmark with a tiny configuration and its two cells
    (``tiny.decode``, ``tiny.encode``) added, as a later change would add
    them: files and entries only."""
    shutil.copytree(BENCH, tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(TINY))
    spec["configs"].append({"name": "tiny", "source": "test",
                            "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "test"})
    have = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]}
    for op in ("decode", "encode"):
        spec["workloads"].append({"name": f"tiny.{op}", "config": "tiny",
                                  "traffic": op, "chips": 1, "why": "test"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "workloads" in m and m["name"].startswith(op):
                m["workloads"].append(f"tiny.{op}")
        # the readers of an op that no cell of BENCHMARK.json reports yet
        for path in sorted((BENCH / "metrics").glob(f"{op}*.py")):
            name = path.stem
            if name in have:
                continue
            rate = name == f"{op}_GBps"
            spec["end_to_end" if rate else "per_layer"].append(
                {"name": name, "unit": "GB/s" if rate else "ms",
                 "better": "higher", "source": "host_clock",
                 **({"bound": 0.25} if rate else
                    {"layer": "test", "moves": f"{op}_GBps"}),
                 "workloads": [f"tiny.{op}"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


# --- lookups by name ---------------------------------------------------------

def test_every_cell_resolves_with_its_files():
    spec = registry.load_benchmark()
    for w in spec["workloads"]:
        cell = registry.cell(w["name"])
        assert cell.traffic["op"] in ("decode", "encode")
        names = {m.name for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(registry.reader(m))


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        registry.cell("no.such.cell")


def test_added_files_are_found_without_a_code_edit(tmp_path):
    root = tiny_tree(tmp_path)
    bench = root / "benchmark"
    mix = json.loads((bench / "traffic" / "decode.json").read_text())
    mix["clients"] = 2
    (bench / "traffic" / "decode2.json").write_text(json.dumps(mix))
    (bench / "metrics" / "decode.calls.py").write_text(
        "def read(run):\n    return float(len(run.calls()))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny.decode2", "config": "tiny",
                              "traffic": "decode2", "chips": 1, "why": "t"})
    spec["per_layer"].append({"name": "decode.calls", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "clients", "moves": "decode_GBps",
                              "workloads": ["tiny.decode2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = registry.cell("tiny.decode2", root, bench)
    assert cell.config == TINY and cell.traffic["clients"] == 2
    assert [m.name for m in cell.per_layer] == ["decode.calls"]
    read = registry.reader(cell.per_layer[0])
    fake = harness.Run(cell, None, 1.0, harness.Window(0.0, 1.0, calls=[
        harness.Call(0, 0, 0.0, 0.5, 10, {})]))
    assert read(fake) == 1.0


# --- the window's arithmetic -------------------------------------------------

def _call(t0, t1, nbytes=1000, error=None, client=0):
    return harness.Call(client, 0, t0, t1, nbytes, {}, error)


def test_window_rate_counts_completed_calls_over_their_span():
    calls = [_call(0.0, 0.4), _call(0.0, 0.5, client=1), _call(0.4, 0.9),
             _call(0.5, 1.2, client=1)]           # completes after the end
    # 3 calls of 1000 bytes by 0.9 s; the last one is cut by the end (1.0)
    assert harness.window_rate(calls, 0.0, 1.0) == pytest.approx(
        3000 / 0.9 / 1e9)


def test_window_rate_leaves_out_failed_calls_and_none_without_any():
    calls = [_call(0.0, 0.5), _call(0.5, 0.8, error="boom")]
    assert harness.window_rate(calls, 0.0, 1.0) == pytest.approx(
        1000 / 0.5 / 1e9)
    assert harness.window_rate([_call(0.0, 2.0)], 0.0, 1.0) is None
    assert harness.window_rate([], 0.0, 1.0) is None


def test_window_rate_starts_at_the_window_not_the_first_call():
    assert harness.window_rate([_call(0.3, 0.5)], 0.1, 1.0) == \
        pytest.approx(1000 / 0.4 / 1e9)


def test_percentile_and_done():
    assert harness.percentile(range(1, 101), 95) == pytest.approx(95.05)
    w = harness.Window(0.0, 1.0, calls=[_call(0, 0.5), _call(0.5, 1.5),
                                        _call(0.1, 0.2, error="x")])
    assert len(w.done()) == 1


def test_run_closed_loop_window_on_stand_in_op():
    class Op:
        nbytes = 10

        def call(self, engine, stats):
            stats["parse"] = 0.001
            return [engine]

        def quick(self, outs, stats, key):
            return {"bad": int(outs != [key[0]])}

    w = harness.run_window(Op(), [0, 1, 2], 0.2, seed=5)
    assert {c.client for c in w.calls} == {0, 1, 2}
    assert w.faults == {"bad": 0}
    assert all(c.t0 < w.t_end for c in w.calls)
    # one kept call or two per client, each a list the op returned
    assert 3 <= len(w.kept) <= 6


# --- roofline counts from the format -----------------------------------------

def test_fse_work_matches_a_hand_count():
    lits = np.frombuffer(b"abcdefghabcd", np.uint8)
    rows = np.array([[4, 8, 4], [4, 6, 8], [4, 0, 0]], np.int32)
    blk = F.encode_block(lits, rows, 26)
    cont = blk + EOS
    # by hand from the Vx2 header: 20-bit fields of three 64-bit words
    p0 = int.from_bytes(blk[8:16], "little")
    p1 = int.from_bytes(blk[16:24], "little")
    p2 = int.from_bytes(blk[24:32], "little")
    n_lit, lit_pay, n_lmd = p0 & 0xFFFFF, (p0 >> 20) & 0xFFFFF, \
        (p0 >> 40) & 0xFFFFF
    lmd_pay = (p1 >> 40) & 0xFFFFF
    head = p2 & 0xFFFFFFFF
    assert (n_lit, n_lmd) == (12, 3)
    assert head + lit_pay + lmd_pay == len(blk)
    w = CK.fse_work([cont, cont])
    assert w["blocks"] == 2
    assert w["literals"] == 24 and w["matches"] == 6
    assert w["symbols"] == 2 * (12 + 3 * 3)
    assert w["coded_bytes"] == 2 * len(blk)
    assert w["decoded_bytes"] == 2 * (12 + 3 * 3 * 4)
    assert w["ops"] == 5 * w["symbols"]


def test_fse_work_skips_raw_and_vn_blocks():
    from benchmark.reference import frontend as SF
    raw = SF.encode_bytes(b"x" * 100)           # a RAW or VN block
    assert CK.fse_work([raw, EOS])["blocks"] == 0


def test_block_each_draws_containers_uniformly_and_sees_one_bad_byte():
    from benchmark.reference import frontend as SF
    from benchmark import corpus
    raws = [corpus.make_file(k, n, 3, i) for i, (k, n) in enumerate(
        [("text", 40000), ("html", 9000), ("binary", 20000), ("text", 6000)])]
    conts = [SF.encode_bytes(r) for r in raws]
    rng = np.random.default_rng(1)
    assert CK.check_block_each(conts, raws, rng, 8) == {"containers": 4,
                                                        "bad": 0}
    blk = CK.walk(conts[1])[0]          # the smallest source's only block
    i = blk.end - 3
    bad = conts[:1] + [conts[1][:i] + bytes([conts[1][i] ^ 0x40])
                       + conts[1][i + 1:]] + conts[2:]
    assert CK.check_block_each(bad, raws, rng, 8)["bad"] == 1
    # two of four containers drawn: each is drawn about half the time
    seen = sum(CK.check_block_each(bad, raws, np.random.default_rng(s),
                                   2)["bad"] for s in range(200))
    assert 70 <= seen <= 130


def test_roofline_share_and_idle_share_by_hand():
    t = TR.Trace(window_s=2.0, busy_s=0.5, kernels={
        "ns::literal_kernel<4>": [4, 0.004], "ns::lmd_kernel<3>": [4, 0.004],
        "ns::literal_encode_kernel": [1, 9.0]})
    nbytes, ops = 3.35e9, 0.0          # one ms of bytes, no ops
    # least 1 ms a call, 2 ms of the two kernels a call: 50%
    assert roofline.share(t, ("literal_kernel", "lmd_kernel"), nbytes,
                          ops) == pytest.approx(50.0)
    # ops bound: 67e9 ops are 1 ms
    assert roofline.share(t, ("literal_kernel", "lmd_kernel"), 0.0,
                          67e9) == pytest.approx(50.0)
    assert roofline.share(t, ("no_such_kernel",), 1.0, 1.0) is None
    assert roofline.idle_share(t) == pytest.approx(75.0)


def test_reduce_events_busy_gaps_and_kernels():
    ev = [
        {"ph": "X", "name": "benchmark.window", "cat": "user_annotation",
         "ts": 0, "dur": 1000},
        {"ph": "X", "name": "benchmark.call", "cat": "user_annotation",
         "ts": 0, "dur": 1000},
        {"ph": "X", "name": "lit_k", "cat": "kernel", "ts": 100, "dur": 100},
        {"ph": "X", "name": "lmd_k", "cat": "kernel", "ts": 150, "dur": 100},
        {"ph": "X", "name": "Memcpy HtoD", "cat": "gpu_memcpy", "ts": 600,
         "dur": 200},
        {"ph": "X", "name": "late", "cat": "kernel", "ts": 950, "dur": 100},
    ]
    t = TR.reduce_events(ev)
    # busy: 100-250, 600-800, 950-1000 (clipped at the window's end)
    assert t.busy_s == pytest.approx(400e-6)
    assert t.window_s == pytest.approx(1000e-6)
    assert t.kernels["lit_k"] == [1, pytest.approx(100e-6)]
    assert t.kernels["late"] == [1, pytest.approx(50e-6)]
    gaps = dict(t.idle_gaps)
    assert sum(gaps.values()) == pytest.approx(600e-6)
    assert any(k.startswith("host_benchmark.call:lmd_k-Memcpy") for k in gaps)
    assert TR.reduce_events(ev[1:]) is None


# --- the result line -----------------------------------------------------------

def test_result_line_keys_on_the_cpu(tmp_path):
    from benchmark import control
    root = tiny_tree(tmp_path)
    res, lines = harness.run_cell("tiny.decode", 2**31 + 7, 0.5, False,
                                  "cpu", root=root, bench=root / "benchmark",
                                  wrap=control.host_engine)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"decode_GBps", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert all(set(v) == {"value", "limit"} for v in res["checks"].values())
    assert any(line.startswith("setup_split_s ") for line in lines)
    json.dumps(res)


# --- what the harness and the reference import ---------------------------------

def _top_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(
    p.relative_to(BENCH).as_posix() for p in BENCH.rglob("*.py")
    if "__pycache__" not in p.parts))
def test_no_module_imports_jax_or_the_jax_package(path):
    found = _top_imports(BENCH / path)
    assert not found & set(harness.FORBIDDEN), found
    if path.startswith("reference/"):
        assert "lzfse_rust_tpu_torch" not in found
        assert found <= {"__future__", "numpy", "dataclasses"}, found


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.check, benchmark.reference.container\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'lzfse_rust_tpu',"
            " 'lzfse_rust_tpu_torch', 'torch'}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"


def test_a_module_loaded_by_a_reader_stops_the_result(tmp_path, monkeypatch,
                                                      capsys):
    """A reader (or the check) that loads JAX leaves no result line: the
    look at ``sys.modules`` comes after every reader has run."""
    from benchmark import control, run
    root = tiny_tree(tmp_path / "tree")
    stand_in = tmp_path / "site"
    (stand_in / "jax").mkdir(parents=True)
    (stand_in / "jax" / "__init__.py").write_text("STAND_IN = True\n")
    monkeypatch.syspath_prepend(str(stand_in))
    (root / "benchmark" / "metrics" / "setup_s.py").write_text(
        "import jax\n\n\ndef read(run):\n    return run.setup_s\n")
    assert "jax" not in sys.modules
    try:
        res, lines = harness.run_cell("tiny.decode", 5, 0.3, False, "cpu",
                                      root=root, bench=root / "benchmark",
                                      wrap=control.host_engine)
        assert sys.modules["jax"].STAND_IN
        assert run.emit(res, lines) == 3
    finally:
        sys.modules.pop("jax", None)
    out, err = capsys.readouterr()
    assert "{" not in out and "['jax']" in err
    assert run.emit(res, lines) == 0
    out, _ = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1])["correct"] is True


def test_inputs_are_made_in_worker_processes_from_the_seed():
    inputs = harness.Inputs(TINY, 2**40 + 3)
    raws = inputs.result()
    from benchmark import corpus
    files = corpus.layout(TINY)
    assert [len(r) for r in raws] == [f[2] for f in files]
    assert raws[3] == corpus.make_file(files[3][1], files[3][2], 2**40 + 3, 3)
    assert inputs.seconds > 0
    assert not inputs._ex._processes   # every worker has ended


def test_host_line_reads_the_process_counters():
    a = harness.host_sample()
    harness.cpu_probe_ms()
    line = harness.host_line(a, harness.host_sample())
    assert line.startswith("host wall_s=") and "utime_s=" in line
    assert "stime_s=" in line and "majflt=" in line


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "lzfse_rust_tpu_torch_like", sys)
    assert "lzfse_rust_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "lzfse_rust_tpu.api", sys)
    assert "lzfse_rust_tpu" in harness.forbidden_modules()
