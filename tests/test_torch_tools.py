"""The port's measurement tools (``lzfse_rust_tpu_torch/tools``) on the CPU:
the parts that need no card, and the refusal to run without one.

Every tool measures the CUDA device, so on the CPU each must print the
card line and raise ``NoCardError`` before it does any work. Their pure
parts (the shape model's counts, the timing arithmetic, the corpus kinds,
the checks' verdicts, the rebuild capture, the runbook's resume) run here
on small seeded batches.
"""

import hashlib
import json
import os
import pathlib
import pkgutil
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import lzfse_rust_tpu_torch.tools as tools_pkg
from lzfse_rust_tpu_torch import TorchDecoder, TorchEncoder
from lzfse_rust_tpu_torch import api as port_api
from lzfse_rust_tpu_torch.runtime.build import native_runtime
from lzfse_rust_tpu_torch.tools import bench as BENCH
from lzfse_rust_tpu_torch.tools import bench_match_find as BMF
from lzfse_rust_tpu_torch.tools import bench_rebuild, bench_stage_split
from lzfse_rust_tpu_torch.tools import check_corpus
from lzfse_rust_tpu_torch.tools import check_encoder_corpus, common
from lzfse_rust_tpu_torch.tools import predict_utilization as PU
from lzfse_rust_tpu_torch.utils import corpus as CP

ROOT = pathlib.Path(__file__).resolve().parents[1]
QUEUE = ROOT / "lzfse_rust_tpu_torch" / "tools" / "run_card_queue.sh"
TOOLS = sorted(m.name for m in pkgutil.iter_modules(tools_pkg.__path__)
               if m.name != "common")


def _import(name: str):
    return __import__(f"lzfse_rust_tpu_torch.tools.{name}",
                      fromlist=["main"])


def test_tool_modules_import_without_cuda_or_jax():
    code = ("import sys\n"
            + "".join(f"import lzfse_rust_tpu_torch.tools.{t}\n"
                      for t in TOOLS)
            + "from lzfse_rust_tpu_torch.runtime import cuda_lib\n"
            "assert cuda_lib._LIB is None\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'jax')\n"
            "assert not bad, bad\n"
            "print('imported')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PATH": "/nonexistent",
                            "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 0, r.stderr
    assert "imported" in r.stdout


@pytest.mark.parametrize("name", TOOLS)
def test_tool_raises_without_a_card(name, monkeypatch, capsys):
    """Each tool prints the card line first and refuses to run: no
    fallback to the CPU or to a plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(common, "card_line", lambda: "CARD LINE")
    with pytest.raises(common.NoCardError, match=f"{name} measures the CUDA"):
        _import(name).main([])
    assert capsys.readouterr().out.splitlines() == ["CARD LINE"]


def test_warp_waste_counts_the_longest_stream_per_warp():
    equal = PU.warp_waste([10] * 64)
    assert (equal["warps"], equal["useful"], equal["issued"],
            equal["wasted_share"]) == (2, 640, 640, 0.0)
    one = PU.warp_waste([7], warp=4)
    assert (one["issued"], one["wasted_share"]) == (28, 0.75)
    # longest first: 8 and 7 share a warp, 2 and 1 the next
    w = PU.warp_waste([1, 8, 2, 7], warp=2)
    assert (w["issued"], w["useful"]) == (2 * 8 + 2 * 2, 18)
    assert PU.warp_waste([])["wasted_share"] == 0.0


def test_decode_streams_per_block_is_read_from_the_source():
    """The shape model and the block sweep read the decode kernels' one
    tuning constant from ``fse_decode.cu``; the sweep rewrites that line
    and nothing else."""
    from lzfse_rust_tpu_torch.ops import cuda_decode as K
    from lzfse_rust_tpu_torch.tools import block_size_probe as BSP
    src = K.SOURCE.read_text()
    shipped = K.streams_per_block()
    assert 1 <= shipped <= 32
    per_block = PU.streams_per_block()
    assert per_block["decode literals"] == per_block["decode lmds"] == shipped
    for streams in BSP.SIZES:
        out = BSP.variant_source(src, streams)
        assert K.streams_per_block(out) == streams
        assert len(out.splitlines()) == len(src.splitlines())
        diff = [a for a, b in zip(src.splitlines(), out.splitlines())
                if a != b]
        assert len(diff) == (0 if streams == shipped else 1)
    with pytest.raises(RuntimeError, match="kStreams"):
        K.streams_per_block(src.replace("constexpr int kStreams", "int k"))


def test_encode_slots_per_block_is_read_from_the_source():
    """The shape model and the slot sweep read the encode kernels' one
    tuning constant from ``fse_encode.cu``; the sweep rewrites that line
    and nothing else."""
    from lzfse_rust_tpu_torch.ops import cuda_encode as KE
    from lzfse_rust_tpu_torch.tools import block_size_probe as BSP
    src = KE.SOURCE.read_text()
    shipped = KE.slots_per_block()
    assert 1 <= shipped <= 16
    per_block = PU.streams_per_block()
    assert per_block["encode literals"] == per_block["encode lmds"] == shipped
    for slots in BSP.SLOT_SIZES:
        out = BSP.slots_source(src, slots)
        assert KE.slots_per_block(out) == slots
        assert KE.tile_steps(out) == KE.tile_steps()
        diff = [a for a, b in zip(src.splitlines(), out.splitlines())
                if a != b]
        assert len(out.splitlines()) == len(src.splitlines())
        assert len(diff) == (0 if slots == shipped else 1)
    with pytest.raises(RuntimeError, match="kSlots"):
        KE.slots_per_block(src.replace("constexpr int kSlots", "int k"))
    with pytest.raises(RuntimeError, match="kTile"):
        KE.tile_steps(src + "\nconstexpr int kTile = 8;\n")


def test_encode_shape_model_groups_a_block_of_slots():
    """An encode CUDA block costs its longest slot: kSlots slots ordered
    longest first share a group, as the kernels take them."""
    from lzfse_rust_tpu_torch.ops import cuda_encode as KE
    per = KE.slots_per_block()
    steps = [100] + [1] * (2 * per - 1)
    w = PU.warp_waste(steps, min(PU.WARP, per))
    assert w["warps"] == 2
    assert w["issued"] == (100 + 1) * per
    assert w["useful"] == 100 + 2 * per - 1


def test_bench_encode_kernels_keeps_only_the_longest_slot():
    from lzfse_rust_tpu_torch.ops import cuda_encode as KE
    from lzfse_rust_tpu_torch.tools import bench_encode_kernels as BEK
    raws = [r for r, _ in CP.small_batch(seed=3, n_fse=3, lo=60_000,
                                         hi=120_000)]
    for kind, args in zip(("literals", "lmds"),
                          TorchEncoder("cpu").kernel_args(raws)):
        one = BEK.longest_only(args)
        first = int(args["order"][0])
        n_cols = args["lm" if kind == "lmds" else "words"].shape[1]
        steps = KE.steps_of(kind, args["num"], n_cols)
        assert int(steps[first]) == int(steps.max()) > 0
        assert int(one["num"][first]) == int(args["num"][first])
        assert int((one["num"] != 0).sum()) == 1
        assert int((args["num"] != 0).sum()) > 1   # the caller's stay


@pytest.mark.parametrize("name", ["no_stores", "no_refills"])
def test_decode_step_probe_variants_take_out_their_part(name):
    from lzfse_rust_tpu_torch.ops import cuda_decode as K
    from lzfse_rust_tpu_torch.tools import decode_step_probe as DSP
    src = K.SOURCE.read_text()
    out = DSP.variant_source(src, name)
    assert out != src and len(out) < len(src)
    if name == "no_refills":
        assert "st.ring.round(" not in out
    else:
        assert "store_round(d" not in out and "dlm[step]" not in out
    with pytest.raises(RuntimeError, match=name):
        DSP.variant_source(src.replace("st.ring.round", "st.ring.roundx")
                           .replace("store_round(d", "store_roundx(d"), name)


def test_decode_step_probe_keeps_only_the_longest_stream():
    from lzfse_rust_tpu_torch.tools import decode_step_probe as DSP
    pairs = CP.small_batch(seed=3, n_fse=3, lo=6_000, hi=12_000)
    lit, lmd = TorchDecoder("cpu").kernel_args([c for _, c in pairs])
    for name, args in (("literal", lit), ("lmd", lmd)):
        one = DSP.longest_only(args)
        assert one["num"][0] == args["num"].max() and not one["num"][1:].any()
        assert args["num"][1:].any()   # the caller's arguments stay as they were
        n = int(args["num"][0])
        assert DSP.steps_of(name, one) == ((n + 3) // 4 if name == "literal"
                                           else n)


def test_scaled_takes_a_prefix_or_replicas():
    s = np.arange(16)
    assert PU.scaled(s, 0.25).tolist() == [0, 1, 2, 3]
    assert PU.scaled(s, 2).tolist() == s.tolist() * 2
    assert len(PU.scaled(s[:3], 0.125)) == 1


def test_step_counts_follow_the_containers():
    """Decode step counts are the containers' block headers (literals by
    4, L/M/D rows); re-encoding the raw inputs stages the same blocks (the
    corpus containers are the native encoder's), plus the period-split
    alternatives."""
    pairs = CP.serving_batch(seed=5, min_bytes=1 << 20)
    counts = PU.step_counts(pairs)
    desc = native_runtime().walk_batch([c for _, c in pairs])[0]
    lit_n = desc[:, 1].astype(np.int64)
    lmd_n = desc[:, 2].astype(np.int64)
    assert sorted(counts["decode literals"]) == sorted((lit_n + 3) // 4)
    assert sorted(counts["decode lmds"]) == sorted(lmd_n)
    enc_l = counts["encode literals"].tolist()
    enc_m = counts["encode lmds"].tolist()
    assert len(enc_l) == len(enc_m) >= len(desc)
    for want, got in (((lit_n + 3) // 4, enc_l), (lmd_n, enc_m)):
        rest = list(got)
        for v in want.tolist():
            rest.remove(v)   # every decoded block has its staged slot
        assert len(rest) == len(got) - len(desc)


def test_per_step_ms_cancels_the_fixed_cost(monkeypatch):
    """(t(n) - t(n/8)) / (7n/8): a launch costing 5 ms + 2 us per step
    gives 2 us per step."""
    last = []

    def fake_cuda_ms(fn, reps, warmup):
        fn()
        return 5.0 + 0.002 * last[-1]

    monkeypatch.setattr(common, "cuda_ms", fake_cuda_ms)
    ms = common.per_step_ms(lambda n: last.append(n), 20_000)
    assert last == [2_500, 20_000]
    assert ms == pytest.approx(0.002)


def test_second_smallest():
    assert common.second_smallest([3.0, 1.0, 2.0]) == 2.0
    assert common.second_smallest([4.0]) == 4.0


@pytest.mark.parametrize("kind", CP.KINDS)
def test_kind_batch_holds_one_kind(kind):
    pairs = CP.kind_batch(kind, seed=2, min_bytes=64 << 10, lo=4 << 10,
                          hi=32 << 10)
    assert pairs == CP.kind_batch(kind, seed=2, min_bytes=64 << 10,
                                  lo=4 << 10, hi=32 << 10)
    raws = [r for r, _ in pairs]
    assert sum(map(len, raws)) >= 64 << 10
    assert all(4 << 10 <= len(r) <= 32 << 10 for r in raws)
    rng = np.random.default_rng(2)
    size = int(np.exp(rng.uniform(np.log(4 << 10), np.log(32 << 10))))
    assert raws[0] == CP.make_raw(kind, size, rng)
    native = native_runtime()
    assert all(native.decode_bytes(c) == r for r, c in pairs)


def test_check_corpus_counts_mismatches_and_fallbacks(capsys):
    small = CP.small_batch(seed=1, n_fse=2, lo=6_000, hi=12_000)
    sources = [c for _, c in small]
    assert check_corpus.check(TorchDecoder("cpu"), "small", sources) == 0
    assert "0 mismatches, 0 fallbacks" in capsys.readouterr().out

    class Wrong:
        def decode_many(self, srcs, stats):
            stats["fallbacks"] = 1
            return [b"x"] + [native_runtime().decode_bytes(s)
                             for s in srcs[1:]]

    assert check_corpus.check(Wrong(), "small", sources) == 2
    out = capsys.readouterr().out
    assert "MISMATCH small[0]" in out and "1 mismatches, 1 fallbacks" in out


def test_check_encoder_corpus_counts_mismatches(capsys):
    raws = [r for r, _ in CP.small_batch(seed=1, n_fse=2, lo=6_000,
                                         hi=12_000)]
    got = TorchEncoder("cpu").encode_many(raws)
    assert check_encoder_corpus.check("small", raws, got) == 0
    got[-1] = got[0]
    assert check_encoder_corpus.check("small", raws, got) == 1
    assert f"MISMATCH small[{len(raws) - 1}]" in capsys.readouterr().out


def test_bench_rebuild_captures_the_one_rebuild_call():
    small = CP.small_batch(seed=4, n_fse=2, lo=6_000, hi=12_000)
    native = native_runtime()
    real = native.flatten_rebuild
    outs, stats, (args, kwargs) = bench_rebuild.capture(
        TorchDecoder("cpu"), [c for _, c in small])
    assert native.flatten_rebuild is real
    assert [hashlib.sha256(o).digest() for o in outs] == [
        hashlib.sha256(r).digest() for r, _ in small]
    assert stats.get("fallbacks", 0) == 0 and "rebuild" in stats
    assert (real(*args, **kwargs) >= 0).all()   # the call replays


def test_stage_split_summary_rates():
    s = bench_stage_split.summary(
        {"upload": 2.0, "literals": 6.0, "lmds": 2.0}, n_lit=12_000,
        n_lmd=1_000, raw=40_000_000, upload_bytes=8_000_000)
    assert (s["literal_Msym_s"], s["lmd_Msym_s"]) == (2.0, 0.5)
    assert (s["entropy_GBps"], s["total_GBps"], s["upload_GBps"]) == (
        5.0, 4.0, 4.0)


def _match_detail(N, windows, scale):
    return {"N": N, "windows": windows, "slots": N * windows, "sat": 3,
            "matched": 40, "upload_bytes": 6 * N * windows,
            "download_bytes": 9 * N * windows, "win_prep_s": 0.004 * scale,
            "matchfind_s": 0.002 * scale, "arbitrate_s": 0.001 * scale,
            "upload_ms": 0.5 * scale, "kernel_ms": 0.25 * scale,
            "download_ms": 0.75 * scale}


def test_bench_match_find_summary_takes_the_second_smallest():
    runs = [[_match_detail(4096, 2, s), _match_detail(1 << 20, 5, s)]
            for s in (3.0, 1.0, 2.0)]
    rows = BMF.summarize(runs)
    assert [(r["N"], r["windows"], r["slots"]) for r in rows] == [
        (4096, 2, 8192), (1 << 20, 5, 5 << 20)]
    r = rows[1]
    assert (r["group_ms"], r["upload_ms"], r["kernel_ms"], r["download_ms"],
            r["matchfind_ms"], r["arbitrate_ms"]) == pytest.approx(
        (8.0, 1.0, 0.5, 1.5, 4.0, 2.0))
    assert r["stage_ms"] == pytest.approx(14.0)
    assert r["kernel_MBps"] == pytest.approx((5 << 20) / 0.5 / 1e3)
    assert r["stage_MBps"] == pytest.approx((5 << 20) / 14.0 / 1e3)
    assert "N 1048576: 5 windows" in BMF.report(r)


def test_card_queue_keeps_its_markers_in_its_checkout(tmp_path):
    """Without ``CARDQ_DIR`` the logs and ``.ok`` markers live under the
    checkout's ``build/cardq``: a job done in one tree is not skipped in
    another."""
    trees = [tmp_path / "a", tmp_path / "b"]
    for tree in trees:
        (tree / "lzfse_rust_tpu_torch" / "tools").mkdir(parents=True)
        shutil.copy(QUEUE, tree / "lzfse_rust_tpu_torch" / "tools")
    (trees[0] / "build" / "cardq").mkdir(parents=True)
    (trees[0] / "build" / "cardq" / "util.ok").touch()
    env = {k: v for k, v in os.environ.items() if k != "CARDQ_DIR"}
    runs = [subprocess.run(["bash", str(t / QUEUE.relative_to(ROOT)), "util"],
                           capture_output=True, text=True, timeout=120,
                           env={**env, "CUDA_VISIBLE_DEVICES": ""})
            for t in trees]
    assert runs[0].returncode == 0 and "SKIP util (done)" in runs[0].stdout
    assert runs[1].returncode != 0 and "RUN  util" in runs[1].stdout
    assert (trees[1] / "build" / "cardq" / "util.log").exists()
    assert not (trees[1] / "build" / "cardq" / "util.ok").exists()


def test_card_queue_lists_every_tool_and_resumes(tmp_path):
    text = QUEUE.read_text()
    assert subprocess.run(["bash", "-n", str(QUEUE)]).returncode == 0
    for name in TOOLS:
        if name != "block_size_probe":
            assert f" {name}" in text, name
    jobs = [line.split("&&")[0].split()[1] for line in text.splitlines()
            if line.startswith("want ")]
    assert jobs[0] == "bench" and "run bench 900 bench " in text
    for job in jobs:
        (tmp_path / f"{job}.ok").touch()
    r = subprocess.run(["bash", str(QUEUE)], capture_output=True, text=True,
                       timeout=60, env={**os.environ, "CARDQ_DIR": str(tmp_path)})
    assert r.returncode == 0, r.stdout + r.stderr
    assert [line.split()[1] for line in r.stdout.splitlines()
            if line.startswith("SKIP")] == jobs


def test_dryrun_multichip_on_four_cpu_shards():
    from lzfse_rust_tpu_torch.parallel.dryrun import dryrun_multichip
    got = dryrun_multichip(4, device="cpu")
    assert got["devices"] == ["cpu"] * 4 and got["blocks"] == 8


def test_demo_multihost_two_processes_over_gloo():
    """Two processes join a gloo group, decode their shards and all-gather
    them; process 0 checks every block against the spec layer."""
    r = subprocess.run([sys.executable, "-m",
                        "lzfse_rust_tpu_torch.tools.demo_multihost",
                        "--device", "cpu", "--hosts", "2"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 0, r.stderr[-3000:]
    rows = [json.loads(x) for x in r.stdout.splitlines() if x.startswith("{")]
    assert sorted(x["host"] for x in rows) == [0, 1]
    assert all(x["ok"] and x["backend"] == "gloo" and x["devices"] == 4
               for x in rows)


def test_demo_multihost_refuses_more_processes_than_cards(monkeypatch):
    """NCCL takes one card a process: with one card, two processes raise
    before any starts, and nothing switches to gloo."""
    from lzfse_rust_tpu_torch.tools import demo_multihost
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(demo_multihost.subprocess, "Popen", None)
    with pytest.raises(RuntimeError, match="Duplicate GPU detected"):
        demo_multihost.run(2, "cuda")


@pytest.mark.parametrize("argv", [["--device", "cuda", "--hosts", "2"], []])
def test_mesh_tools_raise_without_a_card(argv, monkeypatch, capsys):
    from lzfse_rust_tpu_torch.tools import bench_scaling, demo_multihost
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(common, "card_line", lambda: "CARD LINE")
    for tool in (demo_multihost, bench_scaling):
        with pytest.raises(common.NoCardError):
            tool.main(argv if tool is demo_multihost else [])
    assert capsys.readouterr().out.splitlines() == ["CARD LINE"] * 2


def test_rowgather_counts_each_row_read_and_written_once():
    from lzfse_rust_tpu_torch.tools import microbench_rowgather as RG
    assert RG.gather_bytes(64, torch.uint8, 10) == 10 * 8 + 2 * 10 * 64
    assert RG.gather_bytes(16, torch.int32) == RG.N * (8 + 2 * 64)
    assert [w for _, w, _ in RG.LAYOUTS] == [64, 16, 32, 128]


def test_bench_corpus_ring_helpers_round_trip():
    from lzfse_rust_tpu_torch import api
    from lzfse_rust_tpu_torch.tools import bench_corpus as BC
    raw = CP.make_raw("urls", 200_000, np.random.default_rng(8))
    blob = BC._ring_encode(api, raw)
    assert BC._ring_decode(api, blob) == raw
    assert api.decode_bytes(blob) == raw


@pytest.fixture
def bench_on_cpu(monkeypatch):
    """``tools/bench`` with its engines on the CPU (their plain versions)
    and a small seeded batch in place of the serving batch; the API's card
    route runs ``TorchDecoder("cpu")``, as ``tests/test_torch_api.py``
    stands it in. Returns the batch sizes asked for, the batch and the
    engines."""
    small = CP.small_batch(seed=1, n_fse=2, lo=6_000, hi=12_000)
    asked = []

    def batch(seed, min_bytes):
        asked.append((seed, min_bytes))
        return small

    monkeypatch.setattr(CP, "serving_batch", batch)
    monkeypatch.setattr(BENCH, "require_card",
                        lambda tool: print("CARD LINE") or "stand-in")
    monkeypatch.setattr(BENCH, "card_line", lambda: "CARD LINE")
    engines = (TorchDecoder("cpu"), TorchEncoder("cpu"))
    monkeypatch.setattr(BENCH, "engines", lambda: engines)
    card = (TorchDecoder("cpu"), threading.Lock())
    monkeypatch.setattr(port_api, "_card", lambda kind, device: card)
    return asked, small, engines


def test_bench_prints_the_card_line_then_one_json_line(bench_on_cpu,
                                                       capsys):
    asked, small, _ = bench_on_cpu
    assert BENCH.main(["--min-mib", "3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0] == "CARD LINE"
    res = json.loads(out[1])
    assert asked == [(0, 3 << 20)]
    assert set(res) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert (res["metric"], res["unit"]) == ("full_decode_GBps_card", "GB/s")
    ex = res["extra"]
    raw = sum(len(r) for r, _ in small)
    assert len(ex["runs_ms"]) == BENCH.RUNS == 7
    assert ex["min_ms"] <= ex["median_ms"] <= ex["max_ms"]
    assert res["value"] == round(raw / ex["median_ms"] / 1e6, 4)
    assert len(ex["api_card_route"]["runs_ms"]) == 7
    assert ex["batch"]["raw_bytes"] == raw and "not the Snappy" in ex[
        "batch"]["source"]
    assert "one host thread" in ex["baseline"]["what"]
    assert len(ex["baseline"]["runs_ms"]) == BENCH.BASELINE_RUNS
    assert res["vs_baseline"] == round(res["value"] / ex["baseline"]["GBps"],
                                       3)
    assert ex["host_threads"]["threads"] >= 1
    assert set(ex["stages_ms"]) == set(BENCH.STAGES)
    enc = ex["encode"]
    assert enc["full_encode_GBps_card"] > 0 and enc["byte_identical"]
    assert enc["n_sources"] == sum(c != CP.EMPTY for _, c in small)


@pytest.mark.parametrize("fault", ["corrupt", "fallback"])
def test_bench_gate_fails_before_any_number(fault, bench_on_cpu, capsys,
                                            monkeypatch):
    _, _, (dec, _) = bench_on_cpu
    real = dec.decode_many

    def wrong(sources, stats=None):
        outs = real(sources, stats)
        if fault == "corrupt":
            outs[0] = bytes([outs[0][0] ^ 1]) + outs[0][1:]
        else:
            stats["fallbacks"] = 1
        return outs

    monkeypatch.setattr(dec, "decode_many", wrong)
    with pytest.raises(BENCH.GateError,
                       match="SHA-256" if fault == "corrupt" else "fallback"):
        BENCH.main([])
    assert capsys.readouterr().out.splitlines() == ["CARD LINE"]


@pytest.mark.parametrize("fault", ["raises", "differs"])
def test_bench_encode_failure_fails_the_tool(fault, bench_on_cpu, capsys,
                                             monkeypatch):
    """No ``encode_error`` key and no host fallback: an encode that fails
    or gives another container makes the tool fail."""
    _, _, (_, enc) = bench_on_cpu

    def bad(sources, stats=None):
        if fault == "raises":
            raise RuntimeError("emission failed")
        return [b"bvx$"] * len(sources)

    monkeypatch.setattr(enc, "encode_many", bad)
    with pytest.raises(RuntimeError, match="emission failed" if fault ==
                       "raises" else "differ from the native encoder"):
        BENCH.main([])
    assert capsys.readouterr().out.splitlines() == ["CARD LINE"]
