"""The ``memcached_etc`` configuration, its cell ``etc.decode`` and the two
readers of ``stats["detail_parts"]``, on the CPU.

    python -m pytest benchmark/tests/test_etc_config.py -q

The sizes are the Generalized Pareto fit's mid-quantiles (Atikoglu et al.,
SIGMETRICS 2012: location 0, scale 214.476, shape 0.348238), recomputed
here from the rule the file states.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
sys.path.insert(0, str(ROOT))

from benchmark import corpus, harness, registry  # noqa: E402

SIGMA, XI = 214.476, 0.348238
KINDS = ("text", "html", "urls", "binary")
NEW = ("decode.host_only_share", "decode.host_us_per_container")


def quantile_sizes(n: int) -> list[int]:
    """The fit's ``n`` mid-quantiles, rounded, at least 1 byte."""
    return [max(1, round(SIGMA / XI * ((1 - (i + 0.5) / n) ** -XI - 1)))
            for i in range(n)]


@pytest.fixture(scope="module")
def config():
    return json.loads((BENCH / "configs" / "memcached_etc.json").read_text())


def test_sizes_and_kinds_follow_the_quantile_rule(config):
    assert config["files"] == [[f"etc_v{i}", KINDS[i % 4], s]
                               for i, s in enumerate(quantile_sizes(4096))]
    sizes = [s for _, _, s in config["files"]]
    assert (min(sizes), max(sizes)) == (1, 13584)
    assert max(sizes) == config["value_size_tail"]
    # the encoder's rule by size: RAW up to 20 B, LZVN up to 4 KiB, else FSE
    assert sum(s <= 20 for s in sizes) == 368
    assert sum(s > 4096 for s in sizes) == 12


def test_layout_is_16384_files_of_raw_bytes(config):
    files = corpus.layout(config)
    assert len(files) == 16384 == 4 * len(config["files"])
    assert sum(s for _, _, s in files) == config["raw_bytes"] == 5379244
    assert {k for _, k, _ in files} == set(KINDS)


def test_the_cell_resolves_with_its_metrics(config):
    cell = registry.cell("etc.decode")
    assert cell.chips == 1 and cell.traffic["op"] == "decode"
    assert cell.config == config
    assert {m.name for m in cell.end_to_end} == {"decode_GBps", "setup_s"}
    layer = {m.name for m in cell.per_layer}
    assert set(NEW) <= layer
    snappy = {m.name for m in registry.cell("snappy.decode").per_layer}
    assert "decode.host_us_per_container" in snappy
    assert "decode.host_only_share" not in snappy
    spec = registry.load_benchmark()
    entry = next(c for c in spec["configs"] if c["name"] == "memcached_etc")
    assert entry["file"] == "benchmark/configs/memcached_etc.json"
    assert entry["reduced"] == ["value_size_tail"]


def _run(calls_stats):
    cell = registry.cell("etc.decode")
    calls = [harness.Call(0, i, 0.1 * i, 0.1 * i + 0.05, 10, st)
             for i, st in enumerate(calls_stats)]
    return harness.Run(cell, None, 1.0, harness.Window(0.0, 10.0,
                                                       calls=calls))


def _readers():
    cell = registry.cell("etc.decode")
    return {m.name: registry.reader(m) for m in cell.per_layer
            if m.name in NEW}


STAGES = {"parse": 0.001, "prep": 0.002, "device": 0.5, "flatten": 0.003,
          "rebuild": 0.004}


def _parts(containers, host_only_bytes, raw_bytes):
    return {"containers": containers, "host_only": containers - 1,
            "host_only_bytes": host_only_bytes, "raw_bytes": raw_bytes,
            "fse_blocks": 1, "vn_blocks": containers - 1, "raw_blocks": 0}


def test_readers_by_hand():
    read = _readers()
    run = _run([{**STAGES, "detail_parts": _parts(100, 90, 100)},
                {**STAGES, "detail_parts": _parts(200, 40, 50)}])
    # (90/100 + 40/50) / 2
    assert read["decode.host_only_share"](run) == pytest.approx(85.0)
    # 10 ms of host stages (the device stage left out) over 100 and 200
    assert read["decode.host_us_per_container"](run) == pytest.approx(
        (100.0 + 50.0) / 2)


@pytest.mark.parametrize("name", NEW)
def test_readers_give_none_without_detail_parts(name):
    read = _readers()[name]
    assert read(_run([dict(STAGES)] * 3)) is None
    # one call of a program without the counters is enough
    assert read(_run([{**STAGES, "detail_parts": _parts(4, 3, 8)},
                      dict(STAGES)])) is None
    assert read(_run([])) is None


def test_readers_on_a_run_of_the_program_on_the_cpu(tmp_path):
    """A run of a cut ETC cell (the rule at 256 quantiles, one replica, one
    client) by the program's plain versions: both readers find their
    counters, and nearly all of the output is the host's."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = json.loads((BENCH / "traffic" / "decode.json").read_text())
    (tmp_path / "benchmark" / "traffic" / "decode1.json").write_text(
        json.dumps({**mix, "clients": 1}))
    sizes = quantile_sizes(256)
    small = {"name": "etc_small", "replicas": 1,
             "files": [[f"etc_v{i}", KINDS[i % 4], s]
                       for i, s in enumerate(sizes)]}
    (tmp_path / "benchmark" / "configs" / "etc_small.json").write_text(
        json.dumps(small))
    spec = registry.load_benchmark()
    spec["configs"].append({"name": "etc_small", "source": "test",
                            "file": "benchmark/configs/etc_small.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "etc_small.decode",
                              "config": "etc_small", "traffic": "decode1",
                              "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "etc.decode" in m.get("workloads", ()):
            m["workloads"].append("etc_small.decode")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    res, _ = harness.run_cell("etc_small.decode", 2**33 + 5, 3.0, True,
                              "cpu", root=tmp_path,
                              bench=tmp_path / "benchmark")
    assert res["correct"] is True
    m = res["metrics"]
    fse = sum(s for s in sizes if s > 4096)
    assert 0 < fse and m["decode.host_only_share"]["value"] == \
        pytest.approx(100 * (1 - fse / sum(sizes)))
    assert m["decode.host_us_per_container"]["value"] > 0
