"""The control and the planted faults come out not correct; a sound run
comes out correct.

On the CPU the program's native codec on the host stands in for the
card's engines (``control.host_engine``), and the rest of a run is the
harness's own: set-up, window, checks and the reference. The card test
runs the control at a cell's own size.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import control, harness  # noqa: E402
from benchmark.tests.test_bench_harness import tiny_tree  # noqa: E402

SEED = 2**31 + 101


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("tiny"))


def _run(root, op, wrap, seed=SEED):
    res, _ = harness.run_cell(f"tiny.{op}", seed, 0.4, False, "cpu",
                              root=root, bench=root / "benchmark", wrap=wrap)
    return res


def _faulty(mode, seed=SEED):
    fault = control.wrap_with(mode, seed)
    return lambda op: fault(control.host_engine(op))


@pytest.mark.parametrize("op", ["decode", "encode"])
def test_sound_run_is_correct(root, op):
    res = _run(root, op, control.host_engine)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("op", ["decode", "encode"])
@pytest.mark.parametrize("mode", control.MODES)
def test_control_and_faults_are_not_correct(root, op, mode):
    res = _run(root, op, _faulty(mode))
    assert not res["correct"], (mode, res["checks"])


def test_control_breaks_what_each_op_guarantees(root):
    dec = _run(root, "decode", _faulty("control"))["checks"]
    assert dec["bad_outputs"]["value"] > 0
    enc = _run(root, "encode", _faulty("control"))["checks"]
    # RAW containers are lossless: only the reference encoder's bytes fail
    assert enc["bad_blocks"]["value"] == 0
    assert enc["bad_structure"]["value"] == 0
    assert enc["bad_prefix_blocks"]["value"] > 0


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


@pytest.mark.cuda
def test_control_on_the_card_at_the_cells_size(card):
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "control.py"),
         "--workload", "snappy.decode", "--seeds", "3", "4", "5"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
