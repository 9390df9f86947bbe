"""The check at a tiny size: a sound run is correct; the controls (the
reference in bfloat16, and in float32 with TF32 products on the card, in
the program's place) and each planted fault the cell can have come out not
correct.  The cell runs on
one device, so it has no exchange between cards to leave out."""

import pytest
import torch

from bench_tiny import make_root, run_tiny

from benchmark import harness
from benchmark.faults import FAULTS, planted


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


def test_sound_run_is_correct(root):
    assert run_tiny(root)["correct"]


def _controls_fail(root, device, kinds):
    from benchmark.control import readings

    lines = readings(root, "tiny", [21], {21}, 2, device, log=lambda s: None)
    limits = harness.Cell(root, "tiny").cell["check"]["limits"]
    ctrls = [x for x in lines if x["kind"] in kinds]
    assert len(ctrls) == len(kinds)
    for ctrl in ctrls:
        over = [k for k, lim in limits.items()
                if not ctrl["numbers"][k] <= lim]
        assert over, ctrl


def test_control_is_not_correct(root):
    """The bfloat16 control; the CPU has no TF32 (the next test)."""
    _controls_fail(root, "cpu", {"control:bfloat16"})


@pytest.mark.cuda
def test_controls_on_the_card_are_not_correct(root):
    if not torch.cuda.is_available():
        pytest.skip("TF32 products exist only on a CUDA device")
    _controls_fail(root, "cuda",
                   {"control:" + c for c in harness.CONTROLS})


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_is_not_correct(root, fault):
    with planted(fault):
        assert not run_tiny(root)["correct"]
