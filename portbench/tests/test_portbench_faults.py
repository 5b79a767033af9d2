"""The comparison catches what it exists to catch.  A whole run of each cell,
its look for a card skipped (the CPU), with the timed path broken underneath:
in the train step (its state returned unchanged; half of its minibatch left
out) and in the loop (a call that returns the state it was given; steps that
each start from the call's given state), each reads ``correct`` false.  The
control (the program one precision below the configuration's) reads false
too: on the CPU the fused update's bfloat16 products through K1's plain
version; on the card, ``test_controls_fail_on_the_card``, both
configurations' controls at the cells' own sizes."""

import pytest
import torch

from portbench import calibrate, check, faults, harness
from portbench.tests import helpers


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", helpers.cells())
def test_a_broken_step_reads_incorrect(workload, fault):
    cell = helpers.small(harness.load_cell(harness.ROOT, workload))
    with faults.planted(cell.config, fault):
        result = harness.measure(cell, 31, 0.2, False, device="cpu")
    assert not result["correct"], result["check"]


def test_the_faults_leave_the_trainers_and_the_loop_as_they_were():
    kind = harness.loader(harness.ROOT)("kinds", "offline_q")
    for adapter in faults.TRAINERS:
        module, name = faults.TRAINERS[adapter]
        cls = getattr(__import__(module, fromlist=[name]), name)
        before, loop = cls.train_step, kind.loop
        for fault in faults.FAULTS:
            with faults.planted({"adapter": adapter, "kind": "offline_q"}, fault):
                assert cls.train_step is not before or kind.loop is not loop
            assert cls.train_step is before and kind.loop is loop


@pytest.mark.parametrize("workload", [w for w in helpers.cells() if w.startswith("dqn_full.")])
def test_the_bfloat16_control_reads_incorrect_on_the_cpu(workload):
    cell = helpers.small(harness.load_cell(harness.ROOT, workload))
    assert cell.config["control"] == "bfloat16"
    result = harness.measure(cell, 32, 0.2, False, device="cpu",
                             precision=cell.config["control"])
    assert not result["correct"], result["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", helpers.cells())
def test_controls_fail_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    cell = harness.load_cell(harness.ROOT, workload)
    cfg, numbers = cell.config, harness.kind_of(cell).NUMBERS
    for seed in (701, 702, 703):
        sound = calibrate.reading(harness, cell, seed, "cuda", cfg["precision"])
        control = calibrate.reading(harness, cell, seed, "cuda", cfg["control"])
        assert check.judge(sound, cfg["limits"], numbers)[0], sound
        assert not check.judge(control, cfg["limits"], numbers)[0], control
