"""At a small size on the CPU, the plain references agree with the port's own
CPU path (K1's and K5's plain versions) step for step, and a run of each cell
on the CPU comes out correct."""

import pytest
import torch

from portbench import harness, inputs
from portbench.reference import common
from portbench.tests import helpers


@pytest.mark.parametrize("workload", helpers.cells())
def test_reference_follows_the_ports_call_step_for_step(workload):
    """The window's entry's first call against the reference's steps: each
    step's loss, and the weights and first moment after the call."""
    cell = helpers.small(harness.load_cell(harness.ROOT, workload))
    cfg, traffic = cell.config, cell.traffic
    run = harness.build(cell, 11, "cpu", cfg["precision"])
    run.checked()
    record = run.record
    reference = harness.load_module(harness.HERE / "reference" / f"{cfg['reference']}.py")
    followed = reference.follow(cfg, inputs.make_table(cfg, traffic, 11, "cpu"),
                                inputs.make_weights(cfg, 11, "cpu"),
                                inputs.sub_seed(11, "sampler"), traffic["minibatch"],
                                traffic["steps_per_call"], "cpu")
    assert len(record["losses"]) == traffic["steps_per_call"]
    torch.testing.assert_close(torch.tensor(record["losses"]), torch.tensor(followed["losses"]),
                               rtol=1e-5, atol=0)
    for k, v in followed["online"].items():
        torch.testing.assert_close(record["online"][k], v, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(record["target"][k], followed["target"][k],
                                   rtol=1e-4, atol=1e-5)
        moment = followed["moment"][k]
        torch.testing.assert_close(record["moment"][k], moment, rtol=1e-4,
                                   atol=1e-4 * float(moment.abs().max()))


def test_the_window_goes_on_from_the_checked_call():
    """One entry object: the checked call, the warm call and the window's
    calls are calls of it, on one generator."""
    cell = helpers.small(harness.load_cell(harness.ROOT, helpers.cells()[0]))
    run = harness.build(cell, 12, "cpu", cell.config["precision"])
    entry, calls = run.entry, []
    run.entry = lambda state, generator: calls.append((state, generator)) or entry(state, generator)
    run.checked()
    run.finish(run.call())
    assert len(calls) == 2 and calls[0][1] is calls[1][1]
    assert calls[1][0] is not calls[0][0] or calls[1][0] is run.program.state


@pytest.mark.parametrize("workload", helpers.cells())
def test_a_run_on_the_cpu_is_correct(workload):
    cell = helpers.small(harness.load_cell(harness.ROOT, workload))
    result = harness.measure(cell, 2**31 + 4242, 0.3, False, device="cpu")
    assert result["correct"], result["check"]
    assert list(result)[-1] == "check"
    assert result["failed"] == 0 and result["attempted"] % cell.traffic["steps_per_call"] == 0


def test_inputs_repeat_from_the_seed_and_differ_between_seeds():
    cell = helpers.small(harness.load_cell(harness.ROOT, helpers.cells()[0]))
    a = inputs.make_table(cell.config, cell.traffic, 2**33 + 1, "cpu")
    b = inputs.make_table(cell.config, cell.traffic, 2**33 + 1, "cpu")
    c = inputs.make_table(cell.config, cell.traffic, 2**33 + 2, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["state"], c["state"])
    # the logged action and at least one next action are possible
    assert bool(((a["possible_actions_mask"] * a["action"]).sum(1) == 1).all())
    assert bool((a["possible_next_actions_mask"].sum(1) >= 1).all())
    share = 1 - float(a["not_terminal"].mean())
    assert abs(share - cell.traffic["terminal_share"]) < 0.03


def test_the_reference_adam_is_optax_amsgrad():
    # two steps by hand: m, v, and the running maximum of the bias-corrected v
    p = {"w": torch.tensor([1.0, -2.0])}
    adam = common.Adam({"lr": 0.1, "amsgrad": True}, p)
    g1, g2 = torch.tensor([0.5, -1.0]), torch.tensor([-0.1, 0.2])
    p1 = adam.step(p, {"w": g1})
    torch.testing.assert_close(p1["w"], p["w"] - 0.1 * g1 / (g1.abs() + 1e-8))
    p2 = adam.step(p1, {"w": g2})
    m = 0.9 * 0.1 * g1 + 0.1 * g2
    v = 0.999 * 0.001 * g1 ** 2 + 0.001 * g2 ** 2
    v_hat = torch.maximum(g1 ** 2, v / (1 - 0.999 ** 2))
    torch.testing.assert_close(p2["w"], p1["w"] - 0.1 * (m / (1 - 0.9 ** 2)) / (v_hat.sqrt() + 1e-8))
