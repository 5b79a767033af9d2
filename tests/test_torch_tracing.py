"""The port's own spans (``utils/profiling.py`` ``annotate``): each opened
where the work happens, once a step and nested as the loop nests, only while
a profiler runs, never through ``record_function``, and without moving a
single bit of a call's results."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import RLParameters
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.net_builder import quantile_dqn as qr_builders
from reagent_tpu_torch.training import QRDQNTrainer, make_sampled_train_fn
from reagent_tpu_torch.training.fused_dqn_trainer import FusedDQNTrainer
from reagent_tpu_torch.utils import profiling

S, A, N, ROWS, STEPS = 6, 3, 7, 128, 3
LOOP_SPANS = ("reagent.loop.step", "reagent.loop.sample", "reagent.loop.gather")
OPTIM_SPANS = ("reagent.optim.update", "reagent.optim.soft_update")


def _dataset(seed=5, rows=ROWS):
    g = torch.Generator().manual_seed(seed)
    mask = (torch.rand((rows, A), generator=g) > 0.3).float()
    mask[:, 0] = 1.0
    eye = torch.eye(A)
    return rlt.DiscreteDqnInput(
        state=rlt.FeatureData(float_features=torch.randn((rows, S), generator=g)),
        next_state=rlt.FeatureData(float_features=torch.randn((rows, S), generator=g)),
        action=eye[torch.randint(0, A, (rows,), generator=g)],
        reward=torch.randn((rows, 1), generator=g),
        time_diff=None, step=None,
        not_terminal=(torch.rand((rows, 1), generator=g) > 0.1).float(),
        possible_actions_mask=torch.ones((rows, A)),
        possible_next_actions_mask=mask,
    )


def _qrdqn_call():
    """``(entry, initial state)``: a sampled loop of ``STEPS`` steps on a
    small ``QRDQNTrainer`` with amsgrad Adam."""
    torch.manual_seed(0)
    net = qr_builders.QuantileFullyConnected(
        sizes=[16, 8], activations=["leaky_relu", "relu"], num_atoms=N,
    ).build_q_network(None, A, state_dim=S)
    tr = QRDQNTrainer(net, N, rl=RLParameters(gamma=0.9, target_update_rate=0.1),
                      optimizer={"Adam": {"lr": 0.003, "amsgrad": True}}, device="cpu")
    run = make_sampled_train_fn(tr, _dataset(), minibatch_size=32, num_steps=STEPS)
    return run, tr.state_from_q_network()


def _fused_call():
    """``(entry, initial state)``: K1's CPU route through the packed loop."""
    torch.manual_seed(0)
    net = FullyConnectedDQN(state_dim=S, action_dim=A, sizes=[16], activations=["leaky_relu"])
    tr = FusedDQNTrainer(q_network=net, rl=RLParameters(gamma=0.9, target_update_rate=0.1),
                         optimizer={"Adam": {"lr": 0.01}}, minibatch_size=64, block_size=32,
                         device="cpu")
    return tr.make_packed_sampled_train_fn(_dataset(), num_steps=STEPS), tr.state_from_q_network()


CALLS = {"qrdqn": _qrdqn_call, "fused_dqn": _fused_call}


def _raise(*args, **kwargs):
    raise AssertionError("span opened")


def _traced(kind, monkeypatch):
    """One call under a CPU profiler, with ``record_function`` made to raise;
    returns its host events as ``[(name, start_ns, end_ns, thread)]`` of the
    program's spans."""
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    run, state = CALLS[kind]()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(state, torch.Generator().manual_seed(3))
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events() if e.name().startswith("reagent.")]


def _named(events, name):
    return sorted((a, b) for n, a, b, _ in events if n == name)


def test_the_loop_opens_a_step_a_draw_and_a_gather_each_step_nested(monkeypatch):
    events = _traced("qrdqn", monkeypatch)
    steps = _named(events, "reagent.loop.step")
    assert len(steps) == STEPS
    for name in LOOP_SPANS[1:]:
        inner = _named(events, name)
        assert len(inner) == STEPS, name
        # the k-th draw and gather lie inside the k-th step
        for (a, b), (c, d) in zip(steps, inner):
            assert a <= c <= d <= b, name
    for (_, b), (c, _) in zip(steps, steps[1:]):
        assert b <= c  # steps do not overlap
    draw, gather = _named(events, "reagent.loop.sample"), _named(events, "reagent.loop.gather")
    assert all(d <= c for (_, d), (c, _) in zip(draw, gather))  # the draw comes first


def test_the_optimizer_opens_its_update_and_polyak_spans_once_a_step(monkeypatch):
    events = _traced("qrdqn", monkeypatch)
    steps = _named(events, "reagent.loop.step")
    for name in OPTIM_SPANS:
        spans = _named(events, name)
        assert len(spans) == STEPS, name
        for (a, b), (c, d) in zip(steps, spans):
            assert a <= c <= d <= b, name
    # the whole set of the program's spans in a QR-DQN call on the CPU: no
    # K5 span off the card, no fused staging
    assert {n for n, *_ in events} == set(LOOP_SPANS) | set(OPTIM_SPANS)


def test_the_fused_trainer_stages_its_batch_in_a_span_once_a_step(monkeypatch):
    events = _traced("fused_dqn", monkeypatch)
    steps = _named(events, "reagent.loop.step")
    stage = _named(events, "reagent.fused_dqn.stage")
    assert len(steps) == len(stage) == STEPS
    gathers = _named(events, "reagent.loop.gather")
    for (a, b), (c, d), (_, g) in zip(steps, stage, gathers):
        assert a <= g <= c <= d <= b  # after the gather, inside the step
    # K1's span marks its CUDA route only; the plain version opens none
    assert {n for n, *_ in events} == set(LOOP_SPANS) | {"reagent.fused_dqn.stage"}


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_with_no_profiler_annotate_opens_no_span(kind, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(profiling, "_span", _raise)
    run, state = CALLS[kind]()
    state, metrics = run(state, torch.Generator().manual_seed(3))
    assert torch.isfinite(metrics["td_loss"]).all() and int(state.step) == STEPS
    # the same patch is reached once a profiler runs
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="span opened"):
            with profiling.annotate("reagent.loop.step"):
                pass


def test_with_no_profiler_annotate_returns_one_shared_no_op():
    a, b = profiling.annotate("reagent.loop.step"), profiling.annotate("reagent.k1")
    assert a is b
    with a as inside:
        assert inside is None
    with pytest.raises(ValueError):  # an exception passes through the span
        with a:
            raise ValueError("inside")


def _leaves(state):
    out = []
    for v in vars(state).values():
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, dict):
            out += [v[k] for k in sorted(v)]
        elif isinstance(v, (tuple, list)):
            out += [x for x in v if isinstance(x, torch.Tensor)]
        elif hasattr(v, "__dict__"):
            out += _leaves(v)
    return out


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_a_call_is_bit_identical_with_and_without_a_profiler(kind):
    run, state = CALLS[kind]()
    plain_state, plain = run(state, torch.Generator().manual_seed(3))
    run, state = CALLS[kind]()
    with profile(activities=[ProfilerActivity.CPU]):
        traced_state, traced = run(state, torch.Generator().manual_seed(3))
    assert plain.keys() == traced.keys()
    for k in plain:
        assert torch.equal(plain[k], traced[k]), k
    ours, theirs = _leaves(plain_state), _leaves(traced_state)
    assert len(ours) == len(theirs) > 4
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b)
