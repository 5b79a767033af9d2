"""The observer bus and the reporters against the JAX package.

``DiscreteDQNReporter`` is fed by 5 steps of each package's ``DQNTrainer``
(CPE heads on, ``emit_reporter_arrays``) from JAX's init carried into the
port; the flushed means, the action distributions and every value written
to the summary writer must agree within 1e-5 (rtol and atol: float32
forwards and updates on two libraries, summed in another order).  Then the
port's counterparts of ``tests/test_reporter_histograms.py`` and
``tests/test_misc_components.py::test_reporter_aggregation``, the one host
copy of a step's metrics, and ``DQNTrainer``'s ``metrics_to_score``.
"""

from collections import defaultdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reagent_tpu.core import types as jrlt
from reagent_tpu.core.tracker import summary_writer_context as jax_summary_writer_context
from reagent_tpu.reporting.reporters import DiscreteDQNReporter as JaxDiscreteDQNReporter
from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.aggregators import (
    ActionCountAggregator,
    RecentValuesAggregator,
    TensorBoardHistogramAndMeanAggregator,
)
from reagent_tpu_torch.core.observers import (
    CompositeObserver,
    EpochEndObserver,
    IntervalAggregatingObserver,
)
from reagent_tpu_torch.core.parameters import RLParameters
from reagent_tpu_torch.core.tracker import (
    LastValueAggregator,
    MeanAggregator,
    ObservableMixin,
    ValueListObserver,
    summary_writer_context,
    values_to_host,
)
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.reporting import CompoundReporter
from reagent_tpu_torch.reporting.reporters import DiscreteDQNReporter, SlateQReporter
from reagent_tpu_torch.training.dqn_trainer import DQNTrainer
from test_torch_cpe import ACTIONS, _batch, _batches, _trainers

TOL = dict(rtol=1e-5, atol=1e-5)


class RecordingWriter:
    """A summary writer that keeps what it is given: ``(step, value)`` per tag."""

    def __init__(self):
        self.scalars = defaultdict(list)
        self.histograms = defaultdict(list)

    def add_scalar(self, tag, value, global_step=None):
        self.scalars[tag].append((global_step, float(value)))

    def add_histogram(self, tag, values, global_step=None):
        self.histograms[tag].append((global_step, np.array(values, np.float64)))


def _reported_run(steps=5):
    """Both packages' trainers and reporters over the same batches; returns
    (port reporter, flush, writer), (JAX reporter, flush, writer)."""
    jtrainer, jstate, trainer, state = _trainers(
        dict(gamma=0.9, target_update_rate=0.1))
    jtrainer.emit_reporter_arrays = trainer.emit_reporter_arrays = True
    ours, theirs = DiscreteDQNReporter(list(ACTIONS)), JaxDiscreteDQNReporter(list(ACTIONS))
    w_ours, w_theirs = RecordingWriter(), RecordingWriter()
    with summary_writer_context(w_ours), jax_summary_writer_context(w_theirs):
        for b in _batches(3, steps):
            jstate, jm = jtrainer.train_step(jstate, _batch(jrlt, jnp.asarray, b))
            state, m = trainer.train_step(state, _batch(rlt, torch.tensor, b))
            assert set(m) == set(jm)
            theirs.log(**jm)
            ours.log(**m)
        return (ours, ours.flush(0), w_ours), (theirs, theirs.flush(0), w_theirs)


def test_dqn_reporter_matches_jax():
    (ours, f_ours, w_ours), (theirs, f_theirs, w_theirs) = _reported_run()
    assert set(f_ours) == set(f_theirs) >= {"td_loss", "reward_loss", "cpe_td_loss"}
    for key in f_theirs:
        np.testing.assert_allclose(f_ours[key], f_theirs[key], **TOL, err_msg=key)
    for name in ("logged_actions", "model_action_idxs"):
        assert ours.observer(name).values == theirs.observer(name).values, name
        assert (ours.observer(name).get_distributions()
                == theirs.observer(name).get_distributions()), name
    fba_ours, fba_theirs = ours.observer("model_values"), theirs.observer("model_values")
    for fn in ("mean", "std"):
        for action in ACTIONS:
            np.testing.assert_allclose(fba_ours.values[fn][action],
                                       fba_theirs.values[fn][action], **TOL)
    np.testing.assert_allclose(list(ours.observer("recent_rewards").values),
                               list(theirs.observer("recent_rewards").values), **TOL)
    for kind in ("scalars", "histograms"):
        got, want = getattr(w_ours, kind), getattr(w_theirs, kind)
        assert set(got) == set(want), kind
        for tag in want:
            assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]], tag
            for (_, g), (_, w) in zip(got[tag], want[tag]):
                np.testing.assert_allclose(g, w, **TOL, err_msg=tag)
    assert {"actions/logged/a0", "train/model_values/a2/mean", "td_loss/mean"} <= set(
        w_ours.scalars)
    assert {"td_loss", "reward/logged", "train/model_values/a1"} <= set(w_ours.histograms)


# ------------------------------- tests/test_reporter_histograms.py on the port


def _tb_batch(B=16, obs=4, A=2, seed=0):
    rng = np.random.default_rng(seed)
    action_idx = rng.integers(0, A, B)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    return rlt.DiscreteDqnInput(
        state=rlt.FeatureData(float_features=t(rng.normal(size=(B, obs)))),
        next_state=rlt.FeatureData(float_features=t(rng.normal(size=(B, obs)))),
        action=t(np.eye(A)[action_idx]),
        next_action=t(np.eye(A)[rng.integers(0, A, B)]),
        reward=t(rng.normal(size=(B, 1))),
        time_diff=torch.ones((B, 1)),
        step=torch.ones((B, 1), dtype=torch.int32),
        not_terminal=torch.ones((B, 1)),
        possible_actions_mask=torch.ones((B, A)),
        possible_next_actions_mask=torch.ones((B, A)),
    )


def _run_dqn_with_reporter(tmp_path, steps=5):
    from torch.utils.tensorboard import SummaryWriter

    q_net = FullyConnectedDQN(state_dim=4, action_dim=2, sizes=[16], activations=["relu"])
    trainer = DQNTrainer(
        q_network=q_net, rl=RLParameters(gamma=0.9, target_update_rate=0.5),
        optimizer={"Adam": {"lr": 1e-2}}, emit_reporter_arrays=True, device="cpu")
    state = trainer.init(torch.Generator().manual_seed(0))
    reporter = DiscreteDQNReporter(actions=["left", "right"])
    writer = SummaryWriter(log_dir=str(tmp_path))
    with summary_writer_context(writer):
        for i in range(steps):
            state, metrics = trainer.train_step(state, _tb_batch(seed=i))
            reporter.log(**metrics)
        flushed = reporter.flush(epoch=0)
    writer.close()
    return reporter, flushed


def _load_events(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(tmp_path))
    acc.Reload()
    return acc


def test_dqn_reporter_trainer_arrays(tmp_path):
    reporter, flushed = _run_dqn_with_reporter(tmp_path)
    assert "td_loss" in flushed and np.isfinite(flushed["td_loss"])
    dist = reporter.observer("logged_actions").get_cumulative_distributions()
    assert set(dist) == {"left", "right"}
    assert sum(dist.values()) == pytest.approx(1.0)
    assert all(v > 0 for v in dist.values())
    assert len(reporter.observer("recent_rewards").values) == 5 * 16
    fba = reporter.observer("model_values")
    assert set(fba.values["mean"]) == {"left", "right"}
    assert len(fba.values["mean"]["left"]) == 5


def test_dqn_reporter_writes_tb_events(tmp_path):
    _run_dqn_with_reporter(tmp_path)
    acc = _load_events(tmp_path)
    scalars = set(acc.Tags()["scalars"])
    histos = set(acc.Tags()["histograms"])
    assert {"actions/logged/left", "actions/logged/right"} <= scalars
    assert {"actions/model/left", "actions/model/right"} <= scalars
    assert {"train/model_values/left", "train/model_values/right", "td_loss",
            "reward/logged"} <= histos
    assert "train/model_values/left/mean" in scalars
    assert len(acc.Scalars("actions/logged/left")) == 5


def test_slate_q_reporter_recent_rewards(tmp_path):
    from torch.utils.tensorboard import SummaryWriter

    reporter = SlateQReporter(recent_window_size=32)
    writer = SummaryWriter(log_dir=str(tmp_path))
    with summary_writer_context(writer):
        for i in range(8):
            reporter.log(td_loss=torch.tensor(1.0 / (i + 1)),
                         logged_rewards=torch.arange(10, dtype=torch.float32) + i)
        flushed = reporter.flush(epoch=0)
    writer.close()
    assert flushed["td_loss"] > 0
    recent = reporter.observer("recent_rewards")
    assert len(recent.values) == 32
    assert recent.values[-1] == pytest.approx(16.0)
    acc = _load_events(tmp_path)
    assert {"td_loss", "reward/logged"} <= set(acc.Tags()["histograms"])


def test_reporter_aggregation():
    r = DiscreteDQNReporter()
    for i in range(5):
        r.log(td_loss=float(i), q_values_mean=1.0)
    out = r.flush(epoch=0)
    assert out["td_loss"] == pytest.approx(2.0)
    assert out["q_values_mean"] == pytest.approx(1.0)
    assert r.flush(epoch=1) == {}  # aggregators reset after flush


# ------------------------------------------------------------ the bus itself


def test_values_to_host_keeps_dtypes_and_shapes():
    """Every tensor comes back as a numpy array equal to it, of its dtype
    and shape (bfloat16 as float32); other values pass through."""
    obj = object()
    values = {
        "loss": torch.tensor(0.25), "idx": torch.tensor([3, 0, 2**40]),
        "q": torch.arange(12, dtype=torch.float32).reshape(4, 3) / 7,
        "mask": torch.tensor([[True, False]]), "small": torch.tensor([1, 2], dtype=torch.int8),
        "half": torch.tensor([0.5, 1.5], dtype=torch.bfloat16), "none": None, "obj": obj,
        "f": 1.5,
    }
    host = values_to_host(values)
    assert host["none"] is None and host["obj"] is obj and host["f"] == 1.5
    for key in ("loss", "idx", "q", "mask", "small"):
        want = values[key].numpy()
        assert host[key].dtype == want.dtype and host[key].shape == want.shape, key
        np.testing.assert_array_equal(host[key], want)
    assert host["half"].dtype == np.float32
    np.testing.assert_array_equal(host["half"], [0.5, 1.5])


def test_reporter_log_copies_once(monkeypatch):
    """``log`` reads a step's tensors through one ``Tensor.cpu`` call."""
    calls = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *args, **kwargs):
        calls.append(self.numel())
        return real_cpu(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    r = DiscreteDQNReporter(["a", "b"])
    r.log(td_loss=torch.tensor(1.0), logged_actions=torch.tensor([0, 1, 1]),
          logged_rewards=torch.ones(3), model_values=torch.zeros(3, 2),
          model_action_idxs=torch.tensor([1, 1, 0]))
    assert len(calls) == 1
    assert r.observer("logged_actions").get_cumulative_distributions() == {
        "a": 1 / 3, "b": 2 / 3}


def test_aggregators_and_observers():
    mean, last = MeanAggregator("x"), LastValueAggregator("x")
    for v in (torch.tensor([1.0, 3.0]), np.float32(4.0)):
        mean.update("x", v)
        last.update("x", v)
    assert isinstance(mean.values[0], np.ndarray)
    assert mean.flush() == pytest.approx(3.0) and last.flush() == pytest.approx(4.0)
    assert mean.flush() is None

    agg = ActionCountAggregator("a", ["l", "r"])
    obs = IntervalAggregatingObserver(2, agg)
    epochs = []
    bus = ObservableMixin().add_observers(
        [CompositeObserver([obs]), EpochEndObserver(epochs.append), ValueListObserver("a")])
    for a in ([0, 1], [1, 1], [0, 0]):
        bus.notify_observers(a=torch.tensor(a))
    assert agg.values == {"l": [1], "r": [3]}  # the first interval of two updates
    bus.notify_observers(epoch_end=0)
    assert agg.values == {"l": [1, 2], "r": [3, 0]} and epochs == [0]

    recent = RecentValuesAggregator("r", size=3)
    recent.update("r", torch.arange(5.0))
    assert list(recent.values) == [2.0, 3.0, 4.0]
    writer = RecordingWriter()
    with summary_writer_context(writer):
        TensorBoardHistogramAndMeanAggregator("t", "t").update("t", torch.tensor([1.0, 2.0]))
    assert writer.scalars["t/mean"][0][1] == pytest.approx(1.5)
    np.testing.assert_array_equal(writer.histograms["t"][0][1], [1.0, 2.0])


def test_compound_reporter_routes_to_each():
    a, b = DiscreteDQNReporter(), SlateQReporter(recent_window_size=4)
    c = CompoundReporter([a, b])
    c.log(td_loss=torch.tensor(2.0), logged_rewards=torch.arange(6.0))
    assert c.flush(0)["td_loss"] == pytest.approx(2.0)
    assert list(b.observer("recent_rewards").values) == [2.0, 3.0, 4.0, 5.0]


def test_metrics_to_score_matches_jax():
    """``DQNTrainer(q, metrics_to_score=...)`` (a ``TypeError`` in the port
    until the CPE API took it) keeps ``metrics_to_score`` and
    ``action_names`` as JAX's trainer does; ``get_metrics_to_score`` sorts
    the metric names as JAX's does."""
    from reagent_tpu.evaluation.evaluator import get_metrics_to_score as jax_get_metrics_to_score
    from reagent_tpu.models import FullyConnectedDQN as JaxFullyConnectedDQN
    from reagent_tpu.training import DQNTrainer as JaxDQNTrainer
    from reagent_tpu_torch.evaluation.evaluator import get_metrics_to_score

    q = FullyConnectedDQN(state_dim=4, action_dim=2, sizes=[8], activations=["relu"])
    jq = JaxFullyConnectedDQN(state_dim=4, action_dim=2, sizes=[8], activations=["relu"])
    for kw in ({"metrics_to_score": ("m",)}, {"metrics_to_score": ("m", "ctr"),
                                               "action_names": ("l", "r")}, {}):
        ours, theirs = DQNTrainer(q, device="cpu", **kw), JaxDQNTrainer(jq, **kw)
        assert ours.metrics_to_score == theirs.metrics_to_score == kw.get("metrics_to_score", ())
        assert ours.action_names == theirs.action_names == kw.get("action_names")
    for values in (None, {}, {"watch": 1.0, "ctr": 2.0}):
        assert get_metrics_to_score(values) == jax_get_metrics_to_score(values)
