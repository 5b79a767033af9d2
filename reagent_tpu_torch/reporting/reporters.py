"""Per-algorithm reporters.

Port of ``reagent_tpu/reporting/reporters.py`` (reference:
reagent/reporting/*.py).  The reference batches aggregation through
IntervalAggregatingObserver; here TensorBoard-writing aggregators emit on
every update and scalar aggregators flush per epoch — same TB surface,
simpler plumbing.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from reagent_tpu_torch.core.aggregators import (
    ActionCountAggregator,
    FunctionsByActionAggregator,
    RecentValuesAggregator,
    TensorBoardActionCountAggregator,
    TensorBoardActionHistogramAndMeanAggregator,
    TensorBoardHistogramAndMeanAggregator,
)
from reagent_tpu_torch.core.tracker import MeanAggregator, ValueListObserver
from reagent_tpu_torch.reporting.reporter_base import ReporterBase


def _mk(keys):
    return {
        "value_list_observers": {"cpe_details": ValueListObserver("cpe_details")},
        "aggregating_observers": {k: MeanAggregator(k) for k in keys},
    }


def _action_observers(actions: List[str], recent_window_size: int):
    """The action-level depth of the reference DiscreteDQNReporter
    (reporting/discrete_dqn_reporter.py:30-70): count distributions, TB
    histograms of logged/model actions, per-action model-value summaries,
    and a recent-rewards window."""
    return {
        "logged_actions": ActionCountAggregator("logged_actions", actions),
        "model_action_idxs": ActionCountAggregator("model_action_idxs", actions),
        "logged_actions_tb": TensorBoardActionCountAggregator(
            "logged_actions", "logged", actions
        ),
        "model_action_idxs_tb": TensorBoardActionCountAggregator(
            "model_action_idxs", "model", actions
        ),
        "model_values": FunctionsByActionAggregator(
            "model_values", actions, {"mean": np.mean, "std": np.std}
        ),
        "model_values_tb": TensorBoardActionHistogramAndMeanAggregator(
            "model_values", "train", "model_values", actions
        ),
        "recent_rewards": RecentValuesAggregator(
            "logged_rewards", size=recent_window_size
        ),
        "logged_rewards_tb": TensorBoardHistogramAndMeanAggregator(
            "logged_rewards", "reward/logged"
        ),
        "td_loss_tb": TensorBoardHistogramAndMeanAggregator("td_loss", "td_loss"),
    }


class _MultiObserverReporter(ReporterBase):
    """Routes one metric key to several aggregators (TB + scalar)."""

    def __init__(self, value_list_observers, aggregating_observers):
        super().__init__(value_list_observers, {})
        self._multi_observers = aggregating_observers

    def _log_host(self, values) -> None:
        super()._log_host(values)
        for agg in self._multi_observers.values():
            value = values.get(agg.key)
            if value is not None:
                agg.update(agg.key, np.asarray(value))

    def flush(self, epoch: int):
        out = super().flush(epoch)
        for agg in self._multi_observers.values():
            v = agg.flush()
            if v is not None:
                out[agg.key] = v
        self.last_flush = out
        return out

    def observer(self, name: str):
        return self._multi_observers.get(name)


class DiscreteDQNReporter(_MultiObserverReporter):
    """Reference: reporting/discrete_dqn_reporter.py."""

    def __init__(
        self,
        actions: Optional[List[str]] = None,
        recent_window_size: int = 100,
    ):
        kw = _mk(
            [
                "td_loss", "reward_loss", "q_values_mean", "q_taken_mean",
                "reward_mean", "cpe_td_loss",
            ]
        )
        multi = _action_observers(actions, recent_window_size) if actions else {}
        super().__init__(kw["value_list_observers"], multi)
        self._aggregating_observers.update(kw["aggregating_observers"])


class ActorCriticReporter(ReporterBase):
    """Reference: reporting/actor_critic_reporter.py."""

    def __init__(self):
        super().__init__(
            **_mk(["q1_loss", "q2_loss", "actor_loss", "alpha_loss", "value_loss"])
        )


class TD3Reporter(ReporterBase):
    def __init__(self):
        super().__init__(**_mk(["q1_loss", "q2_loss", "actor_loss", "target_q_mean"]))


class ParametricDQNReporter(ReporterBase):
    def __init__(self):
        super().__init__(**_mk(["td_loss", "reward_loss", "q_mean"]))


class SlateQReporter(_MultiObserverReporter):
    """Reference: reporting/slate_q_reporter.py:20-55 — recent logged rewards
    window + TB histograms of td_loss and logged rewards."""

    def __init__(self, recent_window_size: int = 100):
        kw = _mk(["td_loss", "q_mean"])
        multi = {
            "recent_rewards": RecentValuesAggregator(
                "logged_rewards", size=recent_window_size
            ),
            "logged_rewards_tb": TensorBoardHistogramAndMeanAggregator(
                "logged_rewards", "reward/logged"
            ),
            "td_loss_tb": TensorBoardHistogramAndMeanAggregator(
                "td_loss", "td_loss"
            ),
        }
        super().__init__(kw["value_list_observers"], multi)
        self._aggregating_observers.update(kw["aggregating_observers"])


class Seq2SlateReporter(ReporterBase):
    """Ranking trainer validation metrics (the reference logs these from
    seq2slate_trainer.py:231-236 and :276-279 into its lightning reporter;
    the OSS tree has no dedicated reporter class, so the key set is ours)."""

    def __init__(self):
        kw = _mk(
            [
                "obj_loss", "baseline_loss", "ips_mean", "clamped_ips_mean",
                "kl_loss", "eval_baseline_loss",
            ]
        )
        # EDP pairs are accumulated by accumulate_edp_pairs, not the
        # reporter (np.asarray would mangle them into object scalars)
        kw["value_list_observers"].update(
            {
                k: ValueListObserver(k)
                for k in (
                    "eval_advantages",
                    "logged_slate_rank_probs",
                    "ranked_slate_rank_probs",
                )
            }
        )
        super().__init__(**kw)


class WorldModelReporter(ReporterBase):
    def __init__(self):
        super().__init__(**_mk(["loss", "gmm", "bce", "mse"]))


class DiscreteCRRReporter(_MultiObserverReporter):
    """Reference: reporting/discrete_crr_reporter.py (same action-histogram
    depth as the DQN reporter)."""

    def __init__(
        self,
        actions: Optional[List[str]] = None,
        recent_window_size: int = 100,
    ):
        kw = _mk(["q1_loss", "q2_loss", "actor_loss", "actor_q1_mean", "td_loss"])
        multi = _action_observers(actions, recent_window_size) if actions else {}
        super().__init__(kw["value_list_observers"], multi)
        self._aggregating_observers.update(kw["aggregating_observers"])


class RewardNetworkReporter(ReporterBase):
    """Reference: reporting/reward_network_reporter.py."""

    def __init__(self):
        super().__init__(**_mk(["loss", "unweighted_loss", "eval_loss"]))


class Seq2RewardReporter(ReporterBase):
    """Reference: reporting/seq2reward_reporter.py."""

    def __init__(self):
        super().__init__(
            **_mk(["mse_loss", "step_entropy_loss", "q_values_mean", "eval_mse_loss"])
        )


class Seq2RewardCompressReporter(Seq2RewardReporter):
    """Reference: reporting/seq2reward_reporter.py:106."""

    def __init__(self):
        ReporterBase.__init__(
            self,
            **_mk(
                ["mse_loss", "accuracy", "eval_mse_loss", "eval_accuracy",
                 "eval_q_values_mean", "eval_action_distribution"]
            ),
        )
