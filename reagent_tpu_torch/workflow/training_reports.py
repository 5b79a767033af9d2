"""Typed per-family training reports.

Port of ``reagent_tpu/workflow/training_reports.py`` (reference:
reagent/workflow/training_reports.py:18-55) — registry-named report
dataclasses carrying the CPE estimates surfaced to the publisher/validator.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from reagent_tpu_torch.core.registry import Registry
from reagent_tpu_torch.evaluation.cpe import CpeEstimate

TRAINING_REPORTS: Registry = Registry("workflow.training_reports")


@TRAINING_REPORTS.register("dqn_report")
@dataclasses.dataclass
class DQNTrainingReport:
    td_loss: Optional[float] = None
    mc_loss: Optional[float] = None
    reward_ips: Optional[CpeEstimate] = None
    reward_dm: Optional[CpeEstimate] = None
    reward_dr: Optional[CpeEstimate] = None
    value_sequential_dr: Optional[CpeEstimate] = None
    value_weighted_dr: Optional[CpeEstimate] = None
    value_magic_dr: Optional[CpeEstimate] = None

    @classmethod
    def from_cpe_details(cls, td_loss, cpe_details) -> "DQNTrainingReport":
        if cpe_details is None:
            return cls(td_loss=td_loss)
        r = cpe_details.reward_estimates
        return cls(
            td_loss=td_loss,
            reward_ips=r.inverse_propensity,
            reward_dm=r.direct_method,
            reward_dr=r.doubly_robust,
            value_sequential_dr=r.sequential_doubly_robust,
            value_weighted_dr=r.weighted_doubly_robust,
            value_magic_dr=r.magic,
        )


@TRAINING_REPORTS.register("actor_critic_report")
@dataclasses.dataclass
class ActorCriticTrainingReport:
    pass


@TRAINING_REPORTS.register("world_model_report")
@dataclasses.dataclass
class WorldModelTrainingReport:
    pass


@TRAINING_REPORTS.register("parametric_dqn_report")
@dataclasses.dataclass
class ParametricDQNTrainingReport:
    td_loss: Optional[float] = None


@TRAINING_REPORTS.register("slate_q_report")
@dataclasses.dataclass
class SlateQTrainingReport:
    td_loss: Optional[float] = None


@TRAINING_REPORTS.register("seq2reward_report")
@dataclasses.dataclass
class Seq2RewardTrainingReport:
    mse_loss: Optional[float] = None
    accuracy: Optional[float] = None
