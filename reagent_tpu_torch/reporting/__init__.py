"""Reporters: per-algorithm metric aggregation.

Port of ``reagent_tpu/reporting/`` (reference: reagent/reporting/).
"""

from reagent_tpu_torch.reporting.reporter_base import CompoundReporter, ReporterBase
from reagent_tpu_torch.reporting.reporters import (
    ActorCriticReporter,
    DiscreteDQNReporter,
    ParametricDQNReporter,
    SlateQReporter,
    TD3Reporter,
    WorldModelReporter,
    DiscreteCRRReporter,
    RewardNetworkReporter,
    Seq2RewardCompressReporter,
    Seq2RewardReporter,
)

__all__ = [
    "ReporterBase",
    "CompoundReporter",
    "DiscreteDQNReporter",
    "ActorCriticReporter",
    "TD3Reporter",
    "ParametricDQNReporter",
    "SlateQReporter",
    "WorldModelReporter",
    "DiscreteCRRReporter",
    "RewardNetworkReporter",
    "Seq2RewardCompressReporter",
    "Seq2RewardReporter",
]
