"""CPE result containers + bootstrap helper.

Reference: reagent/evaluation/cpe.py:18-157 (CpeEstimate/CpeEstimateSet/
CpeDetails) and :176 (bootstrapped_std_error_of_mean).

The port's own copy of ``reagent_tpu/evaluation/cpe.py``,
line for line (numpy on the host), so that the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, NamedTuple, Optional

import numpy as np

logger = logging.getLogger(__name__)


class CpeEstimate(NamedTuple):
    raw: float
    normalized: float
    raw_std_error: float
    normalized_std_error: float


class CpeEstimateSet(NamedTuple):
    direct_method: Optional[CpeEstimate] = None
    inverse_propensity: Optional[CpeEstimate] = None
    doubly_robust: Optional[CpeEstimate] = None
    sequential_doubly_robust: Optional[CpeEstimate] = None
    weighted_doubly_robust: Optional[CpeEstimate] = None
    magic: Optional[CpeEstimate] = None

    def check_estimates_exist(self):
        assert self.direct_method is not None
        assert self.inverse_propensity is not None
        assert self.doubly_robust is not None

    def log(self):
        for name in self._fields:
            est = getattr(self, name)
            if est is not None:
                logger.info(
                    "%s: normalized %.3f +/- %.3f raw %.3f +/- %.3f",
                    name, est.normalized, est.normalized_std_error,
                    est.raw, est.raw_std_error,
                )

    def log_to_tensorboard(self, metric_name: str) -> None:
        from reagent_tpu_torch.core.tracker import SummaryWriterContext

        for name in self._fields:
            est = getattr(self, name)
            if est is not None:
                SummaryWriterContext.add_scalar(
                    f"CPE/{metric_name}/{name}", est.normalized
                )


@dataclasses.dataclass
class CpeDetails:
    reward_estimates: CpeEstimateSet = dataclasses.field(default_factory=CpeEstimateSet)
    metric_estimates: Dict[str, CpeEstimateSet] = dataclasses.field(default_factory=dict)
    q_value_means: Optional[Dict[str, float]] = None
    q_value_stds: Optional[Dict[str, float]] = None
    action_distribution: Optional[Dict[str, float]] = None

    def log(self):
        self.reward_estimates.log()
        for metric, est in self.metric_estimates.items():
            logger.info("%s estimates:", metric)
            est.log()

    def log_to_tensorboard(self) -> None:
        self.reward_estimates.log_to_tensorboard("Reward")
        for metric_name, estimate_set in self.metric_estimates.items():
            estimate_set.log_to_tensorboard(metric_name)


def bootstrapped_std_error_of_mean(
    data, sample_percent: float = 0.25, num_samples: int = 1000, rng=None
) -> float:
    """Reference: cpe.py:176-191."""
    data = np.asarray(data)
    rng = rng or np.random
    sample_size = int(sample_percent * len(data))
    means = [
        np.mean(rng.choice(data, size=sample_size, replace=True))
        for _ in range(num_samples)
    ]
    return float(np.std(means))
