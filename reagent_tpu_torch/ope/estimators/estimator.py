"""Estimator ABC + result containers + multi-estimator Evaluator.

Port of ``reagent_tpu/ope/estimators/estimator.py``, line for line (numpy on the
host), so that the port imports nothing of the JAX package.

Reference: reagent/ope/estimators/estimator.py:64-280.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class EstimatorResult:
    log_reward: float
    estimated_reward: float
    ground_truth_reward: Optional[float] = 0.0
    estimated_weight: float = 1.0
    estimated_reward_normalized: Optional[float] = None
    estimated_reward_std_error: Optional[float] = None
    estimated_reward_normalized_std_error: Optional[float] = None


@dataclasses.dataclass
class EstimatorResults:
    results: List[EstimatorResult] = dataclasses.field(default_factory=list)

    def append(self, result: EstimatorResult) -> None:
        er = result.estimated_reward
        if math.isnan(er) or math.isinf(er):
            logger.warning("Invalid estimate: %s", er)
            return
        self.results.append(result)

    def report(self) -> Tuple[float, float, float]:
        """(bias, rmse, mean estimate) vs ground truth (reference :110-143)."""
        if not self.results:
            return 0.0, 0.0, 0.0
        est = np.array([r.estimated_reward for r in self.results])
        gt = np.array([r.ground_truth_reward or 0.0 for r in self.results])
        diff = est - gt
        return float(diff.mean()), float(np.sqrt((diff**2).mean())), float(est.mean())


class Estimator:
    """Base estimator: evaluate(input) -> EstimatorResult."""

    def evaluate(self, input: Any, **kwargs: Any) -> Optional[EstimatorResult]:
        raise NotImplementedError

    def __repr__(self) -> str:
        return type(self).__name__


class Evaluator:
    """Run several estimators over several experiments (reference :222-280;
    multiprocessing there, thread pool here — the work is numpy-parallel)."""

    def __init__(self, experiments: Iterable[Tuple[Iterable[Estimator], Any]], max_workers: int = 4):
        self._experiments = list(experiments)
        self._max_workers = max_workers

    def evaluate(self) -> dict:
        results: dict = {}

        def run_one(exp):
            estimators, input = exp
            out = []
            for estimator in estimators:
                try:
                    out.append((repr(estimator), estimator.evaluate(input)))
                except Exception as e:  # noqa: BLE001
                    logger.warning("estimator %s failed: %s", estimator, e)
                    out.append((repr(estimator), None))
            return out

        with ThreadPoolExecutor(max_workers=self._max_workers) as pool:
            for exp_results in pool.map(run_one, self._experiments):
                for name, res in exp_results:
                    if res is None:
                        continue
                    results.setdefault(name, EstimatorResults()).append(res)
        return results
