"""Base contextual-bandit offline evaluator.

Port of ``reagent_tpu/evaluation/cb/base_evaluator.py`` (reference
reagent/evaluation/cb/base_evaluator.py:16-247): an explicit
``OfflineEvalState`` of scalar tensors, global sums and a local window, and
functions that return a new state.  JAX reduces the window over a mesh axis
with ``psum``; here ``aggregate_across_instances`` takes a
``torch.distributed`` process group (``None``: one process, no reduction).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import torch

from reagent_tpu_torch.core.types import CBInput, _TensorDataClass
from reagent_tpu_torch.evaluation.cb.utils import add_importance_weights
from reagent_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)
Tensor = torch.Tensor

EPSILON = 1e-9


@dataclasses.dataclass
class OfflineEvalState(_TensorDataClass):
    """Global and windowed local accumulators (ref buffers :66-146)."""

    # global cumulative
    sum_weight_accepted: Tensor
    sum_importance_weight_accepted: Tensor
    sum_weight_all_data: Tensor
    sum_reward_weighted_accepted: Tensor
    sum_reward_importance_weighted_accepted: Tensor
    num_eval_model_updates: Tensor
    # local window (reset at each aggregation)
    sum_weight_accepted_local: Tensor
    sum_importance_weight_accepted_local: Tensor
    sum_weight_all_data_local: Tensor
    sum_weight_since_update_local: Tensor
    sum_reward_weighted_accepted_local: Tensor
    sum_reward_importance_weighted_accepted_local: Tensor
    sum_reward_weighted_all_data_local: Tensor
    sum_size_weighted_accepted_local: Tensor
    sum_size_weighted_all_data_local: Tensor
    # windowed metrics (filled by aggregate)
    frac_accepted: Tensor
    avg_reward_accepted: Tensor
    avg_reward_rejected: Tensor
    avg_reward_all_data: Tensor
    avg_size_accepted: Tensor
    avg_size_rejected: Tensor
    accepted_rejected_reward_ratio: Tensor

    @classmethod
    def create(cls, device="cuda") -> "OfflineEvalState":
        device = resolve_device(device)
        return cls(**{f.name: torch.zeros((), device=device) for f in dataclasses.fields(cls)})


class BaseOfflineEval:
    """Non-stationary-policy offline eval (Li et al. 2011, Algorithm 3 family)."""

    metric_prefix: str = "[model]Offline_Eval_"

    def __init__(self, max_importance_weight: Optional[float] = None):
        self.max_importance_weight = max_importance_weight

    def init_state(self, device="cuda") -> OfflineEvalState:
        return OfflineEvalState.create(device)

    def ingest_batch(self, state: OfflineEvalState, batch: CBInput, model_actions: Tensor
                     ) -> Tuple[OfflineEvalState, CBInput]:
        """Accumulate the sums; zero the weights where the actions differ (ref :148-170)."""
        state = self._process_all_data(state, batch)
        new_batch = add_importance_weights(batch, model_actions, self.max_importance_weight)
        return self._process_used_data(state, new_batch), new_batch

    def _process_all_data(self, state: OfflineEvalState, batch: CBInput) -> OfflineEvalState:
        raise NotImplementedError

    def _process_used_data(self, state: OfflineEvalState, batch: CBInput) -> OfflineEvalState:
        raise NotImplementedError

    def aggregate_across_instances(self, state: OfflineEvalState,
                                   group=None) -> OfflineEvalState:
        raise NotImplementedError

    def update_eval_model(self, state: OfflineEvalState) -> OfflineEvalState:
        """Count a model refresh; the caller swaps the parameters it scores
        with (ref :210-217)."""
        return state.replace(num_eval_model_updates=state.num_eval_model_updates + 1,
                             sum_weight_since_update_local=torch.zeros_like(
                                 state.sum_weight_since_update_local))

    def get_avg_reward(self, state: OfflineEvalState) -> float:
        raise NotImplementedError

    def metrics_dict(self, state: OfflineEvalState) -> dict:
        p = self.metric_prefix
        out = {f"{p}avg_reward": self.get_avg_reward(state)}
        for name in ("sum_weight_accepted", "sum_weight_all_data", "num_eval_model_updates",
                     "frac_accepted", "avg_reward_accepted", "avg_reward_rejected",
                     "avg_size_accepted", "avg_size_rejected", "accepted_rejected_reward_ratio",
                     "avg_reward_all_data"):
            out[f"{p}{name}"] = float(getattr(state, name))
        return out

    def get_formatted_result_string(self, state: OfflineEvalState) -> str:
        return (
            f"Avg reward {self.get_avg_reward(state):0.3f} based on"
            f" {int(state.sum_weight_accepted)} processed observations (out of"
            f" {int(state.sum_weight_all_data)} observations). The eval model has"
            f" been updated {int(state.num_eval_model_updates)} times"
        )
