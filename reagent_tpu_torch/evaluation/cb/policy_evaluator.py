"""Replay-method policy evaluator for contextual bandits.

Port of ``reagent_tpu/evaluation/cb/policy_evaluator.py`` (reference
reagent/evaluation/cb/policy_evaluator.py:16-167): the rejection-sampling
estimator of Li et al., https://arxiv.org/pdf/1003.0146.pdf (Algorithm 3),
which keeps the rows where the evaluated policy's action matches the logged
one, weights them by 1 / p_logged and averages their reward.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from reagent_tpu_torch.core.types import CBInput
from reagent_tpu_torch.evaluation.cb.base_evaluator import (
    EPSILON,
    BaseOfflineEval,
    OfflineEvalState,
)
from reagent_tpu_torch.evaluation.cb.utils import effective_weight

Tensor = torch.Tensor
# the window's sums that aggregate_across_instances reduces, in one tensor
_LOCAL = ("sum_weight_accepted_local", "sum_importance_weight_accepted_local",
          "sum_weight_all_data_local", "sum_reward_weighted_accepted_local",
          "sum_reward_importance_weighted_accepted_local", "sum_reward_weighted_all_data_local",
          "sum_size_weighted_accepted_local", "sum_size_weighted_all_data_local")


def _weights_of(batch: CBInput) -> Tensor:
    return batch.weight if batch.weight is not None else torch.ones_like(batch.reward)


def _sizes_of(batch: CBInput) -> Tensor:
    if batch.arm_presence is not None:
        return torch.sum(batch.arm_presence.to(torch.float32), dim=1)
    return (torch.ones(batch.reward.shape[0], device=batch.reward.device)
            * batch.context_arm_features.shape[1])


class PolicyEvaluator(BaseOfflineEval):
    def _process_all_data(self, state, batch):
        assert batch.reward is not None
        weights = _weights_of(batch)
        return state.replace(
            sum_weight_all_data_local=state.sum_weight_all_data_local + weights.sum(),
            sum_reward_weighted_all_data_local=state.sum_reward_weighted_all_data_local
            + torch.sum(weights * batch.reward),
            sum_size_weighted_all_data_local=state.sum_size_weighted_all_data_local
            + torch.sum(weights.reshape(-1) * _sizes_of(batch)),
        )

    def _process_used_data(self, state, batch):
        assert batch.reward is not None and batch.importance_weight is not None
        weights = _weights_of(batch)
        eff = effective_weight(batch)
        accepted = (batch.importance_weight > 0).to(torch.float32)
        return state.replace(
            sum_reward_importance_weighted_accepted_local=(
                state.sum_reward_importance_weighted_accepted_local
                + torch.sum(eff * batch.reward)),
            sum_reward_weighted_accepted_local=(
                state.sum_reward_weighted_accepted_local
                + torch.sum(weights * accepted * batch.reward)),
            sum_weight_accepted_local=(
                state.sum_weight_accepted_local + torch.sum(weights * accepted)),
            sum_importance_weight_accepted_local=(
                state.sum_importance_weight_accepted_local + eff.sum()),
            sum_size_weighted_accepted_local=(
                state.sum_size_weighted_accepted_local
                + torch.sum((weights * accepted).reshape(-1) * _sizes_of(batch))),
            sum_weight_since_update_local=(
                state.sum_weight_since_update_local + weights.sum()),
        )

    def aggregate_across_instances(self, state: OfflineEvalState,
                                   group=None) -> OfflineEvalState:
        """Fold the local window into the global sums (ref :71-154).

        With a ``torch.distributed`` process group the eight local sums are
        summed over its processes, one all-reduce of one tensor (the
        reference's sync_ddp_if_available, JAX's ``psum`` over a mesh axis);
        ``None`` reduces nothing, as JAX's ``axis_name=None``.
        """
        local = torch.stack([getattr(state, k) for k in _LOCAL])
        if group is not None:
            local = local.clone()
            dist.all_reduce(local, op=dist.ReduceOp.SUM, group=group)
        acc, imp, alld, r_acc, r_imp, r_all, s_acc, s_all = local.unbind()
        rejected = alld - acc
        r_rej = r_all - r_acc
        s_rej = s_all - s_acc
        z = torch.zeros_like(acc)

        def ratio(a, b):
            return a / torch.clamp(b, min=EPSILON)

        return state.replace(
            sum_reward_weighted_accepted=state.sum_reward_weighted_accepted + r_acc,
            sum_reward_importance_weighted_accepted=(
                state.sum_reward_importance_weighted_accepted + r_imp),
            sum_weight_accepted=state.sum_weight_accepted + acc,
            sum_importance_weight_accepted=state.sum_importance_weight_accepted + imp,
            sum_weight_all_data=state.sum_weight_all_data + alld,
            frac_accepted=ratio(acc, alld),
            avg_reward_accepted=ratio(r_acc, acc),
            avg_reward_rejected=ratio(r_rej, rejected),
            avg_reward_all_data=ratio(r_all, alld),
            accepted_rejected_reward_ratio=ratio(ratio(r_acc, acc), ratio(r_rej, rejected)),
            avg_size_accepted=ratio(s_acc, acc),
            avg_size_rejected=ratio(s_rej, rejected),
            **{k: z for k in _LOCAL},
        )

    def get_avg_reward(self, state: OfflineEvalState) -> float:
        """The IPS replay estimate of the evaluated policy's average reward."""
        assert float(state.sum_importance_weight_accepted_local) == 0.0, (
            "call aggregate_across_instances() before reading the estimate")
        return float(state.sum_reward_importance_weighted_accepted
                     / (state.sum_importance_weight_accepted + EPSILON))
