"""Seq2Slate policy-gradient trainer: off-policy REINFORCE with an IPS clamp.

Port of ``reagent_tpu/training/ranking/seq2slate_trainer.py`` (``ips_clamp``
:28, ``seq2slate_validation_step`` :38, ``accumulate_edp_pairs`` :114,
``Seq2SlateTrainer`` :136; reference reagent/training/ranking/
seq2slate_trainer.py:25-279).  The loss: -clamp(p_model / p_logged) *
(slate_reward - baseline).  The validation step builds the greedy and the
sampled evaluation pages scored by a slate reward network.

``train_step`` reads no value on the host: the baseline's warm-up keeps the
policy by a device-side select, as JAX's ``jnp.where``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import IPSClamp, IPSClampMethod, Seq2SlateParameters
from reagent_tpu_torch.models.seq2slate import Seq2SlateMode
from reagent_tpu_torch.optim import OptState, make_optimizer
from reagent_tpu_torch.training import functional
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


def ips_clamp(impt_smpl: Tensor, clamp: Optional[IPSClamp]) -> Tensor:
    """Reference: reagent/model_utils/seq2slate_utils.py ips_clamp."""
    if clamp is None:
        return impt_smpl
    if clamp.clamp_method == IPSClampMethod.AGGRESSIVE:
        # drop the samples whose weights are too large
        return torch.where(impt_smpl > clamp.clamp_max, 0.0, impt_smpl)
    return torch.clamp(impt_smpl, max=clamp.clamp_max)


def _per_seq_log_probs(net, params, batch: rlt.PreprocessedRankingInput) -> Tensor:
    return functional.apply(
        net, params, Seq2SlateMode.PER_SEQ_LOG_PROB_MODE.value,
        batch.state.float_features, batch.src_seq.float_features,
        tgt_in_idx=batch.tgt_in_idx, tgt_out_idx=batch.tgt_out_idx,
        tgt_in_seq=None if batch.tgt_in_seq is None else batch.tgt_in_seq.float_features,
    ).per_seq_log_probs


def seq2slate_validation_step(
    seq2slate_net: nn.Module,
    policy_params,
    batch: rlt.PreprocessedRankingInput,
    baseline_net: Optional[nn.Module] = None,
    baseline_params=None,
    calc_cpe: bool = False,
    reward_network: Optional[nn.Module] = None,
    reward_params=None,
):
    """The shared validation pass (reference seq2slate_trainer.py:196-259,
    seq2slate_tf_trainer.py:100-137) -> ``(metrics, edp_g, edp_ng)``; the
    pages are None unless ``calc_cpe`` (which needs ``reward_network``).
    ``metrics``: eval_baseline_loss, eval_advantages,
    logged_slate_rank_probs, ranked_slate_rank_probs."""
    from reagent_tpu_torch.evaluation.evaluation_data_page import EvaluationDataPage

    with torch.no_grad():
        reward = batch.slate_reward.reshape(-1, 1)
        T = batch.tgt_out_idx.shape[1]
        logged = torch.exp(_per_seq_log_probs(seq2slate_net, policy_params, batch)).reshape(-1)
        eval_baseline_loss = torch.zeros((), device=reward.device)
        if baseline_net is not None and baseline_params is not None:
            b = functional.apply(baseline_net, baseline_params, batch.state.float_features)
            eval_baseline_loss = torch.mean((b - reward) ** 2)
        else:
            b = torch.zeros_like(reward)
        ranked = functional.apply(
            seq2slate_net, policy_params, Seq2SlateMode.RANK_MODE.value,
            batch.state.float_features, batch.src_seq.float_features,
            tgt_seq_len=T, greedy=True)
    metrics = {
        "eval_baseline_loss": eval_baseline_loss,
        "eval_advantages": (reward - b).reshape(-1),
        "logged_slate_rank_probs": logged,
        "ranked_slate_rank_probs": ranked.ranked_per_seq_probs.reshape(-1),
    }
    if not calc_cpe:
        return metrics, None, None
    if reward_network is None:
        raise ValueError("calc_cpe needs a slate reward network")
    mdp_ids = None if batch.extras is None else batch.extras.mdp_id
    seq_nums = None if batch.extras is None else batch.extras.sequence_number
    pages = [EvaluationDataPage.create_from_tensors_seq2slate(
        seq2slate_net, policy_params, reward_network, reward_params, batch,
        eval_greedy=greedy, mdp_ids=mdp_ids, sequence_numbers=seq_nums)
        for greedy in (True, False)]
    return metrics, pages[0], pages[1]


def accumulate_edp_pairs(pairs):
    """``validation_epoch_end`` (reference seq2slate_trainer.py:262-279):
    the per-batch (edp_g, edp_ng) pairs appended into one pair."""
    pairs = [p for p in pairs if p[0] is not None]
    if not pairs:
        return None, None
    edp_g, edp_ng = pairs[0]
    for g, ng in pairs[1:]:
        edp_g = edp_g.append(g)
        edp_ng = edp_ng.append(ng)
    return edp_g, edp_ng


@dataclasses.dataclass
class Seq2SlateTrainerState:
    policy_params: Dict[str, Tensor]
    policy_opt_state: OptState
    step: Tensor  # int32 scalar on the device
    baseline_params: Optional[Dict[str, Tensor]] = None
    baseline_opt_state: Optional[OptState] = None


class Seq2SlateTrainer:
    """``seq2slate_net`` is a ``Seq2SlateTransformerModel``; the optional
    ``baseline_net`` maps the state to [B, 1].  ``device`` defaults to
    ``"cuda"`` and raises if no card is present."""

    def __init__(
        self,
        seq2slate_net: nn.Module,
        params: Seq2SlateParameters = Seq2SlateParameters(),
        baseline_net: Optional[nn.Module] = None,
        baseline_warmup_num_batches: int = 0,
        policy_optimizer: Any = None,
        baseline_optimizer: Any = None,
        calc_cpe: bool = False,
        reward_network: Optional[nn.Module] = None,
        reward_params: Any = None,
        device="cuda",
    ) -> None:
        if calc_cpe and reward_network is None:
            raise ValueError("calc_cpe needs a reward_network")
        self.device = resolve_device(device)
        self.seq2slate_net = seq2slate_net.to(self.device)
        self.params = params
        self.baseline_net = None if baseline_net is None else baseline_net.to(self.device)
        self.baseline_warmup_num_batches = baseline_warmup_num_batches
        self.policy_opt = make_optimizer(policy_optimizer)
        self.baseline_opt = make_optimizer(baseline_optimizer)
        self.calc_cpe = calc_cpe
        self.reward_network = (None if reward_network is None
                               else reward_network.to(self.device))
        self.reward_params = reward_params

    def init(self, generator: torch.Generator) -> Seq2SlateTrainerState:
        """Fresh weights from ``generator`` (the policy, then the baseline)."""
        self.seq2slate_net.reset_parameters(generator)
        if self.baseline_net is not None:
            self.baseline_net.reset_parameters(generator)
        return self.state_from_networks()

    def state_from_networks(self) -> Seq2SlateTrainerState:
        """The training state for the networks' current weights (the
        policy's that its log-probabilities read)."""
        policy_params = self.seq2slate_net.params_for(Seq2SlateMode.PER_SEQ_LOG_PROB_MODE)
        state = Seq2SlateTrainerState(
            policy_params=policy_params,
            policy_opt_state=self.policy_opt.init(policy_params),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
        )
        if self.baseline_net is not None:
            baseline_params = functional.params_of(self.baseline_net)
            state = dataclasses.replace(
                state, baseline_params=baseline_params,
                baseline_opt_state=self.baseline_opt.init(baseline_params))
        return state

    def train_step(
        self, state: Seq2SlateTrainerState, batch: rlt.PreprocessedRankingInput
    ) -> Tuple[Seq2SlateTrainerState, Dict[str, Tensor]]:
        reward = batch.slate_reward.reshape(-1, 1)
        obs = batch.state.float_features

        baseline_params, baseline_opt_state = state.baseline_params, state.baseline_opt_state
        baseline_loss = torch.zeros((), device=reward.device)
        if self.baseline_net is not None:
            def b_loss_fn(bp):
                b = functional.apply(self.baseline_net, bp, obs)
                return torch.mean((b - reward) ** 2), b.detach()

            baseline_loss, b_grads, b = functional.value_and_grad(
                b_loss_fn, state.baseline_params, has_aux=True)
            with torch.no_grad():
                baseline_params, baseline_opt_state = self.baseline_opt.update(
                    b_grads, state.baseline_opt_state, state.baseline_params)
        else:
            b = torch.zeros_like(reward)

        logged_propensities = batch.tgt_out_probs.reshape(-1, 1)

        def policy_loss_fn(pp):
            log_probs = _per_seq_log_probs(self.seq2slate_net, pp, batch)
            impt_smpl = torch.exp(log_probs) / torch.clamp(logged_propensities, min=1e-35)
            clamped = ips_clamp(impt_smpl, self.params.ips_clamp)
            obj_loss = torch.mean(-clamped * (reward - b))
            return obj_loss, (impt_smpl.detach(), clamped.detach())

        obj_loss, grads, (impt_smpl, clamped) = functional.value_and_grad(
            policy_loss_fn, state.policy_params, has_aux=True)
        with torch.no_grad():
            # the baseline's warm-up: keep the policy until it is warm
            do_update = state.step >= self.baseline_warmup_num_batches
            new_params, new_opt = self.policy_opt.update(
                grads, state.policy_opt_state, state.policy_params)
            new_state = Seq2SlateTrainerState(
                policy_params=functional.select(do_update, new_params, state.policy_params),
                policy_opt_state=functional.select(do_update, new_opt, state.policy_opt_state),
                step=state.step + 1,
                baseline_params=baseline_params,
                baseline_opt_state=baseline_opt_state,
            )
        return new_state, {
            "obj_loss": obj_loss,
            "baseline_loss": baseline_loss,
            "ips_mean": impt_smpl.mean(),
            "clamped_ips_mean": clamped.mean(),
        }

    def validation_step(self, state: Seq2SlateTrainerState,
                        batch: rlt.PreprocessedRankingInput, reward_params: Any = None):
        """Reference seq2slate_trainer.py:196-259: the evaluation metrics
        and, with ``calc_cpe``, the (greedy, sampled) evaluation pages."""
        return seq2slate_validation_step(
            self.seq2slate_net, state.policy_params, batch,
            baseline_net=self.baseline_net, baseline_params=state.baseline_params,
            calc_cpe=self.calc_cpe, reward_network=self.reward_network,
            reward_params=reward_params if reward_params is not None else self.reward_params)

    def rank(self, state: Seq2SlateTrainerState, batch: rlt.PreprocessedRankingInput,
             tgt_seq_len: int, greedy: bool = True, gumbel: Optional[Tensor] = None,
             generator: Optional[torch.Generator] = None):
        return functional.apply(
            self.seq2slate_net, state.policy_params, Seq2SlateMode.RANK_MODE.value,
            batch.state.float_features, batch.src_seq.float_features,
            tgt_seq_len=tgt_seq_len, greedy=greedy, gumbel=gumbel, generator=generator)
