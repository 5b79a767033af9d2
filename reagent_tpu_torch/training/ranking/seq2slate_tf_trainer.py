"""Seq2Slate teacher-forcing and simulation trainers.

Port of ``reagent_tpu/training/ranking/seq2slate_tf_trainer.py`` (teacher
forcing :35, ``Seq2SlateSimulationTrainer`` :126; reference reagent/training/
ranking/seq2slate_tf_trainer.py:24, the KL toward the optimal orderings, and
seq2slate_sim_trainer.py:62, training on slates the policy ranks and a
reward model scores).  The simulation step's sampled rank takes explicit
gumbel draws ``[T, B, S + 2]`` or a ``torch.Generator`` where JAX takes a
key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import Seq2SlateParameters
from reagent_tpu_torch.models.seq2slate import Seq2SlateMode
from reagent_tpu_torch.optim import OptState, make_optimizer
from reagent_tpu_torch.training import functional
from reagent_tpu_torch.training.ranking.seq2slate_trainer import (
    Seq2SlateTrainer,
    seq2slate_validation_step,
)
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class Seq2SlateTFTrainerState:
    policy_params: Dict[str, Tensor]
    policy_opt_state: OptState
    step: Tensor


class Seq2SlateTeacherForcingTrainer:
    """KL(per-symbol distribution || one-hot optimal ordering) (ref
    tf_trainer.py:66-90).  ``device`` defaults to ``"cuda"``."""

    def __init__(
        self,
        seq2slate_net: nn.Module,
        params: Seq2SlateParameters = Seq2SlateParameters(),
        policy_optimizer: Any = None,
        calc_cpe: bool = False,
        reward_network: Optional[nn.Module] = None,
        reward_params: Any = None,
        device="cuda",
    ):
        if calc_cpe and reward_network is None:
            raise ValueError("calc_cpe needs a reward_network")
        self.device = resolve_device(device)
        self.seq2slate_net = seq2slate_net.to(self.device)
        self.params = params
        self.policy_opt = make_optimizer(policy_optimizer)
        self.calc_cpe = calc_cpe
        self.reward_network = (None if reward_network is None
                               else reward_network.to(self.device))
        self.reward_params = reward_params

    def init(self, generator: torch.Generator) -> Seq2SlateTFTrainerState:
        self.seq2slate_net.reset_parameters(generator)
        return self.state_from_networks()

    def state_from_networks(self) -> Seq2SlateTFTrainerState:
        policy_params = self.seq2slate_net.params_for(
            Seq2SlateMode.PER_SYMBOL_LOG_PROB_DIST_MODE)
        return Seq2SlateTFTrainerState(
            policy_params=policy_params, policy_opt_state=self.policy_opt.init(policy_params),
            step=torch.zeros((), dtype=torch.int32, device=self.device))

    def validation_step(self, state: Seq2SlateTFTrainerState,
                        batch: rlt.PreprocessedRankingInput, reward_params: Any = None):
        """Reference seq2slate_tf_trainer.py:100-137 (no baseline)."""
        return seq2slate_validation_step(
            self.seq2slate_net, state.policy_params, batch, calc_cpe=self.calc_cpe,
            reward_network=self.reward_network,
            reward_params=reward_params if reward_params is not None else self.reward_params)

    def train_step(
        self, state: Seq2SlateTFTrainerState, batch: rlt.PreprocessedRankingInput
    ) -> Tuple[Seq2SlateTFTrainerState, Dict[str, Tensor]]:
        if batch.optim_tgt_out_idx is None:
            raise ValueError("teacher forcing needs optim_tgt_out_idx")
        C = batch.src_seq.float_features.shape[1] + 2
        labels = F.one_hot(batch.optim_tgt_out_idx.to(torch.int64), C).to(torch.float32)

        def loss_fn(pp):
            log_probs = functional.apply(
                self.seq2slate_net, pp, Seq2SlateMode.PER_SYMBOL_LOG_PROB_DIST_MODE.value,
                batch.state.float_features, batch.src_seq.float_features,
                tgt_in_idx=batch.optim_tgt_in_idx, tgt_out_idx=batch.optim_tgt_out_idx,
                tgt_in_seq=batch.optim_tgt_in_seq.float_features,
            ).per_symbol_log_probs
            # batchmean KL to the one-hot target == the label's mean NLL
            return -torch.mean(torch.sum(labels * log_probs, dim=(1, 2)))

        loss, grads, _ = functional.value_and_grad(loss_fn, state.policy_params)
        with torch.no_grad():
            params, opt_state = self.policy_opt.update(
                grads, state.policy_opt_state, state.policy_params)
        return Seq2SlateTFTrainerState(policy_params=params, policy_opt_state=opt_state,
                                       step=state.step + 1), {"kl_loss": loss}


class Seq2SlateSimulationTrainer:
    """On-policy training against a reward-model simulator (reference
    seq2slate_sim_trainer.py:62-200): rank with the current policy (a
    sampled rank), score the ranked slates with the reward model, then take
    the policy-gradient step as if they had been logged."""

    def __init__(
        self,
        seq2slate_net: nn.Module,
        reward_net: nn.Module,
        reward_params: Any,
        params: Seq2SlateParameters = Seq2SlateParameters(),
        policy_optimizer: Any = None,
        baseline_net: Optional[nn.Module] = None,
        device="cuda",
    ):
        self.trainer = Seq2SlateTrainer(
            seq2slate_net, params=params, baseline_net=baseline_net,
            policy_optimizer=policy_optimizer, device=device)
        self.device = self.trainer.device
        self.seq2slate_net = self.trainer.seq2slate_net
        self.reward_net = reward_net.to(self.device)
        self.reward_params = reward_params

    def init(self, generator: torch.Generator):
        return self.trainer.init(generator)

    def state_from_networks(self):
        return self.trainer.state_from_networks()

    def validation_step(self, state, batch: rlt.PreprocessedRankingInput):
        """Seq2SlateTrainer's, with the simulator's reward model as the CPE
        reward network (calc_cpe always on), as the reference's subclass."""
        return seq2slate_validation_step(
            self.seq2slate_net, state.policy_params, batch,
            baseline_net=self.trainer.baseline_net, baseline_params=state.baseline_params,
            calc_cpe=True, reward_network=self.reward_net, reward_params=self.reward_params)

    def train_step(self, state, batch: rlt.PreprocessedRankingInput,
                   gumbel: Optional[Tensor] = None,
                   generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            out = functional.apply(
                self.seq2slate_net, state.policy_params, Seq2SlateMode.RANK_MODE.value,
                batch.state.float_features, batch.src_seq.float_features,
                tgt_seq_len=batch.tgt_out_idx.shape[1], greedy=False, gumbel=gumbel,
                generator=generator)
            ranked_idx = out.ranked_tgt_out_idx
            B = ranked_idx.shape[0]
            src = batch.src_seq.float_features
            cand = torch.cat([torch.zeros((B, 2, src.shape[2]), dtype=src.dtype,
                                          device=src.device), src], dim=1)
            tgt_in = torch.cat([torch.ones((B, 1), dtype=ranked_idx.dtype,
                                           device=ranked_idx.device), ranked_idx[:, :-1]], dim=1)

            def gather(idx):
                return torch.gather(cand, 1, idx[:, :, None].expand(-1, -1, cand.shape[2]))

            sim_batch = batch.replace(
                tgt_out_idx=ranked_idx, tgt_in_idx=tgt_in,
                tgt_in_seq=rlt.FeatureData(float_features=gather(tgt_in)),
                tgt_out_seq=rlt.FeatureData(float_features=gather(ranked_idx)),
                tgt_out_probs=out.ranked_per_seq_probs)
            sim_reward = functional.apply(self.reward_net, self.reward_params, sim_batch)
            sim_batch = sim_batch.replace(slate_reward=sim_reward)
        return self.trainer.train_step(state, sim_batch)
