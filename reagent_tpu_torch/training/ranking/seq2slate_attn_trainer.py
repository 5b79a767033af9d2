"""Seq2Slate pairwise-attention trainer: encoder-only supervised ranking.

Port of ``reagent_tpu/training/ranking/seq2slate_attn_trainer.py`` (:34;
reference reagent/training/ranking/seq2slate_attn_trainer.py:26-157): no
decoder; the encoder scores each slate position and trains with a KL loss
against the observed position rewards (https://arxiv.org/pdf/1904.06813.pdf).
The evaluation computes DCG, NDCG, MAP and AUC of the ranked slate against
the logged one (scikit-learn, imported where they are computed).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.models.seq2slate import Seq2SlateMode
from reagent_tpu_torch.optim import OptState, make_optimizer
from reagent_tpu_torch.training import functional
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class Seq2SlatePairwiseAttnTrainerState:
    params: Dict[str, Tensor]
    opt_state: OptState
    step: Tensor


def _kl_to_position_reward(encoder_scores: Tensor, target: Tensor) -> Tensor:
    """KLDivLoss(batchmean): sum target * (log target - log pred) / B."""
    log_pred = torch.log_softmax(encoder_scores, dim=1)
    safe_log_t = torch.where(target > 0, torch.log(torch.clamp(target, min=1e-20)), 0.0)
    return torch.sum(target * (safe_log_t - log_pred)) / target.shape[0]


class Seq2SlatePairwiseAttnTrainer:
    def __init__(self, seq2slate_net: nn.Module, slate_size: int, calc_cpe: bool = False,
                 policy_optimizer: Any = None, device="cuda") -> None:
        self.device = resolve_device(device)
        self.seq2slate_net = seq2slate_net.to(self.device)
        self.slate_size = slate_size
        self.calc_cpe = calc_cpe
        self.policy_opt = make_optimizer(policy_optimizer)

    def init(self, generator: torch.Generator) -> Seq2SlatePairwiseAttnTrainerState:
        self.seq2slate_net.reset_parameters(generator)
        return self.state_from_networks()

    def state_from_networks(self) -> Seq2SlatePairwiseAttnTrainerState:
        params = self.seq2slate_net.params_for(Seq2SlateMode.ENCODER_SCORE_MODE)
        return Seq2SlatePairwiseAttnTrainerState(
            params=params, opt_state=self.policy_opt.init(params),
            step=torch.zeros((), dtype=torch.int32, device=self.device))

    def _encoder_scores(self, params, batch: rlt.PreprocessedRankingInput) -> Tensor:
        return functional.apply(
            self.seq2slate_net, params, Seq2SlateMode.ENCODER_SCORE_MODE.value,
            batch.state.float_features, batch.src_seq.float_features,
            tgt_out_idx=batch.tgt_out_idx).encoder_scores

    def train_step(
        self, state: Seq2SlatePairwiseAttnTrainerState, batch: rlt.PreprocessedRankingInput
    ) -> Tuple[Seq2SlatePairwiseAttnTrainerState, Dict[str, Tensor]]:
        loss, grads, _ = functional.value_and_grad(
            lambda p: _kl_to_position_reward(self._encoder_scores(p, batch),
                                             batch.position_reward),
            state.params)
        with torch.no_grad():
            params, opt_state = self.policy_opt.update(grads, state.opt_state, state.params)
        return (Seq2SlatePairwiseAttnTrainerState(params=params, opt_state=opt_state,
                                                  step=state.step + 1),
                {"train_cross_entropy_loss": loss})

    # ------------------------------------------------------------- evaluate

    def validation_metrics(self, state: Seq2SlatePairwiseAttnTrainerState,
                           batch: rlt.PreprocessedRankingInput) -> Dict[str, float]:
        """NDCG, DCG, MAP and AUC of the ranked against the logged slates
        (ref :78-157); the greedy rank takes no draws."""
        from sklearn.metrics import (
            average_precision_score,
            dcg_score,
            ndcg_score,
            roc_auc_score,
        )

        with torch.no_grad():
            ce_loss = float(_kl_to_position_reward(self._encoder_scores(state.params, batch),
                                                   batch.position_reward))
            out = functional.apply(
                self.seq2slate_net, state.params, Seq2SlateMode.RANK_MODE.value,
                batch.state.float_features, batch.src_seq.float_features,
                tgt_seq_len=self.slate_size, greedy=True)
        ranked_idx = out.ranked_tgt_out_idx.cpu().numpy() - 2
        logged_idx = batch.tgt_out_idx.cpu().numpy() - 2
        position_reward = batch.position_reward.cpu().numpy()
        score_bar = np.arange(self.slate_size, 0, -1)

        dcgs, ndcgs, maps, aucs = [], [], [], []
        base_dcgs, base_ndcgs, base_maps, base_aucs = [], [], [], []
        for i in range(position_reward.shape[0]):
            labels = position_reward[i].astype(bool)
            if not labels.any() or labels.all():
                continue
            ranked_scores = np.zeros(self.slate_size)
            ranked_scores[ranked_idx[i]] = score_bar
            truth_scores = np.zeros(self.slate_size)
            truth_scores[logged_idx[i]] = position_reward[i]
            base_scores = np.zeros(self.slate_size)
            base_scores[logged_idx[i]] = score_bar
            maps.append(average_precision_score(truth_scores, ranked_scores))
            base_maps.append(average_precision_score(truth_scores, base_scores))
            aucs.append(roc_auc_score(truth_scores, ranked_scores))
            base_aucs.append(roc_auc_score(truth_scores, base_scores))
            t2, r2, b2 = truth_scores[None], ranked_scores[None], base_scores[None]
            dcgs.append(dcg_score(t2, r2))
            ndcgs.append(ndcg_score(t2, r2))
            base_dcgs.append(dcg_score(t2, b2))
            base_ndcgs.append(ndcg_score(t2, b2))

        def mean(xs):
            return float(np.mean(xs)) if xs else float("nan")

        return {
            "eval_cross_entropy_loss": ce_loss,
            "eval_dcg": mean(dcgs),
            "eval_ndcg": mean(ndcgs),
            "eval_mean_ap": mean(maps),
            "eval_auc": mean(aucs),
            "eval_base_dcg": mean(base_dcgs),
            "eval_base_ndcg": mean(base_ndcgs),
            "eval_base_map": mean(base_maps),
            "eval_base_auc": mean(base_aucs),
        }
