"""SlateQ trainer: the slate decomposition of Q-learning for recommenders.

Port of ``reagent_tpu/training/slate_q_trainer.py`` (``SlateQTrainer``,
``NextSlateValueNormMethod``, ``_maxq_topk_next_action`` :98, ``train_step``
:109; reference reagent/training/slate_q_trainer.py:35-280, SlateQ, Ie et
al. 2019): Q(s, slate) decomposes into per-item Q(s, d) weighted by the
user-choice model (a softmax over the docs' values); the next slate is the
top k of the target item-Qs, or the logged one.

The top k is a stable descending sort cut to the slate: ``jax.lax.top_k``
returns the lower index first on ties, which ``torch.topk`` on the card does
not promise.  ``train_step`` reads no value on the host and leaves the state
it was given untouched.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import RLParameters
from reagent_tpu_torch.optim import OptState, make_optimizer, soft_update
from reagent_tpu_torch.training import functional
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


class NextSlateValueNormMethod(enum.Enum):
    NORM_BY_CURRENT_SLATE_SIZE = "norm_by_current_slate_size"
    NORM_BY_NEXT_SLATE_SIZE = "norm_by_next_slate_size"


@dataclasses.dataclass
class SlateQTrainerState:
    q_params: Dict[str, Tensor]
    q_target_params: Dict[str, Tensor]
    opt_state: OptState
    step: Tensor  # int32 scalar on the device


def stable_top_k(scores: Tensor, k: int) -> Tensor:
    """The indices of the ``k`` largest scores of each row, the lower index
    first on ties (``jax.lax.top_k``'s order)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


class SlateQTrainer:
    """``q_network`` is a parametric critic: (state [B, S], doc [B, D]) ->
    [B, 1].  ``device`` defaults to ``"cuda"`` and raises if no card is
    present."""

    def __init__(
        self,
        q_network: nn.Module,
        slate_size: int,
        rl: RLParameters = RLParameters(maxq_learning=False),
        optimizer: Any = None,
        single_selection: bool = True,
        next_slate_value_norm_method: NextSlateValueNormMethod = (
            NextSlateValueNormMethod.NORM_BY_CURRENT_SLATE_SIZE
        ),
        discount_time_scale: Optional[float] = None,
        emit_reporter_arrays: bool = False,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.emit_reporter_arrays = emit_reporter_arrays
        self.q_network = q_network.to(self.device)
        self.slate_size = slate_size
        self.rl = rl
        self.gamma = rl.gamma
        self.tau = rl.target_update_rate
        self.maxq_learning = rl.maxq_learning
        self.optimizer = make_optimizer(optimizer)
        self.single_selection = single_selection
        self.next_slate_value_norm_method = next_slate_value_norm_method
        self.discount_time_scale = discount_time_scale

    def init(self, generator: torch.Generator) -> SlateQTrainerState:
        """Draw fresh weights from ``generator`` and build the state."""
        self.q_network.reset_parameters(generator)
        return self.state_from_networks()

    def state_from_networks(self) -> SlateQTrainerState:
        """The training state for the network's current weights (target a
        copy, a fresh optimizer state)."""
        q_params = functional.params_of(self.q_network)
        return SlateQTrainerState(
            q_params=q_params,
            q_target_params={k: v.clone() for k, v in q_params.items()},
            opt_state=self.optimizer.init(q_params),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    # -- helpers (reference slate_q_trainer.py:107-185) ---------------------

    def _item_q_values(self, params, state: rlt.FeatureData, docs: rlt.DocList) -> Tensor:
        """Per-item Q(s, d): [B, K], each state repeated in place."""
        B, K, D = docs.float_features.shape
        tiled_state = state.float_features.repeat_interleave(K, dim=0)
        q = functional.apply(self.q_network, params, tiled_state,
                             docs.float_features.reshape(B * K, D))
        return q.reshape(B, K)

    def _docs_value(self, docs: rlt.DocList) -> Tensor:
        value = docs.value * docs.mask
        if self.single_selection:
            value = torch.softmax(value, dim=1)
        return value

    def _slate_size_of(self, state: rlt.FeatureData) -> Tensor:
        mask = state.candidate_docs.mask
        return torch.clamp(mask.sum(dim=1, keepdim=True), max=float(self.slate_size))

    def _maxq_topk_next_action(self, tstate: SlateQTrainerState,
                               next_state: rlt.FeatureData) -> Tensor:
        docs = next_state.candidate_docs
        q = self._item_q_values(tstate.q_target_params, next_state, docs)
        return stable_top_k(q * self._docs_value(docs), self.slate_size)

    # -- train step ---------------------------------------------------------

    def train_step(
        self, state: SlateQTrainerState, batch: rlt.SlateQInput
    ) -> Tuple[SlateQTrainerState, Dict[str, Tensor]]:
        reward = batch.reward  # [B, slate]
        with torch.no_grad():
            reward_mask = batch.reward_mask.to(torch.float32)
            not_terminal = batch.not_terminal.to(torch.float32)
            if self.discount_time_scale is not None:
                discount = self.gamma ** (
                    batch.time_diff.to(torch.float32) / self.discount_time_scale)
            else:
                discount = torch.full_like(reward, self.gamma)

            if self.maxq_learning:
                next_action = self._maxq_topk_next_action(state, batch.next_state)
            else:
                next_action = batch.next_action
            # index 0 on terminal rows, so the gathers stay in bounds
            next_action = torch.where(not_terminal.reshape(-1, 1) > 0, next_action,
                                      torch.zeros_like(next_action))
            next_docs = batch.next_state.candidate_docs.select_slate(next_action)
            next_q = torch.sum(
                self._item_q_values(state.q_target_params, batch.next_state, next_docs)
                * self._docs_value(next_docs),
                dim=1, keepdim=True)
            if not self.single_selection:
                if (self.next_slate_value_norm_method
                        == NextSlateValueNormMethod.NORM_BY_NEXT_SLATE_SIZE):
                    next_q = next_q / self._slate_size_of(batch.next_state)
                else:
                    next_q = next_q / self._slate_size_of(batch.state)
            target_q = reward + discount * (next_q * not_terminal)
            action_docs = batch.state.candidate_docs.select_slate(batch.action)

        def loss_fn(params):
            q = self._item_q_values(params, batch.state, action_docs)  # [B, slate]
            if self.single_selection:
                # masked MSE over the positions with an observed reward
                err = (q - target_q) ** 2 * reward_mask
                loss = torch.sum(err) / torch.clamp(torch.sum(reward_mask), min=1.0)
            else:
                loss = torch.mean((q - target_q) ** 2)
            return loss, q.detach().mean()

        value_loss, grads, q_mean = functional.value_and_grad(
            loss_fn, state.q_params, has_aux=True)
        with torch.no_grad():
            q_params, opt_state = self.optimizer.update(grads, state.opt_state, state.q_params)
            new_state = SlateQTrainerState(
                q_params=q_params,
                q_target_params=soft_update(q_params, state.q_target_params, self.tau),
                opt_state=opt_state,
                step=state.step + 1,
            )
        metrics = {"td_loss": value_loss, "q_mean": q_mean}
        if self.emit_reporter_arrays:
            # the reporter's recent-window and histogram array (reference
            # slate_q_reporter.py:35-52 "logged_rewards")
            metrics["logged_rewards"] = reward.reshape(-1)
        return new_state, metrics
