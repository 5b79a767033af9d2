"""Serving wrappers of the world-model and counterfactual-scorer networks.

Port of ``reagent_tpu/prediction/world_model_wrappers.py``
(``Seq2RewardWithPreprocessor`` :28, ``Seq2RewardPlanShortSeqWithPreprocessor``
:52, ``CompressModelWithPreprocessor`` :90, ``MDNRNNWithPreprocessor`` :108,
``BinaryDifferenceScorerWithPreprocessor`` :141,
``BinaryDifferenceScorerPredictorWrapper`` :160,
``LearnVMSlateWithPreprocessor`` :171; reference
reagent/prediction/predictor_wrapper.py).  Each wrapper holds (module,
params) and a state preprocessor (``(values, presence) -> normalized``) and
runs without a graph; ``params`` None runs the module's own.  The action
sequences a planner enumerates are built once, on the module's device.

The dense float32 forwards go through ``training/functional.py::score``: one
K3 launch on the card for the compress model's Q, the step model of the
short-sequence planner and the binary difference scorer, where JAX applies
the flax modules in XLA.  Any other net runs its own forward.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.models.seq2reward_model import gen_permutations, get_Q
from reagent_tpu_torch.training import functional

Tensor = torch.Tensor
Preprocessor = Callable[[Tensor, Tensor], Tensor]


def _device_of(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


class Seq2RewardWithPreprocessor:
    """Plans over every action sequence of length ``seq_len``: for each first
    action, the best accumulated reward (reference :643-684)."""

    def __init__(self, model, params, state_preprocessor: Preprocessor, seq_len: int,
                 num_action: int):
        self.model = model
        self.params = params
        self.state_preprocessor = state_preprocessor
        self.seq_len = seq_len
        self.num_action = num_action
        self.all_permut = gen_permutations(seq_len, num_action, _device_of(model))

    @torch.no_grad()
    def __call__(self, values: Tensor, presence: Tensor) -> Tensor:
        state = self.state_preprocessor(values, presence)
        return get_Q(self.model, self.params, state, self.all_permut)


class Seq2RewardPlanShortSeqWithPreprocessor:
    """Plans for every look-ahead in [1, seq_len] and weights each by the
    step model's predicted distribution of look-aheads (reference
    :687-738)."""

    def __init__(self, model, params, step_model, step_params,
                 state_preprocessor: Preprocessor, seq_len: int, num_action: int):
        self.model = model
        self.params = params
        self.step_model = step_model
        self.step_params = functional.params_of(step_model) if step_params is None else step_params
        self.state_preprocessor = state_preprocessor
        self.seq_len = seq_len
        self.num_action = num_action
        device = _device_of(model)
        self.all_permut = [gen_permutations(s + 1, num_action, device) for s in range(seq_len)]

    @torch.no_grad()
    def __call__(self, values: Tensor, presence: Tensor) -> Tensor:
        state = self.state_preprocessor(values, presence)
        step_probability = torch.softmax(
            functional.score(self.step_model, self.step_params, state), dim=1)  # [B, seq_len]
        max_acc_reward = torch.stack(
            [get_Q(self.model, self.params, state, p) for p in self.all_permut],
            dim=1)  # [B, seq_len, A]
        return torch.sum(max_acc_reward * step_probability[:, :, None], dim=1)


class CompressModelWithPreprocessor:
    """The compressed (distilled) planning Q behind the state preprocessor
    (reference :869-876)."""

    def __init__(self, model, params, state_preprocessor: Preprocessor):
        self.model = model
        self.params = functional.params_of(model) if params is None else params
        self.state_preprocessor = state_preprocessor

    @torch.no_grad()
    def __call__(self, values: Tensor, presence: Tensor) -> Tensor:
        return functional.score(self.model, self.params,
                                self.state_preprocessor(values, presence))


class MDNRNNWithPreprocessor:
    """The memory network over a flattened ``[B, seq_len * state_dim]``
    state (with presence) and an action sequence ``[T, B, A]`` (reference
    :828-866)."""

    def __init__(self, model, params, state_preprocessor: Preprocessor, seq_len: int,
                 num_action: int):
        self.model = model
        self.params = params
        self.state_preprocessor = state_preprocessor
        self.seq_len = seq_len
        self.num_action = num_action

    @torch.no_grad()
    def __call__(self, values: Tensor, presence: Tensor, action: Tensor):
        B = values.shape[0]
        state = (self.state_preprocessor(values, presence)
                 .reshape(B, self.seq_len, -1).transpose(0, 1))
        return functional.apply(self.model, self.params, rlt.FeatureData(float_features=state),
                                rlt.FeatureData(float_features=action))


class BinaryDifferenceScorerWithPreprocessor:
    """A two-logit model -> P(class 1) (reference :176-213)."""

    def __init__(self, model, params, state_preprocessor: Preprocessor):
        self.model = model
        self.params = functional.params_of(model) if params is None else params
        self.state_preprocessor = state_preprocessor

    @torch.no_grad()
    def __call__(self, values: Tensor, presence: Tensor) -> Tensor:
        logits = functional.score(self.model, self.params,
                                  self.state_preprocessor(values, presence))
        if logits.shape[1] != 2:
            raise ValueError(f"a binary difference scorer needs 2 logits, got {logits.shape}")
        return torch.softmax(logits, dim=1)[:, 1]


class BinaryDifferenceScorerPredictorWrapper:
    """The serving facade over ``BinaryDifferenceScorerWithPreprocessor``
    (reference :216-231)."""

    def __init__(self, scorer_with_preprocessor: BinaryDifferenceScorerWithPreprocessor):
        self.model = scorer_with_preprocessor

    def __call__(self, values: Tensor, presence: Tensor) -> Tensor:
        return self.model(values, presence)


class LearnVMSlateWithPreprocessor:
    """An ``MLPScorer`` over (state, candidate slate), each side behind its
    preprocessor (reference :452-492)."""

    def __init__(self, mlp, mlp_params, state_preprocessor: Preprocessor,
                 candidate_preprocessor: Preprocessor):
        self.mlp = mlp
        self.mlp_params = mlp_params
        self.state_preprocessor = state_preprocessor
        self.candidate_preprocessor = candidate_preprocessor

    @torch.no_grad()
    def __call__(self, state_vp: Tuple[Tensor, Tensor],
                 candidate_vp: Tuple[Tensor, Tensor]) -> Tensor:
        B, C, D = candidate_vp[0].shape
        state = self.state_preprocessor(*state_vp)
        cand = self.candidate_preprocessor(
            candidate_vp[0].reshape(B * C, D), candidate_vp[1].reshape(B * C, D)
        ).reshape(B, C, -1)
        feat = rlt.FeatureData(float_features=state,
                               candidate_docs=rlt.DocList(float_features=cand))
        return functional.apply(self.mlp, self.mlp_params, feat).reshape(B, C)

