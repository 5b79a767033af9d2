"""ParametricDQN model manager.

Port of ``reagent_tpu/model_managers/parametric_dqn.py`` (reference:
reagent/model_managers/parametric/parametric_dqn.py + parametric_dqn_base.py):
Q(s, a) over feature-vector actions.  For discrete logged actions the batch
preprocessor one-hot encodes them as action features and offers every
action as a possible one.  The serving module scores in process and writes
no artifact, as JAX's does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import pandas as pd
import torch

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import (
    NormalizationData,
    NormalizationKey,
    NormalizationParameters,
)
from reagent_tpu_torch.core.registry import MODEL_MANAGERS, PARAMETRIC_DQN_NET_BUILDERS
from reagent_tpu_torch.model_managers.discrete_dqn import DiscreteDQN
from reagent_tpu_torch.preprocessing.batch_preprocessor import DiscreteDqnBatchPreprocessor
from reagent_tpu_torch.preprocessing.identify_types import DO_NOT_PREPROCESS
from reagent_tpu_torch.preprocessing.preprocessor import Preprocessor
from reagent_tpu_torch.training.parametric_dqn_trainer import ParametricDQNTrainer
from reagent_tpu_torch.utils.device import resolve_device


class _ParametricFromDiscreteBatchPreprocessor(DiscreteDqnBatchPreprocessor):
    """Timeline rows with discrete actions -> ``ParametricDqnInput``: one-hot
    action features, and as possible actions every action, ``tile(eye(A),
    (B, 1))`` (row ``i * A + j`` is action j of row i), on the batch's
    device."""

    def __call__(self, batch_df: pd.DataFrame) -> rlt.ParametricDqnInput:
        d = super().__call__(batch_df)
        B, A = d.action.shape[0], self.num_actions
        tiled = torch.eye(A, device=self.device).repeat(B, 1)
        return rlt.ParametricDqnInput(
            state=d.state,
            next_state=d.next_state,
            action=rlt.FeatureData(float_features=d.action),
            next_action=rlt.FeatureData(float_features=d.next_action),
            possible_actions=rlt.FeatureData(float_features=tiled),
            possible_actions_mask=d.possible_actions_mask,
            possible_next_actions=rlt.FeatureData(float_features=tiled),
            possible_next_actions_mask=d.possible_next_actions_mask,
            reward=d.reward,
            time_diff=d.time_diff,
            step=d.step,
            not_terminal=d.not_terminal,
            extras=d.extras,
        )


@MODEL_MANAGERS.register()
@dataclasses.dataclass
class ParametricDQN(DiscreteDQN):
    def build_trainer(
        self,
        normalization_data_map: Dict[str, NormalizationData],
        use_gpu: bool = False,
        device="cuda",
    ) -> ParametricDQNTrainer:
        """The parametric builder named by ``net_builder``, or, where it names
        a discrete one, ``FullyConnected`` with its arguments (as JAX's);
        ``use_gpu`` has no effect — ``device`` places the trainer."""
        state_norm = normalization_data_map[NormalizationKey.STATE]
        num_actions = len(self._param.actions)
        members = PARAMETRIC_DQN_NET_BUILDERS.members()
        builder = PARAMETRIC_DQN_NET_BUILDERS.build(
            self.net_builder
            if any(k in members for k in self.net_builder)
            else {"FullyConnected": next(iter(self.net_builder.values()))}
        )
        q_network = builder.build_q_network(state_norm, None, action_dim=num_actions)
        return ParametricDQNTrainer(
            q_network=q_network,
            rl=self.rl_parameters,
            double_q_learning=self._param.double_q_learning,
            optimizer=self._param.optimizer,
            device=device,
        )

    def build_batch_preprocessor(
        self, normalization_data_map: Dict[str, NormalizationData], device="cuda"
    ) -> _ParametricFromDiscreteBatchPreprocessor:
        device = resolve_device(device)
        state_norm = normalization_data_map[NormalizationKey.STATE]
        return _ParametricFromDiscreteBatchPreprocessor(
            num_actions=len(self._param.actions),
            state_preprocessor=Preprocessor(
                state_norm.dense_normalization_parameters, device=device),
            action_names=self._param.actions,
            device=device,
        )

    def build_serving_module(self, trainer, trainer_state, normalization_data_map):
        """Q(s, a) in process, the actions' one-hot features unnormalized."""
        from reagent_tpu_torch.prediction.predictor_wrapper import (
            ParametricDqnPredictorWrapper,
            ParametricDqnWithPreprocessor,
        )

        state_norm = normalization_data_map[NormalizationKey.STATE]
        pre = Preprocessor(state_norm.dense_normalization_parameters, device=trainer.device)
        action_params = {
            i: NormalizationParameters(feature_type=DO_NOT_PREPROCESS, mean=0.0, stddev=1.0)
            for i in range(len(self._param.actions))
        }
        action_pre = Preprocessor(action_params, device=trainer.device)
        wrapped = ParametricDqnWithPreprocessor(
            trainer.export_q_network(trainer_state), pre, action_pre)
        return ParametricDqnPredictorWrapper(wrapped)
