"""DiscreteDQN model manager.

Port of ``reagent_tpu/model_managers/discrete_dqn.py``: builds the q-network
from the net-builder union, the trainer, the batch preprocessor and the
serving artifact.  With ``trainer_param.use_fused_kernel: true`` the trainer
is ``FusedDQNTrainer`` (K1 above 512 rows, else K2), otherwise ``DQNTrainer``,
with the reward and CPE Q heads from ``cpe_net_builder`` when
``eval_parameters.calc_cpe_in_training`` is set (the fused trainer has no
CPE heads and refuses them).  The reporter is a ``DiscreteDQNReporter``
over the action names, so the unfused trainer emits its per-sample reporter
arrays, as the JAX manager's does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Union

import pandas as pd

import reagent_tpu_torch.net_builder  # noqa: F401 — registers net builders
from reagent_tpu_torch.core.parameters import (
    EvaluationParameters,
    NormalizationData,
    NormalizationKey,
    RLParameters,
)
from reagent_tpu_torch.core.registry import DISCRETE_DQN_NET_BUILDERS, MODEL_MANAGERS
from reagent_tpu_torch.model_managers.model_manager import ModelManager, identify_dense
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.preprocessing.batch_preprocessor import DiscreteDqnBatchPreprocessor
from reagent_tpu_torch.preprocessing.normalization import get_num_output_features
from reagent_tpu_torch.preprocessing.preprocessor import Preprocessor
from reagent_tpu_torch.reporting.reporters import DiscreteDQNReporter
from reagent_tpu_torch.training.dqn_trainer import DQNTrainer
from reagent_tpu_torch.training.fused_dqn_trainer import FusedDQNTrainer
from reagent_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class DQNTrainerParam:
    """Mirrors the reference's trainer_param block for DiscreteDQN."""

    actions: List[str] = dataclasses.field(default_factory=list)
    rl: Dict[str, Any] = dataclasses.field(default_factory=dict)
    double_q_learning: bool = True
    minibatch_size: int = 512
    minibatches_per_step: int = 1
    optimizer: Dict[str, Any] = dataclasses.field(default_factory=lambda: {"Adam": {"lr": 1e-3}})
    use_fused_kernel: bool = False
    block_size: Any = None  # the TPU kernel's row block; checked, see ops/fused_dqn_offline.py


@MODEL_MANAGERS.register()
@dataclasses.dataclass
class DiscreteDQN(ModelManager):
    trainer_param: Dict[str, Any] = dataclasses.field(default_factory=dict)
    net_builder: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"FullyConnected": {}}
    )
    cpe_net_builder: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"FullyConnected": {}}
    )
    eval_parameters: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        tp = dict(self.trainer_param)
        rl_kwargs = dict(tp.get("rl", {}) or {})
        self._param = DQNTrainerParam(
            actions=[str(a) for a in tp.get("actions", [])],
            rl=rl_kwargs,
            double_q_learning=tp.get("double_q_learning", True),
            minibatch_size=tp.get("minibatch_size", 512),
            optimizer=tp.get("optimizer", {"Adam": {"lr": 1e-3}}),
            use_fused_kernel=tp.get("use_fused_kernel", False),
            block_size=tp.get("block_size"),
        )
        self.rl_parameters = RLParameters(**rl_kwargs)
        self.eval_params = EvaluationParameters(
            **{
                k: v
                for k, v in dict(self.eval_parameters).items()
                if k in {"calc_cpe_in_training"}
            }
        )

    # ------------------------------------------------------------- identify

    def run_feature_identification(self, df: pd.DataFrame) -> Dict[str, NormalizationData]:
        """Fit normalization from state_features (ref identify_types_flow.py:24)."""
        return {NormalizationKey.STATE: NormalizationData(
            dense_normalization_parameters=identify_dense(df["state_features"]))}

    # ---------------------------------------------------------------- build

    @property
    def action_names(self) -> List[str]:
        return self._param.actions

    def get_reporter(self) -> DiscreteDQNReporter:
        return DiscreteDQNReporter(actions=list(self._param.actions))

    def build_trainer(
        self,
        normalization_data_map: Dict[str, NormalizationData],
        use_gpu: bool = False,
        device="cuda",
    ) -> Union[DQNTrainer, FusedDQNTrainer]:
        """``use_gpu`` is accepted so the JAX package's configs load; it has
        no effect — ``device`` places the trainer."""
        if self.eval_params.calc_cpe_in_training and self._param.use_fused_kernel:
            raise ValueError(
                "use_fused_kernel does not support CPE heads; set "
                "eval_parameters.calc_cpe_in_training: false"
            )
        state_norm = normalization_data_map[NormalizationKey.STATE]
        num_actions = len(self._param.actions)
        builder = DISCRETE_DQN_NET_BUILDERS.build(self.net_builder)
        q_network = builder.build_q_network(state_norm, output_dim=num_actions)
        if not self._param.use_fused_kernel:
            reward_network = q_network_cpe = None
            if self.eval_params.calc_cpe_in_training:
                cpe_builder = DISCRETE_DQN_NET_BUILDERS.build(self.cpe_net_builder)
                reward_network = cpe_builder.build_q_network(state_norm, output_dim=num_actions)
                q_network_cpe = cpe_builder.build_q_network(state_norm, output_dim=num_actions)
            return DQNTrainer(
                emit_reporter_arrays=True,
                q_network=q_network,
                rl=self.rl_parameters,
                double_q_learning=self._param.double_q_learning,
                optimizer=self._param.optimizer,
                action_names=tuple(self._param.actions),
                reward_network=reward_network,
                q_network_cpe=q_network_cpe,
                device=device,
            )
        B = self._param.minibatch_size
        block = self._param.block_size
        if block is None and B > 512:
            block = 512  # the offline-sized batch goes to K1
        return FusedDQNTrainer(
            q_network=q_network,
            rl=self.rl_parameters,
            double_q_learning=self._param.double_q_learning,
            optimizer=self._param.optimizer,
            minibatch_size=B,
            block_size=block,
            device=device,
        )

    def build_batch_preprocessor(
        self, normalization_data_map: Dict[str, NormalizationData], device="cuda"
    ) -> DiscreteDqnBatchPreprocessor:
        device = resolve_device(device)
        state_norm = normalization_data_map[NormalizationKey.STATE]
        return DiscreteDqnBatchPreprocessor(
            num_actions=len(self._param.actions),
            state_preprocessor=Preprocessor(
                state_norm.dense_normalization_parameters, device=device),
            action_names=self._param.actions,
            device=device,
        )

    def state_dim(self, normalization_data_map: Dict[str, NormalizationData]) -> int:
        return get_num_output_features(
            normalization_data_map[NormalizationKey.STATE].dense_normalization_parameters
        )

    def build_serving_module(self, trainer, trainer_state, normalization_data_map):
        """The serving module, on the trainer's device, with the q-network's
        true activations in its manifest (the JAX manager writes relu for
        every hidden layer; see ROADMAP.md §3)."""
        from reagent_tpu_torch.prediction.predictor_wrapper import (
            DiscreteDqnPredictorWrapper,
            DiscreteDqnWithPreprocessor,
        )

        q_network = trainer.export_q_network(trainer_state)
        if not isinstance(q_network, FullyConnectedDQN):
            raise ValueError(
                "the manifest.json + weights.bin artifact holds a flat MLP; a "
                f"{type(q_network).__name__} cannot be exported through it"
            )
        state_norm = normalization_data_map[NormalizationKey.STATE]
        pre = Preprocessor(state_norm.dense_normalization_parameters, device=trainer.device)
        wrapped = DiscreteDqnWithPreprocessor(q_network, pre)
        return DiscreteDqnPredictorWrapper(
            wrapped, self._param.actions, activations=q_network.activations
        )
