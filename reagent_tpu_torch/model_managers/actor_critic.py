"""Actor-critic model managers: SAC and TD3 (continuous control).

Port of ``reagent_tpu/model_managers/actor_critic.py:40-248`` (reference:
reagent/model_managers/actor_critic_base.py — state and action feature
identification, ``PolicyNetworkInput`` batch preprocessing, the actor as the
serving artifact — and actor_critic/{sac.py:36-131, td3.py:33-122}, the net
builder unions wired into the trainers).  The reporter is an
``ActorCriticReporter`` (SAC) or a ``TD3Reporter``; the JAX managers have
none (``ROADMAP.md`` §3).
"""

from __future__ import annotations

import dataclasses
import types
from typing import Any, Dict, Optional

import pandas as pd

import reagent_tpu_torch.net_builder  # noqa: F401 — registers net builders
from reagent_tpu_torch.core.parameters import (
    NormalizationData,
    NormalizationKey,
    RLParameters,
)
from reagent_tpu_torch.core.registry import (
    CONTINUOUS_ACTOR_NET_BUILDERS,
    MODEL_MANAGERS,
    PARAMETRIC_DQN_NET_BUILDERS,
    VALUE_NET_BUILDERS,
)
from reagent_tpu_torch.model_managers.model_manager import ModelManager, identify_dense
from reagent_tpu_torch.preprocessing.batch_preprocessor import PolicyNetworkBatchPreprocessor
from reagent_tpu_torch.preprocessing.normalization import get_num_output_features
from reagent_tpu_torch.preprocessing.postprocessor import Postprocessor
from reagent_tpu_torch.preprocessing.preprocessor import Preprocessor
from reagent_tpu_torch.reporting.reporters import ActorCriticReporter, TD3Reporter
from reagent_tpu_torch.training.sac_trainer import SACTrainer
from reagent_tpu_torch.training.td3_trainer import TD3Trainer
from reagent_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class ActorCriticBase(ModelManager):
    """Shared plumbing for continuous-control managers (ref actor_critic_base.py:60-280)."""

    trainer_param: Dict[str, Any] = dataclasses.field(default_factory=dict)
    actor_net_builder: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"GaussianFullyConnected": {}}
    )
    critic_net_builder: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"FullyConnected": {}}
    )
    # actions are raw continuous vectors; don't renormalize them by default
    preprocess_actions: bool = False

    def __post_init__(self):
        tp = dict(self.trainer_param)
        self.rl_parameters = RLParameters(**dict(tp.get("rl", {}) or {}))
        self._tp = tp
        # train_workflow reads manager._param.minibatch_size
        self._param = types.SimpleNamespace(
            minibatch_size=tp.get("minibatch_size", 256), actions=[])

    # ------------------------------------------------------------- identify

    def run_feature_identification(self, df: pd.DataFrame) -> Dict[str, NormalizationData]:
        """State AND action normalization (ref actor_critic_base.py:150-180)."""
        return {
            NormalizationKey.STATE: NormalizationData(
                dense_normalization_parameters=identify_dense(df["state_features"])),
            NormalizationKey.ACTION: NormalizationData(
                dense_normalization_parameters=identify_dense(
                    df["action"], skip_preprocess=not self.preprocess_actions)),
        }

    def state_dim(self, normalization_data_map: Dict[str, NormalizationData]) -> int:
        return get_num_output_features(
            normalization_data_map[NormalizationKey.STATE].dense_normalization_parameters)

    def action_dim(self, normalization_data_map: Dict[str, NormalizationData]) -> int:
        return get_num_output_features(
            normalization_data_map[NormalizationKey.ACTION].dense_normalization_parameters)

    def build_batch_preprocessor(
        self, normalization_data_map: Dict[str, NormalizationData], device="cuda"
    ) -> PolicyNetworkBatchPreprocessor:
        device = resolve_device(device)

        def pre(key):
            return Preprocessor(
                normalization_data_map[key].dense_normalization_parameters, device=device)

        return PolicyNetworkBatchPreprocessor(
            pre(NormalizationKey.STATE), pre(NormalizationKey.ACTION), device=device)

    def _actor_and_critics(self, normalization_data_map):
        """The actor, q1 and q2 (None without ``use_2_q_functions``)."""
        sdim = self.state_dim(normalization_data_map)
        adim = self.action_dim(normalization_data_map)
        actor = CONTINUOUS_ACTOR_NET_BUILDERS.build(self.actor_net_builder).build_actor(
            None, None, state_dim=sdim, action_dim=adim)
        critic_builder = PARAMETRIC_DQN_NET_BUILDERS.build(self.critic_net_builder)
        q1 = critic_builder.build_q_network(None, None, state_dim=sdim, action_dim=adim)
        q2 = (critic_builder.build_q_network(None, None, state_dim=sdim, action_dim=adim)
              if self.use_2_q_functions else None)
        return actor, q1, q2

    def build_serving_module(self, trainer, trainer_state, normalization_data_map):
        """The actor as the serving module, on the trainer's device, with the
        action postprocessor that maps its [-1, 1] actions back to serving
        units (ref actor_critic_base.py:282)."""
        from reagent_tpu_torch.prediction.predictor_wrapper import (
            ActorPredictorWrapper,
            ActorWithPreprocessor,
        )

        state_norm = normalization_data_map[NormalizationKey.STATE]
        pre = Preprocessor(state_norm.dense_normalization_parameters, device=trainer.device)
        post = None
        action_norm = normalization_data_map.get(NormalizationKey.ACTION)
        if action_norm is not None:
            post = Postprocessor(action_norm.dense_normalization_parameters,
                                 device=trainer.device)
        return ActorPredictorWrapper(ActorWithPreprocessor(
            trainer.export_actor(trainer_state), pre, action_postprocessor=post))


@MODEL_MANAGERS.register()
@dataclasses.dataclass
class SAC(ActorCriticBase):
    """SAC manager (ref model_managers/actor_critic/sac.py:36-118).  The
    artifact serves the squashed mean action whatever ``serve_mean_policy``
    says, as the JAX manager's does."""

    value_net_builder: Optional[Dict[str, Any]] = None
    use_2_q_functions: bool = True
    serve_mean_policy: bool = True

    def get_reporter(self) -> ActorCriticReporter:
        return ActorCriticReporter()

    def build_trainer(
        self,
        normalization_data_map: Dict[str, NormalizationData],
        use_gpu: bool = False,
        device="cuda",
    ) -> SACTrainer:
        """``use_gpu`` is accepted so the JAX package's configs load; it has
        no effect — ``device`` places the trainer."""
        actor, q1, q2 = self._actor_and_critics(normalization_data_map)
        value = None
        if self.value_net_builder:
            value = VALUE_NET_BUILDERS.build(self.value_net_builder).build_value_network(
                None, state_dim=self.state_dim(normalization_data_map))
        tp = self._tp
        return SACTrainer(
            actor_network=actor,
            q1_network=q1,
            q2_network=q2,
            value_network=value,
            rl=self.rl_parameters,
            q_network_optimizer=tp.get("q_network_optimizer"),
            actor_network_optimizer=tp.get("actor_network_optimizer"),
            value_network_optimizer=tp.get("value_network_optimizer"),
            alpha_optimizer=tp.get("alpha_optimizer", "default"),
            entropy_temperature=tp.get("entropy_temperature", 0.2),
            target_entropy=tp.get("target_entropy", -1.0),
            crr_config=tp.get("crr_config"),
            device=device,
        )


@MODEL_MANAGERS.register()
@dataclasses.dataclass
class TD3(ActorCriticBase):
    """TD3 manager (ref model_managers/actor_critic/td3.py:33-110)."""

    actor_net_builder: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"FullyConnected": {}}
    )
    use_2_q_functions: bool = True

    def get_reporter(self) -> TD3Reporter:
        return TD3Reporter()

    def build_trainer(
        self,
        normalization_data_map: Dict[str, NormalizationData],
        use_gpu: bool = False,
        device="cuda",
    ) -> TD3Trainer:
        """``use_gpu`` is accepted so the JAX package's configs load; it has
        no effect — ``device`` places the trainer."""
        actor, q1, q2 = self._actor_and_critics(normalization_data_map)
        tp = self._tp
        return TD3Trainer(
            actor_network=actor,
            q1_network=q1,
            q2_network=q2,
            rl=self.rl_parameters,
            q_network_optimizer=tp.get("q_network_optimizer"),
            actor_network_optimizer=tp.get("actor_network_optimizer"),
            noise_variance=tp.get("noise_variance", 0.2),
            noise_clip=tp.get("noise_clip", 0.5),
            delayed_policy_update=tp.get("delayed_policy_update", 2),
            device=device,
        )
