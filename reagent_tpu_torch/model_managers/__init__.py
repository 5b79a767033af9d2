"""Model managers: per-algorithm orchestration (the port's part of
``reagent_tpu/model_managers/``); importing the package registers them."""

from reagent_tpu_torch.model_managers.actor_critic import SAC, TD3, ActorCriticBase
from reagent_tpu_torch.model_managers.discrete import DiscreteC51DQN, DiscreteQRDQN
from reagent_tpu_torch.model_managers.discrete_crr import DiscreteCRR
from reagent_tpu_torch.model_managers.discrete_dqn import DiscreteDQN
from reagent_tpu_torch.model_managers.model_based import CrossEntropyMethod, SyntheticReward
from reagent_tpu_torch.model_managers.model_manager import ModelManager
from reagent_tpu_torch.model_managers.parametric_dqn import ParametricDQN
from reagent_tpu_torch.model_managers.policy_gradient import PPO, Reinforce
from reagent_tpu_torch.model_managers.slate_q import SlateQ
from reagent_tpu_torch.model_managers.world_model import Seq2RewardModel, WorldModel

__all__ = [
    "ModelManager",
    "DiscreteDQN",
    "DiscreteCRR",
    "SAC",
    "TD3",
    "ActorCriticBase",
    "DiscreteQRDQN",
    "DiscreteC51DQN",
    "ParametricDQN",
    "PPO",
    "Reinforce",
    "SlateQ",
    "WorldModel",
    "Seq2RewardModel",
    "CrossEntropyMethod",
    "SyntheticReward",
]
