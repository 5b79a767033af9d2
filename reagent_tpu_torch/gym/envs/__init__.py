"""Functional environments (the online loops' device-resident envs) and the
host gymnasium adapter ``Gym`` (registered in ``ENVS``)."""

from reagent_tpu_torch.gym.envs.functional import (
    CartPole,
    FunctionalEnv,
    FunctionalEnvState,
    Pendulum,
    where_state,
)
from reagent_tpu_torch.gym.envs.gym_env import Gym

__all__ = ["CartPole", "FunctionalEnv", "FunctionalEnvState", "Gym", "Pendulum", "where_state"]
