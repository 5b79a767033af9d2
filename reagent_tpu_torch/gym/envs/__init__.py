"""Functional environments (the online loops' device-resident envs)."""

from reagent_tpu_torch.gym.envs.functional import (
    CartPole,
    FunctionalEnv,
    FunctionalEnvState,
    where_state,
)

__all__ = ["CartPole", "FunctionalEnv", "FunctionalEnvState", "where_state"]
