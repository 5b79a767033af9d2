"""Functional environments (the online loops' device-resident envs), the
host gymnasium adapter ``Gym``, and ``build_env`` over the ``ENVS`` registry
(port of ``reagent_tpu/gym/envs/__init__.py``, :39)."""

from reagent_tpu_torch.core.registry import ENVS
from reagent_tpu_torch.gym.envs.functional import (
    CartPole,
    FunctionalEnv,
    FunctionalEnvState,
    Pendulum,
    where_state,
)
from reagent_tpu_torch.gym.envs.gym_env import Gym

for _env_cls in (CartPole, Pendulum):
    if _env_cls.__name__ not in ENVS.members():
        ENVS.register()(_env_cls)

# the JAX registry's other members, not ported yet
UNPORTED_ENVS = (
    "LinDyna", "OpenGridworld", "StringGame", "StringGameV1", "ChangingArms", "RecSimSlate",
    "RecSimInterestEvolution", "PocManEnv", "ToyVMEnv", "OraclePVM", "StateEmbedEnv",
    "PossibleActionsMaskTester",
)


def build_env(config):
    """An env from a tagged-union config, e.g. ``{"CartPole": {"device":
    "cpu"}}`` (reference gym/envs/__init__.py:21-67 ``Env__Union``): the
    functional CartPole and Pendulum (on ``"cuda"`` unless ``device`` says
    otherwise) and ``Gym``."""
    name = next(iter(config)) if isinstance(config, dict) else config
    if isinstance(name, str) and name in UNPORTED_ENVS:
        raise NotImplementedError(
            f"env {name!r} is not ported yet (ROADMAP.md §1 item 7); the port has "
            f"{sorted(ENVS.members())}")
    return ENVS.build(config)


__all__ = ["CartPole", "FunctionalEnv", "FunctionalEnvState", "Gym", "Pendulum", "UNPORTED_ENVS",
           "build_env", "where_state"]
