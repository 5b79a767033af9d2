"""Functional environments (the online loops' device-resident envs), the
slate envs, the host envs (``Gym``, ``ToyVMEnv``), and ``build_env`` over the
``ENVS`` registry (port of ``reagent_tpu/gym/envs/__init__.py``, :29-36:
every member of the JAX union)."""

from reagent_tpu_torch.core.registry import ENVS
from reagent_tpu_torch.gym.envs.extra import (
    ChangingArms,
    LinDyna,
    OpenGridworld,
    RecSimSlate,
    StringGame,
    StringGameV1,
)
from reagent_tpu_torch.gym.envs.functional import (
    CartPole,
    FunctionalEnv,
    FunctionalEnvState,
    Pendulum,
    where_state,
)
from reagent_tpu_torch.gym.envs.functionality import PossibleActionsMaskTester
from reagent_tpu_torch.gym.envs.gym_env import Gym
from reagent_tpu_torch.gym.envs.oracle_pvm import OraclePVM
from reagent_tpu_torch.gym.envs.pomdp import PocManEnv, ToyVMEnv
from reagent_tpu_torch.gym.envs.recsim import RecSimInterestEvolution
from reagent_tpu_torch.gym.envs.state_embed import StateEmbedEnv

# YAML-selectable env union (reference gym/envs/__init__.py:21-67 Env__Union):
# every env registers under its class name; ``Gym`` registers in gym_env.py
for _env_cls in (
    CartPole, Pendulum, LinDyna, OpenGridworld, StringGame, StringGameV1,
    ChangingArms, RecSimSlate, RecSimInterestEvolution, PocManEnv, ToyVMEnv,
    OraclePVM, StateEmbedEnv, PossibleActionsMaskTester,
):
    if _env_cls.__name__ not in ENVS.members():
        ENVS.register()(_env_cls)


def build_env(config):
    """An env from a tagged-union config, e.g. ``{"CartPole": {"device":
    "cpu"}}`` (reference gym/envs/__init__.py:21-67 ``Env__Union``); the
    device-resident envs are on ``"cuda"`` unless ``device`` says otherwise."""
    return ENVS.build(config)


__all__ = [
    "build_env",
    "CartPole",
    "ChangingArms",
    "FunctionalEnv",
    "FunctionalEnvState",
    "Gym",
    "LinDyna",
    "OpenGridworld",
    "OraclePVM",
    "Pendulum",
    "PocManEnv",
    "PossibleActionsMaskTester",
    "RecSimInterestEvolution",
    "RecSimSlate",
    "StateEmbedEnv",
    "StringGame",
    "StringGameV1",
    "ToyVMEnv",
    "where_state",
]
