"""Host gymnasium adapter.

Port of ``reagent_tpu/gym/envs/gym_env.py`` (reference:
reagent/gym/envs/gym.py:24, the ``Gym`` EnvWrapper), for the batch-RL
pipeline's collection and evaluation and for envs without a functional
implementation; the online loops' fast path is ``functional.py``.
``gymnasium`` is imported when an env is made, not with this module.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from reagent_tpu_torch.core.registry import ENVS


@ENVS.register()
class Gym:
    def __init__(self, env_name: str, set_max_steps: Optional[int] = None, **kwargs: Any):
        import gymnasium

        self.env_name = env_name
        self.env = gymnasium.make(env_name, max_episode_steps=set_max_steps, **kwargs)

    @property
    def observation_space(self):
        return self.env.observation_space

    @property
    def action_space(self):
        return self.env.action_space

    def reset(self, seed: Optional[int] = None):
        obs, _info = self.env.reset(seed=seed)
        return np.asarray(obs, dtype=np.float32)

    def step(self, action):
        obs, reward, terminated, truncated, _info = self.env.step(action)
        return (
            np.asarray(obs, dtype=np.float32),
            float(reward),
            bool(terminated or truncated),
        )

    def close(self):
        self.env.close()
