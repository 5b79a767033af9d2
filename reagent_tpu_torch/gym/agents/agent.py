"""Agent: obs preprocessing -> policy -> action extraction, and episode hooks.

Port of ``reagent_tpu/gym/agents/agent.py`` (``discrete_action_extractor``,
``continuous_action_extractor``, ``Agent``, :18-73; reference
reagent/gym/agents/agent.py:20-136), for host envs (``Gym``).  The policy's
draws come from the agent's ``torch.Generator`` on its device.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from reagent_tpu_torch.gym.policies.policy import Policy
from reagent_tpu_torch.utils.device import resolve_device


def discrete_action_extractor(actor_output) -> int:
    return int(torch.argmax(actor_output.action.reshape(-1)).item())


def continuous_action_extractor(actor_output) -> np.ndarray:
    return actor_output.action.detach().cpu().numpy().reshape(-1)


class Agent:
    def __init__(
        self,
        policy: Policy,
        params_fn: Callable[[], Any],
        action_extractor: Callable = discrete_action_extractor,
        obs_preprocessor: Optional[Callable] = None,
        post_transition_callback: Optional[Callable] = None,
        post_episode_callback: Optional[Callable] = None,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        self.policy = policy
        self.params_fn = params_fn  # late-bound so training updates flow through
        self.action_extractor = action_extractor
        self.obs_preprocessor = obs_preprocessor
        self.post_transition_callback = post_transition_callback
        self.post_episode_callback = post_episode_callback
        self.device = resolve_device(device)
        self.generator = (generator if generator is not None
                          else torch.Generator(device=self.device).manual_seed(0))

    @classmethod
    def create_for_env(
        cls, env, policy: Policy, params_fn: Callable[[], Any], **kwargs
    ) -> "Agent":
        """Pick the action extractor from the env's action space (ref :58-96)."""
        import gymnasium

        if isinstance(env.action_space, gymnasium.spaces.Discrete):
            extractor = discrete_action_extractor
        else:
            extractor = continuous_action_extractor
        return cls(policy, params_fn, action_extractor=extractor, **kwargs)

    def act(self, obs) -> Any:
        x = obs if self.obs_preprocessor is None else self.obs_preprocessor(obs)
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x, np.float32)
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if x.ndim == 1:
            x = x[None, :]
        out = self.policy.act(self.params_fn(), x, self.generator)
        return self.action_extractor(out)

    def post_step(self, transition) -> None:
        if self.post_transition_callback is not None:
            self.post_transition_callback(transition)

    def post_episode(self, trajectory) -> None:
        if self.post_episode_callback is not None:
            self.post_episode_callback(trajectory)
