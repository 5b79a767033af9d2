"""Functionality-test envs.

Port of ``reagent_tpu/gym/envs/functionality.py`` (``MaskTesterState``,
``PossibleActionsMaskTester``, :22-70; reference reagent/gym/envs/
functionality/possible_actions_mask_tester.py): the state encodes only the
step index, and the one signal of which action pays 10 is the possible
actions mask (one legal action a step).  MDP value = 10 * max_steps = 200.

``reset_noise`` and ``step_noise``: the next legal action, an integer in
[0, action_num) (JAX's ``randint``), one per env.  Takes a leading batch
dimension.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from reagent_tpu_torch.gym.envs.functional import FunctionalEnv
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class MaskTesterState:
    step_idx: Tensor
    legal_action: Tensor
    t: Tensor


class PossibleActionsMaskTester(FunctionalEnv):
    discrete = True

    def __init__(self, max_steps: int = 20, action_num: int = 4, device="cuda"):
        self.max_steps = max_steps
        self.action_num = action_num
        self.action_dim = action_num
        # obs = [one-hot step | possible_actions_mask]
        self.observation_dim = max_steps + action_num
        self.device = resolve_device(device)

    def _obs(self, state: MaskTesterState) -> Tensor:
        # one_hot of step_idx, all zeros once it reaches max_steps
        onehot = F.one_hot(torch.clamp(state.step_idx, max=self.max_steps).to(torch.int64),
                           self.max_steps + 1)[..., :self.max_steps].to(torch.float32)
        mask = F.one_hot(state.legal_action.to(torch.int64), self.action_num).to(torch.float32)
        return torch.cat([onehot, mask], dim=-1)

    def possible_actions_mask(self, obs: Tensor) -> Tensor:
        """The mask from an observation (its tail)."""
        return obs[..., self.max_steps:]

    def _draw(self, generator, shape) -> Tensor:
        return torch.randint(0, self.action_num, tuple(shape), generator=generator,
                             device=self.device, dtype=torch.int32)

    def reset_noise(self, generator, batch_size=None):
        return self._draw(generator, () if batch_size is None else (batch_size,))

    def step_noise(self, generator, batch_shape=()):
        return self._draw(generator, batch_shape)

    def reset(self, generator=None, batch_size=None, noise=None) -> Tuple[MaskTesterState, Tensor]:
        legal = self.reset_noise(generator, batch_size) if noise is None else noise
        legal = legal.to(device=self.device, dtype=torch.int32)
        zero = torch.zeros(legal.shape, dtype=torch.int32, device=self.device)
        state = MaskTesterState(step_idx=zero, legal_action=legal, t=zero.clone())
        return state, self._obs(state)

    def step(self, state: MaskTesterState, action: Tensor, generator=None, noise=None):
        legal = self.step_noise(generator, state.step_idx.shape) if noise is None else noise
        reward = torch.where(action.to(torch.int32) == state.legal_action, 10.0, 0.0)
        done = state.step_idx == (self.max_steps - 1)
        new_state = MaskTesterState(
            step_idx=state.step_idx + 1,
            legal_action=legal.to(device=self.device, dtype=torch.int32),
            t=state.t + 1,
        )
        return new_state, self._obs(new_state), reward, done
