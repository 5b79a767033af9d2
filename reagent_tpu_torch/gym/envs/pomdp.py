"""POMDP benchmark environments.

Port of ``reagent_tpu/gym/envs/pomdp.py`` (``PocManState``, ``PocManEnv``
:42-117, ``Document``, ``simulate_reward``, ``random_document`` and
``ToyVMEnv`` :120-189; reference reagent/gym/envs/pomdp/pocman.py and
gym/envs/toy_vm.py).  Pocman is a small maze with random-walk ghosts, food
pellets and a local-perception observation, one env.  ``reset_noise``: the
ghosts' start cells, distinct indices into the free cells (JAX's
``choice(..., replace=False)``); ``step_noise``: each ghost's direction in
[0, 4) (JAX's ``randint`` per ghost).  ToyVM is a host env on
``np.random.RandomState``, kept as the JAX package has it, so one seed gives
one stream.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import numpy as np
import torch

from reagent_tpu_torch.gym.envs.functional import FunctionalEnv
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor

# 7x7 maze: 1 = wall, 0 = corridor (pocman-style cross corridors)
_MAZE = np.array(
    [
        [1, 1, 1, 1, 1, 1, 1],
        [1, 0, 0, 0, 0, 0, 1],
        [1, 0, 1, 0, 1, 0, 1],
        [1, 0, 0, 0, 0, 0, 1],
        [1, 0, 1, 0, 1, 0, 1],
        [1, 0, 0, 0, 0, 0, 1],
        [1, 1, 1, 1, 1, 1, 1],
    ],
    np.int32,
)
_FREE = np.argwhere(_MAZE == 0)
_DIRS = np.array([[-1, 0], [1, 0], [0, -1], [0, 1]], np.int32)  # N S W E


@dataclasses.dataclass
class PocManState:
    agent: Tensor  # [2]
    ghosts: Tensor  # [num_ghosts, 2]
    food: Tensor  # [H, W] 0/1
    t: Tensor


class PocManEnv(FunctionalEnv):
    """Partially observed pac-man: observe only wall/food/ghost adjacency.

    Observation (10 bits): per direction, a wall?; per direction, a ghost
    within 2 cells?; food adjacent?; a bias (reference pocman.py's
    observation bits)."""

    discrete = True
    action_dim = 4
    observation_dim = 10

    def __init__(self, num_ghosts: int = 2, max_steps: int = 80, device="cuda"):
        self.num_ghosts = num_ghosts
        self.max_steps = max_steps
        self.device = resolve_device(device)
        self._maze = torch.tensor(_MAZE, dtype=torch.int32, device=self.device)
        self._free = torch.tensor(_FREE, dtype=torch.int64, device=self.device)
        self._dirs = torch.tensor(_DIRS, dtype=torch.int64, device=self.device)

    def _cell(self, grid: Tensor, pos: Tensor) -> Tensor:
        return grid[pos[..., 0], pos[..., 1]]

    def _obs(self, state: PocManState) -> Tensor:
        a = state.agent
        bits = [self._cell(self._maze, a + self._dirs[d]).to(torch.float32) for d in range(4)]
        for d in range(4):  # ghost within 2 cells in direction d
            n1 = a + self._dirs[d]
            n2 = a + 2 * self._dirs[d]
            near = ((state.ghosts == n1[None]).all(1) | (state.ghosts == n2[None]).all(1)).any()
            bits.append(near.to(torch.float32))
        food_adj = torch.zeros((), device=self.device)
        for d in range(4):
            food_adj = torch.maximum(
                food_adj, self._cell(state.food, a + self._dirs[d]).to(torch.float32))
        bits.append(food_adj)
        bits.append(torch.ones((), device=self.device))
        return torch.stack(bits)

    def reset_noise(self, generator):
        return torch.randperm(self._free.shape[0], generator=generator,
                              device=self.device)[:self.num_ghosts]

    def reset(self, generator=None, noise=None):
        ghost_idx = self.reset_noise(generator) if noise is None else noise
        agent = self._free[0]
        ghosts = self._free[ghost_idx.to(device=self.device, dtype=torch.int64)]
        food = (self._maze == 0).to(torch.int32)
        food[agent[0], agent[1]] = 0
        state = PocManState(agent=agent, ghosts=ghosts, food=food,
                            t=torch.zeros((), dtype=torch.int32, device=self.device))
        return state, self._obs(state)

    def step_noise(self, generator):
        return torch.randint(0, 4, (self.num_ghosts,), generator=generator, device=self.device)

    def step(self, state: PocManState, action: Tensor, generator=None, noise=None):
        directions = self.step_noise(generator) if noise is None else noise
        target = state.agent + self._dirs[action.to(torch.int64)]
        blocked = self._cell(self._maze, target) == 1
        agent = torch.where(blocked, state.agent, target)

        # ghosts take uniform random legal moves
        moved = state.ghosts + self._dirs[directions.to(device=self.device, dtype=torch.int64)]
        ghosts = torch.where((self._cell(self._maze, moved) == 1)[:, None], state.ghosts, moved)

        ate = self._cell(state.food, agent) == 1
        food = state.food.clone()
        food[agent[0], agent[1]] = 0
        caught = (ghosts == agent[None]).all(1).any()
        t = state.t + 1
        reward = torch.where(ate, 1.0, -0.05) + torch.where(caught, -10.0, 0.0)
        all_eaten = torch.sum(food) == 0
        done = caught | all_eaten | (t >= self.max_steps)
        new_state = PocManState(agent=agent, ghosts=ghosts, food=food, t=t)
        return new_state, self._obs(new_state), reward, done


class Document(NamedTuple):
    tap: float
    quality: float
    abandon: float


def simulate_reward(slate: List[Document], prng: np.random.RandomState) -> float:
    """Cascading click model (reference toy_vm.py:14-31)."""
    reward = 0.0
    position = 0
    n = len(slate)
    if not n:
        return 0.0
    comparison = slate[position].tap
    roll = prng.rand()
    done = comparison < roll
    while not done:
        reward += slate[position].quality
        comparison = 1 - slate[position].abandon
        roll = prng.rand()
        position += 1
        done = (comparison < roll) or (position >= n)
    return reward


def random_document(prng) -> Document:
    from scipy.special import expit, logit

    p, q, r = prng.rand(), prng.rand(), prng.rand()
    return Document(expit(logit(p) + 1), q, expit(logit(r) - 2))


class ToyVMEnv:
    """Slate re-ranking toy env with the cascading reward (reference toy_vm.py)."""

    def __init__(self, slate_size: int, max_steps: int = 20, seed: int = 0):
        self.slate_size = slate_size
        self.max_steps = max_steps
        self._prng = np.random.RandomState(seed)
        self._t = 0

    def _sample_docs(self) -> List[Document]:
        return [random_document(self._prng) for _ in range(self.slate_size)]

    def reset(self):
        self._t = 0
        self.docs = self._sample_docs()
        return self.docs

    def step(self, permutation: List[int]):
        slate = [self.docs[i] for i in permutation]
        reward = simulate_reward(slate, self._prng)
        self._t += 1
        done = self._t >= self.max_steps
        self.docs = self._sample_docs()
        return self.docs, reward, done
