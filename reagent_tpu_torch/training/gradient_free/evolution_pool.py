"""Evolution-strategies pool.

Port of ``reagent_tpu/training/gradient_free/evolution_pool.py`` (:25-99;
reference reagent/training/gradient_free/evolution_pool.py:21-120): mutate a
parent dict of tensors into a population, estimate the gradient from the
normalized rewards and step the parent with Adam (optax's defaults, from the
port's optimizer union).

The whole population is one stacked dict (a leading population axis), and
``compute_all_local_rewards`` evaluates it with ``torch.func.vmap``, as JAX
vmaps.  JAX draws the parent and each iteration's noise from folded keys;
here they are values (``parent_tensors=``, ``noise=``: each child's mutation,
``[population, *shape]`` already scaled by ``mutation_power``) or come from
the pool's ``torch.Generator`` on its device, seeded by ``seed``, so every
rank that builds a pool with one seed draws the same noise.  The guard on the
rewards' std reads one float a step on the host, as JAX's does; the std is
the population std (``jnp.std``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from reagent_tpu_torch.core.parameters import EvolutionParameters
from reagent_tpu_torch.optim import OptState, make_optimizer
from reagent_tpu_torch.optim.union import Adam
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor
Tensors = Dict[str, Tensor]


@dataclasses.dataclass
class EvolutionPoolState:
    """What an ``EvolutionPool`` carries from one iteration to the next: the
    parent, its Adam state and the current population's mutations."""

    parent_tensors: Tensors
    opt_state: OptState
    noise: Tensors


class EvolutionPool:
    def __init__(
        self,
        seed: int,
        es_params: EvolutionParameters,
        tensor_sizes: Dict[str, List[int]],
        parent_tensors: Optional[Tensors] = None,
        noise: Optional[Tensors] = None,
        device="cuda",
    ) -> None:
        self.es_params = es_params
        self.tensor_sizes = tensor_sizes
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        if parent_tensors is None:
            parent_tensors = {name: torch.randn(tuple(size), generator=self.generator,
                                                device=self.device)
                              for name, size in tensor_sizes.items()}
        self.parent_tensors = {k: v.to(self.device, torch.float32)
                               for k, v in parent_tensors.items()}
        self.optimizer = make_optimizer(Adam(lr=es_params.learning_rate))
        self.opt_state = self.optimizer.init(self.parent_tensors)
        self.population_tensors: Tensors = {}
        self._noise: Tensors = {}
        self.populate_children(0, noise)

    def draw_noise(self) -> Tensors:
        """One iteration's mutations from the pool's generator: N(0,
        mutation_power^2), ``[population, *shape]`` a tensor."""
        pop = self.es_params.population_size
        return {name: torch.randn((pop, *parent.shape), generator=self.generator,
                                  device=self.device) * self.es_params.mutation_power
                for name, parent in self.parent_tensors.items()}

    def populate_children(self, iteration: int, noise: Optional[Tensors] = None) -> None:
        """Population = parent + mutation, stacked (reference :65-73).
        ``iteration`` names the population, as JAX's folds it into the key;
        the draws here come from ``noise`` or the generator's stream."""
        if noise is None:
            noise = self.draw_noise()
        self._noise = {name: noise[name].to(self.device, torch.float32)
                       for name in self.parent_tensors}
        self.population_tensors = {name: parent[None] + self._noise[name]
                                   for name, parent in self.parent_tensors.items()}

    def apply_global_reward(self, rewards: Tensor, next_iteration: int,
                            noise: Optional[Tensors] = None) -> None:
        """The ES gradient estimate from the normalized rewards (reference
        :75-110), one Adam step of the parent, then the next population
        (``noise``: its mutations, else drawn)."""
        rewards = torch.as_tensor(rewards, dtype=torch.float32, device=self.device)
        std = torch.std(rewards, correction=0)
        if float(torch.abs(std)) > 1e-6:
            normalized = (rewards - torch.mean(rewards)) / std
            pop = self.es_params.population_size
            grads = {}
            for name, noise_t in self._noise.items():
                # - sum_i r_i * eps_i / (pop * sigma): ascend the reward
                w = normalized.reshape((-1,) + (1,) * (noise_t.ndim - 1))
                grads[name] = -torch.sum(noise_t * w, dim=0) / (
                    pop * self.es_params.mutation_power)
            self.parent_tensors, self.opt_state = self.optimizer.update(
                grads, self.opt_state, self.parent_tensors)
        self.populate_children(next_iteration, noise)

    def compute_all_local_rewards(self, reward_fn: Callable[[Tensors], Tensor]) -> Tensor:
        """``reward_fn`` of one individual, vmapped over the population."""
        return torch.func.vmap(reward_fn)(self.population_tensors)

    def state(self) -> EvolutionPoolState:
        return EvolutionPoolState(parent_tensors=self.parent_tensors,
                                  opt_state=self.opt_state, noise=self._noise)

    def load_state(self, state: EvolutionPoolState) -> None:
        """Continue from ``state`` (``interop.evolution_pool_state_from_arrays``
        carries JAX's ``parent_tensors``, ``opt_state`` and ``_noise``)."""
        self.parent_tensors = {k: v.to(self.device) for k, v in state.parent_tensors.items()}
        self.opt_state = state.opt_state
        self.populate_children(0, state.noise)


class OneMaxEvolutionPool(EvolutionPool):
    """The demo pool (reference :121-132): the reward grows as the tensor
    ``"data"`` approaches [+inf, -inf, +inf, -inf, ...]."""

    def compute_local_reward(self, individual: Tensors) -> Tensor:
        sigmoid_params = torch.sigmoid(individual["data"])
        total = torch.sum(sigmoid_params[0::2]) + torch.sum(1 - sigmoid_params[1::2])
        return total / sigmoid_params.shape[0]

    def compute_rewards(self) -> Tensor:
        return self.compute_all_local_rewards(self.compute_local_reward)
