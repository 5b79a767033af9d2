"""Distributed evolution-strategies worker.

Port of ``reagent_tpu/training/gradient_free/es_worker.py`` (:44-69;
reference reagent/training/gradient_free/es_worker.py:20-60): each rank of a
``torch.distributed`` process group evaluates its contiguous block of the
population and ``all_gather``s the rewards, in rank order, so every rank
steps its parent on the whole reward vector.  JAX runs the same evaluation
under ``shard_map`` over a mesh axis and ``all_gather``s there.  With
``group=None`` the worker evaluates the whole population locally.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from reagent_tpu_torch.core.parameters import EvolutionParameters
from reagent_tpu_torch.training.gradient_free.evolution_pool import EvolutionPool

Tensor = torch.Tensor


class EsWorker:
    def __init__(self, individual_pool: EvolutionPool, es_params: EvolutionParameters,
                 group: Optional[dist.ProcessGroup] = None) -> None:
        self.pool = individual_pool
        self.es_params = es_params
        self.group = group

    def run_epoch(self, reward_fn: Callable[[Dict[str, Tensor]], Tensor], iteration: int,
                  noise: Optional[Dict[str, Tensor]] = None) -> float:
        """Evaluate this rank's block of the population, gather every rank's
        rewards, step the pool (``noise``: the next population's mutations,
        else drawn) and return the mean reward."""
        population = self.pool.population_tensors
        if self.group is None:
            rewards = torch.func.vmap(reward_fn)(population)
        else:
            world, rank = dist.get_world_size(self.group), dist.get_rank(self.group)
            pop = self.es_params.population_size
            if pop % world:
                raise ValueError(f"a population of {pop} does not divide over {world} ranks")
            n = pop // world
            local = torch.func.vmap(reward_fn)(
                {k: v[rank * n:(rank + 1) * n] for k, v in population.items()})
            parts = [torch.empty_like(local) for _ in range(world)]
            dist.all_gather(parts, local.contiguous(), group=self.group)
            rewards = torch.cat(parts)
        self.pool.apply_global_reward(rewards, iteration + 1, noise)
        return float(torch.mean(rewards))
