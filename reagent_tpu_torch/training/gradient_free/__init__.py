"""Gradient-free optimization (reference: reagent/training/gradient_free/)."""

from reagent_tpu_torch.training.gradient_free.ars_util import ARSOptimizer
from reagent_tpu_torch.training.gradient_free.es_worker import EsWorker
from reagent_tpu_torch.training.gradient_free.evolution_pool import (
    EvolutionPool,
    EvolutionPoolState,
    OneMaxEvolutionPool,
)

__all__ = ["EvolutionPool", "EvolutionPoolState", "OneMaxEvolutionPool", "EsWorker",
           "ARSOptimizer"]
