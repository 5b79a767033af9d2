"""Ranking samplers (port of ``reagent_tpu/samplers/``)."""

from reagent_tpu_torch.samplers.frechet import FrechetSort

__all__ = ["FrechetSort"]
