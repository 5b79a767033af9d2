"""Policies backed by exported serving artifacts.

Port of ``reagent_tpu/gym/policies/predictor_policies.py`` (reference:
reagent/gym/policies/predictor_policies.py): a loaded
``manifest.json`` + ``weights.bin`` artifact (``DiscreteDqnPredictorWrapper.load``,
a numpy forward on the host) scores the observation and one of the port's
samplers picks the action.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.gym.policies.samplers import GreedyActionSampler, SoftmaxActionSampler
from reagent_tpu_torch.prediction.predictor_wrapper import DiscreteDqnPredictorWrapper


class DiscreteDqnPredictorPolicy:
    """Greedy (or softmax) policy over a loaded serving artifact."""

    def __init__(self, model_path: str, temperature: Optional[float] = None):
        self.predictor = DiscreteDqnPredictorWrapper.load(model_path)
        self.sampler = (
            SoftmaxActionSampler(temperature) if temperature else GreedyActionSampler()
        )

    def act(self, params_unused, obs, generator: Optional[torch.Generator] = None
            ) -> rlt.ActorOutput:
        """``obs`` [obs_dim] or [B, obs_dim] in the artifact's feature order;
        ``generator`` feeds the softmax sampler's draw."""
        values = np.asarray(obs, np.float32)
        if values.ndim == 1:
            values = values[None, :]
        _, q = self.predictor(values, np.ones_like(values))
        return self.sampler.sample_action(torch.as_tensor(q), generator)


def create_predictor_policy_from_model(model_path: str, **kwargs) -> DiscreteDqnPredictorPolicy:
    """Reference predictor_policies.py create_predictor_policy_from_model."""
    return DiscreteDqnPredictorPolicy(model_path, **kwargs)
