"""Policy = scorer . sampler.

Port of ``reagent_tpu/gym/policies/policy.py`` (``Policy``,
``discrete_q_scorer``, ``actor_scorer``, :19-51; reference:
reagent/gym/policies/policy.py:13-39).  A scorer maps (params, obs) to
scores (Q-values or logits) or to an ``ActorOutput``; the sampler turns
scores into an action with the draws of an explicit ``torch.Generator`` on
the scores' device.  The discrete scorer is the act step's forward,
``training/functional.py::score``: a dense MLP in float32 is one K3 launch on
a CUDA tensor.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.training import functional

Tensor = torch.Tensor


class Policy:
    def __init__(self, scorer: Callable[[Any, Tensor], Any], sampler: Any):
        self.scorer = scorer
        self.sampler = sampler

    def act(self, params: Any, obs: Tensor,
            generator: Optional[torch.Generator] = None) -> rlt.ActorOutput:
        return self.sampler.sample_action(self.scorer(params, obs), generator)


def discrete_q_scorer(q_network: nn.Module) -> Callable[[Any, Tensor], Tensor]:
    """Scores of a discrete Q-network (or logits network) on a parameter dict
    (reference scorers/discrete_scorer.py), without a graph."""

    def scorer(params, obs: Tensor) -> Tensor:
        return functional.score(q_network, params, obs)

    return scorer


def actor_scorer(actor_network: nn.Module) -> Callable[[Any, Tensor], rlt.ActorOutput]:
    """Scorer of a continuous actor, which returns its ``ActorOutput``: the
    sampler passes it through.  ``params_and_noise`` is (the actor's
    parameter dict, the standard-normal draw the actor's forward takes)."""

    def scorer(params_and_noise, obs: Tensor) -> rlt.ActorOutput:
        params, noise = params_and_noise
        with torch.no_grad():
            return functional.apply(actor_network, params, obs, noise)

    return scorer
