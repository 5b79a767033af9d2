"""Multi-armed bandit library (port of ``reagent_tpu/mab/__init__.py``)."""

from reagent_tpu_torch.mab.mab_algorithm import (
    GreedyAlgo,
    MABAlgo,
    MABState,
    RandomActionsAlgo,
    randomized_argmax,
)
from reagent_tpu_torch.mab.simulation import BernoulliMAB, single_evaluation_bandit_algo
from reagent_tpu_torch.mab.thompson_sampling import BernoulliBetaThompson, NormalGammaThompson
from reagent_tpu_torch.mab.ucb import UCB1, MetricUCB, UCBTuned

__all__ = [
    "MABAlgo",
    "MABState",
    "GreedyAlgo",
    "RandomActionsAlgo",
    "randomized_argmax",
    "UCB1",
    "MetricUCB",
    "UCBTuned",
    "BernoulliBetaThompson",
    "NormalGammaThompson",
    "BernoulliMAB",
    "single_evaluation_bandit_algo",
]
