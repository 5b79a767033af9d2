"""Gradient-free / combinatorial optimizers (port of ``reagent_tpu/lite/``;
reference: reagent/lite/)."""

from reagent_tpu_torch.lite.optimizer import (
    BayesianByBackpropOptimizer,
    BayesianMLPEnsemblerOptimizer,
    BestResultsQueue,
    ComboOptimizerBase,
    GumbelSoftmaxOptimizer,
    LinearBayesianByBackprop,
    MLPBayesianByBackprop,
    NeverGradOptimizer,
    PolicyGradientOptimizer,
    QLearningOptimizer,
    RandomSearchOptimizer,
)

__all__ = [
    "BestResultsQueue",
    "ComboOptimizerBase",
    "RandomSearchOptimizer",
    "GumbelSoftmaxOptimizer",
    "PolicyGradientOptimizer",
    "QLearningOptimizer",
    "BayesianMLPEnsemblerOptimizer",
    "NeverGradOptimizer",
    "LinearBayesianByBackprop",
    "MLPBayesianByBackprop",
    "BayesianByBackpropOptimizer",
]
