from reagent_tpu_torch.ope.trainers.rl_tabular_trainers import (
    DPTrainer,
    DPValueFunction,
    EstimatedStateValueFunction,
    MonteCarloTrainer,
    MonteCarloValueFunction,
    TabularPolicy,
    generate_episode,
)
from reagent_tpu_torch.ope.trainers.linear_trainers import (
    DecisionTreeClassifierTrainer,
    DecisionTreeTrainer,
    LassoTrainer,
    LinearTrainer,
    LogisticRegressionTrainer,
    NNTrainer,
    SGDClassifierTrainer,
    TrainingData,
)

__all__ = [
    "TabularPolicy",
    "DPTrainer",
    "DPValueFunction",
    "MonteCarloTrainer",
    "MonteCarloValueFunction",
    "EstimatedStateValueFunction",
    "generate_episode",
    "LinearTrainer",
    "LogisticRegressionTrainer",
    "SGDClassifierTrainer",
    "DecisionTreeTrainer",
    "DecisionTreeClassifierTrainer",
    "LassoTrainer",
    "NNTrainer",
    "TrainingData",
]
