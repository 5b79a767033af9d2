"""Multiclass-classification → contextual-bandit OPE benchmark.

Port of ``reagent_tpu/ope/test/multiclass_bandits.py`` (numpy and sklearn on
the host, as JAX's); pandas is imported inside the CSV loader only.

Reference: reagent/ope/test/multiclass_bandits.py:40-320 — turn a UCI
classification dataset into a bandit problem (arXiv:1103.4601): context =
features, action = predicted class, reward = 1 if the action equals the true
label.  A logging policy generates propensity-logged data; DM/IPS/DR estimate
a target policy's value, checked against the simulated ground truth.

The reference downloads UCI CSVs; this harness accepts the same CSV contract
(``file``/``label_col``/``sep``) and additionally the offline sklearn bundled
datasets (iris, digits, wine) so the benchmark runs with zero egress.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional, Tuple

import numpy as np

from reagent_tpu_torch.ope.estimators.contextual_bandits_estimators import (
    BanditsEstimatorInput,
    DMEstimator,
    DoublyRobustEstimator,
    IPSEstimator,
)
from reagent_tpu_torch.ope.estimators.estimator import EstimatorResult
from reagent_tpu_torch.ope.trainers.linear_trainers import (
    LogisticRegressionTrainer,
    TrainingData,
)

logger = logging.getLogger(__name__)


class MultiClassDataset:
    """Features + integer labels (+one-hot); UCI-CSV or sklearn-bundled."""

    def __init__(self, features: np.ndarray, labels: np.ndarray):
        self.features = np.asarray(features, np.float64)
        labels = np.asarray(labels).reshape(-1)
        classes, labels = np.unique(labels, return_inverse=True)
        self.labels = labels
        self.num_actions = len(classes)
        self.one_hot = np.eye(self.num_actions)[labels]

    @classmethod
    def from_csv(cls, params: Dict) -> "MultiClassDataset":
        """Reference UCIMultiClassDataset contract (:56-100).  pandas is
        imported here only, so that the package imports where it is absent."""
        import pandas as pd

        if "file" not in params:
            raise ValueError('Please define "file" in "dataset"')
        if "label_col" not in params:
            raise ValueError('Please define "label_col" in "dataset"')
        index_col = params.get("index_col")
        sep = params.get("sep", ",")
        df = pd.read_csv(
            params["file"], sep=sep, header=None,
            index_col=index_col if index_col is not None else False,
        )
        label_col = params["label_col"]
        if label_col < 0:
            label_col = df.shape[1] + (1 if index_col is not None else 0) + label_col
        if index_col is not None and label_col > index_col:
            label_col -= 1
        feats = df.iloc[:, [i for i in range(df.shape[1]) if i != label_col]].values
        labels = df.iloc[:, label_col].values
        return cls(feats, labels)

    @classmethod
    def from_sklearn(cls, name: str = "digits") -> "MultiClassDataset":
        from sklearn import datasets

        loader = {"iris": datasets.load_iris, "digits": datasets.load_digits,
                  "wine": datasets.load_wine}[name]
        d = loader()
        return cls(d.data, d.target)

    def __len__(self) -> int:
        return len(self.labels)


@dataclasses.dataclass
class MultiClassPolicy:
    """Softmax over classifier scores, mixed with uniform exploration."""

    propensities: np.ndarray  # [N, A]

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        cum = np.cumsum(self.propensities, axis=1)
        u = rng.random((len(cum), 1))
        return np.argmax(cum >= u, axis=1)


def make_policy(
    dataset: MultiClassDataset,
    train_idx: np.ndarray,
    epsilon: float,
    tau: float = 1.0,
) -> MultiClassPolicy:
    """Train a classifier on a subset; epsilon-mix its softmax (ref :170-220)."""
    trainer = LogisticRegressionTrainer()
    trainer.train(
        TrainingData(
            train_x=dataset.features[train_idx], train_y=dataset.labels[train_idx]
        )
    )
    proba = trainer.predict_proba(dataset.features)
    scores = np.log(np.maximum(proba, 1e-12)) / tau
    soft = np.exp(scores - scores.max(axis=1, keepdims=True))
    soft /= soft.sum(axis=1, keepdims=True)
    A = dataset.num_actions
    return MultiClassPolicy((1 - epsilon) * soft + epsilon / A)


def evaluate_all(
    dataset: MultiClassDataset,
    log_epsilon: float = 0.3,
    tgt_epsilon: float = 0.05,
    train_frac: float = 0.5,
    seed: int = 0,
) -> Dict[str, EstimatorResult]:
    """Log with one policy, estimate the other's value, compare to truth
    (reference evaluate_all :230-320)."""
    rng = np.random.default_rng(seed)
    N = len(dataset)
    perm = rng.permutation(N)
    train_idx, eval_idx = perm[: int(N * train_frac)], perm[int(N * train_frac):]

    log_policy = make_policy(dataset, train_idx[: len(train_idx) // 2], log_epsilon)
    tgt_policy = make_policy(dataset, train_idx, tgt_epsilon)

    log_actions = log_policy.sample(rng)[eval_idx]
    log_rewards = (log_actions == dataset.labels[eval_idx]).astype(np.float64)

    # ground truth: expected accuracy of the target policy on eval rows
    gt = float(
        np.mean(
            tgt_policy.propensities[eval_idx, dataset.labels[eval_idx]]
        )
    )

    # DM reward model: classifier trained on the LOGGED data only
    dm_trainer = LogisticRegressionTrainer()
    dm_trainer.train(
        TrainingData(train_x=dataset.features[eval_idx], train_y=log_actions,
                     train_weight=log_rewards)
    )
    # reward model r_hat(x, a) = P(label == a | x) proxy from logged hits
    proba = dm_trainer.predict_proba(dataset.features[eval_idx])
    dm_rewards = np.zeros((len(eval_idx), dataset.num_actions))
    dm_rewards[:, dm_trainer._model.classes_.astype(int)] = proba

    einput = BanditsEstimatorInput(
        log_action=log_actions,
        log_reward=log_rewards,
        log_propensities=log_policy.propensities[eval_idx],
        tgt_propensities=tgt_policy.propensities[eval_idx],
        dm_rewards=dm_rewards,
        ground_truth_reward=gt,
    )
    return {
        "dm": DMEstimator().evaluate(einput),
        "ips": IPSEstimator().evaluate(einput),
        "dr": DoublyRobustEstimator().evaluate(einput),
    }
