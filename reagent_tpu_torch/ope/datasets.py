"""Logged (behavior-policy) dataset abstractions for OPE benchmarks.

Port of ``reagent_tpu/ope/datasets.py``, line for line (numpy on the
host), so that the port imports nothing of the JAX package.

Reference: reagent/ope/datasets/logged_dataset.py — ``BanditsDataset`` ABC
(len/getitem + num_features/num_actions/features/actions/rewards views).

Design: datasets are host-side containers of dense numpy arrays; the OPE
estimators consume whole-dataset arrays (vectorized) rather than
per-sample __getitem__ loops, so the array properties are the primary API and
``__getitem__`` exists for reference-API compatibility.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class BanditsSample:
    """One logged decision: (features, action, reward)."""

    features: np.ndarray
    action: int
    reward: float


class BanditsDataset(abc.ABC):
    """Base class for a logged, aka behavior, contextual-bandit dataset."""

    @abc.abstractmethod
    def __len__(self) -> int: ...

    def __getitem__(self, idx: int) -> BanditsSample:
        return BanditsSample(
            features=self.features[idx],
            action=int(self.actions[idx]),
            reward=float(self.rewards[idx]),
        )

    @property
    @abc.abstractmethod
    def num_features(self) -> int: ...

    @property
    @abc.abstractmethod
    def num_actions(self) -> int: ...

    @property
    @abc.abstractmethod
    def features(self) -> np.ndarray:
        """[N, num_features] float array of all logged contexts."""

    @property
    @abc.abstractmethod
    def actions(self) -> np.ndarray:
        """[N] int array of logged actions."""

    @property
    @abc.abstractmethod
    def rewards(self) -> np.ndarray:
        """[N] float array of logged rewards."""


class ArrayBanditsDataset(BanditsDataset):
    """In-memory BanditsDataset over dense arrays (the common OSS case)."""

    def __init__(self, features: np.ndarray, actions: np.ndarray, rewards: np.ndarray):
        features = np.asarray(features, np.float32)
        actions = np.asarray(actions, np.int64)
        rewards = np.asarray(rewards, np.float32)
        assert features.ndim == 2 and len(features) == len(actions) == len(rewards)
        self._features, self._actions, self._rewards = features, actions, rewards

    def __len__(self) -> int:
        return len(self._features)

    @property
    def num_features(self) -> int:
        return self._features.shape[1]

    @property
    def num_actions(self) -> int:
        return int(self._actions.max()) + 1 if len(self._actions) else 0

    @property
    def features(self) -> np.ndarray:
        return self._features

    @property
    def actions(self) -> np.ndarray:
        return self._actions

    @property
    def rewards(self) -> np.ndarray:
        return self._rewards

    def train_eval_split(
        self, frac_train: float, seed: int = 0
    ) -> Tuple["ArrayBanditsDataset", "ArrayBanditsDataset"]:
        idx = np.random.default_rng(seed).permutation(len(self))
        k = int(frac_train * len(self))
        tr, ev = idx[:k], idx[k:]
        return (
            ArrayBanditsDataset(self._features[tr], self._actions[tr], self._rewards[tr]),
            ArrayBanditsDataset(self._features[ev], self._actions[ev], self._rewards[ev]),
        )
