"""Typed value wrappers for the OPE library.

Port of ``reagent_tpu/ope/estimators/types.py``, line for line (numpy on the
host), so that the port imports nothing of the JAX package.

Reference: reagent/ope/estimators/types.py (606 LoC) — TypeWrapper:28,
Objects/Values:93/212, Items:381, ActionDistribution:481, ActionSpace:486,
Policy:500, TrainingData:522, PredictResults:532, Trainer:538.

The reference wraps every id/value in torch-backed classes; here the numeric
payloads are plain numpy arrays (estimators are vectorized over them), and the
wrappers keep only the API the benchmark harnesses rely on: hashable typed
keys, keyed value tables with distribution/greedy helpers, and the
Policy/Trainer protocols.
"""

from __future__ import annotations

import dataclasses
from abc import ABC, abstractmethod
from typing import Generic, Mapping, Optional, Sequence, Tuple, TypeVar, Union

import numpy as np

ValueType = TypeVar("ValueType")
KeyType = TypeVar("KeyType")


def is_array(obj) -> bool:
    return isinstance(obj, (np.ndarray, list, tuple))


@dataclasses.dataclass(frozen=True)
class TypeWrapper(Generic[ValueType]):
    """Hashable/comparable wrapper around ids of any payload type (ref :28-91)."""

    value: ValueType

    def __index__(self) -> int:
        return int(self.value)  # type: ignore[arg-type]

    def __int__(self) -> int:
        return int(self.value)  # type: ignore[arg-type]

    def __hash__(self) -> int:
        v = self.value
        if isinstance(v, np.ndarray):
            return hash(tuple(v.flatten().tolist()))
        if isinstance(v, list):
            return hash(tuple(v))
        return hash(v)

    def __eq__(self, other) -> bool:
        if not isinstance(other, TypeWrapper):
            return False
        if isinstance(self.value, np.ndarray) or isinstance(other.value, np.ndarray):
            return np.array_equal(np.asarray(self.value), np.asarray(other.value))
        return self.value == other.value

    def __lt__(self, other) -> bool:
        if isinstance(self.value, np.ndarray):
            return bool(np.less(self.value, other.value).all())
        return self.value < other.value

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}{{value[{self.value}]}}"


class Action(TypeWrapper[Union[int, Tuple[int, ...], np.ndarray]]):
    """Discrete (or structured) action id."""


class State(TypeWrapper[Union[int, float, Tuple, np.ndarray]]):
    """Environment state id / feature vector."""


class Values(Generic[KeyType]):
    """Keyed float table (ref Objects:93 + Values:212): supports dict or
    dense-array construction, normalization to a distribution, greedy picks."""

    def __init__(
        self, values: Union[Mapping[KeyType, float], Sequence[float], np.ndarray]
    ):
        if isinstance(values, Mapping):
            self._keys = list(values.keys())
            self._values = np.asarray([values[k] for k in self._keys], np.float64)
        else:
            self._values = np.asarray(values, np.float64)
            self._keys = [self._to_key(i) for i in range(len(self._values))]
        self._key_to_index = {k: i for i, k in enumerate(self._keys)}

    def _to_key(self, k: int) -> KeyType:
        return k  # type: ignore[return-value]

    @property
    def values(self) -> np.ndarray:
        return self._values

    def __getitem__(self, key: KeyType) -> float:
        return float(self._values[self._key_to_index[key]])

    def __len__(self) -> int:
        return len(self._values)

    def __iter__(self):
        return iter(self._keys)

    def items(self):
        return ((k, float(self._values[i])) for i, k in enumerate(self._keys))

    def probability(self, key: KeyType) -> float:
        total = self._values.sum()
        if total <= 0:
            return 1.0 / len(self._values)
        return float(self._values[self._key_to_index[key]] / total)

    def as_distribution(self) -> np.ndarray:
        total = self._values.sum()
        if total <= 0:
            return np.full(len(self._values), 1.0 / len(self._values))
        return self._values / total

    def greedy(self, k: int = 1):
        order = np.argsort(-self._values)[:k]
        picks = [self._keys[i] for i in order]
        return picks[0] if k == 1 else picks

    def sort(self, descending: bool = True):
        order = np.argsort(-self._values if descending else self._values)
        return [self._keys[i] for i in order], self._values[order]

    def replace(self, new_values) -> "Values":
        out = self.__class__(np.asarray(new_values, np.float64))
        out._keys = list(self._keys)
        out._key_to_index = dict(self._key_to_index)
        return out


class Items(Generic[ValueType]):
    """An ordered item universe (ref :381-479)."""

    def __init__(self, items: Union[int, Sequence[ValueType]]):
        if isinstance(items, int):
            self._items = [self._new_item(i) for i in range(items)]
        else:
            self._items = list(items)

    def _new_item(self, i: int) -> ValueType:
        return i  # type: ignore[return-value]

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __getitem__(self, i: int) -> ValueType:
        return self._items[i]

    def fill(self, values) -> Values:
        vals = Values(np.asarray(values, np.float64))
        vals._keys = list(self._items)
        vals._key_to_index = {k: i for i, k in enumerate(self._items)}
        return vals


class ActionDistribution(Values["Action"]):
    def _to_key(self, k: int) -> Action:
        return Action(k)


class ActionSpace(Items["Action"]):
    def _new_item(self, i: int) -> Action:
        return Action(i)

    @property
    def space(self) -> Sequence[Action]:
        return self._items

    def distribution(self, dist) -> ActionDistribution:
        d = ActionDistribution(np.asarray(dist, np.float64))
        d._keys = list(self._items)
        d._key_to_index = {k: i for i, k in enumerate(self._items)}
        return d


class Policy(ABC):
    """Policy protocol (ref :500-519)."""

    def __init__(self, action_space: ActionSpace):
        self._action_space = action_space

    @abstractmethod
    def _query(self, context) -> Tuple[Action, ActionDistribution]:
        ...

    def __call__(self, context) -> Tuple[Action, ActionDistribution]:
        return self._query(context)

    @property
    def action_space(self) -> ActionSpace:
        return self._action_space


@dataclasses.dataclass(frozen=True)
class TrainingData:
    """(ref :522-529)"""

    train_x: np.ndarray
    train_y: np.ndarray
    train_weight: Optional[np.ndarray]
    validation_x: np.ndarray
    validation_y: np.ndarray
    validation_weight: Optional[np.ndarray]


@dataclasses.dataclass(frozen=True)
class PredictResults:
    """(ref :532-535)"""

    predictions: Optional[np.ndarray]
    scores: np.ndarray
    probabilities: Optional[np.ndarray] = None


class Trainer(ABC):
    """Model-trainer protocol for OPE reward models (ref :538-606)."""

    def __init__(self) -> None:
        self._model = None

    @property
    def is_trained(self) -> bool:
        return self._model is not None

    @abstractmethod
    def train(self, data: TrainingData) -> None:
        ...

    @abstractmethod
    def predict(self, x: np.ndarray) -> PredictResults:
        ...

    @staticmethod
    def _sample(
        x: np.ndarray, y: np.ndarray, weight: Optional[np.ndarray] = None,
        num_samples: int = 0, rng: Optional[np.random.Generator] = None,
    ):
        if 0 < num_samples < x.shape[0]:
            rng = rng or np.random.default_rng()
            cs = rng.choice(x.shape[0], num_samples, replace=False)
            return x[cs], y[cs], weight[cs] if weight is not None else None
        return x, y, weight
