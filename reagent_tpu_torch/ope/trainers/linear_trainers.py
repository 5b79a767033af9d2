"""Reward-model trainers for the bandit estimators.

Port of ``reagent_tpu/ope/trainers/linear_trainers.py``: the sklearn
trainers as JAX's (sklearn imported inside ``train``), ``NNTrainer`` in
torch.

Reference: reagent/ope/trainers/linear_trainers.py:1-363 (sklearn-backed
logistic/linear/decision-tree/SGD trainers with a common Trainer protocol).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class TrainingData:
    train_x: np.ndarray
    train_y: np.ndarray
    train_weight: Optional[np.ndarray] = None
    validation_x: Optional[np.ndarray] = None
    validation_y: Optional[np.ndarray] = None
    validation_weight: Optional[np.ndarray] = None


def _regression_score(y_true, y_pred, weight=None) -> float:
    """Reference's regression model-selection score 1/2^MSE
    (reagent/ope/trainers/linear_trainers.py:45-52) — higher is better,
    bounded in (0, 1]."""
    err = np.asarray(y_true, np.float64) - np.asarray(y_pred, np.float64)
    if weight is None:
        mse = float(np.mean(err * err))
    else:
        w = np.asarray(weight, np.float64)
        mse = float(np.sum(w * err * err) / np.sum(w))
    return 1.0 / math.pow(2.0, mse)


def _validation_split(data: TrainingData):
    """Validation triple, falling back to the training set when absent."""
    if data.validation_x is not None and data.validation_y is not None:
        return data.validation_x, data.validation_y, data.validation_weight
    return data.train_x, data.train_y, data.train_weight


class LinearTrainer:
    """Ridge regression (reference LinearTrainer)."""

    def __init__(self, alpha: float = 1.0):
        self.alpha = alpha
        self._model = None

    def train(self, data: TrainingData) -> None:
        from sklearn.linear_model import Ridge

        self._model = Ridge(alpha=self.alpha)
        self._model.fit(data.train_x, data.train_y, sample_weight=data.train_weight)

    def predict(self, x: np.ndarray) -> np.ndarray:
        assert self._model is not None, "call train first"
        return self._model.predict(x)

    def score(self, x: np.ndarray, y: np.ndarray) -> float:
        return float(self._model.score(x, y))


class LogisticRegressionTrainer(LinearTrainer):
    def __init__(self, C: float = 1.0):
        super().__init__()
        self.C = C

    def train(self, data: TrainingData) -> None:
        from sklearn.linear_model import LogisticRegression

        self._model = LogisticRegression(C=self.C, max_iter=1000)
        self._model.fit(data.train_x, data.train_y, sample_weight=data.train_weight)

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        return self._model.predict_proba(x)


class SGDClassifierTrainer(LinearTrainer):
    def __init__(self, loss: str = "log_loss", max_iter: int = 1000):
        super().__init__()
        self.loss = loss
        self.max_iter = max_iter

    def train(self, data: TrainingData) -> None:
        from sklearn.linear_model import SGDClassifier

        self._model = SGDClassifier(loss=self.loss, max_iter=self.max_iter)
        self._model.fit(data.train_x, data.train_y, sample_weight=data.train_weight)


class DecisionTreeTrainer(LinearTrainer):
    def __init__(self, max_depth: Optional[int] = None):
        super().__init__()
        self.max_depth = max_depth

    def train(self, data: TrainingData) -> None:
        from sklearn.tree import DecisionTreeRegressor

        self._model = DecisionTreeRegressor(max_depth=self.max_depth)
        self._model.fit(data.train_x, data.train_y, sample_weight=data.train_weight)


class LassoTrainer(LinearTrainer):
    """L1 regression with validation-selected alpha.

    Reference: reagent/ope/trainers/linear_trainers.py:62-96 — sweeps alpha
    over logspace(-4, 2, 7), keeps the model with the best validation score
    (1/2^MSE).  Load-bearing in the reference MSLR slate harness
    (reagent/ope/test/mslr_slate.py:369,620-621).
    """

    name = "lasso"

    def __init__(self, seed: int = 0):
        super().__init__()
        self.seed = seed

    def train(self, data: TrainingData) -> None:
        from sklearn.linear_model import Lasso

        sx, sy, ssw = _validation_split(data)
        best_score = float("-inf")
        self._model = None
        for alpha in np.logspace(-4, 2, num=7, base=10):
            model = Lasso(
                alpha=alpha,
                fit_intercept=False,
                max_iter=10000,
                selection="random",
                random_state=self.seed,
            )
            model.fit(data.train_x, data.train_y)
            score = _regression_score(sy, model.predict(sx), weight=ssw)
            if score > best_score:
                best_score = score
                self._model = model


class DecisionTreeClassifierTrainer(LinearTrainer):
    """Classification tree with validation-selected depth.

    Reference: reagent/ope/trainers/linear_trainers.py:144-178 — entropy
    criterion, depth sweep 3..18 step 3, accuracy model selection.
    """

    name = "decision_tree_classifier"

    def __init__(self, seed: int = 0):
        super().__init__()
        self.seed = seed

    def train(self, data: TrainingData) -> None:
        from sklearn.tree import DecisionTreeClassifier

        sx, sy, ssw = _validation_split(data)
        best_score = float("-inf")
        self._model = None
        for depth in range(3, 21, 3):
            model = DecisionTreeClassifier(
                criterion="entropy",
                splitter="random",
                max_depth=depth,
                min_samples_split=4,
                min_samples_leaf=4,
                random_state=self.seed,
            )
            model.fit(data.train_x, data.train_y, sample_weight=data.train_weight)
            score = model.score(sx, sy, ssw)
            if score > best_score:
                best_score = score
                self._model = model

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        return self._model.predict_proba(x)


class NNTrainer:
    """MLP regression reward model, trained with Adam on the device.

    Reference: reagent/ope/trainers/linear_trainers.py:259-363 (torch
    LinearNet + Adam + ReduceLROnPlateau).  The JAX package's net and its
    schedule (``reagent_tpu/ope/trainers/linear_trainers.py:181-294``): the
    He-normal init and the minibatch indices come from numpy's
    ``default_rng(seed)``, as JAX's do, so both packages draw the same
    numbers; the step is autograd of the batch's MSE and the port's Adam rule
    (optax's, ``optim/union.py``); the LR halves when the loss, read on the
    host every 10 steps (as JAX's ``float(loss)``), has not improved by 1e-5
    in 5 reads.  ``predict`` runs the ``[N, d -> h -> ... -> out]`` relu
    chain as one K3 launch on a CUDA tensor (its ``[in, out]`` weights are
    K3's layout).

    ``params`` holds the weights by name, ``layers.{i}.w`` ``[in, out]`` and
    ``layers.{i}.b`` ``[out]`` (``utils/interop.py::
    nn_trainer_params_from_arrays`` carries JAX's list of ``{"w", "b"}``).
    """

    name = "linear_net"

    def __init__(
        self,
        hidden_dim: int = 500,
        hidden_layers: int = 2,
        learning_rate: float = 1e-3,
        seed: int = 0,
        device="cuda",
    ):
        from reagent_tpu_torch.utils.device import resolve_device

        self.hidden_dim = hidden_dim
        self.hidden_layers = hidden_layers
        self.learning_rate = learning_rate
        self.seed = seed
        self.device = resolve_device(device)
        self.params = None
        self.losses = []  # each step's loss, a 0-d tensor on the device
        self.lr = None  # the LR after the last step

    def _init_params(self, rng, d_in: int, d_out: int):
        dims = [d_in] + [self.hidden_dim] * self.hidden_layers + [d_out]
        params = []
        for a, b in zip(dims[:-1], dims[1:]):
            scale = np.sqrt(2.0 / a)
            params.append(
                {
                    "w": rng.normal(scale=scale, size=(a, b)).astype(np.float32),
                    "b": np.zeros(b, np.float32),
                }
            )
        return params

    @property
    def num_layers(self) -> int:
        return len(self.params) // 2

    def weights(self, params=None):
        """K3's ``[(W [in, out], b [out])]`` of ``params`` (the trained ones
        by default)."""
        params = self.params if params is None else params
        return [(params[f"layers.{i}.w"], params[f"layers.{i}.b"])
                for i in range(len(params) // 2)]

    def activations(self):
        return ["relu"] * (self.num_layers - 1) + ["linear"]

    @staticmethod
    def _apply(weights, x):
        h = x
        for w, b in weights[:-1]:
            h = torch.relu(h @ w + b)
        w, b = weights[-1]
        return h @ w + b

    def train(
        self,
        data: TrainingData,
        iterations: int = 100,
        batch_size: int = 1024,
    ) -> None:
        from reagent_tpu_torch.optim.union import AdamRule
        from reagent_tpu_torch.utils.interop import nn_trainer_params_from_arrays

        x = np.asarray(data.train_x, np.float32)
        y = np.asarray(data.train_y, np.float32)
        if y.ndim == 1:
            y = y[:, None]
        d_in, d_out = x.shape[1], y.shape[1]
        if d_in == 0 or d_out == 0:
            raise ValueError(
                f"NNTrainer.train got a degenerate feature/target shape "
                f"(d_in={d_in}, d_out={d_out})"
            )
        dev = self.device
        rng = np.random.default_rng(self.seed)
        params = nn_trainer_params_from_arrays(self._init_params(rng, d_in, d_out), dev)
        xd = torch.from_numpy(x).to(dev)
        yd = torch.from_numpy(y).to(dev)
        opt = AdamRule(self.learning_rate, 0.9, 0.999, 1e-8)
        opt_state = opt.init(params)
        n = x.shape[0]
        best_loss, since_best = float("inf"), 0
        self.losses = []
        for t in range(iterations):
            idx = torch.from_numpy(rng.integers(n, size=min(batch_size, n))).to(dev)
            bx, by = xd[idx], yd[idx]
            leaves = {k: v.requires_grad_(True) for k, v in params.items()}
            loss = torch.mean((self._apply(self.weights(leaves), bx) - by) ** 2)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            params, opt_state = opt.update(
                grads, opt_state, {k: v.detach() for k, v in leaves.items()})
            loss = loss.detach()
            self.losses.append(loss)
            if (t + 1) % 10 == 0:
                cur = float(loss)
                if cur < best_loss - 1e-5:
                    best_loss, since_best = cur, 0
                else:
                    since_best += 1
                    if since_best >= 5:  # plateau: halve LR, like the reference
                        opt.lr = opt.lr * 0.5
                        since_best = 0
        self.params = params
        self.lr = opt.lr

    def predict(self, x: np.ndarray) -> np.ndarray:
        """The net's output on the host: one K3 launch on the card."""
        from reagent_tpu_torch.ops.fused_mlp import fused_mlp_forward

        assert self.params is not None, "call train first"
        xd = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)
        out = fused_mlp_forward(xd, self.weights(), self.activations()).cpu().numpy()
        return out[:, 0] if out.shape[1] == 1 else out

    def score(self, x: np.ndarray, y: np.ndarray) -> float:
        pred = self.predict(x)
        y = np.asarray(y, np.float64)
        return -float(np.mean((pred.reshape(y.shape) - y) ** 2))
