"""Combinatorial optimizers over discrete parameter spaces.

Port of ``reagent_tpu/lite/optimizer.py`` (reference
reagent/lite/optimizer.py:95-1686 -- ComboOptimizerBase API (sample_internal
/ update_params / optimize_step / best_solutions), RandomSearch (:276),
GumbelSoftmax (:557), PolicyGradient (:665), QLearning (:797), the Bayesian
MLP ensembler (:1238), the nevergrad wrapper (:368) and Bayes by backprop
(:1418-1686)).

The parameter space is ``{name: [choice, ...]}``.  ``obj_func`` maps a dict
of sampled choice indices (``int64`` tensors on the optimizer's device; the
relaxed one-hots of the Gumbel-softmax optimizer) to a [batch, 1] cost
(minimized), a tensor or an array.

Draws: what JAX draws from a numpy ``Generator`` (the random, Q-learning and
ensemble optimizers, every mutation and candidate order) comes here from the
same ``np.random.default_rng(seed)`` stream, so the two packages draw alike.
What JAX draws from its key (``_next_key``) is taken as a value, or drawn
from the optimizer's ``torch.Generator`` on its device, seeded by ``seed``:

- ``PolicyGradientOptimizer.sample_internal(draws=)`` and
  ``LogitBasedComboOptimizerBase.sample(gumbel=)``: ``{name: [B, n]}``
  standard Gumbel draws (``jax.random.categorical``'s);
- ``GumbelSoftmaxOptimizer.sample_internal(draws=)`` and its
  ``optimize_step(sample_draws=)``: ``{name: [B, n]}`` uniforms in
  [1e-20, 1);
- ``BayesianByBackpropOptimizer.sample_internal(draws=)``: one surrogate
  noise (``{weight: standard normal of its shape}``), and
  ``update_params(draws=)``: one such noise a train step.

The logits and the Bayes-by-backprop surrogate live on the device and step
with the optimizer union's ``Adam`` (optax's).  The MLP surrogate's forward
on the candidates, ``relu(x @ w + b) @ w2 + b2`` on the sampled weights
``mu + softplus(rho) * eps``, is one K3 launch (``ops/fused_mlp.py``) on a
CUDA tensor; its training forward, the KL term and the linear surrogate are
torch.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reagent_tpu_torch.mab.mab_algorithm import gumbel
from reagent_tpu_torch.ops.fused_mlp import fused_mlp_forward
from reagent_tpu_torch.optim import make_optimizer
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor
Draws = Dict[str, Tensor]

BATCH_SIZE = 512
MAX_NUM_BEST_SOLUTIONS = 50
ANNEAL_RATE = 0.9997
UNIFORM_MIN = 1e-20  # the Gumbel-softmax uniforms' minval (JAX's)


def _np(x) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class BestResultsQueue:
    """Keep the k lowest-cost solutions (reference optimizer.py:95-126)."""

    def __init__(self, max_len: int = MAX_NUM_BEST_SOLUTIONS):
        self.max_len = max_len
        self._heap: List[Tuple[float, int, Dict]] = []  # max-heap by -cost
        self._counter = itertools.count()

    def insert(self, reward: float, sol: Dict) -> None:
        # store negative so heap root is the WORST kept solution
        heapq.heappush(self._heap, (-reward, next(self._counter), sol))
        if len(self._heap) > self.max_len:
            heapq.heappop(self._heap)

    def topk(self, k: int) -> List[Tuple[float, Dict]]:
        items = sorted(self._heap, key=lambda t: -t[0])
        return [(-neg, sol) for neg, _, sol in items[:k]]


class ComboOptimizerBase:
    def __init__(
        self,
        param: Dict[str, Sequence[Any]],
        obj_func: Optional[Callable[[Dict[str, Tensor]], Any]] = None,
        batch_size: int = BATCH_SIZE,
        seed: int = 0,
        device="cuda",
    ) -> None:
        self.param = {k: list(v) for k, v in param.items()}
        self.obj_func = obj_func
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.best_sols = BestResultsQueue()
        self.last_sample_internal_res = None
        self._host_copies: Dict[int, Tuple[Tensor, np.ndarray]] = {}
        self._init()

    def _init(self) -> None:
        pass

    def _upload(self, host: Dict[str, Any]) -> Dict[str, Tensor]:
        """A sample's choice indices as ``int64`` tensors on the optimizer's
        device.  Their host arrays are kept beside them (``_host``), so that
        the step that scores and learns from the sample reads none of them
        back from the device; the previous sample's are dropped."""
        host = {k: np.asarray(v, dtype=np.int64) for k, v in host.items()}
        sampled = {k: torch.as_tensor(v, device=self.device) for k, v in host.items()}
        self._host_copies = {id(t): (t, host[k]) for k, t in sampled.items()}
        return sampled

    def _host(self, x) -> np.ndarray:
        """``x`` as numpy: the kept host array of a tensor that ``_upload``
        or ``optimize_step`` made from one, else a read of the tensor."""
        kept = self._host_copies.get(id(x))
        if kept is not None and kept[0] is x:
            return kept[1]
        return _np(x)

    def _insert_all(self, costs: Sequence[float], sampled: Dict[str, Any]) -> None:
        host = {k: self._host(v) for k, v in sampled.items()}
        for i, c in enumerate(costs):
            self.best_sols.insert(float(c), {k: int(v[i]) for k, v in host.items()})

    # -- API (reference :177-275) -------------------------------------------

    def optimize_step(self, sample_draws: Optional[Draws] = None, update_draws=None) -> Tuple:
        """Sample a batch, evaluate it, update; ``sample_draws`` and
        ``update_draws`` are what ``sample_internal`` and ``update_params``
        take as ``draws``."""
        assert self.obj_func is not None, "obj_func not provided"
        sampled = self.sample_internal(self.batch_size, draws=sample_draws)
        sampled_solutions = sampled[0]
        cost = _np(self.obj_func(sampled_solutions)).reshape(-1)
        cost_t = torch.as_tensor(cost, device=self.device)
        self._host_copies[id(cost_t)] = (cost_t, cost)
        self.update_params(cost_t, draws=update_draws)
        self._insert_all(cost, sampled_solutions)
        return sampled_solutions, cost

    def best_solutions(self, k: int = 1) -> List[Tuple[float, Dict]]:
        return self.best_sols.topk(k)

    def sample_internal(self, batch_size: Optional[int] = None, draws=None) -> Tuple:
        raise NotImplementedError

    def update_params(self, cost: Tensor, draws=None) -> None:
        raise NotImplementedError

    def sample(self, batch_size: int, temperature: float = 1.0) -> Dict[str, Tensor]:
        """Sample from the learned sampling distribution."""
        return self.sample_internal(batch_size)[0]

    def indices_to_raw_choices(self, sampled: Dict[str, Any]) -> List[Dict[str, Any]]:
        host = {k: self._host(v) for k, v in sampled.items()}
        n = len(next(iter(host.values())))
        return [{k: self.param[k][int(host[k][i])] for k in host} for i in range(n)]


class RandomSearchOptimizer(ComboOptimizerBase):
    """Uniform (or given-distribution) random sampling (reference :276-366)."""

    def __init__(self, param, obj_func=None, batch_size=BATCH_SIZE,
                 sampling_weights: Optional[Dict[str, np.ndarray]] = None, seed=0,
                 device="cuda"):
        self.sampling_weights = sampling_weights
        super().__init__(param, obj_func, batch_size, seed, device)

    def sample_internal(self, batch_size: Optional[int] = None, draws=None) -> Tuple:
        bs = batch_size or self.batch_size
        host = {}
        for k, choices in self.param.items():
            if self.sampling_weights and k in self.sampling_weights:
                p = np.asarray(self.sampling_weights[k], dtype=np.float64)
                p = p / p.sum()
                host[k] = self.rng.choice(len(choices), bs, p=p)
            else:
                host[k] = self.rng.integers(0, len(choices), bs)
        sampled = self._upload(host)
        self.last_sample_internal_res = (sampled,)
        return (sampled,)

    def update_params(self, cost: Tensor, draws=None) -> None:
        pass  # random search learns nothing


class LogitBasedComboOptimizerBase(ComboOptimizerBase):
    """Learnable per-parameter logits (reference :499-555)."""

    def __init__(self, param, obj_func=None, batch_size=BATCH_SIZE,
                 learning_rate: float = 0.1, anneal_rate: float = 1.0,
                 temperature: float = 1.0, min_temperature: float = 0.1, seed=0,
                 device="cuda"):
        self.learning_rate = learning_rate
        self.anneal_rate = anneal_rate
        self.temperature = temperature
        self.min_temperature = min_temperature
        super().__init__(param, obj_func, batch_size, seed, device)

    def _init(self) -> None:
        self.logits = {
            k: torch.zeros(len(v), dtype=torch.float32, device=self.device)
            for k, v in self.param.items()
        }
        self.opt = make_optimizer({"Adam": {"lr": self.learning_rate}})
        self.opt_state = self.opt.init(self.logits)

    def _gumbel(self, k: str, bs: int, draws: Optional[Draws]) -> Tensor:
        if draws is not None:
            return draws[k].to(self.device)
        return gumbel((bs, len(self.param[k])), self.generator, self.device)

    def _step(self, grads: Dict[str, Tensor]) -> None:
        with torch.no_grad():
            self.logits, self.opt_state = self.opt.update(grads, self.opt_state, self.logits)

    def sample(self, batch_size: int, temperature: float = 1.0,
               gumbel: Optional[Draws] = None) -> Dict[str, Tensor]:
        """Categorical draws from ``softmax(logits / temperature)`` by the
        Gumbel-max trick (``gumbel``: ``{name: [B, n]}``)."""
        return {k: torch.argmax(self._gumbel(k, batch_size, gumbel) + logits / temperature,
                                dim=1)
                for k, logits in self.logits.items()}


class GumbelSoftmaxOptimizer(LogitBasedComboOptimizerBase):
    """Differentiable sampling via Gumbel-softmax (reference :557-664).

    The objective must accept soft one-hot inputs; gradients flow through the
    relaxed samples into the logits (autograd).
    """

    def _soft(self, logits: Dict[str, Tensor], bs: int, uniforms: Optional[Draws]):
        soft = {}
        for k, lg in logits.items():
            if uniforms is not None:
                u = uniforms[k].to(self.device)
            else:
                u = torch.rand((bs, lg.shape[0]), generator=self.generator,
                               device=self.device).clamp(min=UNIFORM_MIN)
            g = -torch.log(-torch.log(u))
            soft[k] = torch.softmax((lg + g) / self.temperature, dim=-1)
        return soft

    def sample_internal(self, batch_size: Optional[int] = None, draws=None) -> Tuple:
        bs = batch_size or self.batch_size
        soft = self._soft(self.logits, bs, draws)
        self.last_sample_internal_res = (soft,)
        return (soft,)

    def optimize_step(self, sample_draws: Optional[Draws] = None, update_draws=None) -> Tuple:
        """One gradient step through the relaxed samples; ``sample_draws``
        the uniforms."""
        assert self.obj_func is not None
        bs = self.batch_size
        logits = {k: v.detach().requires_grad_(True) for k, v in self.logits.items()}
        soft = self._soft(logits, bs, sample_draws)
        mean_cost = torch.mean(torch.as_tensor(self.obj_func(soft)))
        grads = torch.autograd.grad(mean_cost, list(logits.values()))
        self._step(dict(zip(logits, grads)))
        self.temperature = max(self.temperature * self.anneal_rate, self.min_temperature)
        hard = {k: torch.argmax(v.detach(), dim=1) for k, v in soft.items()}
        cost_arr = np.full(bs, float(mean_cost.detach()))
        self._insert_all(cost_arr, hard)
        return hard, cost_arr

    def update_params(self, cost: Tensor, draws=None) -> None:
        pass  # folded into optimize_step (gradient-through-sampling)


class PolicyGradientOptimizer(LogitBasedComboOptimizerBase):
    """REINFORCE over the sampling distribution (reference :665-795)."""

    def sample_internal(self, batch_size: Optional[int] = None, draws=None) -> Tuple:
        bs = batch_size or self.batch_size
        sampled = self.sample(bs, gumbel=draws)
        self.last_sample_internal_res = (sampled,)
        return (sampled,)

    def update_params(self, cost: Tensor, draws=None) -> None:
        sampled = self.last_sample_internal_res[0]
        cost = torch.as_tensor(cost, device=self.device).reshape(-1)
        adv = cost - torch.mean(cost)
        logits = {k: v.detach().requires_grad_(True) for k, v in self.logits.items()}
        total = 0.0
        for k, lg in logits.items():
            logp = torch.log_softmax(lg, dim=0)
            total = total + torch.mean(adv * logp[sampled[k]])
        # minimize E[adv * logp] -> decrease the probability of high cost
        grads = torch.autograd.grad(total, list(logits.values()))
        self._step(dict(zip(logits, grads)))
        self.last_sample_internal_res = None


class QLearningOptimizer(ComboOptimizerBase):
    """Sequential choice as an MDP: pick params one at a time with a Q-net
    (reference :797-1046, simplified to a per-parameter independent Q table
    with epsilon-greedy exploration)."""

    def __init__(self, param, obj_func=None, batch_size=BATCH_SIZE,
                 learning_rate: float = 0.1, epsilon: float = 0.2, seed=0, device="cuda"):
        self.learning_rate = learning_rate
        self.epsilon = epsilon
        super().__init__(param, obj_func, batch_size, seed, device)

    def _init(self) -> None:
        # Q[k][i] = expected -cost of choosing i for param k
        self.q = {k: np.zeros(len(v)) for k, v in self.param.items()}
        self.counts = {k: np.zeros(len(v)) for k, v in self.param.items()}

    def sample_internal(self, batch_size: Optional[int] = None, draws=None) -> Tuple:
        bs = batch_size or self.batch_size
        host = {}
        for k, q in self.q.items():
            greedy = int(np.argmax(q))
            host[k] = np.where(
                self.rng.uniform(size=bs) < self.epsilon,
                self.rng.integers(0, len(q), bs),
                greedy,
            )
        sampled = self._upload(host)
        self.last_sample_internal_res = (sampled,)
        return (sampled,)

    def update_params(self, cost: Tensor, draws=None) -> None:
        sampled = self.last_sample_internal_res[0]
        cost = self._host(cost).reshape(-1)
        for k in self.q:
            idx = self._host(sampled[k])
            for i, c in zip(idx, cost):
                self.counts[k][i] += 1
                lr = self.learning_rate
                self.q[k][i] += lr * ((-c) - self.q[k][i])
        self.last_sample_internal_res = None

    def sample(self, batch_size: int, temperature: float = 1.0) -> Dict[str, Tensor]:
        return {
            k: torch.full((batch_size,), int(np.argmax(q)), dtype=torch.int64,
                          device=self.device)
            for k, q in self.q.items()
        }


def _one_hot_encode(param: Dict[str, List], sampled: Dict[str, np.ndarray]) -> np.ndarray:
    """Concatenated float64 one-hots of each parameter's choice."""
    return np.concatenate(
        [np.eye(len(choices))[sampled[k]] for k, choices in param.items()], axis=1)


class BayesianMLPEnsemblerOptimizer(ComboOptimizerBase):
    """Bayesian optimization with an MLP-ensemble surrogate (reference :1238).

    Acquisition: sample candidates, each ensemble member predicts cost, pick
    candidates with the lowest sampled predictions (Thompson-style).  The
    ensemble is float64 numpy, as JAX's, with its own ``default_rng(1)``
    init.
    """

    def __init__(self, param, obj_func=None, batch_size=BATCH_SIZE,
                 num_ensemble: int = 5, candidate_pool: int = 1024,
                 learning_rate: float = 1e-2, train_steps: int = 20, seed=0, device="cuda"):
        self.num_ensemble = num_ensemble
        self.candidate_pool = candidate_pool
        self.learning_rate = learning_rate
        self.train_steps = train_steps
        super().__init__(param, obj_func, batch_size, seed, device)

    def _init(self) -> None:
        self.dim = sum(len(v) for v in self.param.values())
        rng = np.random.default_rng(1)
        self.weights = [
            (rng.normal(0, 0.3, (self.dim, 32)), np.zeros(32),
             rng.normal(0, 0.3, (32, 1)), np.zeros(1))
            for _ in range(self.num_ensemble)
        ]
        self.xs: List[np.ndarray] = []
        self.ys: List[float] = []

    def _encode(self, sampled: Dict[str, Any]) -> np.ndarray:
        return _one_hot_encode(self.param, {k: self._host(v) for k, v in sampled.items()})

    def _predict(self, member, x):
        w1, b1, w2, b2 = member
        h = np.maximum(x @ w1 + b1, 0)
        return (h @ w2 + b2).reshape(-1)

    def _train_member(self, mi):
        x = np.stack(self.xs)
        y = np.array(self.ys)
        w1, b1, w2, b2 = self.weights[mi]
        # bootstrap resample per member
        idx = self.rng.integers(0, len(x), len(x))
        xb, yb = x[idx], y[idx]
        lr = self.learning_rate
        for _ in range(self.train_steps):
            h = np.maximum(xb @ w1 + b1, 0)
            pred = (h @ w2 + b2).reshape(-1)
            err = (pred - yb)[:, None] / len(xb)
            gw2 = h.T @ err
            gb2 = err.sum(0)
            gh = err @ w2.T * (h > 0)
            gw1 = xb.T @ gh
            gb1 = gh.sum(0)
            w1 -= lr * gw1; b1 -= lr * gb1; w2 -= lr * gw2; b2 -= lr * gb2  # noqa: E702
        self.weights[mi] = (w1, b1, w2, b2)

    def sample_internal(self, batch_size: Optional[int] = None, draws=None) -> Tuple:
        bs = batch_size or self.batch_size
        # propose random candidates, rank by a random member's prediction
        cand = {
            k: self.rng.integers(0, len(v), self.candidate_pool)
            for k, v in self.param.items()
        }
        if self.xs:
            x = self._encode(cand)
            member = self.weights[self.rng.integers(0, self.num_ensemble)]
            pred = self._predict(member, x)
            order = np.argsort(pred)[:bs]
        else:
            order = np.arange(bs)
        sampled = self._upload({k: v[order] for k, v in cand.items()})
        self.last_sample_internal_res = (sampled,)
        return (sampled,)

    def update_params(self, cost: Tensor, draws=None) -> None:
        sampled = self.last_sample_internal_res[0]
        x = self._encode(sampled)
        y = self._host(cost).reshape(-1)
        self.xs.extend(list(x))
        self.ys.extend(list(y))
        for mi in range(self.num_ensemble):
            self._train_member(mi)
        self.last_sample_internal_res = None


class NeverGradOptimizer(ComboOptimizerBase):
    """Wrapper over nevergrad (reference :368-498); without nevergrad,
    construction raises with a clear message."""

    def __init__(self, *args, **kwargs):
        try:
            import nevergrad  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "nevergrad is not installed; use RandomSearchOptimizer / "
                "PolicyGradientOptimizer / BayesianMLPEnsemblerOptimizer instead"
            ) from e
        super().__init__(*args, **kwargs)


def _gaussian_kl(params: Dict[str, Tensor], weights: Sequence[str], prior_sigma: float):
    total = 0.0
    for name in weights:
        mu, sigma = params[f"{name}_mu"], F.softplus(params[f"{name}_rho"])
        total = total + torch.sum(
            torch.log(prior_sigma / sigma)
            + (sigma**2 + mu**2) / (2 * prior_sigma**2)
            - 0.5
        )
    return total


class LinearBayesianByBackprop:
    """Variational Bayesian linear regression head (reference :1418-1477).

    Each weight ``name`` has a Gaussian posterior (``name_mu``,
    ``name_rho``); ``forward(params, x, noise)`` is the prediction on one
    posterior sample ``mu + softplus(rho) * noise[name]``.  The means start
    at 0.1 times a standard normal from a CPU generator seeded by ``seed``.
    """

    WEIGHTS: Tuple[str, ...] = ("w", "b")

    def __init__(self, input_dim: int, prior_sigma: float = 1.0, seed: int = 0,
                 device="cuda"):
        self.input_dim = input_dim
        self.prior_sigma = prior_sigma
        self.device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        params = {
            "w_mu": 0.1 * torch.randn((input_dim, 1), generator=g),
            "w_rho": torch.full((input_dim, 1), -3.0),
            "b_mu": torch.zeros((1,)),
            "b_rho": torch.full((1,), -3.0),
        }
        self.params = {k: v.to(self.device) for k, v in params.items()}

    def draw_noise(self, generator: torch.Generator) -> Draws:
        """One standard normal a weight, of its shape, on the generator's
        device."""
        return {name: torch.randn(self.params[f"{name}_mu"].shape, generator=generator,
                                  device=generator.device)
                for name in self.WEIGHTS}

    @staticmethod
    def sample(params: Dict[str, Tensor], noise: Draws, name: str) -> Tensor:
        return params[f"{name}_mu"] + F.softplus(params[f"{name}_rho"]) * noise[name]

    @classmethod
    def train_forward(cls, params, x, noise) -> Tensor:
        """The prediction under autograd."""
        return (x @ cls.sample(params, noise, "w") + cls.sample(params, noise, "b")).reshape(-1)

    @classmethod
    def forward(cls, params, x, noise) -> Tensor:
        with torch.no_grad():
            return cls.train_forward(params, x, noise)

    def kl(self, params) -> Tensor:
        return _gaussian_kl(params, self.WEIGHTS, self.prior_sigma)


class MLPBayesianByBackprop(LinearBayesianByBackprop):
    """Variational Bayesian one-hidden-layer MLP (reference :1479-1545).

    ``forward`` is one K3 launch on a CUDA tensor (the plain version on the
    CPU): both layers on the sampled weights, contiguous ``[in, out]``, relu
    then linear; ``train_forward`` is the same function under autograd."""

    WEIGHTS = ("w", "b", "w2", "b2")
    ACTIVATIONS = ("relu", "linear")

    def __init__(self, input_dim: int, hidden: int = 32, prior_sigma: float = 1.0,
                 seed: int = 0, device="cuda"):
        self.input_dim = input_dim
        self.prior_sigma = prior_sigma
        self.device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        params = {
            "w_mu": 0.1 * torch.randn((input_dim, hidden), generator=g),
            "w_rho": torch.full((input_dim, hidden), -3.0),
            "b_mu": torch.zeros((hidden,)),
            "b_rho": torch.full((hidden,), -3.0),
            "w2_mu": 0.1 * torch.randn((hidden, 1), generator=g),
            "w2_rho": torch.full((hidden, 1), -3.0),
            "b2_mu": torch.zeros((1,)),
            "b2_rho": torch.full((1,), -3.0),
        }
        self.params = {k: v.to(self.device) for k, v in params.items()}

    @classmethod
    def sampled_weights(cls, params, noise) -> List[Tuple[Tensor, Tensor]]:
        """K3's ``[(W [in, out], b)]`` of one posterior sample."""
        return [(cls.sample(params, noise, w).contiguous(), cls.sample(params, noise, b))
                for w, b in (("w", "b"), ("w2", "b2"))]

    @classmethod
    def train_forward(cls, params, x, noise) -> Tensor:
        (w, b), (w2, b2) = cls.sampled_weights(params, noise)
        h = torch.relu(x @ w + b)
        return (h @ w2 + b2).reshape(-1)

    @classmethod
    def forward(cls, params, x, noise) -> Tensor:
        with torch.no_grad():
            x = x.to(torch.float32).contiguous()
            return fused_mlp_forward(x, cls.sampled_weights(params, noise),
                                     cls.ACTIVATIONS).reshape(-1)


class BayesianByBackpropOptimizer(ComboOptimizerBase):
    """BANANAS-style Bayesian optimization with a Bayes-by-backprop surrogate
    (reference :1547-1686, method of arXiv:1910.11858).

    sample(): mutate the best solutions found so far (random mutation of a
    temperature-scaled fraction of variables), then keep the candidates whose
    Thompson-sampled (independent posterior draw) predicted cost is lowest.
    update_params(): fit the surrogate by maximizing the ELBO (MSE + KL).
    """

    def __init__(self, param, obj_func=None, batch_size=BATCH_SIZE,
                 surrogate: str = "mlp", start_temp: float = 1.0,
                 min_temp: float = 0.1, anneal_rate: float = ANNEAL_RATE,
                 num_mutations: int = 50, learning_rate: float = 1e-2,
                 train_steps: int = 50, kl_weight: float = 1e-3, seed=0, device="cuda"):
        if num_mutations < 2:
            raise ValueError("number of mutations should be more than 1")
        self.surrogate_kind = surrogate
        self.temp = start_temp
        self.min_temp = min_temp
        self.anneal_rate = anneal_rate
        self.num_mutations = num_mutations
        self.learning_rate = learning_rate
        self.train_steps = train_steps
        self.kl_weight = kl_weight
        super().__init__(param, obj_func, batch_size, seed, device)

    def _init(self) -> None:
        self.dim = sum(len(v) for v in self.param.values())
        if self.surrogate_kind == "linear":
            self.net = LinearBayesianByBackprop(self.dim, device=self.device)
        else:
            self.net = MLPBayesianByBackprop(self.dim, device=self.device)
        self.opt = make_optimizer({"Adam": {"lr": self.learning_rate}})
        self.opt_state = self.opt.init(self.net.params)
        self.xs: List[np.ndarray] = []
        self.ys: List[float] = []
        self.last_predictor_loss_mean = None

    def _train_step(self, params, opt_state, x, y, noise):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        pred = self.net.train_forward(p, x, noise)
        loss = torch.mean((pred - y) ** 2) + self.kl_weight * self.net.kl(p)
        grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            params, opt_state = self.opt.update(dict(zip(p, grads)), opt_state, params)
        return params, opt_state, loss.detach()

    def _encode(self, sampled: Dict[str, Any]) -> np.ndarray:
        return _one_hot_encode(self.param, {k: self._host(v) for k, v in sampled.items()})

    def _mutate(self, bs: int) -> Dict[str, np.ndarray]:
        best = [sol for _, sol in self.best_solutions(self.num_mutations)]
        if not best:
            return {k: self.rng.integers(0, len(v), bs) for k, v in self.param.items()}
        picks = [best[self.rng.integers(0, len(best))] for _ in range(bs)]
        keys = sorted(self.param.keys())
        n_mut = max(1, int(self.temp * len(keys)))
        out = {k: np.array([p[k] for p in picks]) for k in keys}
        for i in range(bs):
            for k in self.rng.choice(keys, n_mut, replace=False):
                out[k][i] = self.rng.integers(0, len(self.param[k]))
        return out

    def sample_internal(self, batch_size: Optional[int] = None,
                        draws: Optional[Draws] = None) -> Tuple:
        bs = batch_size or self.batch_size
        cand = self._mutate(max(bs * 4, self.num_mutations))
        if self.xs:
            x = torch.as_tensor(self._encode(cand), dtype=torch.float32, device=self.device)
            noise = draws if draws is not None else self.net.draw_noise(self.generator)
            pred = _np(self.net.forward(self.net.params, x, noise))
            order = np.argsort(pred)[:bs]
        else:
            order = np.arange(bs)
        sampled = self._upload({k: v[order] for k, v in cand.items()})
        self.last_sample_internal_res = (sampled,)
        return (sampled,)

    def update_params(self, cost: Tensor, draws: Optional[Sequence[Draws]] = None) -> None:
        sampled = self.last_sample_internal_res[0]
        self.xs.extend(list(self._encode(sampled)))
        self.ys.extend(list(self._host(cost).reshape(-1)))
        x = torch.as_tensor(np.stack(self.xs), dtype=torch.float32, device=self.device)
        y = torch.as_tensor(np.array(self.ys), dtype=torch.float32, device=self.device)
        params, opt_state = self.net.params, self.opt_state
        loss = None
        for step in range(self.train_steps):
            noise = draws[step] if draws is not None else self.net.draw_noise(self.generator)
            params, opt_state, loss = self._train_step(params, opt_state, x, y, noise)
        self.net.params, self.opt_state = params, opt_state
        self.last_predictor_loss_mean = float(loss) if loss is not None else None
        self.temp = max(self.min_temp, self.temp * self.anneal_rate)
        self.last_sample_internal_res = None
