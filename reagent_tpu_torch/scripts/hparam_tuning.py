"""Hyper-parameter tuning: seed-averaged parallel evaluation + search loop.

Port of ``reagent_tpu/scripts/hparam_tuning.py``, a copy (numpy and scipy;
no tensor of its own: ``eval_fn`` trains on whatever device it chooses).
Reference: reagent/scripts/hparam_tuning.py:20-207 (Ax-backed there; Ax is not a
dependency of the port, so the search loops are a grid and a GP with
expected improvement, with the same evaluate-params contract).
"""

from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def evaluate_params(
    params_list: List[Dict],
    fixed_params: Dict,
    eval_fn: Callable[[Dict], Dict[str, float]],
    parse_params_fn: Optional[Callable] = None,
    num_seeds: int = 10,
    num_proc: int = 4,
) -> List[Dict[str, Tuple[float, float]]]:
    """Evaluate each config averaged over seeds (reference ax_evaluate_params).

    Returns, per config, {metric: (mean, sem)} across seeds.
    """
    jobs = []
    for ci, params in enumerate(params_list):
        for s in range(num_seeds):
            p = copy.deepcopy(params)
            p.update(fixed_params)
            p["seed"] = s
            if parse_params_fn is not None:
                p = parse_params_fn(p)
            jobs.append((ci, p))

    if num_proc > 1:
        with ThreadPoolExecutor(max_workers=num_proc) as pool:
            metrics = list(pool.map(lambda job: eval_fn(job[1]), jobs))
    else:
        metrics = [eval_fn(p) for _, p in jobs]

    results: List[Dict[str, Tuple[float, float]]] = []
    for ci in range(len(params_list)):
        per_metric: Dict[str, List[float]] = {}
        for (cj, _), m in zip(jobs, metrics):
            if cj != ci:
                continue
            for k, v in m.items():
                per_metric.setdefault(k, []).append(v)
        results.append(
            {
                k: (float(np.mean(v)), float(np.std(v) / np.sqrt(len(v))))
                for k, v in per_metric.items()
            }
        )
    return results


def grid_search(
    param_grid: Dict[str, Sequence],
    eval_fn: Callable[[Dict], Dict[str, float]],
    objective: str,
    fixed_params: Optional[Dict] = None,
    num_seeds: int = 3,
    minimize: bool = False,
    num_proc: int = 4,
) -> Tuple[Dict, Dict[str, Tuple[float, float]]]:
    """Exhaustive grid search returning (best_params, best_metrics)."""
    import itertools

    keys = list(param_grid)
    configs = [
        dict(zip(keys, combo)) for combo in itertools.product(*param_grid.values())
    ]
    results = evaluate_params(
        configs, fixed_params or {}, eval_fn, num_seeds=num_seeds, num_proc=num_proc
    )
    scores = [r[objective][0] for r in results]
    best = int(np.argmin(scores) if minimize else np.argmax(scores))
    return configs[best], results[best]


# ---------------------------------------------------------------- Bayesian


def _encode(config: Dict, space: List[Dict]) -> np.ndarray:
    """Config -> unit-cube vector (range params min-max scaled, choice params
    index-scaled)."""
    xs = []
    for p in space:
        v = config[p["name"]]
        if p["type"] == "range":
            lo, hi = p["bounds"]
            xs.append((float(v) - lo) / max(hi - lo, 1e-12))
        else:
            vals = list(p["values"])
            xs.append(vals.index(v) / max(len(vals) - 1, 1))
    return np.asarray(xs, np.float64)


def _sample_config(space: List[Dict], rng: np.random.Generator) -> Dict:
    out = {}
    for p in space:
        if p["type"] == "range":
            lo, hi = p["bounds"]
            v = float(rng.uniform(lo, hi))
            if p.get("value_type") == "int":
                v = int(round(v))
            out[p["name"]] = v
        else:
            out[p["name"]] = p["values"][int(rng.integers(len(p["values"])))]
    return out


def bayesian_search(
    param_space: List[Dict],
    eval_fn: Callable[[Dict], Dict[str, float]],
    objective: str,
    fixed_params: Optional[Dict] = None,
    num_iterations: int = 20,
    num_random_init: int = 5,
    num_seeds: int = 3,
    minimize: bool = False,
    num_proc: int = 4,
    num_candidates: int = 512,
    length_scale: float = 0.25,
    noise: float = 1e-3,
    seed: int = 0,
) -> Tuple[Dict, Dict[str, Tuple[float, float]]]:
    """GP + expected-improvement Bayesian optimization.

    The reference delegates this to Ax (reagent/scripts/hparam_tuning.py:20
    ``ax_evaluate_params`` inside an AxClient loop); Ax is not a dependency,
    so this is a self-contained GP-EI loop with the same parameter-space
    schema (list of {"name", "type": "range"|"choice", "bounds"|"values"})
    and the same seed-averaged evaluation contract.

    Returns (best_params, best_metrics).
    """
    rng = np.random.default_rng(seed)
    sign = 1.0 if minimize else -1.0  # internally minimize sign * objective

    observed_cfgs: List[Dict] = []
    observed_results: List[Dict[str, Tuple[float, float]]] = []
    X: List[np.ndarray] = []
    y: List[float] = []

    def evaluate(cfg: Dict) -> None:
        res = evaluate_params(
            [cfg], fixed_params or {}, eval_fn, num_seeds=num_seeds,
            num_proc=num_proc,
        )[0]
        observed_cfgs.append(cfg)
        observed_results.append(res)
        X.append(_encode(cfg, param_space))
        y.append(sign * res[objective][0])

    for _ in range(min(num_random_init, num_iterations)):
        evaluate(_sample_config(param_space, rng))

    for _ in range(num_iterations - len(observed_cfgs)):
        Xa = np.stack(X)
        ya = np.asarray(y)
        mu_y, std_y = ya.mean(), max(ya.std(), 1e-9)
        yn = (ya - mu_y) / std_y

        def k(a, b):
            d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
            return np.exp(-d2 / (2 * length_scale**2))

        Kxx = k(Xa, Xa) + noise * np.eye(len(Xa))
        L = np.linalg.cholesky(Kxx)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))

        cands = [_sample_config(param_space, rng) for _ in range(num_candidates)]
        Xc = np.stack([_encode(c, param_space) for c in cands])
        Kxc = k(Xa, Xc)
        mu = Kxc.T @ alpha
        v = np.linalg.solve(L, Kxc)
        var = np.clip(1.0 - (v**2).sum(0), 1e-12, None)
        sd = np.sqrt(var)
        best_y = yn.min()
        # expected improvement (minimization form)
        from scipy.stats import norm as _norm

        z = (best_y - mu) / sd
        ei = (best_y - mu) * _norm.cdf(z) + sd * _norm.pdf(z)
        evaluate(cands[int(np.argmax(ei))])

    scores = [sign * r[objective][0] for r in observed_results]
    best = int(np.argmin(scores))
    return observed_cfgs[best], observed_results[best]
