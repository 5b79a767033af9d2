"""CartPole sequential-OPE benchmark: IPS/DR/MAGIC vs on-policy truth.

Port of ``reagent_tpu/ope/test/cartpole.py`` on the port's functional
CartPole (``gym/envs/functional.py``).

Reference: reagent/ope/test/cartpole.py — roll out a behavior policy on
CartPole, estimate the value of a better target policy with the sequential
estimators, compare against the target policy's true (simulated) value.

The N episodes step as one batch (JAX's ``vmap``), each act step one K3
launch of the Q-network on ``[N, 4]`` (``training/functional.py::score``),
and the logged states' Q-values one K3 launch on ``[N * T, 4]``.  Where JAX
splits a key, the rollout takes its draws as values (``RolloutDraws``: the
reset uniforms and the gumbels of each step's categorical draw, which is the
argmax of the logits plus a gumbel) or draws them from a ``torch.Generator``.
The rollout reads nothing back to the host until it ends.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from reagent_tpu_torch.gym.envs.functional import CartPole
from reagent_tpu_torch.gym.policies.samplers import gumbel
from reagent_tpu_torch.ope.estimators.sequential_estimators import (
    DoublyRobustEstimator,
    IPSEstimator,
    MAGICEstimator,
    RLEstimatorInput,
)

Tensor = torch.Tensor


@dataclasses.dataclass
class RolloutDraws:
    """A batch rollout's draws: reset uniforms ``[N, 4]`` and the gumbels of
    the categorical draws ``[N, T, A]``."""

    reset_uniforms: Tensor
    gumbels: Tensor

    def to(self, device) -> "RolloutDraws":
        return RolloutDraws(self.reset_uniforms.to(device), self.gumbels.to(device))


def draw_rollout_noise(env, num_episodes: int, horizon: int,
                       generator: torch.Generator) -> RolloutDraws:
    """The draws of ``num_episodes`` episodes of ``horizon`` steps from
    ``generator``, on its device."""
    dev = generator.device
    return RolloutDraws(
        torch.rand((num_episodes, env.reset_noise_dim), generator=generator, device=dev),
        gumbel((num_episodes, horizon, env.action_dim), generator, dev))


def _rollout(env, scores_fn, temperature: float, num_episodes: int, horizon: int,
             draws: RolloutDraws) -> Dict[str, Tensor]:
    """The batch rollout on the env's device: states [N, T, 4], actions,
    rewards, the softmax propensities [N, T, A] and the valid mask."""
    draws = draws.to(env.device)
    if tuple(draws.gumbels.shape[:2]) != (num_episodes, horizon):
        raise ValueError(f"draws for {tuple(draws.gumbels.shape[:2])} episodes x steps, "
                         f"not ({num_episodes}, {horizon})")
    state, obs = env.reset_from_uniform(draws.reset_uniforms)
    done = torch.zeros(num_episodes, dtype=torch.bool, device=env.device)
    out = {k: [] for k in ("states", "actions", "rewards", "propensities", "mask")}
    for t in range(horizon):
        logits = scores_fn(obs) / temperature
        probs = torch.softmax(logits, dim=-1)
        a = torch.argmax(logits + draws.gumbels[:, t], dim=-1).to(torch.int32)
        state, nobs, reward, ndone = env.step(state, a)
        valid = ~done
        for k, v in (("states", obs), ("actions", a), ("rewards", reward * valid),
                     ("propensities", probs), ("mask", valid)):
            out[k].append(v)
        obs, done = nobs, done | ndone
    return {k: torch.stack(v, dim=1) for k, v in out.items()}


def _host(rollout: Dict[str, Tensor]) -> Dict[str, np.ndarray]:
    out = {k: v.cpu().numpy() for k, v in rollout.items()}
    out["mask"] = out["mask"].astype(np.float64)
    return out


def q_scores(q_network, params):
    """obs [N, 4] -> Q-values [N, A] of the port's Q-network with ``params``
    by name: one K3 launch on a CUDA tensor (``training/functional.py::
    score``)."""
    from reagent_tpu_torch.training.functional import score

    return lambda obs: score(q_network, params, obs)


def collect_trajectories(
    env: CartPole,
    scores_fn,  # obs [N, S] -> action scores [N, A]
    temperature: float,
    num_episodes: int,
    horizon: int,
    draws: Optional[RolloutDraws] = None,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, np.ndarray]:
    """Batched softmax-policy rollouts with per-step propensities, as numpy
    arrays; ``draws`` as ``draw_rollout_noise`` returns them, else drawn from
    ``generator``."""
    if draws is None:
        if generator is None:
            raise ValueError("collect_trajectories needs its draws or a generator")
        draws = draw_rollout_noise(env, num_episodes, horizon, generator)
    return _host(_rollout(env, scores_fn, temperature, num_episodes, horizon, draws))


def evaluate_cartpole(
    q_network,
    params,
    behavior_temperature: float = 2.0,
    target_temperature: float = 0.2,
    num_episodes: int = 200,
    horizon: int = 100,
    gamma: float = 0.99,
    seed: int = 0,
    max_steps: Optional[int] = None,
    draws: Optional[Tuple[RolloutDraws, RolloutDraws]] = None,
    device="cuda",
    return_logs: bool = False,
):
    """Log with a high-temperature policy; estimate the sharp policy's value.

    ``q_network`` is the port's Q-network module and ``params`` its
    parameters by name (``training/functional.py``); ``draws`` the logging
    and the target rollouts' draws, else both drawn from a generator on
    ``device`` seeded with ``seed``.  Returns (the estimates by name, the
    target policy's simulated value), and the logged rollout as numpy arrays
    (``collect_trajectories``'s) after them with ``return_logs``."""
    env = CartPole(max_steps=max_steps or horizon, device=device)
    scores_fn = q_scores(q_network, {k: v.to(env.device) for k, v in params.items()})
    if draws is None:
        generator = torch.Generator(env.device).manual_seed(seed)
        draws = tuple(draw_rollout_noise(env, num_episodes, horizon, generator)
                      for _ in range(2))
    log_draws, tgt_draws = draws

    rollout = _rollout(env, scores_fn, behavior_temperature, num_episodes, horizon, log_draws)
    N, T = rollout["actions"].shape
    # the logged states' Q-values: one forward over [N * T, 4]
    q_all = scores_fn(rollout["states"].reshape(N * T, -1)).reshape(N, T, -1)
    # ground truth: run the target policy itself
    truth = _rollout(env, scores_fn, target_temperature, num_episodes, horizon, tgt_draws)
    logs = _host(rollout)
    q_all = q_all.cpu().numpy()
    truth = _host(truth)

    # logged propensity of the taken action / target propensities per step
    log_prop = logs["propensities"][
        np.arange(N)[:, None], np.arange(T)[None, :], logs["actions"]
    ]
    tgt_logits = q_all / target_temperature
    tgt_prop = np.exp(tgt_logits - tgt_logits.max(-1, keepdims=True))
    tgt_prop /= tgt_prop.sum(-1, keepdims=True)

    decay = gamma ** np.arange(T)
    gt = float(np.mean(np.sum(truth["rewards"] * truth["mask"] * decay, axis=1)))

    einput = RLEstimatorInput(
        gamma=gamma,
        actions=logs["actions"],
        rewards=logs["rewards"],
        log_propensities=log_prop,
        tgt_propensities=tgt_prop,
        mask=logs["mask"],
        q_values=q_all,
        ground_truth_reward=gt,
    ).with_absorbing_padding()
    results = {
        "ips": IPSEstimator().evaluate(einput),
        "dr": DoublyRobustEstimator().evaluate(einput),
        "magic": MAGICEstimator().evaluate(einput),
    }
    return (results, gt, logs) if return_logs else (results, gt)
