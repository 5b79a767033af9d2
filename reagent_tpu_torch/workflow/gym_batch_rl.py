"""Gym batch-RL pipeline: collect random data -> timeline -> train -> evaluate.

Port of ``reagent_tpu/workflow/gym_batch_rl.py`` (reference:
reagent/workflow/gym_batch_rl.py:66-220) — the 4-command offline E2E
(offline_gym_random, timeline_operator, identify_and_train_network,
evaluate_gym).  The Spark JVM boundary dissolves into the pandas timeline.
The rows, the random draws and their order are the JAX package's, so both
write the same pre-timeline pickle and the same table from one seed; the
artifact is scored on the host by ``load_predictor``.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import pandas as pd

from reagent_tpu_torch.data.data_module import TableSpec
from reagent_tpu_torch.data.timeline import timeline_transform
from reagent_tpu_torch.gym.envs.gym_env import Gym
from reagent_tpu_torch.prediction.predictor_wrapper import load_predictor

logger = logging.getLogger(__name__)

def offline_gym_random(
    env_name: str,
    pkl_path: str,
    num_train_transitions: int,
    max_steps: Optional[int] = None,
    seed: int = 1,
) -> None:
    """Random-policy rollouts -> pre-timeline pandas pickle (reference :66-84)."""
    env = Gym(env_name=env_name, set_max_steps=max_steps)
    df = random_rollouts(env, num_train_transitions, seed)
    env.close()
    logger.info("Saving %d pre-timeline rows to %s", len(df), pkl_path)
    df.to_pickle(pkl_path)


def random_rollouts(env, num_train_transitions: int, seed: int) -> pd.DataFrame:
    """``num_train_transitions`` rows of uniformly random actions in ``env``
    (a ``Gym``-like ``reset(seed) -> obs``, ``step(action) -> (obs, reward,
    done)`` with an ``action_space``: discrete where it has ``n``, else a box
    with ``low`` and ``high``), in the pre-timeline columns.  The env resets
    with ``seed`` once, then unseeded after each episode; the actions come
    from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    rows = []
    mdp_id = 0
    obs = env.reset(seed=seed)
    seq = 0
    discrete = hasattr(env.action_space, "n")
    num_actions = env.action_space.n if discrete else None
    while len(rows) < num_train_transitions:
        if discrete:
            action = int(rng.integers(0, num_actions))
            action_str = str(action)
            action_prob = 1.0 / num_actions
            possible_actions = [str(a) for a in range(num_actions)]
        else:
            action = rng.uniform(env.action_space.low, env.action_space.high)
            action_str = {i: float(v) for i, v in enumerate(action)}
            action_prob = 1.0
            possible_actions = None
        next_obs, reward, done = env.step(action)
        row = {
            "ds": "2026-01-01",
            "mdp_id": str(mdp_id),
            "sequence_number": seq,
            "state_features": {i: float(v) for i, v in enumerate(obs)},
            "action": action_str,
            "reward": float(reward),
            "action_probability": action_prob,
            "metrics": {"reward": float(reward)},
        }
        if possible_actions is not None:
            row["possible_actions"] = possible_actions
        rows.append(row)
        seq += 1
        obs = next_obs
        if done:
            mdp_id += 1
            seq = 0
            obs = env.reset()
    return pd.DataFrame(rows)


def timeline_operator(pkl_path: str, input_table_spec: TableSpec) -> None:
    """pandas timeline transform -> parquet/pickle table (reference :138-170)."""
    df = pd.read_pickle(pkl_path)
    out = timeline_transform(df)
    out_path = input_table_spec.path or (pkl_path + ".timeline.pkl")
    out.to_pickle(out_path)
    logger.info("Timeline table with %d rows written to %s", len(out), out_path)


def greedy_returns(predictor, env, num_eval_episodes: int, seed: int = 0) -> list:
    """The return of each of ``num_eval_episodes`` episodes of ``env`` (a
    ``Gym``-like ``reset(seed) -> obs``, ``step(action) -> (obs, reward,
    done)``), acting by ``predictor``: an actor's action as it is, else the
    argmax of the action scores; episode ``i`` resets with ``seed + i``."""
    continuous = predictor.model_type == "actor"
    returns = []
    for ep in range(num_eval_episodes):
        obs = env.reset(seed=seed + ep)
        total, done = 0.0, False
        while not done:
            features = {i: float(v) for i, v in enumerate(np.asarray(obs).reshape(-1))}
            if continuous:
                action = np.asarray(predictor.predict(features)).reshape(-1)
            else:
                _, q = predictor.predict(features)
                action = int(np.argmax(np.asarray(q).reshape(-1)))
            obs, reward, done = env.step(action)
            total += reward
        returns.append(total)
    return returns


def evaluate_gym(
    env_name: str,
    model_path: str,
    num_eval_episodes: int = 20,
    passing_score_bar: Optional[float] = None,
    max_steps: Optional[int] = None,
    seed: int = 0,
) -> float:
    """Load the exported serving artifact, run greedy episodes (reference
    gym_batch_rl.py:173-220); raises ``AssertionError`` below
    ``passing_score_bar``.  ``load_predictor`` dispatches on the artifact's
    model_type: the discrete-DQN artifact acts by the argmax of its scores,
    the actor artifact by its action (continuous control)."""
    predictor = load_predictor(model_path)
    env = Gym(env_name=env_name, set_max_steps=max_steps)
    returns = greedy_returns(predictor, env, num_eval_episodes, seed)
    env.close()
    mean_reward = float(np.mean(returns))
    logger.info("Mean eval reward over %d episodes: %.1f", num_eval_episodes, mean_reward)
    if passing_score_bar is not None and not mean_reward >= passing_score_bar:
        raise AssertionError(f"{mean_reward} <= {passing_score_bar}, eval failed")
    return mean_reward
