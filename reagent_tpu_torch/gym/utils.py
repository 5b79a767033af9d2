"""Gym utilities: normalizers from env spaces, replay -> DataFrame export.

Port of ``reagent_tpu/gym/utils.py`` (``only_continuous_normalizer``,
``discrete_action_normalizer``, ``build_state_normalizer``,
``build_action_normalizer``, ``build_normalizer``,
``create_df_from_replay_buffer``, :29-148; reference reagent/gym/
utils.py:43-260).  ``create_df_from_replay_buffer`` reads the port's
``ReplayBufferState`` on the host and returns the columns
``data/timeline.py`` consumes.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import pandas as pd

from reagent_tpu_torch.core.parameters import (
    NormalizationData,
    NormalizationKey,
    NormalizationParameters,
)

try:  # gymnasium is optional: the functional envs need none
    from gymnasium import spaces
except ImportError:  # pragma: no cover
    spaces = None


def only_continuous_normalizer(
    feature_ids: List[int],
    min_value=None,
    max_value=None,
) -> Dict[int, NormalizationParameters]:
    """CONTINUOUS params with optional clipping bounds (ref gym/utils.py:60-80)."""
    min_value = np.broadcast_to(
        np.asarray(min_value if min_value is not None else np.nan), len(feature_ids)
    )
    max_value = np.broadcast_to(
        np.asarray(max_value if max_value is not None else np.nan), len(feature_ids)
    )
    return {
        fid: NormalizationParameters(
            feature_type="CONTINUOUS",
            mean=0.0,
            stddev=1.0,
            min_value=None if np.isnan(lo) or np.isinf(lo) else float(lo),
            max_value=None if np.isnan(hi) or np.isinf(hi) else float(hi),
        )
        for fid, lo, hi in zip(feature_ids, min_value, max_value)
    }


def discrete_action_normalizer(
    feature_ids: List[int],
) -> Dict[int, NormalizationParameters]:
    return {
        fid: NormalizationParameters(feature_type="DO_NOT_PREPROCESS", mean=0.0, stddev=1.0)
        for fid in feature_ids
    }


def build_state_normalizer(env) -> Dict[int, NormalizationParameters]:
    """From a gym Box observation space, or a functional env (ref :93-108)."""
    obs_dim = getattr(env, "observation_dim", None)
    if obs_dim is not None:  # a functional env
        return only_continuous_normalizer(list(range(obs_dim)))
    space = env.observation_space
    if spaces is not None and isinstance(space, spaces.Box):
        assert len(space.shape) == 1, f"{space.shape} has dim > 1: unsupported"
        return only_continuous_normalizer(
            list(range(space.shape[0])), space.low, space.high
        )
    raise NotImplementedError(f"{space} not supported")


def build_action_normalizer(env) -> Dict[int, NormalizationParameters]:
    """Reference :110-126."""
    if getattr(env, "discrete", None) is not None:  # functional env
        if env.discrete:
            return discrete_action_normalizer(list(range(env.action_dim)))
        return only_continuous_normalizer(list(range(env.action_dim)), -1.0, 1.0)
    space = env.action_space
    if spaces is not None and isinstance(space, spaces.Discrete):
        return discrete_action_normalizer(list(range(space.n)))
    if spaces is not None and isinstance(space, spaces.Box):
        assert len(space.shape) == 1
        return only_continuous_normalizer(
            list(range(space.shape[0])), space.low, space.high
        )
    raise NotImplementedError(f"{space} not supported")


def build_normalizer(env) -> Dict[str, NormalizationData]:
    """Reference :129-155."""
    explicit = getattr(env, "normalization_data", None)
    if explicit is not None:
        return explicit
    return {
        NormalizationKey.STATE: NormalizationData(
            dense_normalization_parameters=build_state_normalizer(env)
        ),
        NormalizationKey.ACTION: NormalizationData(
            dense_normalization_parameters=build_action_normalizer(env)
        ),
    }


def create_df_from_replay_buffer(
    rb,
    rb_state,
    discrete_action: bool = True,
    ds: str = "2026-01-01",
) -> pd.DataFrame:
    """Dump valid transitions as pre-timeline rows (ref gym/utils.py:157-260).

    Produces the same column contract consumed by data.timeline — a bridge
    from a device-resident buffer to the offline batch workflow.
    """
    store = {k: v.cpu().numpy() for k, v in rb_state.store.items()}
    valid = rb_state.is_valid.cpu().numpy()
    idx = np.nonzero(valid)[0]
    rows = []
    mdp_id, seq = 0, 0
    for i in idx:
        obs = store["observation"][i]
        action = store["action"][i]
        terminal = bool(store["terminal"][i])
        row = {
            "ds": ds,
            "mdp_id": str(mdp_id),
            "sequence_number": seq,
            "state_features": {j: float(v) for j, v in enumerate(np.ravel(obs))},
            "action": (
                str(int(action))
                if discrete_action
                else {j: float(v) for j, v in enumerate(np.ravel(action))}
            ),
            "reward": float(store["reward"][i]),
            "action_probability": 1.0,
            "metrics": {"reward": float(store["reward"][i])},
        }
        if discrete_action:
            num_actions = int(store["action"].max()) + 1
            row["possible_actions"] = [str(a) for a in range(num_actions)]
        rows.append(row)
        seq += 1
        if terminal:
            mdp_id += 1
            seq = 0
    return pd.DataFrame(rows)
