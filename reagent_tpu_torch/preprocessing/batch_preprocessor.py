"""Batch preprocessor: raw timeline columns -> a typed batch on the device.

Port of ``reagent_tpu/preprocessing/batch_preprocessor.py`` (``sparse_to_dense``
:23, the ``BatchPreprocessor`` base :45, ``DiscreteDqnBatchPreprocessor``
:49-129, ``PolicyNetworkBatchPreprocessor`` :132-165).  The column decoding runs in
numpy on the host, as in the JAX package; the normalization runs on the
preprocessor's device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.preprocessing.preprocessor import Preprocessor


def sparse_to_dense(
    feature_dicts: Sequence[Optional[Dict]], sorted_features: List[int]
) -> Tuple[np.ndarray, np.ndarray]:
    """map<feature_id, value> rows -> (values, presence) in sorted-feature order."""
    n, f = len(feature_dicts), len(sorted_features)
    values = np.zeros((n, f), np.float32)
    presence = np.zeros((n, f), np.float32)
    col = {fid: j for j, fid in enumerate(sorted_features)}
    for i, d in enumerate(feature_dicts):
        if not d:
            continue
        for fid, v in d.items():
            j = col.get(int(fid))
            if j is not None and v is not None:
                values[i, j] = v
                presence[i, j] = 1.0
    return values, presence


class BatchPreprocessor:
    """The base of the batch preprocessors: ``__call__(batch_df)`` turns a
    DataFrame of timeline rows into a typed batch."""


class DiscreteDqnBatchPreprocessor(BatchPreprocessor):
    """Reference: batch_preprocessor.py:26-50."""

    def __init__(
        self,
        num_actions: int,
        state_preprocessor: Preprocessor,
        action_names: Optional[Sequence[str]] = None,
        device="cpu",
    ):
        """``state_preprocessor`` must already live on ``device``."""
        self.num_actions = num_actions
        self.device = torch.device(device)
        self.state_preprocessor = state_preprocessor
        self.action_names = list(action_names) if action_names else [
            str(i) for i in range(num_actions)
        ]
        self._a2i = {a: i for i, a in enumerate(self.action_names)}

    def _one_hot_actions(self, actions: Sequence) -> np.ndarray:
        out = np.zeros((len(actions), self.num_actions), np.float32)
        for i, a in enumerate(actions):
            j = self._a2i.get(str(a))
            if j is not None:
                out[i, j] = 1.0
        return out

    def _possible_mask(self, rows: Sequence) -> np.ndarray:
        out = np.zeros((len(rows), self.num_actions), np.float32)
        for i, pa in enumerate(rows):
            if pa is None or (isinstance(pa, float) and np.isnan(pa)):
                continue
            for a in pa:
                j = self._a2i.get(str(a))
                if j is not None:
                    out[i, j] = 1.0
        return out

    def __call__(self, batch_df: pd.DataFrame) -> rlt.DiscreteDqnInput:
        dev = self.device

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.tensor(a, device=dev)

        sf = self.state_preprocessor.sorted_features
        sv, sp = sparse_to_dense(batch_df["state_features"].tolist(), sf)
        nv, npres = sparse_to_dense(batch_df["next_state_features"].tolist(), sf)
        state = self.state_preprocessor(put(sv), put(sp))
        next_state = self.state_preprocessor(put(nv), put(npres))

        action = self._one_hot_actions(batch_df["action"].tolist())
        next_action = self._one_hot_actions(batch_df["next_action"].tolist())
        not_terminal = batch_df["not_terminal"].to_numpy(np.float32).reshape(-1, 1)
        if "possible_actions" in batch_df.columns:
            pam = self._possible_mask(batch_df["possible_actions"].tolist())
        else:
            pam = np.ones((len(batch_df), self.num_actions), np.float32)
        if "possible_next_actions" in batch_df.columns:
            pnam = self._possible_mask(batch_df["possible_next_actions"].tolist())
        else:
            pnam = np.tile(not_terminal, (1, self.num_actions))

        B = len(batch_df)
        mdp_codes = pd.factorize(pd.Series([str(m) for m in batch_df["mdp_id"].tolist()]))[0]
        action_probability = (
            batch_df["action_probability"].to_numpy(np.float32)
            if "action_probability" in batch_df.columns
            else np.ones(B, np.float32)
        )
        extras = rlt.ExtraData(
            mdp_id=put(mdp_codes.reshape(-1, 1)),
            sequence_number=put(
                batch_df["sequence_number"].to_numpy(np.int64).reshape(-1, 1)
            ),
            action_probability=put(action_probability.reshape(-1, 1)),
        )
        return rlt.DiscreteDqnInput(
            state=rlt.FeatureData(float_features=state),
            next_state=rlt.FeatureData(float_features=next_state),
            action=put(action),
            next_action=put(next_action),
            reward=put(batch_df["reward"].to_numpy(np.float32).reshape(-1, 1)),
            time_diff=put(batch_df["time_diff"].to_numpy(np.float32).reshape(-1, 1)),
            step=torch.ones((B, 1), dtype=torch.int32, device=dev),
            not_terminal=put(not_terminal),
            possible_actions_mask=put(pam),
            possible_next_actions_mask=put(pnam),
            extras=extras,
        )


class PolicyNetworkBatchPreprocessor(BatchPreprocessor):
    """Continuous actions as map<fid, value> (reference batch_preprocessor.py:96):
    four ``sparse_to_dense`` decodes a batch (state, next state, action, next
    action), each normalized on ``device``."""

    def __init__(self, state_preprocessor: Preprocessor, action_preprocessor: Preprocessor,
                 device="cpu"):
        """Both preprocessors must already live on ``device``."""
        self.state_preprocessor = state_preprocessor
        self.action_preprocessor = action_preprocessor
        self.device = torch.device(device)

    def __call__(self, batch_df: pd.DataFrame) -> rlt.PolicyNetworkInput:
        dev = self.device

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.tensor(a, device=dev)

        def dense(column, preprocessor):
            values, presence = sparse_to_dense(
                batch_df[column].tolist(), preprocessor.sorted_features)
            return rlt.FeatureData(float_features=preprocessor(put(values), put(presence)))

        B = len(batch_df)
        return rlt.PolicyNetworkInput(
            state=dense("state_features", self.state_preprocessor),
            next_state=dense("next_state_features", self.state_preprocessor),
            action=dense("action", self.action_preprocessor),
            next_action=dense("next_action", self.action_preprocessor),
            reward=put(batch_df["reward"].to_numpy(np.float32).reshape(-1, 1)),
            time_diff=put(batch_df["time_diff"].to_numpy(np.float32).reshape(-1, 1)),
            step=torch.ones((B, 1), dtype=torch.int32, device=dev),
            not_terminal=put(batch_df["not_terminal"].to_numpy(np.float32).reshape(-1, 1)),
        )
