"""EvaluationDataPage: everything CPE needs about one evaluation pass.

Port of ``reagent_tpu/evaluation/evaluation_data_page.py`` (reference:
reagent/evaluation/evaluation_data_page.py:30-52 fields,
create_from_tensors_dqn :309, create_from_tensors_parametric_dqn :186,
compute_values :496, validate :542, set_metric_as_reward :628).  The page
holds numpy arrays on the host, as the JAX package's does.  Both factories
run their forwards through ``training.functional.score``: a float32 dense
MLP or critic on a CUDA tensor is one K3 launch each.  The seq2slate page
waits for ``ROADMAP.md`` §1 item 10.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.training import functional


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@dataclasses.dataclass
class EvaluationDataPage:
    """Arrays are numpy on host (evaluation is not the training hot loop)."""

    mdp_id: Optional[np.ndarray]
    sequence_number: Optional[np.ndarray]
    logged_propensities: np.ndarray  # [N, 1]
    logged_rewards: np.ndarray  # [N, 1]
    action_mask: np.ndarray  # [N, A] one-hot logged action
    model_propensities: np.ndarray  # [N, A] target-policy propensities
    model_rewards: np.ndarray  # [N, A] predicted reward per action
    model_rewards_for_logged_action: np.ndarray  # [N, 1]
    model_values: Optional[np.ndarray] = None  # [N, A] Q-values
    possible_actions_mask: Optional[np.ndarray] = None
    optimal_q_values: Optional[np.ndarray] = None
    eval_action_idxs: Optional[np.ndarray] = None
    logged_values: Optional[np.ndarray] = None
    logged_metrics: Optional[np.ndarray] = None
    logged_metrics_values: Optional[np.ndarray] = None
    model_metrics: Optional[np.ndarray] = None
    model_metrics_for_logged_action: Optional[np.ndarray] = None
    model_metrics_values: Optional[np.ndarray] = None
    model_metrics_values_for_logged_action: Optional[np.ndarray] = None
    contexts: Optional[np.ndarray] = None

    def replace(self, **kwargs) -> "EvaluationDataPage":
        return dataclasses.replace(self, **kwargs)

    # ------------------------------------------------------------ factories

    @classmethod
    def create_from_training_batch(
        cls, tdb, trainer, trainer_state
    ) -> "EvaluationDataPage":
        """A page from a typed batch (reference evaluation_data_page.py:53-88):
        ``DiscreteDqnInput`` -> ``create_from_tensors_dqn``,
        ``ParametricDqnInput`` -> ``create_from_tensors_parametric_dqn``."""
        extras = getattr(tdb, "extras", None) or rlt.ExtraData()
        if isinstance(tdb, rlt.DiscreteDqnInput):
            return cls.create_from_tensors_dqn(
                trainer,
                trainer_state,
                mdp_ids=extras.mdp_id,
                sequence_numbers=extras.sequence_number,
                states=tdb.state.float_features,
                actions=tdb.action,
                propensities=extras.action_probability,
                rewards=tdb.reward,
                possible_actions_mask=tdb.possible_actions_mask,
                metrics=extras.metrics,
            )
        if isinstance(tdb, rlt.ParametricDqnInput):
            return cls.create_from_tensors_parametric_dqn(
                trainer,
                trainer_state,
                mdp_ids=extras.mdp_id,
                sequence_numbers=extras.sequence_number,
                states=tdb.state.float_features,
                actions=tdb.action.float_features,
                propensities=extras.action_probability,
                rewards=tdb.reward,
                possible_actions_mask=tdb.possible_actions_mask,
                possible_actions=tdb.possible_actions.float_features,
                max_num_actions=extras.max_num_actions or tdb.possible_actions_mask.shape[1],
                metrics=extras.metrics,
            )
        raise NotImplementedError(f"training_input type: {type(tdb).__name__}")

    @classmethod
    def create_from_tensors_dqn(
        cls,
        trainer,
        trainer_state,
        mdp_ids,
        sequence_numbers,
        states: torch.Tensor,
        actions: torch.Tensor,
        propensities: torch.Tensor,
        rewards: torch.Tensor,
        possible_actions_mask: torch.Tensor,
        metrics: Optional[torch.Tensor] = None,
    ) -> "EvaluationDataPage":
        """Forward the trainer's Q, reward and CPE networks over logged data
        (reference evaluation_data_page.py:309-404).  ``metrics`` is
        accepted as the JAX package's signature has it, and not stored."""
        temperature = getattr(trainer.rl, "temperature", 1.0)
        with torch.no_grad():
            mask = possible_actions_mask.to(torch.float32)
            optimal_q_values = functional.score(trainer.q_network, trainer_state.q_params, states)
            eval_action_idxs = torch.argmax(optimal_q_values + (1 - mask) * -1e9, dim=1)
            model_propensities = torch.softmax(
                optimal_q_values / max(temperature, 1e-9)
                + torch.log(torch.clamp(mask, 1e-20, 1.0)),
                dim=1,
            )
            if trainer_state.cpe_params is not None:
                model_values = functional.score(
                    trainer.q_network_cpe, trainer_state.cpe_params, states)
            else:
                model_values = optimal_q_values
            if trainer_state.reward_params is not None:
                model_rewards = functional.score(
                    trainer.reward_network, trainer_state.reward_params, states)
            else:
                model_rewards = torch.zeros_like(optimal_q_values)
            rewards_for_logged = torch.sum(model_rewards * actions, dim=1, keepdim=True)

        return cls(
            mdp_id=_host(mdp_ids),
            sequence_number=_host(sequence_numbers),
            logged_propensities=_host(propensities).reshape(-1, 1),
            logged_rewards=_host(rewards).reshape(-1, 1),
            action_mask=_host(actions),
            model_propensities=_host(model_propensities),
            model_rewards=_host(model_rewards),
            model_rewards_for_logged_action=_host(rewards_for_logged),
            model_values=_host(model_values),
            possible_actions_mask=_host(possible_actions_mask),
            optimal_q_values=_host(optimal_q_values),
            eval_action_idxs=_host(eval_action_idxs),
        )

    @classmethod
    def create_from_tensors_parametric_dqn(
        cls,
        trainer,
        trainer_state,
        mdp_ids,
        sequence_numbers,
        states: torch.Tensor,
        actions: torch.Tensor,
        propensities: torch.Tensor,
        rewards: torch.Tensor,
        possible_actions_mask: torch.Tensor,
        possible_actions: torch.Tensor,  # [B * max_num_actions, action_dim] tiled
        max_num_actions: int,
        metrics: Optional[torch.Tensor] = None,
    ) -> "EvaluationDataPage":
        """The parametric-DQN page (reference evaluation_data_page.py:186-305):
        the (state, action) networks score every possible action, each state
        repeated ``max_num_actions`` times in place.  Each logged action must
        match exactly one allowed possible action (``isclose``, atol 1e-6),
        else ``ValueError``; so must a reward network be present."""
        if trainer.reward_network is None:
            raise ValueError("CFEval requires a trained reward network")
        B, M = possible_actions_mask.shape[0], max_num_actions
        temperature = getattr(trainer.rl, "temperature", 1.0)
        with torch.no_grad():
            mask = possible_actions_mask.to(torch.float32)
            tiled_states = states.repeat_interleave(M, dim=0)  # [B * M, state_dim]
            # FIXME parity (reference :215-218): model_values should come from
            # a CPE Q-network once parametric DQN grows one; until then q_network
            model_values = functional.score(
                trainer.q_network, trainer_state.q_params, tiled_states,
                possible_actions).reshape(B, M)
            model_propensities = torch.softmax(
                model_values / max(temperature, 1e-9) + torch.log(torch.clamp(mask, 1e-20, 1.0)),
                dim=1,
            )
            rewards_and_metrics = functional.score(
                trainer.reward_network, trainer_state.reward_params, tiled_states,
                possible_actions)
            model_rewards = rewards_and_metrics[:, :1].reshape(B, M)
            model_metrics = rewards_and_metrics[:, 1:].reshape(B, -1)
            model_rewards_for_logged_action = functional.score(
                trainer.reward_network, trainer_state.reward_params, states, actions)[:, :1]
            # a tolerant match, restricted to the actions the mask allows
            # (duplicate padded rows outside the mask must not double-match)
            action_mask = torch.all(
                torch.isclose(possible_actions.reshape(B, M, actions.shape[1]),
                              actions[:, None, :], atol=1e-6),
                dim=2,
            ).to(torch.float32) * mask
        if not bool((action_mask.sum(dim=1) == 1).all()):
            raise ValueError("each logged action must match exactly one allowed possible action")
        num_metrics = model_metrics.shape[1] // M
        model_metrics_values = None
        if num_metrics > 0:
            # FIXME parity (reference :276-279)
            model_metrics_values = model_values.repeat(1, num_metrics)

        return cls(
            mdp_id=_host(mdp_ids),
            sequence_number=_host(sequence_numbers),
            logged_propensities=_host(propensities).reshape(-1, 1),
            logged_rewards=_host(rewards).reshape(-1, 1),
            action_mask=_host(action_mask),
            model_rewards=_host(model_rewards),
            model_rewards_for_logged_action=_host(model_rewards_for_logged_action),
            model_values=_host(model_values),
            model_metrics_values=(
                None if model_metrics_values is None else _host(model_metrics_values)),
            model_propensities=_host(model_propensities),
            logged_metrics=None if metrics is None else _host(metrics),
            model_metrics=None if num_metrics == 0 else _host(model_metrics),
            possible_actions_mask=_host(possible_actions_mask),
            optimal_q_values=_host(model_values),
            eval_action_idxs=None,
        )

    # ------------------------------------------------------------ operations

    def append(self, edp: "EvaluationDataPage") -> "EvaluationDataPage":
        new_vals = {}
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(edp, f.name)
            if a is None or b is None:
                new_vals[f.name] = None
            else:
                new_vals[f.name] = np.concatenate([a, b], axis=0)
        return EvaluationDataPage(**new_vals)

    def sort(self) -> "EvaluationDataPage":
        """Sort by (mdp_id, sequence_number) — reference :470-494."""
        assert self.mdp_id is not None and self.sequence_number is not None
        mdp = np.asarray(self.mdp_id).reshape(-1)
        seq = np.asarray(self.sequence_number).reshape(-1)
        order = np.lexsort((seq, mdp))
        new_vals = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            new_vals[f.name] = None if v is None else np.asarray(v)[order]
        return EvaluationDataPage(**new_vals)

    def compute_values(self, gamma: float) -> "EvaluationDataPage":
        """Per-step discounted returns-to-go within each episode (ref :496)."""
        assert self.mdp_id is not None and self.sequence_number is not None
        logged_values = compute_values_for_mdps(
            self.logged_rewards, self.mdp_id, self.sequence_number, gamma
        )
        logged_metrics_values = None
        if self.logged_metrics is not None:
            logged_metrics_values = compute_values_for_mdps(
                self.logged_metrics, self.mdp_id, self.sequence_number, gamma
            )
        return self.replace(
            logged_values=logged_values, logged_metrics_values=logged_metrics_values
        )

    def validate(self) -> None:
        """Reference :542-568."""
        assert self.logged_propensities.ndim == 2
        assert self.logged_rewards.ndim == 2
        assert self.logged_propensities.shape[1] == 1
        assert self.logged_rewards.shape[1] == 1
        num_actions = self.model_propensities.shape[1]
        assert self.model_rewards.shape[1] == num_actions
        assert self.action_mask.shape == self.model_propensities.shape
        assert np.all(self.logged_propensities > 0), "Logged propensities must be > 0"

    def set_metric_as_reward(self, i: int, num_actions: int) -> "EvaluationDataPage":
        """Swap metric i into the reward slots (reference :628-657)."""
        assert self.logged_metrics is not None, "metrics must not be none"
        assert self.model_metrics is not None
        assert self.model_metrics_values is not None
        return self.replace(
            logged_rewards=self.logged_metrics[:, i : i + 1],
            logged_values=(
                None
                if self.logged_metrics_values is None
                else self.logged_metrics_values[:, i : i + 1]
            ),
            model_rewards=self.model_metrics[
                :, i * num_actions : (i + 1) * num_actions
            ],
            model_rewards_for_logged_action=(
                None
                if self.model_metrics_for_logged_action is None
                else self.model_metrics_for_logged_action[:, i : i + 1]
            ),
            model_values=self.model_metrics_values[
                :, i * num_actions : (i + 1) * num_actions
            ],
            logged_metrics=None,
            model_metrics=None,
            model_metrics_values=None,
        )


def compute_values_for_mdps(
    rewards: np.ndarray,
    mdp_ids: np.ndarray,
    sequence_numbers: np.ndarray,
    gamma: float,
) -> np.ndarray:
    """Backward within-episode discounted sums (reference :523-540)."""
    rewards = np.asarray(rewards, dtype=np.float64)
    values = rewards.copy().reshape(-1)
    mdp = np.asarray(mdp_ids).reshape(-1)
    seq = np.asarray(sequence_numbers).reshape(-1).astype(np.float64)
    for x in range(len(values) - 2, -1, -1):
        if mdp[x] != mdp[x + 1]:
            continue
        values[x] += values[x + 1] * math.pow(gamma, seq[x + 1] - seq[x])
    return values.reshape(-1, 1).astype(np.float32)
