"""OraclePVM: personalized-VM-tuning environment (a slate ranking bandit).

Port of ``reagent_tpu/gym/envs/oracle_pvm.py`` (``kendall_tau`` :32,
``OraclePVMState``, ``OraclePVM`` :43-110; reference reagent/gym/envs/
oracle_pvm.py:55-160): per-doc scores are the doc features, the hidden
mixing weights are all ones; an action is a weight vector; the reward is
the Kendall tau between the action's ranking of the docs and the oracle's,
MATCH_REWARD_BOOST on an exact match.  Single-step episodes, one env.

``reset_noise``: (user features [U], doc features [C, F]), uniforms in
[0, 1) (JAX's two ``uniform`` draws).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from reagent_tpu_torch.gym.envs.functional import FunctionalEnv
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor

VM_WEIGHT_LOW = -1.0
VM_WEIGHT_HIGH = 1.0
MATCH_REWARD_BOOST = 3.0


def kendall_tau(rank_a: Tensor, rank_b: Tensor) -> Tensor:
    """Kendall rank correlation of two permutations (scipy.stats.kendalltau
    for distinct ranks; reference oracle_pvm.py:126)."""
    da = rank_a[:, None] - rank_a[None, :]
    db = rank_b[:, None] - rank_b[None, :]
    concordance = (torch.sign(da) * torch.sign(db)).to(torch.float32)
    n = rank_a.shape[0]
    num_pairs = n * (n - 1) / 2.0
    return torch.sum(torch.triu(concordance, diagonal=1)) / num_pairs


@dataclasses.dataclass
class OraclePVMState:
    user: Tensor  # [user_feat_dim]
    docs: Tensor  # [num_candidates, candidate_feat_dim]
    t: Tensor


class OraclePVM(FunctionalEnv):
    """Learn the hidden ground-truth mixing weights (all ones)."""

    discrete = False

    def __init__(
        self,
        num_candidates: int = 5,
        user_feat_dim: int = 1,
        candidate_feat_dim: int = 3,
        num_weights: int = 3,
        device="cuda",
    ):
        assert num_weights <= candidate_feat_dim
        self.num_candidates = num_candidates
        self.slate_size = num_candidates  # ref asserts slate_size == num_candidates
        self.user_feat_dim = user_feat_dim
        self.candidate_feat_dim = candidate_feat_dim
        self.num_weights = num_weights
        self.device = resolve_device(device)
        self.ground_truth_weights = torch.ones((num_weights,), device=self.device)
        self.action_dim = num_weights
        self.observation_dim = user_feat_dim + num_candidates * candidate_feat_dim
        self.max_steps = 1

    def _obs(self, state: OraclePVMState) -> Tensor:
        return torch.cat([state.user, state.docs.reshape(-1)])

    def reset_noise(self, generator):
        return (torch.rand((self.user_feat_dim,), generator=generator, device=self.device),
                torch.rand((self.num_candidates, self.candidate_feat_dim), generator=generator,
                           device=self.device))

    def reset(self, generator=None, noise=None) -> Tuple[OraclePVMState, Tensor]:
        user, docs = self.reset_noise(generator) if noise is None else noise
        state = OraclePVMState(user=user, docs=docs,
                               t=torch.zeros((), dtype=torch.int32, device=self.device))
        return state, self._obs(state)

    def _scores(self, state: OraclePVMState) -> Tensor:
        # score_fn_i(user, doc) = doc[i] (ref make_default_score_fn)
        return state.docs[:, :self.num_weights]  # [n_docs, num_weights]

    def _ranking(self, scores: Tensor, weights: Tensor) -> Tensor:
        values = torch.sum(scores * weights[None, :], dim=1)
        return torch.argsort(-values, stable=True)

    def step(self, state: OraclePVMState, action: Tensor, generator=None):
        scores = self._scores(state)
        truth = self._ranking(scores, self.ground_truth_weights)
        policy = self._ranking(scores, action.to(torch.float32))
        exact = torch.all(truth == policy)
        reward = torch.where(exact, MATCH_REWARD_BOOST, kendall_tau(truth, policy))
        new_state = dataclasses.replace(state, t=state.t + 1)
        return (new_state, self._obs(new_state), reward,
                torch.ones((), dtype=torch.bool, device=self.device))

    @staticmethod
    def is_match(reward) -> bool:
        return float(reward) > MATCH_REWARD_BOOST - 1e-6
