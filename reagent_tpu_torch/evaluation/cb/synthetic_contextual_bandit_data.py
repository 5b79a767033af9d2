"""Synthetic non-stationary contextual-bandit environment and LinUCB agent.

Port of ``reagent_tpu/evaluation/cb/synthetic_contextual_bandit_data.py``
(reference reagent/evaluation/cb/synthetic_contextual_bandit_data.py:42-333
and run_synthetic_bandit.py:45-88): an episode draws a "campaign" (a batch
of arms) from a fixed catalogue; features ~ N(mf, sf) per arm; reward = w.f
+ a shift + noise; the agent (joint LinUCB, greedy over UCB) accumulates
reward and regret.

JAX builds the catalogue from a key and each batch from a key.  Here they
take their draws as values or from a ``torch.Generator``: the catalogue's
``{"ids": a permutation of the arms, "mf", "sf", "weight", "shifts":
standard normals}`` (``sf`` is their absolute value, ``shifts`` scaled by
``sigma_shift`` and moved by ``mu_shift``, as JAX's), and a batch's
``(index, feature normals [B, K, D], noise normals [B, K])``.  The
catalogue lives on the env's device.  The reward and regret of each step
stay there too, summed per step; ``accumulated_rewards`` and
``accumulated_regrets`` read them back as JAX's running float totals.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from reagent_tpu_torch.core.types import CBInput
from reagent_tpu_torch.models.linear_regression import LinearRegressionUCB
from reagent_tpu_torch.training.cb.linucb_trainer import LinUCBTrainer
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


class DynamicBanditEnv:
    def __init__(
        self,
        num_unique_batches: int = 100,
        batch_size: int = 4,
        num_arms_per_episode: int = 10,
        feature_dim: int = 500,
        mu_shift: float = 0.0,
        sigma_shift: float = 0.0,
        reward_noise_sigma: float = 0.01,
        catalogue: Optional[Dict[str, Tensor]] = None,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        self.num_unique_batches = num_unique_batches
        self.batch_size = batch_size
        self.num_arms_per_episode = num_arms_per_episode
        self.feature_dim = feature_dim
        self.num_arms_all = num_unique_batches * batch_size * num_arms_per_episode
        self.mu_shift = mu_shift
        self.sigma_shift = sigma_shift
        self.reward_noise_sigma = reward_noise_sigma
        self.device = resolve_device(device)
        self.generator = generator
        shape = (num_unique_batches, batch_size, num_arms_per_episode, feature_dim)
        if catalogue is None:
            catalogue = {
                "ids": torch.randperm(self.num_arms_all, generator=generator,
                                      device=self.device),
                "mf": self._normal(shape), "sf": self._normal(shape),
                "weight": self._normal((feature_dim,)),
                "shifts": self._normal((self.num_arms_all,))}
        cat = {k: torch.as_tensor(v, device=self.device) for k, v in catalogue.items()}
        # the arm ids (ref gen_all_arms_ids)
        self.all_unique_arm_ids = cat["ids"].reshape(
            num_unique_batches, batch_size, num_arms_per_episode)
        # each arm's feature distribution (ref gen_all_arms_feature_distribution)
        self.mf = cat["mf"].to(torch.float32)
        self.sf = torch.abs(cat["sf"].to(torch.float32))
        # the linear reward map and the shifts (ref gen_mapping_weights)
        self.weight = cat["weight"].to(torch.float32)
        self.reward_shifts = cat["shifts"].to(torch.float32) * sigma_shift + mu_shift
        self.reward_regret_track_start()

    def _normal(self, shape) -> Tensor:
        return torch.randn(shape, generator=self.generator, device=self.device)

    def reward_regret_track_start(self):
        self._step_rewards: List[Tensor] = []
        self._step_regrets: List[Tensor] = []

    @staticmethod
    def _running(xs: List[Tensor]) -> List[float]:
        if not xs:
            return []
        return np.cumsum(torch.stack(xs).cpu().numpy().astype(np.float64)).tolist()

    @property
    def accumulated_rewards(self) -> List[float]:
        return self._running(self._step_rewards)

    @property
    def accumulated_regrets(self) -> List[float]:
        return self._running(self._step_regrets)

    @property
    def accumulated_rewards_final(self) -> float:
        return (self.accumulated_rewards or [0.0])[-1]

    @property
    def accumulated_regrets_final(self) -> float:
        return (self.accumulated_regrets or [0.0])[-1]

    def batch_draws(self) -> Tuple[Tensor, Tensor, Tensor]:
        """One batch's (index, feature normals, noise normals) from the generator."""
        B, K, D = self.batch_size, self.num_arms_per_episode, self.feature_dim
        idx = torch.randint(0, self.num_unique_batches, (), generator=self.generator,
                            device=self.device)
        return idx, self._normal((B, K, D)), self._normal((B, K))

    def get_batch(self, draws: Optional[Sequence[Tensor]] = None) -> Tuple[CBInput, Tensor]:
        """One batch of episodes and every arm's reward [B, K] (ref get_batch)."""
        idx, feat_normal, noise = self.batch_draws() if draws is None else draws
        # a one-element index: a 0-d tensor index would be read on the host
        idx = torch.as_tensor(idx, device=self.device).reshape(1)

        def pick(x):
            return x.index_select(0, idx)[0]

        features = pick(self.mf) + pick(self.sf) * torch.as_tensor(feat_normal, device=self.device)
        # JAX indexes the per-arm shifts by the batch index: one shift a batch
        rewards_all_arms = (features @ self.weight + pick(self.reward_shifts)
                            + torch.as_tensor(noise, device=self.device)
                            * self.reward_noise_sigma)
        return (CBInput(context_arm_features=features, arms=pick(self.all_unique_arm_ids)),
                rewards_all_arms)

    def add_chosen_action_reward(self, chosen_action_idx: Tensor, batch: CBInput,
                                 rewards_all_arms: Tensor) -> CBInput:
        row = torch.arange(self.batch_size, device=rewards_all_arms.device)
        chosen = chosen_action_idx.reshape(-1)
        chosen_reward = rewards_all_arms[row, chosen][:, None]
        # reward and regret tracking (ref reward_regret_tracking)
        self._step_rewards.append(chosen_reward.sum())
        self._step_regrets.append(
            torch.sum(rewards_all_arms.max(dim=1).values - chosen_reward.reshape(-1)))
        return batch.replace(reward=chosen_reward, action=chosen[:, None])


class DynamicBanditAgent:
    """Joint LinUCB and the greedy argmax over its UCB scores (ref :42-98)."""

    def __init__(self, trainer: LinUCBTrainer, feature_dim: int, device="cuda"):
        self.trainer = trainer
        self.feature_dim = feature_dim
        self.device = resolve_device(device)

    @classmethod
    def make_agent(cls, feature_dim: int, ucb_alpha: float = 1.0, gamma: float = 1.0,
                   device="cuda"):
        scorer = LinearRegressionUCB(input_dim=feature_dim, ucb_alpha=ucb_alpha, gamma=gamma)
        return cls(trainer=LinUCBTrainer(scorer), feature_dim=feature_dim, device=device)

    def init_state(self):
        return self.trainer.init(self.device)

    def act(self, state, obs: CBInput) -> Tuple[Tensor, Tensor]:
        """The greedy argmax over the UCB scores -> ([B, 1] actions, [B] log-probs)."""
        chosen = torch.argmax(self.trainer.score(state, obs), dim=1)
        return chosen[:, None], torch.zeros(chosen.shape[0], device=chosen.device)  # log(1)

    def learn(self, state, batch: CBInput):
        state, metrics = self.trainer.train_step(state, batch)
        return self.trainer.on_epoch_end(state), metrics


def run_dynamic_bandit_env(
    num_unique_batches: int = 10,
    batch_size: int = 4,
    num_arms_per_episode: int = 5,
    feature_dim: int = 16,
    num_obs: int = 100,
    rand_seed: int = 937162211,
    device="cuda",
    catalogue: Optional[Dict[str, Tensor]] = None,
    batch_draws: Optional[Sequence[Sequence[Tensor]]] = None,
) -> Tuple[DynamicBanditAgent, List[float], List[float]]:
    """Train LinUCB online in the synthetic env (ref run_synthetic_bandit.py:45-88).
    The draws not given come from a generator seeded with ``rand_seed``."""
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(rand_seed)
    env = DynamicBanditEnv(num_unique_batches=num_unique_batches, batch_size=batch_size,
                           num_arms_per_episode=num_arms_per_episode, feature_dim=feature_dim,
                           catalogue=catalogue, generator=generator, device=device)
    agent = DynamicBanditAgent.make_agent(feature_dim=feature_dim, device=device)
    state = agent.init_state()
    for i in range(num_obs):
        obs, rewards_all = env.get_batch(None if batch_draws is None else batch_draws[i])
        action, _log_prob = agent.act(state, obs)
        obs = env.add_chosen_action_reward(action.reshape(-1), obs, rewards_all)
        state, _ = agent.learn(state, obs)
    return agent, env.accumulated_rewards, env.accumulated_regrets
