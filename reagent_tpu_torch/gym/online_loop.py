"""Generic online actor-learner loop on a functional env.

Port of ``reagent_tpu/gym/online_loop.py`` (``prefill_replay_buffer`` :47,
``run_online_training`` :101, ``evaluate_policy`` :219).  The JAX loop is one
``lax.scan`` compiled per configuration (and cached); here it is a plain
Python loop over device tensors: act -> env.step -> rb.add -> (every
``train_every`` steps) sample -> batch -> train_step -> auto-reset.  Episode
bookkeeping and the auto-reset are ``torch.where`` selects, so the loop
never waits for the device to hand a value to the host.  Randomness comes
from one explicit ``torch.Generator`` on the env's device.

``evaluate_policy`` runs its ``num_episodes`` envs as one batch (the JAX
loop's ``vmap``), so the policy scores ``[num_episodes, obs_dim]`` per step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from reagent_tpu_torch.gym.envs.functional import FunctionalEnv, where_state

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class OnlineLoopConfig:
    num_steps: int
    train_every: int = 1
    train_after: int = 0
    minibatch_size: int = 512
    episode_return_buffer: int = 64  # ring of the most recent episode returns


class EpisodeStats:
    """Running episode return, the ring of finished returns and the episode
    count, updated with device selects only."""

    def __init__(self, size: int, device) -> None:
        self.size = size
        self.ep_ret = torch.zeros((), dtype=torch.float32, device=device)
        self.returns = torch.full((size,), float("nan"), dtype=torch.float32, device=device)
        self.ep_idx = torch.zeros((), dtype=torch.int32, device=device)

    def record(self, reward: Tensor, done: Tensor) -> None:
        self.ep_ret = self.ep_ret + reward
        slot = torch.remainder(self.ep_idx, self.size).to(torch.int64).reshape(1)
        kept = self.returns.index_select(0, slot)
        self.returns.index_copy_(0, slot, torch.where(done, self.ep_ret, kept))
        self.ep_idx = self.ep_idx + done.to(torch.int32)
        self.ep_ret = torch.where(done, 0.0, self.ep_ret)

    def aux(self) -> Dict[str, Tensor]:
        return {"recent_episode_returns": self.returns, "episodes_completed": self.ep_idx}


def prefill_replay_buffer(
    env: FunctionalEnv,
    rb,
    rb_state,
    generator: torch.Generator,
    num_steps: int,
    act_fn: Optional[Callable] = None,
):
    """Fill the buffer with uniform-random actions (ref gym/utils.py:43):
    an index of a discrete env, a vector in [-1, 1) of a continuous one;
    the env resets after each episode.

    ``act_fn(None, obs, generator) -> (action_env, action_store)`` overrides
    the uniform policy.
    """
    env_state, obs = env.reset(generator)
    for _ in range(num_steps):
        if act_fn is not None:
            action, _ = act_fn(None, obs, generator)
        elif env.discrete:
            action = torch.randint(0, env.action_dim, (), generator=generator,
                                   device=env.device, dtype=torch.int32)
        else:
            u = torch.rand((env.action_dim,), generator=generator, device=env.device)
            action = u * 2.0 + -1.0
        env_state, next_obs, reward, done = env.step(env_state, action, generator)
        rb_state = rb.add(rb_state, observation=obs, action=action, reward=reward, terminal=done)
        reset_state, reset_obs = env.reset(generator)
        env_state = where_state(done, reset_state, env_state)
        obs = torch.where(done, reset_obs, next_obs)
    return rb_state


def run_online_training(
    env: FunctionalEnv,
    trainer,
    trainer_state,
    rb,
    rb_state,
    policy_act: Callable[[Any, Tensor, torch.Generator], Tuple[Tensor, Tensor]],
    batch_maker: Callable[[Dict[str, Tensor]], Any],
    generator: torch.Generator,
    config: OnlineLoopConfig,
):
    """``num_steps`` env steps with interleaved training.

    ``policy_act(trainer_state, obs, generator) -> (action_for_env,
    action_stored)``.  The first ``train_after`` steps only act; after them,
    every ``train_every`` env steps are followed by one sample and one
    ``trainer.train_step``.  Returns ``(trainer_state, rb_state, aux)``, aux
    holding the ring of recent episode returns, the episode count and the
    per-update losses (``td_loss``, else ``q1_loss``, else the first
    metric).
    """
    stats = EpisodeStats(config.episode_return_buffer, env.device)
    env_state, obs = env.reset(generator)

    def env_step(env_state, obs, rb_state, tstate):
        action_env, action_store = policy_act(tstate, obs, generator)
        env_state, next_obs, reward, done = env.step(env_state, action_env, generator)
        rb_state = rb.add(
            rb_state, observation=obs, action=action_store, reward=reward, terminal=done)
        stats.record(reward, done)
        reset_state, reset_obs = env.reset(generator)
        return (where_state(done, reset_state, env_state),
                torch.where(done, reset_obs, next_obs), rb_state)

    for _ in range(config.train_after):
        env_state, obs, rb_state = env_step(env_state, obs, rb_state, trainer_state)
    num_rounds = max(0, (config.num_steps - config.train_after) // config.train_every)
    losses = []
    for _ in range(num_rounds):
        for _ in range(config.train_every):
            env_state, obs, rb_state = env_step(env_state, obs, rb_state, trainer_state)
        batch = batch_maker(rb.sample(rb_state, generator, config.minibatch_size))
        trainer_state, metrics = trainer.train_step(trainer_state, batch)
        # a DQN's td_loss, else a CRR critic's q1_loss, else the first metric
        # (reagent_tpu/gym/online_loop.py:176-178)
        loss = metrics.get("td_loss", metrics.get("q1_loss"))
        losses.append(next(iter(metrics.values())) if loss is None else loss)
    td_losses = (torch.stack(losses) if losses
                 else torch.zeros((0,), dtype=torch.float32, device=env.device))
    return trainer_state, rb_state, {**stats.aux(), "td_losses": td_losses}


def evaluate_policy(
    env: FunctionalEnv,
    policy_act: Callable[[Any, Tensor, torch.Generator], Tensor],
    trainer_state,
    generator: torch.Generator,
    num_episodes: int = 20,
    max_steps: Optional[int] = None,
) -> Tensor:
    """Returns [num_episodes] of ``policy_act(trainer_state, obs [E, D],
    generator) -> actions [E]``, each episode counted until its first done
    (ref gym/runners/gymrunner.py:67 ``evaluate_for_n_episodes``).  All
    episodes run as one batch for ``max_steps`` (default ``env.max_steps``)."""
    T = max_steps or env.max_steps
    env_state, obs = env.reset(generator, batch_size=num_episodes)
    total = torch.zeros((num_episodes,), dtype=torch.float32, device=env.device)
    alive = torch.ones((num_episodes,), dtype=torch.float32, device=env.device)
    for _ in range(T):
        action = policy_act(trainer_state, obs, generator)
        env_state, obs, reward, done = env.step(env_state, action, generator)
        total = total + reward * alive
        alive = alive * (1.0 - done.to(torch.float32))
    return total
