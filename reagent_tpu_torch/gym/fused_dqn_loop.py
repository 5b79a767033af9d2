"""Fused online DQN loop: noise tape + packed replay + the fused update.

Port of ``reagent_tpu/gym/fused_dqn_loop.py`` (``FusedLoopConfig``,
``run_fused_online_dqn``, :36-205), the fast path of the reference's online
loop (reagent/gym/datasets/replay_buffer_dataset.py: env.step -> replay
insert -> sample -> training_step, one transition at a time).  As in JAX:

  * all of a run's randomness is drawn before the loop in three batched
    draws, the noise tape: gumbel ``[N, A]``, reset uniforms ``[N, R]`` and
    sample uniforms ``[N, B]``;
  * actions are gumbel-max over ``q / T`` (the distribution of
    ``SoftmaxActionSampler``), with ``q`` from one K3 launch
    (``FusedDQNTrainer.q_values``);
  * replay is a ``PackedReplayBuffer`` (one row write, two row gathers), and
    each env step trains once with K2's packed interface
    (``FusedDQNTrainer.train_step_packed``).

The JAX ``lax.scan`` becomes a Python loop over device tensors that does not
sync with the host inside the loop: ``done``, the episode bookkeeping, the
auto-reset and the sample indices are all device-side selects and
arithmetic.  ``run_fused_loop_from_tape`` takes the tape and the initial env
state explicitly (the JAX inner ``run``, :170), so a run can be replayed
from given noise.  JAX's ``unroll`` has no counterpart.

Constraints: a discrete ``FunctionalEnv`` with ``reset_from_uniform``,
softmax exploration, one update per env step, a prefilled buffer.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from reagent_tpu_torch.gym.envs.functional import FunctionalEnv, FunctionalEnvState, where_state
from reagent_tpu_torch.gym.online_loop import EpisodeStats
from reagent_tpu_torch.gym.policies.samplers import gumbel
from reagent_tpu_torch.replay.packed import (
    PackedReplayBuffer,
    PackedReplayBufferState,
    closed_form_indices,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FusedLoopConfig:
    num_steps: int
    minibatch_size: int = 512
    temperature: float = 1.0
    episode_return_buffer: int = 64


def draw_noise_tape(
    env: FunctionalEnv, config: FusedLoopConfig, generator: torch.Generator
) -> Tuple[Tensor, Tensor, Tensor]:
    """The run's randomness: gumbel [N, A], reset uniforms [N, R] and sample
    uniforms [N, B], on the env's device."""
    N, B = config.num_steps, config.minibatch_size
    dev = env.device
    return (
        gumbel((N, env.action_dim), generator, dev),
        torch.rand((N, env.reset_noise_dim), generator=generator, device=dev),
        torch.rand((N, B), generator=generator, device=dev),
    )


def run_fused_online_dqn(
    env: FunctionalEnv,
    trainer,
    trainer_state,
    rb: PackedReplayBuffer,
    rb_state: PackedReplayBufferState,
    generator: torch.Generator,
    config: FusedLoopConfig,
):
    """``num_steps`` of (act, env step, insert, sample, update), each on the
    device.  Returns ``(trainer_state, rb_state, aux)`` like
    ``run_online_training``; ``aux["td_losses"]`` is [num_steps]."""
    if not env.discrete or not hasattr(env, "reset_from_uniform"):
        raise ValueError(
            "the fused DQN loop needs a discrete env with reset_from_uniform(u)")
    # The loop trains from step 0: sampling an under-filled buffer would
    # gather never-written all-zero rows and train on fabricated transitions.
    prefilled = int(rb_state.add_count)
    if prefilled < config.minibatch_size:
        raise ValueError(
            f"fused DQN loop requires a prefilled replay buffer: add_count="
            f"{prefilled} < minibatch_size={config.minibatch_size}. Prefill "
            "with a random policy (gym/online_loop.prefill_replay_buffer) first.")
    env_state, obs = env.reset(generator)
    tape = draw_noise_tape(env, config, generator)
    return run_fused_loop_from_tape(
        env, trainer, trainer_state, rb, rb_state, env_state, obs, tape, config)


def run_fused_loop_from_tape(
    env: FunctionalEnv,
    trainer,
    trainer_state,
    rb: PackedReplayBuffer,
    rb_state: PackedReplayBufferState,
    env_state: FunctionalEnvState,
    obs: Tensor,
    tape: Tuple[Tensor, Tensor, Tensor],
    config: FusedLoopConfig,
):
    """The loop body over a given tape and initial env state."""
    gumbels, reset_us, sample_us = tape
    N = config.num_steps
    cap = rb.capacity
    cols = trainer.configure_packed(rb)
    stats = EpisodeStats(config.episode_return_buffer, env.device)
    td_losses = torch.empty((N,), dtype=torch.float32, device=env.device)
    tstate = trainer_state
    for i in range(N):
        # act: gumbel-max softmax sample
        q = trainer.q_values(tstate, obs[None])[0]
        action = torch.argmax(q / config.temperature + gumbels[i]).to(torch.int32)

        env_state, next_obs, reward, done = env.step(env_state, action)
        rb_state = rb.add(rb_state, observation=obs, action=action, reward=reward, terminal=done)

        stats.record(reward, done)
        reset_state, reset_obs = env.reset_from_uniform(reset_us[i])
        env_state = where_state(done, reset_state, env_state)
        obs = torch.where(done, reset_obs, next_obs)

        # uniform minibatch from the tape, insert-then-sample: this step's
        # done and the post-add episode length decide the excluded tail
        cur = torch.remainder(rb_state.add_count, cap)
        written = torch.clamp(rb_state.add_count, max=cap)
        t_excl = torch.where(done, 0, torch.clamp(rb_state.episode_len, max=1))
        valid_count = torch.clamp(written - t_excl, min=1)
        indices = closed_form_indices(cur, t_excl, valid_count, sample_us[i], cap)
        rows = rb_state.rows.index_select(0, indices)
        next_rows = rb_state.rows.index_select(0, torch.remainder(indices + 1, cap))
        tstate, metrics = trainer.train_step_packed(tstate, rows, next_rows, cols)
        td_losses[i] = metrics["td_loss"]
    return tstate, rb_state, {**stats.aux(), "td_losses": td_losses}
