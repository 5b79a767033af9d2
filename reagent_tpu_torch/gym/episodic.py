"""Episodic data collection for the policy-gradient trainers.

Port of ``reagent_tpu/gym/episodic.py`` (``collect_episode``,
``make_episodic_trainer_step``; reference:
reagent/gym/datasets/episodic_dataset.py, a host generator of exact-length
episodes).  As in JAX, an episode runs a fixed ``max_steps`` with an alive
mask and comes back padded (``PolicyGradientInput.valid_mask``): ``done``
never reaches the host, so the whole episode is queued on the device with no
read.  JAX's ``lax.scan`` becomes a Python loop over device tensors; the act
step's forward is ``logits_fn``, for a dense MLP
``gym/policies/policy.py::discrete_q_scorer`` (one K3 launch on a CUDA
tensor).  After the first ``done`` the env keeps stepping, as JAX's does;
the mask zeroes those steps' rewards and drops them from the statistics.

An episode's randomness is explicit: the env's reset uniforms ``[R]`` and
the sampler's gumbel draws ``[max_steps, A]`` (``draw_episode_noise``), so a
caller can replay JAX's draws; without them the episode draws both from a
``torch.Generator`` on the env's device.  The port's envs draw nothing in
``step``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.gym.envs.functional import FunctionalEnv
from reagent_tpu_torch.gym.policies.samplers import gumbel

Tensor = torch.Tensor


def draw_episode_noise(
    env: FunctionalEnv, max_steps: int, generator: torch.Generator
) -> Tuple[Tensor, Tensor]:
    """An episode's draws on the env's device: reset uniforms [R] and gumbel
    draws [max_steps, A]."""
    return (torch.rand((env.reset_noise_dim,), generator=generator, device=env.device),
            gumbel((max_steps, env.action_dim), generator, env.device))


def collect_episode(
    env: FunctionalEnv,
    logits_fn: Callable[[Any, Tensor], Tensor],
    sampler,
    params: Any,
    max_steps: int,
    noise: Optional[Tuple[Tensor, Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[rlt.PolicyGradientInput, Tensor]:
    """Roll out one episode padded to ``max_steps``: ``(episode, return)``.

    ``logits_fn(params, obs [1, D]) -> [1, A]``; ``noise`` as
    ``draw_episode_noise`` returns it, else drawn from ``generator``."""
    if noise is None:
        if generator is None:
            raise ValueError("collect_episode needs its noise or a generator to draw it from")
        noise = draw_episode_noise(env, max_steps, generator)
    reset_u, gumbels = noise
    env_state, obs = env.reset_from_uniform(reset_u)
    alive = torch.ones((), dtype=torch.float32, device=obs.device)
    steps = []
    for t in range(max_steps):
        out = sampler.sample_action(logits_fn(params, obs[None]), noise=gumbels[t:t + 1])
        action_onehot = out.action[0]
        action_idx = torch.argmax(action_onehot).to(torch.int32)
        env_state, next_obs, reward, done = env.step(env_state, action_idx)
        steps.append((obs, action_onehot, reward * alive, out.log_prob[0], alive))
        alive = alive * (1.0 - done.to(torch.float32))
        obs = next_obs
    obs_seq, act_seq, rew_seq, lp_seq, mask_seq = (torch.stack(x) for x in zip(*steps))
    episode = rlt.PolicyGradientInput(
        state=rlt.FeatureData(float_features=obs_seq), action=act_seq, reward=rew_seq,
        log_prob=lp_seq, valid_mask=mask_seq)
    return episode, torch.sum(rew_seq)


def make_episodic_trainer_step(env, logits_fn, sampler, trainer, max_steps: int):
    """``step(trainer_state, generator=None, noise=None) -> (trainer_state,
    episode return, metrics)``: collect one episode with the current policy
    (``trainer_state.policy_params``), then train on it."""

    def step(trainer_state, generator: Optional[torch.Generator] = None,
             noise: Optional[Tuple[Tensor, Tensor]] = None):
        episode, ep_return = collect_episode(
            env, logits_fn, sampler, trainer_state.policy_params, max_steps,
            noise=noise, generator=generator)
        trainer_state, metrics = trainer.train_step(trainer_state, episode)
        return trainer_state, ep_return, metrics

    return step
