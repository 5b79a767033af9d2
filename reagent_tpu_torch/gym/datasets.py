"""Iterator-style gym datasets: host-loop adapters over the device pieces.

Port of ``reagent_tpu/gym/datasets.py`` (``ReplayBufferDataset``,
``EpisodicDataset``, ``OfflineReplayBufferDataset``, :22-155; reference
reagent/gym/datasets/replay_buffer_dataset.py:22-206 and
episodic_dataset.py): iterables that step the env, insert into replay and
yield train batches, one Python step at a time, for users who want the
batches on the host side of the loop.  The fast path is
``online_loop.run_online_training``.

Draws come from one ``torch.Generator``.  ``indices``, where given, are the
sampled replay indices of each batch in order (an iterable of ``[B]``
tensors), and ``noises`` each episode's draws, in place of the generator's:
so a run can replay another's samples.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import torch

from reagent_tpu_torch.gym.episodic import collect_episode

Tensor = torch.Tensor


def _params(policy_params):
    # a callable reads the live params (e.g. ``lambda: ts.q_params``)
    return policy_params() if callable(policy_params) else policy_params


class ReplayBufferDataset:
    """Step env + insert + sample, yielding one typed batch per
    ``training_frequency`` env steps."""

    def __init__(
        self,
        env,
        policy_act: Callable[[Any, Tensor, torch.Generator], Tensor],
        policy_params: Any,
        rb,
        rb_state,
        batch_maker: Callable[[Dict[str, Tensor]], Any],
        training_frequency: int = 1,
        num_episodes: Optional[int] = None,
        max_steps: Optional[int] = None,
        batch_size: int = 256,
        generator: Optional[torch.Generator] = None,
        indices: Optional[Iterable[Tensor]] = None,
    ):
        self.env = env
        self.policy_act = policy_act
        self.policy_params = policy_params
        self.rb = rb
        self.rb_state = rb_state
        self.batch_maker = batch_maker
        self.training_frequency = training_frequency
        self.num_episodes = num_episodes
        self.max_steps = max_steps or getattr(env, "max_steps", 1000)
        self.batch_size = batch_size
        self.generator = generator
        self.indices = None if indices is None else iter(indices)

    def _sample(self):
        idx = None if self.indices is None else next(self.indices)
        return self.rb.sample(self.rb_state, self.generator, self.batch_size, indices=idx)

    def __iter__(self) -> Iterator[Any]:
        episodes = 0
        steps = 0
        env_state, obs = self.env.reset(self.generator)
        ep_steps = 0
        while self.num_episodes is None or episodes < self.num_episodes:
            action = self.policy_act(_params(self.policy_params), obs, self.generator)
            env_state, next_obs, reward, done = self.env.step(env_state, action, self.generator)
            ep_steps += 1
            truncated = ep_steps >= self.max_steps
            self.rb_state = self.rb.add(
                self.rb_state, observation=obs, action=action,
                reward=torch.as_tensor(reward, dtype=torch.float32),
                terminal=torch.as_tensor(done, dtype=torch.bool))
            obs = next_obs
            steps += 1
            if steps % self.training_frequency == 0:
                yield self.batch_maker(self._sample())
            if bool(done) or truncated:
                episodes += 1
                ep_steps = 0
                env_state, obs = self.env.reset(self.generator)


class EpisodicDataset:
    """One full padded episode per iteration (ref episodic_dataset.py), as
    ``episodic.collect_episode`` returns it."""

    def __init__(
        self,
        env,
        logits_fn: Callable[[Any, Tensor], Tensor],
        policy_params: Any,
        sampler,
        num_episodes: int,
        max_steps: int,
        generator: Optional[torch.Generator] = None,
        noises: Optional[Iterable] = None,
    ):
        """``noises``: each episode's draws in order, as
        ``episodic.draw_episode_noise`` returns them, in place of the
        generator's."""
        self.env = env
        self.logits_fn = logits_fn
        self.policy_params = policy_params
        self.sampler = sampler
        self.num_episodes = num_episodes
        self.max_steps = max_steps
        self.generator = generator
        self.noises = noises

    def __iter__(self):
        noises = None if self.noises is None else iter(self.noises)
        for _ in range(self.num_episodes):
            yield collect_episode(self.env, self.logits_fn, self.sampler,
                                  _params(self.policy_params), self.max_steps,
                                  noise=None if noises is None else next(noises),
                                  generator=self.generator)

    def __len__(self) -> int:
        return self.num_episodes


class OfflineReplayBufferDataset:
    """A fixed number of batches from a prefilled replay buffer, without
    stepping the env (reference replay_buffer_dataset.py:153-206)."""

    def __init__(
        self,
        rb,
        rb_state,
        batch_maker: Callable[[Dict[str, Tensor]], Any],
        batch_size: int,
        num_batches: int,
        generator: Optional[torch.Generator] = None,
        indices: Optional[Iterable[Tensor]] = None,
    ):
        self.rb = rb
        self.rb_state = rb_state
        self.batch_maker = batch_maker
        self.batch_size = batch_size
        self.num_batches = num_batches
        self.generator = generator
        self.indices = indices

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator[Any]:
        indices = iter(self.indices) if self.indices is not None else None
        for _ in range(self.num_batches):
            idx = None if indices is None else next(indices)
            batch = self.rb.sample(self.rb_state, self.generator, self.batch_size, indices=idx)
            yield self.batch_maker(batch)
