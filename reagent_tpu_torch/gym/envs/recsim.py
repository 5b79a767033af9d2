"""RecSim interest-evolution simulator as tensor step functions.

Port of ``reagent_tpu/gym/envs/recsim.py`` (the constants, ``RecSimIEState``
and ``RecSimInterestEvolution`` :44-285; reference reagent/gym/envs/
recsim.py:16-63 over google-research/recsim's ``interest_evolution``, the
benchmark of the ``slate_q_recsim_online*.yaml`` configs).  The JAX package
re-implements the simulator with the interest-evolution structure, its
constants marked CALIBRATED there; they are copied unchanged.  One env, its
own state and slate API (``step(state, slate [S])``), which slate-Q
consumes.

Every draw is explicit (``noise``), or drawn from ``generator``:

  * ``reset_noise``: (interest in [-1, 1) [T]; doc topics in [0, T) [C];
    standard normals [C], the quality's noise);
  * ``step_noise``, one click: (standard gumbels [S + 1], the choice, as
    JAX's ``categorical``; one uniform, the drift's sign, as JAX's
    ``bernoulli``; the new docs' topics [C] and normals [C]);
  * ``step_noise``, multi-click: (click uniforms [S]; drift uniforms [S],
    one per slate position; the new docs' topics and normals).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor

NUM_TOPICS = 20
VIDEO_LENGTH = 4.0          # recsim UtilityModelVideoSampler(video_length=4.0)
STEP_PENALTY = 0.5          # recsim UtilityModelUserSampler step_penalty
NO_CLICK_MASS = 1.0         # recsim no_click_mass (logit of the skip option)
QUALITY_BONUS_ALPHA = 0.9 / 3.4  # recsim user_update_alpha
MIN_QUALITY, MAX_QUALITY = -3.0, 3.0  # recsim UtilityModelVideoSampler
QUALITY_STD = 0.1
TIME_BUDGET = 250.0         # CALIBRATED (recsim uses 200-unit budgets)
CHOICE_TEMPERATURE = 4.0    # CALIBRATED (recsim rescales scores differently)
INTEREST_ALPHA = 0.25       # CALIBRATED interest-drift step
ENGAGEMENT_FLOOR = 0.2      # CALIBRATED: watch = len * (floor + (1-floor)*align)
MULTI_CLICK_BIAS = -3.0     # CALIBRATED sigmoid bias for the multi-click model

# 70% of topics are low-quality ("chocolatey"), 30% high ("nutritious"):
# recsim interest_evolution.UtilityModelVideoSampler's cluster means
_N_TRASHY = int(NUM_TOPICS * 0.7)
CLUSTER_QUALITY_MEANS = np.concatenate([
    np.linspace(MIN_QUALITY, 0.0, _N_TRASHY),
    np.linspace(0.0, MAX_QUALITY, NUM_TOPICS - _N_TRASHY),
]).astype(np.float32)


def _at(x: Tensor, i: Tensor) -> Tensor:
    """``x[i]`` for a 0-dim index tensor without reading it on the host
    (indexing with a 0-dim tensor converts it to a Python int)."""
    return x.index_select(0, i.reshape(1).to(torch.int64))[0]


@dataclasses.dataclass
class RecSimIEState:
    user_interest: Tensor      # [T]
    doc_topics: Tensor         # [C] int32 topic ids
    doc_quality: Tensor        # [C]
    budget: Tensor             # scalar
    t: Tensor                  # int32 step counter
    last_clicked: Tensor       # int32 slate position of the click, -1 if none
    last_position_watch: Tensor  # [S] per-position watch time of the last step


class RecSimInterestEvolution:
    """Interest-evolution slate env (one click or many).

    ``step(state, slate) -> (state, obs, reward, done)`` where ``slate`` is
    ``[slate_size]`` candidate indices and the reward is the step's clicked
    watch time; the per-position credit is ``state.last_clicked`` (one
    click) or ``state.last_position_watch`` (many)."""

    discrete = False

    def __init__(
        self,
        num_candidates: int = 10,
        slate_size: int = 3,
        max_steps: int = 50,
        single_selection: bool = True,
        is_interest_exploration: bool = False,
        device="cuda",
    ):
        """``is_interest_exploration``: recsim's interest_exploration
        environment (a click pays 1, a zero value head, no interest drift or
        budget bonus), one click only, as the reference (recsim.py:37-56)."""
        if is_interest_exploration and not single_selection:
            raise NotImplementedError(
                "Multiselect interest exploration not implemented"
            )  # same constraint as the reference (recsim.py:42-45)
        self.num_candidates = num_candidates
        self.slate_size = slate_size
        self.max_steps = max_steps
        self.single_selection = single_selection
        self.is_interest_exploration = is_interest_exploration
        self.num_topics = NUM_TOPICS
        self.observation_dim = NUM_TOPICS
        self.device = resolve_device(device)
        self._quality_means = torch.tensor(CLUSTER_QUALITY_MEANS, device=self.device)

    # ------------------------------------------------------------- sampling

    def _doc_noise(self, generator) -> Tuple[Tensor, Tensor]:
        C = self.num_candidates
        return (torch.randint(0, NUM_TOPICS, (C,), generator=generator, device=self.device,
                              dtype=torch.int32),
                torch.randn((C,), generator=generator, device=self.device))

    def _docs(self, topics: Tensor, normals: Tensor) -> Tuple[Tensor, Tensor]:
        topics = topics.to(device=self.device, dtype=torch.int32)
        return topics, self._quality_means[topics.to(torch.int64)] + QUALITY_STD * normals

    def reset_noise(self, generator):
        u = torch.rand((NUM_TOPICS,), generator=generator, device=self.device)
        return (torch.clamp(u * 2.0 - 1.0, min=-1.0), *self._doc_noise(generator))

    def reset(self, generator=None, noise=None):
        interest, topics, normals = self.reset_noise(generator) if noise is None else noise
        topics, quality = self._docs(topics, normals)
        state = RecSimIEState(
            user_interest=interest,
            doc_topics=topics,
            doc_quality=quality,
            budget=torch.full((), TIME_BUDGET, device=self.device),
            t=torch.zeros((), dtype=torch.int32, device=self.device),
            last_clicked=torch.full((), -1, dtype=torch.int32, device=self.device),
            last_position_watch=torch.zeros(self.slate_size, device=self.device),
        )
        return state, self._obs(state)

    def _obs(self, state: RecSimIEState):
        return {
            "user": state.user_interest,
            "doc_features": F.one_hot(state.doc_topics.to(torch.int64), NUM_TOPICS).to(
                torch.float32),
            "doc_quality": state.doc_quality,
        }

    def doc_value(self, state_or_obs) -> Tensor:
        """The reference ValueWrapper's value head (recsim.py:24-29):
        dot(user, doc) for one click, (dot + 1) / 2 for many."""
        if isinstance(state_or_obs, dict):
            user, feats = state_or_obs["user"], state_or_obs["doc_features"]
        else:
            user = state_or_obs.user_interest
            feats = F.one_hot(state_or_obs.doc_topics.to(torch.int64), NUM_TOPICS).to(
                torch.float32)
        if self.is_interest_exploration:
            return torch.zeros(feats.shape[:-1], device=feats.device)  # ValueWrapper(env, 0.0)
        dots = feats @ user
        return dots if self.single_selection else (dots + 1.0) / 2.0

    # ----------------------------------------------------------------- step

    def _drift_interest(self, interest: Tensor, topic: Tensor, u: Tensor) -> Tensor:
        """recsim IEvUserModel.update_state: move the clicked topic's interest
        by +-alpha*(1-|target|), positive where ``u`` < (interest+1)/2."""
        cur = _at(interest, topic)
        update = INTEREST_ALPHA * (1.0 - cur)
        pos_prob = (cur + 1.0) / 2.0
        sign = torch.where(u < pos_prob, 1.0, -1.0)
        return interest.index_copy(0, topic.reshape(1).to(torch.int64),
                                   torch.clamp(cur + sign * update, -1.0, 1.0).reshape(1))

    def step_noise(self, generator):
        from reagent_tpu_torch.gym.policies.samplers import gumbel

        S = self.slate_size
        if self.single_selection:
            return (gumbel((S + 1,), generator, self.device),
                    torch.rand((), generator=generator, device=self.device),
                    *self._doc_noise(generator))
        return (torch.rand((S,), generator=generator, device=self.device),
                torch.rand((S,), generator=generator, device=self.device),
                *self._doc_noise(generator))

    def step(self, state: RecSimIEState, slate: Tensor, generator=None, noise=None):
        noise = self.step_noise(generator) if noise is None else noise
        slate = slate.to(device=self.device, dtype=torch.int64)
        if self.single_selection:
            return self._step_single(state, slate, noise)
        return self._step_multi(state, slate, noise)

    def _step_single(self, state: RecSimIEState, slate: Tensor, noise):
        g, u_drift, new_topics, new_normals = noise
        u = state.user_interest
        topics = state.doc_topics[slate].to(torch.int64)       # [S]
        align = u[topics]                                     # [S] in [-1, 1]
        logits = torch.cat([CHOICE_TEMPERATURE * align,
                            torch.full((1,), NO_CLICK_MASS, device=u.device)])
        choice = torch.argmax(logits + g)
        clicked = choice < self.slate_size
        pos = torch.clamp(choice, max=self.slate_size - 1)
        topic = _at(topics, pos)
        quality = _at(state.doc_quality[slate], pos)

        align01 = (_at(u, topic) + 1.0) / 2.0
        if self.is_interest_exploration:
            # a click pays 1; static affinities (no drift), unit step cost
            watch = torch.where(clicked, 1.0, 0.0)
            new_interest = u
            budget = state.budget - 1.0
        else:
            engagement = VIDEO_LENGTH * (ENGAGEMENT_FLOOR + (1.0 - ENGAGEMENT_FLOOR) * align01)
            watch = torch.where(clicked, torch.minimum(state.budget, engagement), 0.0)
            new_interest = torch.where(clicked, self._drift_interest(u, topic, u_drift), u)
            bonus = QUALITY_BONUS_ALPHA * watch * quality
            budget = torch.where(clicked, state.budget - watch + bonus,
                                 state.budget - STEP_PENALTY)
        topics_new, quality_new = self._docs(new_topics, new_normals)  # resample_documents
        t = state.t + 1
        done = (budget <= 0.0) | (t >= self.max_steps)
        pos_watch = torch.zeros(self.slate_size, device=u.device).index_copy(
            0, pos.reshape(1), watch.reshape(1))
        new_state = RecSimIEState(
            user_interest=new_interest,
            doc_topics=topics_new,
            doc_quality=quality_new,
            budget=budget,
            t=t,
            last_clicked=torch.where(clicked, pos, -1).to(torch.int32),
            last_position_watch=torch.where(clicked, pos_watch, torch.zeros_like(pos_watch)),
        )
        return new_state, self._obs(new_state), watch, done

    def _step_multi(self, state: RecSimIEState, slate: Tensor, noise):
        """Every slate item is examined; independent click probabilities from
        the same interest scores (reference create_multiclick_environment)."""
        u_click, u_drift, new_topics, new_normals = noise
        u = state.user_interest
        topics = state.doc_topics[slate].to(torch.int64)
        align = u[topics]
        p_click = torch.sigmoid(CHOICE_TEMPERATURE * align + MULTI_CLICK_BIAS)
        clicks = (u_click < p_click).to(torch.float32)  # [S]

        align01 = (align + 1.0) / 2.0
        engagement = VIDEO_LENGTH * (ENGAGEMENT_FLOOR + (1.0 - ENGAGEMENT_FLOOR) * align01)
        watch = clicks * engagement                                          # [S]
        total_watch = torch.minimum(torch.sum(watch), state.budget)
        scale = torch.where(torch.sum(watch) > 0,
                            total_watch / torch.clamp(torch.sum(watch), min=1e-6), 0.0)
        watch = watch * scale

        # drift once per clicked topic, in slate order
        new_interest = u
        for i in range(self.slate_size):
            new_interest = torch.where(
                clicks[i] > 0, self._drift_interest(new_interest, topics[i], u_drift[i]),
                new_interest)

        quality = state.doc_quality[slate]
        bonus = QUALITY_BONUS_ALPHA * torch.sum(watch * quality)
        any_click = torch.sum(clicks) > 0
        budget = torch.where(any_click, state.budget - total_watch + bonus,
                             state.budget - STEP_PENALTY)
        topics_new, quality_new = self._docs(new_topics, new_normals)
        t = state.t + 1
        done = (budget <= 0.0) | (t >= self.max_steps)
        new_state = RecSimIEState(
            user_interest=new_interest,
            doc_topics=topics_new,
            doc_quality=quality_new,
            budget=budget,
            t=t,
            last_clicked=torch.full((), -1, dtype=torch.int32, device=u.device),
            last_position_watch=watch,
        )
        return new_state, self._obs(new_state), torch.sum(watch), done
