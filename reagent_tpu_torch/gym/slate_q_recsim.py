"""SlateQ on the interest-evolution RecSim env: the collector, the batch and
the iterated protocol.

Port of the JAX package's slate-Q RecSim job (``tests/test_slateq_recsim.py:
39-228``; reference gym/tests/configs/recsim/slate_q_recsim_online*.yaml,
bar 154): 10 candidates, slate 3, a ``FullyConnectedCritic`` [64, 64]
leaky_relu over the user's 20 interests and a doc's 21 features (its topic
one-hot and its quality), Adam 1e-3; four rounds at epsilon 1.0, 0.5, 0.2
and 0.1, each collecting 150 episodes and then taking 600 steps on a
minibatch of 512 drawn from every round's batch so far; a greedy evaluation
over 20 episodes.  ``VARIANTS`` are the five reference configurations.

The collector is one env stepped in a loop (the port's RecSim API, one
episode at a time) where JAX vmaps a scan over episodes.  Each act step
scores the 10 candidates with ``slate_q_scorer``: the critic's ``[10, 41]``
rows one K3 launch (``training/functional.py::score``), times the choice
model's softmax over the docs' values; the greedy slate is the stable top 3
(``jax.lax.top_k``'s order), an exploring one a uniform draw of 3 distinct
docs.  The episode ends when the env says done, as JAX's valid mask cuts
it.  Every draw comes from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import RLParameters
from reagent_tpu_torch.gym.envs.recsim import NUM_TOPICS, RecSimInterestEvolution
from reagent_tpu_torch.gym.policies.scorers import slate_q_scorer
from reagent_tpu_torch.models.critic import FullyConnectedCritic
from reagent_tpu_torch.training.slate_q_trainer import (
    NextSlateValueNormMethod,
    SlateQTrainer,
    stable_top_k,
)

Tensor = torch.Tensor

NUM_CAND, SLATE, TOPICS = 10, 3, NUM_TOPICS
DOC_DIM = TOPICS + 1  # topic one-hot ++ quality
PASSING_SCORE_BAR = 154.0  # the reference configs' bar
EPSILONS = (1.0, 0.5, 0.2, 0.1)
JOB = dict(episodes=150, train_steps=600, minibatch=512, eval_episodes=20, lr=1e-3,
           gamma=0.9, tau=0.1)

# (name, single_selection, trainer kwargs): the five reference configurations
VARIANTS = [
    ("base", True, {}),
    ("maxq_topk", True, {"rl": RLParameters(gamma=0.9, target_update_rate=0.1,
                                            maxq_learning=True)}),
    ("multi_selection", False,
     {"next_slate_value_norm_method": NextSlateValueNormMethod.NORM_BY_NEXT_SLATE_SIZE}),
    ("multi_selection_avg_curr", False,
     {"next_slate_value_norm_method": NextSlateValueNormMethod.NORM_BY_CURRENT_SLATE_SIZE}),
    ("with_time_scale", True, {"discount_time_scale": 2.0}),
]


def make_q_net() -> FullyConnectedCritic:
    """The reference configs' critic: FullyConnected [64, 64] leaky_relu."""
    return FullyConnectedCritic(state_dim=TOPICS, action_dim=DOC_DIM, sizes=[64, 64],
                                activations=["leaky_relu", "leaky_relu"])


def make_trainer(name: str, single: bool, kwargs: Dict, device) -> SlateQTrainer:
    """The variant's trainer: gamma 0.9 and target update rate 0.1, max-Q
    only for ``maxq_topk``."""
    kwargs = dict(kwargs)
    kwargs.setdefault("rl", RLParameters(gamma=JOB["gamma"], target_update_rate=JOB["tau"],
                                         maxq_learning=name == "maxq_topk"))
    return SlateQTrainer(q_network=make_q_net(), slate_size=SLATE,
                         optimizer={"Adam": {"lr": JOB["lr"]}}, single_selection=single,
                         device=device, **kwargs)


def doc_feats(obs) -> Tensor:
    """[C, TOPICS + 1]: the topic one-hot and the quality."""
    return torch.cat([obs["doc_features"], obs["doc_quality"][:, None]], dim=-1)


class SlateQCollector:
    """Episodes of ``env`` under epsilon-greedy slates of the critic's
    item scores; ``act_steps`` counts the scorer's calls (one K3 launch each
    on the card)."""

    def __init__(self, env: RecSimInterestEvolution, q_network):
        self.env = env
        self.score = slate_q_scorer(env.num_candidates, q_network)
        self.act_steps = 0

    def act(self, params, obs, eps: float, generator: torch.Generator) -> Tensor:
        env = self.env
        state = rlt.FeatureData(
            float_features=obs["user"][None],
            candidate_docs=rlt.DocList(float_features=doc_feats(obs)[None],
                                       value=env.doc_value(obs)[None]))
        greedy = stable_top_k(self.score(params, state), env.slate_size)[0]
        self.act_steps += 1
        if eps <= 0.0:
            return greedy
        dev = env.device
        rand = torch.randperm(env.num_candidates, generator=generator, device=dev)[
            :env.slate_size]
        explore = torch.rand((), generator=generator, device=dev) < eps
        return torch.where(explore, rand, greedy)

    def collect(self, params, eps: float, n_episodes: int,
                generator: torch.Generator) -> Dict[str, Tensor]:
        """``n_episodes`` episodes -> their transitions, stacked, each with
        the next slate (zeros at an episode's end), the per-position watch
        time, the click's position (-1 without one) and the reward."""
        env = self.env
        recs: Dict[str, List[Tensor]] = {k: [] for k in (
            "user", "feats", "topics_dot", "next_user", "next_feats", "next_topics_dot",
            "slate", "next_slate", "pos_watch", "clicked_pos", "reward", "not_terminal")}
        returns = []
        for _ in range(n_episodes):
            st, obs = env.reset(generator)
            ep_return = torch.zeros((), device=env.device)
            slates = []
            for _ in range(env.max_steps):
                slate = self.act(params, obs, eps, generator)
                nst, nobs, rew, done = env.step(st, slate, generator)
                recs["user"].append(obs["user"])
                recs["feats"].append(doc_feats(obs))
                recs["topics_dot"].append(obs["doc_features"] @ obs["user"])
                recs["next_user"].append(nobs["user"])
                recs["next_feats"].append(doc_feats(nobs))
                recs["next_topics_dot"].append(nobs["doc_features"] @ nobs["user"])
                recs["pos_watch"].append(nst.last_position_watch)
                recs["clicked_pos"].append(nst.last_clicked)
                recs["reward"].append(rew)
                recs["not_terminal"].append((~done).to(torch.float32))
                slates.append(slate)
                ep_return = ep_return + rew
                st, obs = nst, nobs
                if bool(done):
                    break
            recs["slate"].extend(slates)
            recs["next_slate"].extend(slates[1:] + [torch.zeros_like(slates[-1])])
            returns.append(ep_return)
        out = {k: torch.stack(v) for k, v in recs.items()}
        out["episode_return"] = torch.stack(returns)
        return out


def batchify(env: RecSimInterestEvolution, recs: Dict[str, Tensor]) -> rlt.SlateQInput:
    """Transitions -> ``SlateQInput`` (the JAX job's ``_batchify``): one
    click credits its position alone (``reward_mask``), many clicks every
    position; the docs' values are the ValueWrapper's head."""
    B = recs["reward"].shape[0]
    dev = recs["reward"].device
    reward = recs["pos_watch"].to(torch.float32)
    if env.single_selection:
        clicked = recs["clicked_pos"].to(torch.int64)
        positions = torch.arange(SLATE, device=dev)[None, :]
        mask = (clicked[:, None] >= 0) & (positions == clicked[:, None])
        value, next_value = recs["topics_dot"], recs["next_topics_dot"]
    else:
        mask = torch.ones((B, SLATE), dtype=torch.bool, device=dev)
        value = (recs["topics_dot"] + 1.0) / 2.0
        next_value = (recs["next_topics_dot"] + 1.0) / 2.0
    ones = torch.ones((B, NUM_CAND), device=dev)
    return rlt.SlateQInput(
        state=rlt.FeatureData(float_features=recs["user"], candidate_docs=rlt.DocList(
            float_features=recs["feats"], mask=ones, value=value)),
        next_state=rlt.FeatureData(float_features=recs["next_user"],
                                   candidate_docs=rlt.DocList(float_features=recs["next_feats"],
                                                              mask=ones, value=next_value)),
        action=recs["slate"].to(torch.int32),
        next_action=recs["next_slate"].to(torch.int32),
        reward=reward,
        reward_mask=mask,
        time_diff=torch.ones((B, 1), device=dev),
        step=None,
        not_terminal=recs["not_terminal"].reshape(B, 1),
    )


def subsample(batch: rlt.SlateQInput, idx: Tensor) -> rlt.SlateQInput:
    """The rows ``idx`` of every batch-leading tensor."""
    B = batch.reward.shape[0]

    def take(x):
        if isinstance(x, Tensor):
            return x[idx] if x.ndim and x.shape[0] == B else x
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{f.name: take(getattr(x, f.name))
                                             for f in dataclasses.fields(x)})
        return x

    return take(batch)


def train_and_eval(name: str, single: bool, kwargs: Dict, device, seed: int = 0,
                   epsilons=EPSILONS, episodes: Optional[int] = None,
                   train_steps: Optional[int] = None, eval_episodes: Optional[int] = None,
                   on_round=None) -> Dict:
    """The job: the trainer from ``seed``'s init, the rounds, the greedy
    evaluation -> {mean return, first and last td_loss, act steps, ...}.
    The depths default to the JOB's; ``on_round(round, state)`` is called
    after each round's updates."""
    episodes = JOB["episodes"] if episodes is None else episodes
    train_steps = JOB["train_steps"] if train_steps is None else train_steps
    eval_episodes = JOB["eval_episodes"] if eval_episodes is None else eval_episodes
    env = RecSimInterestEvolution(num_candidates=NUM_CAND, slate_size=SLATE,
                                  single_selection=single, device=device)
    trainer = make_trainer(name, single, kwargs, device)
    ts = trainer.init(torch.Generator().manual_seed(seed))
    gen = torch.Generator(device=trainer.device).manual_seed(seed + 100)
    host_rng = np.random.default_rng(seed)
    collector = SlateQCollector(env, trainer.q_network)
    batches, tds = [], []
    for rnd, eps in enumerate(epsilons):
        batches.append(batchify(env, collector.collect(ts.q_params, eps, episodes, gen)))
        for _ in range(train_steps):
            b = batches[host_rng.integers(0, len(batches))]
            idx = torch.randint(0, b.reward.shape[0], (JOB["minibatch"],), generator=gen,
                                device=trainer.device)
            ts, m = trainer.train_step(ts, subsample(b, idx))
            tds.append(m["td_loss"])
        if on_round is not None:
            on_round(rnd, ts)
    act_steps = collector.act_steps
    recs = collector.collect(ts.q_params, 0.0, eval_episodes, gen)
    td = torch.stack(tds).cpu() if tds else torch.zeros(0)
    return dict(
        mean_return=float(recs["episode_return"].mean()),
        bar=PASSING_SCORE_BAR,
        train_act_steps=act_steps,
        eval_act_steps=collector.act_steps - act_steps,
        transitions=sum(int(b.reward.shape[0]) for b in batches),
        first_td=float(td[0]) if len(td) else None,
        last_td=float(td[-1]) if len(td) else None,
        trainer=trainer, state=ts,
    )
