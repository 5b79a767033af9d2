"""The model-based jobs: CEM planning over MDN-RNN world models on LinDyna
and CartPole, and Seq2Reward with its compress model on CartPole.

Ports of the JAX package's jobs (``tests/test_world_models.py:225-404``;
reference gym/tests/configs/world_model/
cem_single_world_model_linear_dynamics_offline.yaml,
cem_many_world_models_linear_dynamics_offline.yaml and
cem_cartpole_offline.yaml):

- ``cem_lindyna``: 512 random LinDyna rollouts of 4 steps, actions uniform
  in [-1, 1]; each world model (100 hidden, 2 layers, 1 gaussian, Adam
  1e-3, the not-terminal loss off) trains 400 steps on the whole corpus;
  CEM with 10 iterations, population 100, 15 elites, horizon 4, gamma 1,
  sampled next states, no terminal head; 5 episodes, bar -2.5.
- ``cem_cartpole``: 200,000 random one-step CartPole transitions (1,000
  envs x 200 steps with auto-reset); the world model predicts the state's
  change (``predict_delta``), not-terminal loss weight 200, 1,000 steps on
  minibatches of 1,024 one-step sequences; random shooting with population
  100 and horizon 10 on the expected next state and survival; 3 episodes of
  up to 200 steps, bar 100.
- ``seq2reward_cartpole``: the ``Seq2RewardModel`` manager's network (64
  hidden, 2 layers, step classifier 64) with ``multi_steps`` 6 on windows
  of 6 steps of that CartPole corpus (each window's valid steps end at its
  first done), then the compress model (``FullyConnectedDQN`` 64, 64 relu)
  on the planning Q of the windows' first states; the greedy CartPole
  return of the compress model served through
  ``CompressModelWithPreprocessor`` (K3 once a step) and of the planner
  itself.  The JAX package has no bar for it.

Each job takes its depths as arguments (``chip_smoke.py`` cuts them), its
seeds, and a device; the corpus, the minibatches and the planners' draws
come from generators on that device, the weights' init from CPU
generators.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import MDNRNNTrainerParameters, NormalizationParameters
from reagent_tpu_torch.gym.envs import CartPole, LinDyna, where_state
from reagent_tpu_torch.gym.online_loop import evaluate_policy
from reagent_tpu_torch.model_managers.world_model import Seq2RewardModel
from reagent_tpu_torch.models.cem_planner import CEMPlannerNetwork
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.models.mdn_rnn import MemoryNetwork
from reagent_tpu_torch.prediction.world_model_wrappers import (
    CompressModelWithPreprocessor,
    Seq2RewardPlanShortSeqWithPreprocessor,
    Seq2RewardWithPreprocessor,
)
from reagent_tpu_torch.preprocessing.identify_types import DO_NOT_PREPROCESS
from reagent_tpu_torch.preprocessing.preprocessor import Preprocessor
from reagent_tpu_torch.training.world_model import CompressModelTrainer, MDNRNNTrainer
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor

LINDYNA_JOB = dict(episodes=512, hidden=100, layers=2, gaussians=1, lr=1e-3, wm_steps=400,
                   iterations=10, population=100, elites=15, horizon=4, eval_episodes=5,
                   bar=-2.5)
CARTPOLE_JOB = dict(envs=1000, steps=200, hidden=100, layers=2, gaussians=1, lr=1e-3,
                    not_terminal_weight=200.0, wm_steps=1000, batch=1024, iterations=10,
                    population=100, elites=15, horizon=10, eval_episodes=3, max_steps=200,
                    bar=100.0)
SEQ2REWARD_JOB = dict(multi_steps=6, batch=1024, steps=1000, compress_steps=500,
                      compress_sizes=(64, 64), eval_episodes=10, max_steps=200)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lindyna_corpus(env: LinDyna, episodes: int, generator: torch.Generator
                   ) -> rlt.MemoryNetworkInput:
    """``episodes`` random rollouts of ``env.max_steps`` as one time-major
    batch: observations, actions uniform in [-1, 1], next observations,
    rewards and not-terminals."""
    state, obs = env.reset(generator, batch_size=episodes)
    cols = []
    for _ in range(env.max_steps):
        u = torch.rand((episodes, env.action_dim), generator=generator, device=env.device)
        u = u * 2.0 - 1.0
        state, nobs, rew, done = env.step(state, u)
        cols.append((obs, u, nobs, rew, 1.0 - done.to(torch.float32)))
        obs = nobs
    obs, act, nobs, rew, nt = (torch.stack(c) for c in zip(*cols))
    return rlt.MemoryNetworkInput(
        state=rlt.FeatureData(obs), action=rlt.FeatureData(act),
        next_state=rlt.FeatureData(nobs), reward=rew, not_terminal=nt, time_diff=None,
        step=None)


def cartpole_corpus(env: CartPole, envs: int, steps: int, generator: torch.Generator
                    ) -> Dict[str, Tensor]:
    """``envs`` random-policy CartPoles stepped ``steps`` times with
    auto-reset: time-major [steps, envs, ...] observations, one-hot actions,
    next observations (before the reset), rewards and dones."""
    state, obs = env.reset(generator, batch_size=envs)
    cols = []
    for _ in range(steps):
        a = torch.randint(0, env.action_dim, (envs,), generator=generator, device=env.device)
        nstate, nobs, rew, done = env.step(state, a)
        cols.append((obs, F.one_hot(a, env.action_dim).to(torch.float32), nobs, rew, done))
        rstate, robs = env.reset(generator, batch_size=envs)
        state = where_state(done, rstate, nstate)
        obs = torch.where(done[:, None], robs, nobs)
    obs, act, nobs, rew, done = (torch.stack(c) for c in zip(*cols))
    return dict(obs=obs, action=act, next_obs=nobs, reward=rew, done=done)


def _train_members(trainer: MDNRNNTrainer, n: int, steps: int, batch_fn, init_seed: int):
    """``n`` world models trained ``steps`` steps each on ``batch_fn()``,
    one after another: (each member's parameters, each member's first and
    last loss)."""
    params, losses = [], []
    for m in range(n):
        state = trainer.init(torch.Generator().manual_seed(init_seed + m))
        first = last = None
        for i in range(steps):
            state, metrics = trainer.train_step(state, batch_fn())
            if i == 0:
                first = metrics["loss"]
            last = metrics["loss"]
        params.append(state.params)
        losses.append((float(first), float(last)))
    return params, losses


def cem_lindyna(num_world_models: int, device="cuda", wm_steps: int = LINDYNA_JOB["wm_steps"],
                eval_episodes: int = LINDYNA_JOB["eval_episodes"], seed: int = 0) -> Dict:
    """CEM on LinDyna with ``num_world_models`` world models: the mean
    return of ``eval_episodes`` planned episodes against the -2.5 bar."""
    dev = resolve_device(device)
    cfg = LINDYNA_JOB
    env = LinDyna(device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    corpus = lindyna_corpus(env, cfg["episodes"], gen)
    net = MemoryNetwork(env.observation_dim, env.action_dim, cfg["hidden"], cfg["layers"],
                        cfg["gaussians"])
    trainer = MDNRNNTrainer(net, MDNRNNTrainerParameters(
        hidden_size=cfg["hidden"], num_hidden_layers=cfg["layers"],
        num_gaussians=cfg["gaussians"], learning_rate=cfg["lr"], not_terminal_loss_weight=0.0),
        device=dev)
    params, losses = _train_members(trainer, num_world_models, wm_steps, lambda: corpus,
                                    seed + 1)
    _sync(dev)
    train_s = time.perf_counter() - t0
    planner = CEMPlannerNetwork(
        mem_net=net, mem_net_params_list=params, cem_num_iterations=cfg["iterations"],
        cem_population_size=cfg["population"], ensemble_population_size=1,
        num_elites=cfg["elites"], plan_horizon_length=cfg["horizon"],
        state_dim=env.observation_dim, action_dim=env.action_dim, discrete_action=False,
        terminal_effective=False, gamma=1.0, action_upper_bounds=np.ones(env.action_dim),
        action_lower_bounds=-np.ones(env.action_dim), device=dev)
    t0 = time.perf_counter()
    returns = []
    for _ in range(eval_episodes):
        state, obs = env.reset(gen)
        total = torch.zeros((), device=dev)
        for _ in range(env.max_steps):
            u = planner(rlt.FeatureData(float_features=obs[None]), gen)
            state, obs, rew, _ = env.step(state, u)
            total = total + rew
        returns.append(float(total))
    eval_s = time.perf_counter() - t0
    plans = eval_episodes * env.max_steps
    return dict(num_world_models=num_world_models, wm_steps=wm_steps, wm_losses=losses,
                train_s=train_s, wm_steps_per_s=num_world_models * wm_steps / train_s,
                returns=returns, mean_return=float(np.mean(returns)), bar=cfg["bar"],
                plans=plans, plan_ms=eval_s / plans * 1e3, eval_s=eval_s)


def cartpole_planner(net: MemoryNetwork, params, device) -> CEMPlannerNetwork:
    """The CartPole job's planner: random shooting, population 100, horizon
    10, the expected next state and survival."""
    cfg = CARTPOLE_JOB
    return CEMPlannerNetwork(
        mem_net=net, mem_net_params_list=[params], cem_num_iterations=cfg["iterations"],
        cem_population_size=cfg["population"], ensemble_population_size=1,
        num_elites=cfg["elites"], plan_horizon_length=cfg["horizon"],
        state_dim=CartPole.observation_dim, action_dim=CartPole.action_dim,
        discrete_action=True, terminal_effective=True, gamma=1.0, sample_next_state=False,
        sample_not_terminal=False, device=device)


def cem_cartpole(device="cuda", wm_steps: int = CARTPOLE_JOB["wm_steps"],
                 eval_episodes: int = CARTPOLE_JOB["eval_episodes"],
                 max_steps: int = CARTPOLE_JOB["max_steps"], seed: int = 0,
                 corpus: Optional[Dict[str, Tensor]] = None) -> Dict:
    """CEM on CartPole: the mean return of ``eval_episodes`` planned
    episodes of up to ``max_steps`` against the 100 bar, and the trained
    world model and planner."""
    dev = resolve_device(device)
    cfg = CARTPOLE_JOB
    env = CartPole(max_steps=cfg["max_steps"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    if corpus is None:
        corpus = cartpole_corpus(env, cfg["envs"], cfg["steps"], gen)
    flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in corpus.items()}
    n = flat["reward"].shape[0]
    net = MemoryNetwork(env.observation_dim, env.action_dim, cfg["hidden"], cfg["layers"],
                        cfg["gaussians"], predict_delta=True)
    trainer = MDNRNNTrainer(net, MDNRNNTrainerParameters(
        hidden_size=cfg["hidden"], num_hidden_layers=cfg["layers"],
        num_gaussians=cfg["gaussians"], learning_rate=cfg["lr"],
        not_terminal_loss_weight=cfg["not_terminal_weight"]), device=dev)

    def minibatch():
        idx = torch.randint(0, n, (cfg["batch"],), generator=gen, device=dev)
        return rlt.MemoryNetworkInput(
            state=rlt.FeatureData(flat["obs"][idx][None]),
            action=rlt.FeatureData(flat["action"][idx][None]),
            next_state=rlt.FeatureData(flat["next_obs"][idx][None]),
            reward=flat["reward"][idx][None],
            not_terminal=1.0 - flat["done"][idx][None].to(torch.float32),
            time_diff=None, step=None)

    (params,), losses = _train_members(trainer, 1, wm_steps, minibatch, seed + 1)
    _sync(dev)
    train_s = time.perf_counter() - t0
    planner = cartpole_planner(net, params, dev)
    t0 = time.perf_counter()
    returns, plans = [], 0
    for _ in range(eval_episodes):
        state, obs = env.reset(gen)
        total = 0.0
        for _ in range(max_steps):
            a, _ = planner(rlt.FeatureData(float_features=obs[None]), gen)
            state, obs, rew, done = env.step(state, torch.tensor(a, device=dev))
            plans += 1
            total += float(rew)
            if bool(done):
                break
        returns.append(total)
    eval_s = time.perf_counter() - t0
    return dict(wm_steps=wm_steps, wm_losses=losses, train_s=train_s,
                wm_steps_per_s=wm_steps / train_s, returns=returns,
                mean_return=float(np.mean(returns)), bar=cfg["bar"], plans=plans,
                plan_ms=eval_s / max(plans, 1) * 1e3, eval_s=eval_s, planner=planner,
                corpus=corpus)


def cartpole_windows(corpus: Dict[str, Tensor], batch: int, seq_len: int,
                     generator: torch.Generator) -> rlt.MemoryNetworkInput:
    """``batch`` windows of ``seq_len`` consecutive steps of one env of the
    corpus, each valid up to and including its first done."""
    T, E = corpus["reward"].shape
    dev = corpus["reward"].device
    start = torch.randint(0, T - seq_len + 1, (batch,), generator=generator, device=dev)
    env = torch.randint(0, E, (batch,), generator=generator, device=dev)
    t = start[None, :] + torch.arange(seq_len, device=dev)[:, None]  # [seq_len, batch]
    done = corpus["done"][t, env[None, :]]
    valid = torch.where(done.any(dim=0), torch.argmax(done.to(torch.int32), dim=0) + 1,
                        torch.full_like(start, seq_len))
    return rlt.MemoryNetworkInput(
        state=rlt.FeatureData(corpus["obs"][t, env[None, :]]),
        action=rlt.FeatureData(corpus["action"][t, env[None, :]]),
        next_state=rlt.FeatureData(corpus["next_obs"][t, env[None, :]]),
        reward=corpus["reward"][t, env[None, :]],
        not_terminal=1.0 - done.to(torch.float32), time_diff=None, step=None,
        valid_step=valid.to(torch.int32)[:, None])


def identity_preprocessor(n: int, device) -> Preprocessor:
    """A preprocessor passing ``n`` raw features through unchanged."""
    return Preprocessor({i: NormalizationParameters(feature_type=DO_NOT_PREPROCESS)
                         for i in range(n)}, device=device)


def seq2reward_cartpole(device="cuda", steps: int = SEQ2REWARD_JOB["steps"],
                        compress_steps: int = SEQ2REWARD_JOB["compress_steps"],
                        eval_episodes: int = SEQ2REWARD_JOB["eval_episodes"], seed: int = 0,
                        corpus: Optional[Dict[str, Tensor]] = None) -> Dict:
    """Seq2Reward and its compress model on windows of the CartPole corpus:
    both losses' first and last values, train steps/s, and the greedy
    returns of the compress model (K3) and of the planner."""
    dev = resolve_device(device)
    cfg = SEQ2REWARD_JOB
    env = CartPole(max_steps=cfg["max_steps"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if corpus is None:
        corpus = cartpole_corpus(env, CARTPOLE_JOB["envs"], CARTPOLE_JOB["steps"], gen)
    manager = Seq2RewardModel(trainer_param={"multi_steps": cfg["multi_steps"],
                                             "action_names": ("left", "right")})
    trainer = manager.build_trainer(None, state_dim=env.observation_dim, device=dev)
    state = trainer.init(torch.Generator().manual_seed(seed + 1))
    mse: List[Tensor] = []
    entropy: List[Tensor] = []
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        batch = cartpole_windows(corpus, cfg["batch"], cfg["multi_steps"], gen)
        state, m = trainer.train_step(state, batch)
        mse.append(m["mse_loss"])
        entropy.append(m["step_entropy_loss"])
    _sync(dev)
    train_s = time.perf_counter() - t0
    compress = CompressModelTrainer(
        FullyConnectedDQN(env.observation_dim, env.action_dim, list(cfg["compress_sizes"]),
                          ["relu"] * len(cfg["compress_sizes"])),
        trainer.seq2reward_network, trainer.params, device=dev)
    cstate = compress.init(torch.Generator().manual_seed(seed + 2))
    compress_mse: List[Tensor] = []
    t0 = time.perf_counter()
    for _ in range(compress_steps):
        batch = cartpole_windows(corpus, cfg["batch"], cfg["multi_steps"], gen)
        cstate, m = compress.train_step(cstate, batch, seq2reward_params=state.params)
        compress_mse.append(m["mse_loss"])
    _sync(dev)
    compress_s = time.perf_counter() - t0

    pre = identity_preprocessor(env.observation_dim, dev)
    compressed = CompressModelWithPreprocessor(compress.compress_model_network, cstate.params,
                                               pre)
    planning = Seq2RewardWithPreprocessor(trainer.seq2reward_network, state.params, pre,
                                          cfg["multi_steps"], env.action_dim)

    def greedy(wrapper):
        def act(_, obs, g):
            return torch.argmax(wrapper(obs, torch.ones_like(obs)), dim=1)
        return act

    t0 = time.perf_counter()
    compress_returns = evaluate_policy(env, greedy(compressed), None, gen,
                                       num_episodes=eval_episodes).cpu()
    _sync(dev)
    compress_eval_s = time.perf_counter() - t0
    planner_returns = evaluate_policy(env, greedy(planning), None, gen,
                                      num_episodes=eval_episodes).cpu()
    short = Seq2RewardPlanShortSeqWithPreprocessor(
        trainer.seq2reward_network, state.params, trainer.step_predict_network,
        state.step_params, pre, cfg["multi_steps"], env.action_dim)
    first = cartpole_windows(corpus, cfg["batch"], cfg["multi_steps"], gen).state.float_features[0]
    ones = torch.ones_like(first)
    agree = (torch.argmax(short(first, ones), dim=1) == torch.argmax(planning(first, ones), dim=1))
    mse_t, ent_t, cmse_t = (torch.stack(x).cpu() for x in (mse, entropy, compress_mse))
    return dict(
        steps=steps, train_s=train_s, steps_per_s=steps / train_s,
        mse_loss=(float(mse_t[0]), float(mse_t[-1])),
        step_entropy_loss=(float(ent_t[0]), float(ent_t[-1])),
        compress_steps=compress_steps, compress_s=compress_s,
        compress_mse=(float(cmse_t[0]), float(cmse_t[-1])),
        compress_returns=compress_returns.tolist(),
        compress_mean_return=float(compress_returns.mean()),
        compress_eval_s=compress_eval_s, eval_episodes=eval_episodes,
        planner_mean_return=float(planner_returns.mean()),
        short_seq_agreement=float(agree.to(torch.float32).mean()),
        trainer=trainer, state=state, compress=compress, compress_state=cstate)
