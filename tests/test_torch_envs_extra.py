"""The port's environments against the JAX package's, step by step.

Each JAX env draws inside ``reset``/``step`` from a key; the port's take
those draws explicitly (``noise``).  So each rollout here splits JAX's keys
as the JAX env does (``_JAX_RESET_NOISE`` and ``_JAX_STEP_NOISE`` repeat its
random calls, in its order), hands the JAX env the key and the port's env
the values, and runs both on the same actions from a seeded numpy stream.
Observations, rewards and done flags are held equal: integer and flag
fields exactly, float fields to atol 1e-6 (both packages compute in
float32, the sums of a product in their own order).  The same runs hold the
port's batched envs to their unbatched steps, and ``build_env`` to JAX's
registry member by member.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reagent_tpu.core.registry import ENVS as JAX_ENVS
from reagent_tpu.gym import envs as jenvs
from reagent_tpu.gym.envs import oracle_pvm as joracle
from reagent_tpu_torch.core.registry import ENVS
from reagent_tpu_torch.gym import envs
from reagent_tpu_torch.gym.envs import oracle_pvm

ATOL = 1e-6
STEPS = 24


def _split_uniform(key, shape, lo, hi):
    return jax.random.uniform(key, shape, minval=lo, maxval=hi)


def _recsim_docs(env, key):
    r_topic, r_q = jax.random.split(key)
    return (jax.random.randint(r_topic, (env.num_candidates,), 0, jenvs.recsim.NUM_TOPICS),
            jax.random.normal(r_q, (env.num_candidates,)))


def _recsim_step_noise(env, key):
    r_a, r_drift, r_docs = jax.random.split(key, 3)
    S = env.slate_size
    if env.single_selection:
        first = (jax.random.gumbel(r_a, (S + 1,)), jax.random.uniform(r_drift, ()))
    else:
        first = (jax.random.uniform(r_a, (S,)),
                 jnp.stack([jax.random.uniform(jax.random.fold_in(r_drift, i), ())
                            for i in range(S)]))
    return (*first, *_recsim_docs(env, r_docs))


def _pocman_reset(env, key):
    r1, _ = jax.random.split(key)
    return jax.random.choice(r1, jenvs.pomdp._FREE.shape[0], (env.num_ghosts,), replace=False)


# the values of each JAX env's random calls, by env class name
_JAX_RESET_NOISE = {
    "LinDyna": lambda env, key: jax.random.randint(key, (3,), -1, 2),
    "ChangingArms": lambda env, key: (
        lambda r1, r2: (_split_uniform(r1, (env.num_arms,), -1.0, 1.0),
                        jax.random.uniform(r2, (env.num_arms,))))(*jax.random.split(key)),
    "PossibleActionsMaskTester": lambda env, key: jax.random.randint(key, (), 0, env.action_num),
    "PocManEnv": _pocman_reset,
    "OraclePVM": lambda env, key: (
        lambda ru, rd: (jax.random.uniform(ru, (env.user_feat_dim,)),
                        jax.random.uniform(rd, (env.num_candidates, env.candidate_feat_dim))))(
        *jax.random.split(key)),
    "RecSimSlate": lambda env, key: (
        lambda r1, r2, r3: (_split_uniform(r1, (env.num_topics,), -1.0, 1.0),
                            jax.random.dirichlet(r2, jnp.ones(env.num_topics),
                                                 (env.num_candidates,)),
                            _split_uniform(r3, (env.num_candidates,), 0.5, 1.5)))(
        *jax.random.split(key, 3)),
    "RecSimInterestEvolution": lambda env, key: (
        lambda ru, rd: (_split_uniform(ru, (jenvs.recsim.NUM_TOPICS,), -1.0, 1.0),
                        *_recsim_docs(env, rd)))(*jax.random.split(key)),
}
_JAX_STEP_NOISE = {
    "StringGameV1": lambda env, key: jax.random.uniform(key),
    "ChangingArms": lambda env, key: (
        lambda r1, r2, r3: (jax.random.normal(r1, (env.num_arms,)),
                            jax.random.uniform(r2, (env.num_arms,))))(*jax.random.split(key, 3)),
    "PossibleActionsMaskTester": lambda env, key: jax.random.randint(key, (), 0, env.action_num),
    "PocManEnv": lambda env, key: jnp.stack(
        [jax.random.randint(k, (), 0, 4) for k in jax.random.split(key, env.num_ghosts)]),
    "RecSimSlate": lambda env, key: jax.random.gumbel(jax.random.split(key)[0],
                                                      (env.slate_size + 1,)),
    "RecSimInterestEvolution": _recsim_step_noise,
}

# (name, JAX constructor kwargs): every device-resident member of the union
CASES = [
    ("LinDyna", {}),
    ("OpenGridworld", {}),
    ("OpenGridworld", {"size": 4, "max_steps": 12}),
    ("StringGame", {}),
    ("StringGameV1", {}),
    ("ChangingArms", {"num_arms": 4, "max_steps": 9}),
    ("PossibleActionsMaskTester", {"max_steps": 7}),
    ("PocManEnv", {}),
    ("PocManEnv", {"num_ghosts": 3, "max_steps": 10}),
    ("OraclePVM", {}),
    ("RecSimSlate", {"num_candidates": 6, "slate_size": 2}),
    ("RecSimInterestEvolution", {}),
    ("RecSimInterestEvolution", {"single_selection": False, "max_steps": 12}),
    ("RecSimInterestEvolution", {"is_interest_exploration": True}),
]


def _t(x):
    return torch.tensor(np.asarray(x))


def _noise(table, name, env, key):
    fn = table.get(name)
    if fn is None:
        return None
    out = fn(env, key)
    return tuple(_t(x) for x in out) if isinstance(out, tuple) else _t(out)


def _action(name, jenv, rng):
    if name in ("RecSimSlate", "RecSimInterestEvolution"):
        return rng.permutation(jenv.num_candidates)[:jenv.slate_size].astype(np.int32)
    if name == "OraclePVM":
        return rng.uniform(-1, 1, jenv.action_dim).astype(np.float32)
    if jenv.discrete:
        return np.int32(rng.integers(0, jenv.action_dim))
    return rng.uniform(-1, 1, jenv.action_dim).astype(np.float32)


def _assert_obs(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_obs(got[k], want[k], f"{what}/{k}")
        return
    want = np.asarray(want)
    got = got.numpy()
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _reset_both(name, jenv, env, key):
    jstate, jobs = jenv.reset(key)
    noise = _noise(_JAX_RESET_NOISE, name, jenv, key)
    state, obs = env.reset(noise=noise) if noise is not None else env.reset()
    return jstate, jobs, state, obs


@pytest.mark.parametrize("name,kwargs", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_rollout_matches_jax(name, kwargs):
    jenv = JAX_ENVS.get(name)(**kwargs)
    env = ENVS.get(name)(**kwargs, device="cpu")
    rng = np.random.default_rng(len(name) + len(kwargs))
    key = jax.random.PRNGKey(7)
    key, r = jax.random.split(key)
    jstate, jobs, state, obs = _reset_both(name, jenv, env, r)
    _assert_obs(obs, jobs, "reset")
    dones = 0
    for i in range(STEPS):
        a = _action(name, jenv, rng)
        key, r = jax.random.split(key)
        jstate, jobs, jrew, jdone = jenv.step(jstate, jnp.asarray(a), r)
        noise = _noise(_JAX_STEP_NOISE, name, jenv, r)
        kw = {} if noise is None else {"noise": noise}
        state, obs, rew, done = env.step(state, torch.tensor(a), **kw)
        _assert_obs(obs, jobs, f"step {i}")
        np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), rtol=0, atol=ATOL,
                                   err_msg=f"reward {i}")
        assert bool(done) == bool(jdone), i
        if name == "RecSimInterestEvolution":
            np.testing.assert_array_equal(state.last_clicked.numpy(), np.asarray(jstate.last_clicked))
            np.testing.assert_allclose(state.last_position_watch.numpy(),
                                       np.asarray(jstate.last_position_watch), atol=ATOL, rtol=0)
            np.testing.assert_allclose(state.budget.numpy(), np.asarray(jstate.budget),
                                       atol=1e-4, rtol=0)  # a sum over 50 steps of 250
        if bool(jdone):
            dones += 1
            key, r = jax.random.split(key)
            jstate, jobs, state, obs = _reset_both(name, jenv, env, r)
            _assert_obs(obs, jobs, f"reset after {i}")
    assert dones >= 1 or name in ("RecSimSlate", "RecSimInterestEvolution", "PocManEnv"), name


# the envs the online jobs batch (evaluate_policy), and their draws
BATCHED = [("LinDyna", {}), ("OpenGridworld", {}), ("StringGame", {}), ("StringGameV1", {}),
           ("ChangingArms", {"num_arms": 3}), ("PossibleActionsMaskTester", {})]


@pytest.mark.parametrize("name,kwargs", BATCHED, ids=[n for n, _ in BATCHED])
def test_batched_steps_match_unbatched(name, kwargs):
    """A batch of E envs steps as E envs one at a time, from the same draws
    (floats to atol 1e-6: LinDyna's products sum in another order batched)."""
    env = ENVS.get(name)(**kwargs, device="cpu")
    E = 5
    gen = torch.Generator().manual_seed(3)
    noise = getattr(env, "reset_noise", None)
    rnoise = None if noise is None else noise(gen, E)
    bstate, bobs = env.reset(gen, batch_size=E, **({} if rnoise is None else {"noise": rnoise}))

    def pick(x, e):
        return tuple(v[e] for v in x) if isinstance(x, tuple) else x[e]

    singles = [env.reset(**({} if rnoise is None else {"noise": pick(rnoise, e)}))
               for e in range(E)]
    for e in range(E):
        torch.testing.assert_close(bobs[e], singles[e][1], rtol=0, atol=ATOL)
    rng = np.random.default_rng(4)
    for _ in range(8):
        a = (torch.tensor(rng.integers(0, env.action_dim, E), dtype=torch.int32) if env.discrete
             else torch.tensor(rng.uniform(-1, 1, (E, env.action_dim)), dtype=torch.float32))
        step_noise = getattr(env, "step_noise", None)
        snoise = None if step_noise is None else step_noise(gen, (E,))
        kw = {} if snoise is None else {"noise": snoise}
        bstate, bobs, brew, bdone = env.step(bstate, a, **kw)
        for e in range(E):
            kw = {} if snoise is None else {"noise": pick(snoise, e)}
            st, ob, rw, dn = env.step(singles[e][0], a[e], **kw)
            singles[e] = (st, ob)
            torch.testing.assert_close(bobs[e], ob, rtol=0, atol=ATOL)
            torch.testing.assert_close(brew[e], rw, rtol=0, atol=ATOL)
            assert bool(bdone[e]) == bool(dn)


def test_string_game_v1_termination_values():
    """E[Q_B-first] = 1.8 > E[Q_A-first] = 1.25 (ref pomdp/string_game_v1.py:24-27;
    tests/test_gym_envs_extra.py:143), on the port's draws and exactly on
    JAX's: the same 400 + 400 episodes give the same returns."""
    env = envs.build_env({"StringGameV1": {"device": "cpu"}})
    jenv = jenvs.build_env({"StringGameV1": {}})

    def rollout(first_action, seed):
        rng = jax.random.PRNGKey(seed)
        st, _ = env.reset()
        jst, _ = jenv.reset(rng)
        acts = [first_action, 0, 0]  # optimal continuation is A, A
        total, jtotal, done, t = 0.0, 0.0, False, 0
        while not done:
            rng, r = jax.random.split(rng)
            jst, _, jrew, jdone = jenv.step(jst, jnp.asarray(acts[t]), r)
            st, _, rew, d = env.step(st, torch.tensor(acts[t]), noise=_t(jax.random.uniform(r)))
            total += float(rew)
            jtotal += float(jrew)
            done = bool(d)
            assert done == bool(jdone)
            t += 1
        return total, jtotal

    b = np.array([rollout(1, s) for s in range(400)])
    a = np.array([rollout(0, s + 1000) for s in range(400)])
    np.testing.assert_array_equal(b[:, 0], b[:, 1])
    np.testing.assert_array_equal(a[:, 0], a[:, 1])
    b_mean, a_mean = b[:, 0].mean(), a[:, 0].mean()
    assert 1.4 < b_mean < 2.2, b_mean
    assert 0.9 < a_mean < 1.6, a_mean
    assert b_mean > a_mean
    # and on the port's own draws
    gen = torch.Generator().manual_seed(0)
    port = []
    for first in (1, 0):
        total = 0.0
        for _ in range(400):
            st, _ = env.reset()
            acts, done, t = [first, 0, 0], False, 0
            while not done:
                st, _, rew, d = env.step(st, torch.tensor(acts[t]), gen)
                total += float(rew)
                done, t = bool(d), t + 1
        port.append(total / 400)
    assert 1.4 < port[0] < 2.2 and 0.9 < port[1] < 1.6, port


def test_kendall_tau_against_scipy_and_jax():
    from scipy.stats import kendalltau

    rng = np.random.default_rng(5)
    for n in (2, 3, 5, 8):
        for _ in range(10):
            a, b = rng.permutation(n), rng.permutation(n)
            got = float(oracle_pvm.kendall_tau(torch.tensor(a), torch.tensor(b)))
            np.testing.assert_allclose(got, kendalltau(a, b).statistic, rtol=0, atol=1e-6)
            assert got == float(joracle.kendall_tau(jnp.asarray(a), jnp.asarray(b)))


def test_possible_actions_mask():
    env = envs.PossibleActionsMaskTester(max_steps=5, action_num=3, device="cpu")
    jenv = jenvs.PossibleActionsMaskTester(max_steps=5, action_num=3)
    state, obs = env.reset(noise=torch.tensor(2))
    jstate, jobs = jenv.reset(jax.random.PRNGKey(0))
    torch.testing.assert_close(env.possible_actions_mask(obs), torch.tensor([0.0, 0.0, 1.0]))
    np.testing.assert_array_equal(env.possible_actions_mask(obs[None]).numpy(),
                                  np.asarray(jenv.possible_actions_mask(jnp.asarray(obs[None]))))
    # the legal action pays 10, any other 0; the episode ends after max_steps
    total = 0.0
    for t in range(5):
        legal = int(torch.argmax(env.possible_actions_mask(obs)))
        state, obs, rew, done = env.step(state, torch.tensor(legal), noise=torch.tensor(t % 3))
        total += float(rew)
        assert bool(done) == (t == 4)
    assert total == 50.0
    assert float(obs[:5].sum()) == 0.0  # the step one-hot is empty past the last step


def test_toy_vm_matches_jax():
    """A host env on np.random.RandomState: one seed, one stream."""
    env, jenv = envs.ToyVMEnv(slate_size=4, seed=3), jenvs.ToyVMEnv(slate_size=4, seed=3)
    assert env.reset() == jenv.reset()
    rng = np.random.default_rng(0)
    for _ in range(25):
        perm = list(rng.permutation(4))
        got, want = env.step(perm), jenv.step(perm)
        assert got == want
        if got[2]:
            assert env.reset() == jenv.reset()


def test_build_env_builds_every_member_jax_builds():
    """The port's registry holds JAX's names, and builds each member JAX's
    ``build_env`` builds from the same config (the device-resident envs with
    ``device`` added), of the same sizes."""
    assert set(ENVS.members()) == set(JAX_ENVS.members())
    assert not hasattr(envs, "UNPORTED_ENVS")
    configs = {name: {} for name in JAX_ENVS.members()}
    configs.update({"ToyVMEnv": {"slate_size": 3}, "Gym": {"env_name": "CartPole-v1"},
                    "OpenGridworld": {"size": 5}, "ChangingArms": {"num_arms": 3}})
    built = 0
    for name, cfg in sorted(configs.items()):
        try:
            want = jenvs.build_env({name: dict(cfg)})
        except (TypeError, ImportError):  # needs arguments a config cannot give
            with pytest.raises((TypeError, ImportError)):
                envs.build_env({name: dict(cfg)})
            continue
        takes_device = "device" in inspect.signature(ENVS.get(name)).parameters
        got = envs.build_env({name: dict(cfg, **({"device": "cpu"} if takes_device else {}))})
        assert type(got).__name__ == type(want).__name__
        for attr in ("observation_dim", "action_dim", "discrete", "max_steps", "slate_size"):
            if hasattr(want, attr):
                assert getattr(got, attr) == getattr(want, attr), (name, attr)
        built += 1
    assert built >= 13  # all but StateEmbedEnv (an env and a world model)

