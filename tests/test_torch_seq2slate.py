"""Seq2Slate against the JAX package: the mask helpers, every mode of
``Seq2SlateTransformerModel`` for the three output architectures from JAX's
weights (``interop.seq2slate_state_from_flax``), sampled ranks on JAX's own
gumbel draws, the key/value-cached decode against the full decode re-run on
each prefix, bfloat16 against JAX's bfloat16 model, the batch wrapper, the
reward nets and net builders, and the four trainers (the off-policy
``Seq2SlateTrainer`` with its options, teacher forcing, pairwise attention,
and the simulation trainer on JAX's draws, 3 steps) in 5-step lockstep with
JAX's, each step from JAX's state and Adam state.

Tolerances, float32 on two libraries: forwards and lockstep metrics rtol
1e-5 atol 1e-6; ranked slates exact; the Adam moments within 1e-5 of the
model's largest entry; each parameter rtol 1e-5 atol 1e-6 plus what Adam's
step makes of that moment agreement (``assert_step_close``).  bfloat16
(measured on the CPU at these shapes, max |port - JAX| over the three
architectures): per-sequence log-probabilities 1.314e-03 (values near -6),
ranked per-symbol probabilities 2.652e-03, every greedy slot equal; held
within 5e-3, 5e-3 and 99%, no looser than ``tests/test_slate.py:216-220``'s
rtol 0.15 and 90% agreement.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reagent_tpu_torch.net_builder  # noqa: F401 — registers the builders
from reagent_tpu.core import types as jrlt
from reagent_tpu.core.parameters import IPSClamp as JaxIPSClamp
from reagent_tpu.core.parameters import IPSClampMethod as JaxIPSClampMethod
from reagent_tpu.core.parameters import Seq2SlateParameters as JaxSeq2SlateParameters
from reagent_tpu.models import seq2slate as J
from reagent_tpu.models.seq2slate_reward import (
    Seq2SlateGRURewardNet as JaxGRURewardNet,
)
from reagent_tpu.models.seq2slate_reward import (
    Seq2SlateRewardNetEnsemble as JaxEnsemble,
)
from reagent_tpu.models.seq2slate_reward import (
    Seq2SlateTransformerRewardNet as JaxTransformerRewardNet,
)
from reagent_tpu.models.value import ValueNetwork as JaxValueNetwork
from reagent_tpu.training.ranking import seq2slate_attn_trainer as jattn
from reagent_tpu.training.ranking import seq2slate_tf_trainer as jtf
from reagent_tpu.training.ranking import seq2slate_trainer as jtr
from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import IPSClamp, IPSClampMethod, Seq2SlateParameters
from reagent_tpu_torch.core.registry import SLATE_RANKING_NET_BUILDERS, SLATE_REWARD_NET_BUILDERS
from reagent_tpu_torch.models import seq2slate as P
from reagent_tpu_torch.models.critic import FullyConnectedCritic
from reagent_tpu_torch.models.seq2slate_reward import (
    Seq2SlateGRURewardNet,
    Seq2SlateRewardNetEnsemble,
    Seq2SlateTransformerRewardNet,
)
from reagent_tpu_torch.models.value import ValueNetwork
from reagent_tpu_torch.training.ranking import (
    Seq2SlatePairwiseAttnTrainer,
    Seq2SlateSimulationTrainer,
    Seq2SlateTeacherForcingTrainer,
    Seq2SlateTrainer,
)
from reagent_tpu_torch.training.ranking.seq2slate_trainer import ips_clamp
from reagent_tpu_torch.utils.interop import (
    opt_state_from_arrays,
    q_network_state_from_flax,
    seq2slate_state_from_flax,
    seq2slate_trainer_state_from_arrays,
    slate_reward_state_from_flax,
)
from test_torch_qrdqn import _adam_fields, _np_tree

B, S, T, SD, CD = 6, 6, 4, 5, 7
DIMS = dict(num_stacked_layers=2, num_heads=2, dim_model=16, dim_feedforward=32)
TOL = dict(rtol=1e-5, atol=1e-6)
MOMENT_SCALE = 1e-5  # Adam moments: atol 1e-5 times the model's largest entry
ARCHS = list(J.Seq2SlateOutputArch)


def _close(got, want, tol=TOL, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               err_msg=msg, equal_nan=False, **tol)


def jax_model(arch=J.Seq2SlateOutputArch.AUTOREGRESSIVE, dtype=jnp.float32, temperature=1.0):
    return J.Seq2SlateTransformerModel(
        state_dim=SD, candidate_dim=CD, max_src_seq_len=S, max_tgt_seq_len=T, output_arch=arch,
        compute_dtype=dtype, temperature=temperature, **DIMS)


def port_model(arch, dtype=torch.float32, temperature=1.0):
    return P.Seq2SlateTransformerModel(
        state_dim=SD, candidate_dim=CD, max_src_seq_len=S, max_tgt_seq_len=T,
        output_arch=P.Seq2SlateOutputArch(arch.value), compute_dtype=dtype,
        temperature=temperature, **DIMS)


def all_params(jm, seed=1):
    """JAX's variables with every submodule created: a rank, a log-prob and
    an encoder-score pass in one init."""
    state, src, tgt_in, tgt_out, tgt_in_seq = (jnp.asarray(x) for x in arrays(0)[:5])

    def touch(m):
        m.encode(state, src)
        m.encoder_output_to_scores(state, src, tgt_out)
        if m.output_arch != J.Seq2SlateOutputArch.ENCODER_SCORE:
            m.log_probs(state, src, tgt_in_seq, tgt_in, tgt_out, "per_sequence_log_prob")
        return m.rank(state, src, T, True)

    return jm.init(jax.random.PRNGKey(seed), method=touch)


def load(model, params):
    """The port's model holding JAX's weights; keys JAX never made (the
    decoder of an ENCODER_SCORE model) keep the module's own."""
    res = model.load_state_dict(seq2slate_state_from_flax(_np_tree(params)), strict=False)
    assert not res.unexpected_keys
    assert all(k.startswith("decoder_layers") for k in res.missing_keys), res.missing_keys
    return model


def arrays(seed, batch=B, tgt_len=T):
    """state, src, tgt_in, tgt_out (a permutation of ``tgt_len`` of the S
    candidates, +2), tgt_in_seq, logged probs, slate reward, position
    reward."""
    T = tgt_len
    rng = np.random.default_rng(seed)
    state = rng.normal(size=(batch, SD)).astype(np.float32)
    src = rng.normal(size=(batch, S, CD)).astype(np.float32)
    tgt_out = np.stack([rng.permutation(S)[:T] + 2 for _ in range(batch)]).astype(np.int64)
    tgt_in = np.concatenate([np.ones((batch, 1), np.int64), tgt_out[:, :-1]], axis=1)
    cand = np.concatenate([np.zeros((batch, 2, CD), np.float32), src], axis=1)
    tgt_in_seq = np.take_along_axis(cand, tgt_in[:, :, None], axis=1)
    tgt_out_seq = np.take_along_axis(cand, tgt_out[:, :, None], axis=1)
    probs = rng.uniform(0.005, 0.05, (batch, 1)).astype(np.float32)
    reward = rng.uniform(0.0, 1.0, (batch, 1)).astype(np.float32)
    position_reward = (rng.random((batch, T)) > 0.5).astype(np.float32)
    return state, src, tgt_in, tgt_out, tgt_in_seq, tgt_out_seq, probs, reward, position_reward


def ranking_batch(mod, conv, seed, batch=B, tgt_len=T):
    state, src, tgt_in, tgt_out, tgt_in_seq, tgt_out_seq, probs, reward, pos = arrays(
        seed, batch, tgt_len)
    if conv is jnp.asarray:
        tgt_in, tgt_out = tgt_in.astype(np.int32), tgt_out.astype(np.int32)
    return mod.PreprocessedRankingInput(
        state=mod.FeatureData(float_features=conv(state)),
        src_seq=mod.FeatureData(float_features=conv(src)),
        tgt_in_seq=mod.FeatureData(float_features=conv(tgt_in_seq)),
        tgt_out_seq=mod.FeatureData(float_features=conv(tgt_out_seq)),
        tgt_in_idx=conv(tgt_in), tgt_out_idx=conv(tgt_out),
        optim_tgt_in_idx=conv(tgt_in), optim_tgt_out_idx=conv(tgt_out),
        optim_tgt_in_seq=mod.FeatureData(float_features=conv(tgt_in_seq)),
        tgt_out_probs=conv(probs), slate_reward=conv(reward), position_reward=conv(pos))


def jax_draws(key, T_, batch, C):
    """The gumbel draws JAX's sampled rank makes from ``key``: each step
    splits the key and ``categorical`` draws ``gumbel(r, [B, C])``."""
    out = []
    for _ in range(T_):
        key, r = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(r, (batch, C), jnp.float32)))
    return torch.tensor(np.stack(out))


# ------------------------------------------------------------------ helpers

def test_mask_helpers_and_positions_match_jax():
    rng = np.random.default_rng(0)
    idx = np.stack([rng.permutation(S + 2)[:T] for _ in range(B)])
    logits = rng.normal(size=(B, T, S + 2)).astype(np.float32)
    np.testing.assert_array_equal(P.subsequent_mask(T).numpy(), np.asarray(J.subsequent_mask(T)))
    np.testing.assert_array_equal(
        P.mask_logits_by_idx(torch.tensor(logits), torch.tensor(idx)).numpy(),
        np.asarray(J.mask_logits_by_idx(jnp.asarray(logits), jnp.asarray(idx))))
    probs = np.abs(logits) / 3
    _close(P.per_symbol_to_per_seq_probs(torch.tensor(probs), torch.tensor(idx)),
           J.per_symbol_to_per_seq_probs(jnp.asarray(probs), jnp.asarray(idx)))
    _close(P.per_symbol_to_per_seq_log_probs(torch.tensor(logits), torch.tensor(idx)),
           J.per_symbol_to_per_seq_log_probs(jnp.asarray(logits), jnp.asarray(idx)))
    for T_, D in ((20, 256), (5, 7)):
        np.testing.assert_array_equal(P.positional_table(T_, D), np.asarray(J.positional_table(T_, D)))


# -------------------------------------------------------------------- modes

@pytest.mark.parametrize("arch", ARCHS, ids=[a.value for a in ARCHS])
def test_every_mode_matches_jax(arch):
    """Greedy rank (slates equal; per-symbol and per-sequence probabilities),
    both log-probability modes and the encoder scores from JAX's weights."""
    jm = jax_model(arch)
    params = all_params(jm)
    pm = load(port_model(arch), params)
    state, src, tgt_in, tgt_out, tgt_in_seq = arrays(3)[:5]
    js, jsrc = jnp.asarray(state), jnp.asarray(src)
    ts, tsrc = torch.tensor(state), torch.tensor(src)
    jo = jm.apply(params, "rank", js, jsrc, tgt_seq_len=T, greedy=True)
    po = pm("rank", ts, tsrc, tgt_seq_len=T, greedy=True)
    np.testing.assert_array_equal(po.ranked_tgt_out_idx.numpy(), np.asarray(jo.ranked_tgt_out_idx))
    _close(po.ranked_per_symbol_probs, jo.ranked_per_symbol_probs)
    _close(po.ranked_per_seq_probs, jo.ranked_per_seq_probs)
    enc = dict(tgt_out_idx=tgt_out)
    _close(pm("encoder_score_mode", ts, tsrc, tgt_out_idx=torch.tensor(tgt_out)).encoder_scores,
           jm.apply(params, "encoder_score_mode", js, jsrc, **{k: jnp.asarray(v)
                                                                for k, v in enc.items()})
           .encoder_scores)
    if arch == J.Seq2SlateOutputArch.ENCODER_SCORE:
        return
    kw = dict(tgt_in_idx=tgt_in, tgt_out_idx=tgt_out, tgt_in_seq=tgt_in_seq)
    for mode, field in (("per_sequence_log_prob", "per_seq_log_probs"),
                        ("per_symbol_log_prob_dist", "per_symbol_log_probs")):
        want = getattr(jm.apply(params, mode, js, jsrc,
                                **{k: jnp.asarray(v) for k, v in kw.items()}), field)
        got = getattr(pm(mode, ts, tsrc, **{k: torch.tensor(v) for k, v in kw.items()}), field)
        _close(got, want, msg=mode)


@pytest.mark.parametrize("arch", ARCHS[1:], ids=[a.value for a in ARCHS[1:]])
def test_sampled_rank_on_jax_draws(arch):
    """A sampled rank at temperature 0.7 fed the gumbel draws JAX makes from
    its key: the same slates and probabilities; without draws it raises."""
    jm = jax_model(arch, temperature=0.7)
    params = all_params(jm)
    pm = load(port_model(arch, temperature=0.7), params)
    state, src = arrays(4)[:2]
    key = jax.random.PRNGKey(9)
    jo = jm.apply(params, "rank", jnp.asarray(state), jnp.asarray(src), tgt_seq_len=T,
                  greedy=False, rng=key)
    po = pm("rank", torch.tensor(state), torch.tensor(src), tgt_seq_len=T, greedy=False,
            gumbel=jax_draws(key, T, B, S + 2))
    np.testing.assert_array_equal(po.ranked_tgt_out_idx.numpy(), np.asarray(jo.ranked_tgt_out_idx))
    _close(po.ranked_per_symbol_probs, jo.ranked_per_symbol_probs)
    _close(po.ranked_per_seq_probs, jo.ranked_per_seq_probs)
    with pytest.raises(ValueError):
        pm("rank", torch.tensor(state), torch.tensor(src), greedy=False)
    drawn = pm("rank", torch.tensor(state), torch.tensor(src), greedy=False,
               generator=torch.Generator().manual_seed(0)).ranked_tgt_out_idx
    assert all(len(set(row)) == T for row in drawn.tolist())


def test_kv_cached_decode_matches_full_decode_on_each_prefix():
    """The greedy cached decode against ``decode`` re-run on the decoded
    prefix (start symbol, then the picks so far): the same slates and
    per-symbol probabilities within 1e-6."""
    pm = load(port_model(J.Seq2SlateOutputArch.AUTOREGRESSIVE),
              all_params(jax_model(J.Seq2SlateOutputArch.AUTOREGRESSIVE)))
    state, src = (torch.tensor(x) for x in arrays(5, batch=16)[:2])
    out = pm("rank", state, src, tgt_seq_len=S, greedy=True)
    idx = out.ranked_tgt_out_idx
    cand = torch.cat([torch.zeros((16, 2, CD)), src], dim=1)
    tgt_in = torch.cat([torch.ones((16, 1), dtype=torch.int64), idx[:, :-1]], dim=1)
    with torch.no_grad():
        memory = pm.encode(state, src)
        full = pm.decode(memory, state, tgt_in, torch.gather(
            cand, 1, tgt_in[:, :, None].expand(-1, -1, CD)))
    np.testing.assert_allclose(out.ranked_per_symbol_probs.numpy(), full.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(full.argmax(dim=2).numpy(), idx.numpy())
    assert all(sorted(row) == list(range(2, S + 2)) for row in idx.tolist())


@pytest.mark.parametrize("arch", ARCHS, ids=[a.value for a in ARCHS])
def test_bfloat16_matches_jax_bfloat16(arch):
    """``compute_dtype`` bfloat16 on both sides from the same float32
    weights, at the measured tolerances of the module docstring."""
    jm = jax_model(arch, dtype=jnp.bfloat16)
    params = all_params(jax_model(arch))
    pm = load(port_model(arch, dtype=torch.bfloat16), params)
    state, src, tgt_in, tgt_out, tgt_in_seq = arrays(6, batch=32)[:5]
    js, jsrc, ts, tsrc = (jnp.asarray(state), jnp.asarray(src), torch.tensor(state),
                          torch.tensor(src))
    jo = jm.apply(params, "rank", js, jsrc, greedy=True)
    po = pm("rank", ts, tsrc, greedy=True)
    agree = np.mean(po.ranked_tgt_out_idx.numpy() == np.asarray(jo.ranked_tgt_out_idx))
    assert agree >= 0.99, agree
    _close(po.ranked_per_symbol_probs, jo.ranked_per_symbol_probs, dict(rtol=0, atol=5e-3))
    if arch != J.Seq2SlateOutputArch.ENCODER_SCORE:
        kw = dict(tgt_in_idx=tgt_in, tgt_out_idx=tgt_out, tgt_in_seq=tgt_in_seq)
        want = jm.apply(params, "per_sequence_log_prob", js, jsrc,
                        **{k: jnp.asarray(v) for k, v in kw.items()}).per_seq_log_probs
        got = pm("per_sequence_log_prob", ts, tsrc,
                 **{k: torch.tensor(v) for k, v in kw.items()}).per_seq_log_probs
        _close(got, want, dict(rtol=0, atol=5e-3))


def test_transformer_net_wrapper_modes_match_jax():
    jnet = J.Seq2SlateTransformerNet(state_dim=SD, candidate_dim=CD, max_src_seq_len=S,
                                     max_tgt_seq_len=T, **DIMS)
    jb = ranking_batch(jrlt, jnp.asarray, 7)
    params = all_params(jnet.seq2slate)
    net = P.Seq2SlateTransformerNet(state_dim=SD, candidate_dim=CD, max_src_seq_len=S,
                                    max_tgt_seq_len=T, device="cpu", **DIMS)
    sd = seq2slate_state_from_flax(_np_tree(params))
    b = ranking_batch(rlt, torch.tensor, 7)
    jr = jnet(params, jb, J.Seq2SlateMode.RANK_MODE, greedy=True)
    r = net(sd, b, P.Seq2SlateMode.RANK_MODE, greedy=True)
    np.testing.assert_array_equal(r.ranked_tgt_out_idx.numpy(), np.asarray(jr.ranked_tgt_out_idx))
    _close(net(sd, b, P.Seq2SlateMode.PER_SEQ_LOG_PROB_MODE).per_seq_log_probs,
           jnet(params, jb, J.Seq2SlateMode.PER_SEQ_LOG_PROB_MODE).per_seq_log_probs)
    _close(net(sd, b, "encoder_score_mode").encoder_scores,
           jnet(params, jb, "encoder_score_mode").encoder_scores)
    assert set(net.init(torch.Generator().manual_seed(0))) == {
        k for k, _ in net.seq2slate.named_parameters()}


# --------------------------------------------------- reward nets, builders

def reward_nets(kind, seed=2):
    """(JAX net, its params, the port's net holding them)."""
    jb = ranking_batch(jrlt, jnp.asarray, 0)
    if kind == "gru":
        jnet = JaxGRURewardNet(SD, CD, num_hiddens=8, num_layers=2)
        net = Seq2SlateGRURewardNet(SD, CD, num_hiddens=8, num_layers=2)
        carry = slate_reward_state_from_flax
    else:
        jnet = JaxTransformerRewardNet(SD, CD, num_stacked_layers=2, num_heads=2, dim_model=16,
                                       dim_feedforward=8)
        net = Seq2SlateTransformerRewardNet(SD, CD, num_stacked_layers=2, num_heads=2,
                                            dim_model=16, dim_feedforward=8)
        carry = seq2slate_state_from_flax
    params = jnet.init(jax.random.PRNGKey(seed), jb)
    net.load_state_dict(carry(_np_tree(params)))
    return jnet, params, net


@pytest.mark.parametrize("kind", ["gru", "transformer"])
def test_reward_nets_and_ensemble_match_jax(kind):
    jnet, params, net = reward_nets(kind)
    jb, b = ranking_batch(jrlt, jnp.asarray, 8), ranking_batch(rlt, torch.tensor, 8)
    _close(net(b), jnet.apply(params, jb))
    _, params2, net2 = reward_nets(kind, seed=3)
    sd = [dict(net.state_dict()), dict(net2.state_dict())]
    _close(Seq2SlateRewardNetEnsemble(net, sd)(b), JaxEnsemble(jnet, [params, params2])(jb))


def test_net_builders_build_the_port_modules():
    m = SLATE_RANKING_NET_BUILDERS.build({"SlateRankingTransformer": {
        "num_heads": 8, "dim_model": 256, "dim_feedforward": 512,
        "output_arch": "frechet_sort", "compute_dtype": "bfloat16"}}
    ).build_slate_ranking_network(128, 128, 20, 20)
    assert isinstance(m, P.Seq2SlateTransformerModel)
    assert m.compute_dtype == torch.bfloat16 and m.output_arch == P.Seq2SlateOutputArch.FRECHET_SORT
    scorer = SLATE_RANKING_NET_BUILDERS.build({"SlateRankingScorer": {}}
                                              ).build_slate_ranking_network(5, 7, 6, 4)
    assert isinstance(scorer, FullyConnectedCritic)
    gru = SLATE_REWARD_NET_BUILDERS.build({"SlateRewardGRU": {}})
    assert isinstance(gru.build_slate_reward_network(5, 7, 6, 4), Seq2SlateGRURewardNet)
    assert gru.expect_slate_wise_reward
    tr = SLATE_REWARD_NET_BUILDERS.build({"SlateRewardTransformer": {"dim_model": 8}})
    assert isinstance(tr.build_slate_reward_network(5, 7, 6, 4), Seq2SlateTransformerRewardNet)


# ----------------------------------------------------------------- trainers

def test_ips_clamp_matches_jax():
    x = np.asarray([[0.5], [9.9], [10.0], [10.1], [1e3]], np.float32)
    for method in IPSClampMethod:
        got = ips_clamp(torch.tensor(x), IPSClamp(method, 10.0))
        want = jtr.ips_clamp(jnp.asarray(x), JaxIPSClamp(JaxIPSClampMethod(method.value), 10.0))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ips_clamp(torch.tensor(x), None).numpy(), x)


def _opt(jopt):
    return opt_state_from_arrays(**_adam_fields(jopt), device="cpu")


def _flat(jtree):
    """A flax tree (or a moment tree of one) by the port's names."""
    jtree = _np_tree(jtree)
    return (seq2slate_state_from_flax(jtree) if "state_embedder" in jtree["params"]
            else q_network_state_from_flax(jtree))


LR, B1, B2, EPS = 3e-3, 0.9, 0.999, 1e-8  # the trainers' Adam


def assert_step_close(got_params, got_opt, jparams_new, jopt_old, jopt_new, msg):
    """One Adam step, both sides from JAX's state.  Each moment within
    ``MOMENT_SCALE`` of the model's largest: the gradients agree.  Each
    parameter within ``TOL`` plus what Adam's step ``lr m_hat / (sqrt(v_hat)
    + eps)`` makes of a first-moment difference dm, ``lr dm / (1 - b1^t) /
    (sqrt(v_hat) + eps)`` capped at Adam's largest step 2 lr: large only
    where every gradient of an entry so far was rounding-small (a key
    projection's bias, whose gradient the softmax's shift invariance makes 0,
    is one)."""
    new = _adam_fields(jopt_new)
    t = int(new["count"])
    assert int(got_opt.count) == t, msg
    mu1, nu1 = _flat(new["mu"]), _flat(new["nu"])
    want = _flat(jparams_new)
    assert set(got_params) == set(want), msg
    dm = MOMENT_SCALE * max(float(v.abs().max()) for v in mu1.values())
    dv = MOMENT_SCALE * max(float(v.abs().max()) for v in nu1.values())
    for k in want:
        _close(got_opt.mu[k], mu1[k], dict(rtol=0, atol=dm), f"{msg} mu {k}")
        _close(got_opt.nu[k], nu1[k], dict(rtol=0, atol=dv), f"{msg} nu {k}")
        v_hat = nu1[k].double().numpy() / (1 - B2 ** t)
        allow = TOL["atol"] + np.minimum(
            LR * dm / (1 - B1 ** t) / (np.sqrt(v_hat) + EPS), 2 * LR)
        got, w = got_params[k].detach().double().numpy(), want[k].double().numpy()
        bad = np.abs(got - w) > allow + TOL["rtol"] * np.abs(w)
        assert not bad.any(), (f"{msg} {k}: {int(bad.sum())} entries, max excess "
                               f"{(np.abs(got - w) - allow)[bad].max():.3g}")


S2S_CASES = {
    "universal_clamp": dict(clamp=("UNIVERSAL", 10.0)),
    "aggressive_clamp": dict(clamp=("AGGRESSIVE", 5.0)),
    "no_clamp": dict(),
    "baseline_warmup": dict(clamp=("UNIVERSAL", 10.0), baseline=True, warmup=2),
}


def seq2slate_trainers(case):
    spec = S2S_CASES[case]
    clamp = spec.get("clamp")
    jparams = JaxSeq2SlateParameters(on_policy=False, ips_clamp=None if clamp is None else
                                     JaxIPSClamp(JaxIPSClampMethod[clamp[0]], clamp[1]))
    params = Seq2SlateParameters(on_policy=False, ips_clamp=None if clamp is None else
                                 IPSClamp(IPSClampMethod[clamp[0]], clamp[1]))
    kw = dict(baseline_warmup_num_batches=spec.get("warmup", 0),
              policy_optimizer={"Adam": {"lr": LR}}, baseline_optimizer={"Adam": {"lr": 1e-2}})
    jtrainer = jtr.Seq2SlateTrainer(
        jax_model(), params=jparams,
        baseline_net=JaxValueNetwork(SD, [8], ["relu"]) if spec.get("baseline") else None, **kw)
    trainer = Seq2SlateTrainer(
        port_model(J.Seq2SlateOutputArch.AUTOREGRESSIVE), params=params,
        baseline_net=ValueNetwork(SD, [8], ["relu"]) if spec.get("baseline") else None,
        device="cpu", **kw)
    jstate = jtrainer.init(jax.random.PRNGKey(0), ranking_batch(jrlt, jnp.asarray, 0))
    return jtrainer, jstate, trainer


def carry_seq2slate_state(jstate):
    base = jstate.baseline_params is not None
    return seq2slate_trainer_state_from_arrays(
        _np_tree(jstate.policy_params), _opt(jstate.policy_opt_state), np.asarray(jstate.step),
        "cpu", baseline_params=_np_tree(jstate.baseline_params) if base else None,
        baseline_opt_state=_opt(jstate.baseline_opt_state) if base else None)


def check_seq2slate_step(state, jold, jnew, msg):
    assert_step_close(state.policy_params, state.policy_opt_state, jnew.policy_params,
                      jold.policy_opt_state, jnew.policy_opt_state, f"{msg} policy")
    if jnew.baseline_params is not None:
        want = _flat(jnew.baseline_params)
        for k, v in want.items():
            _close(state.baseline_params[k], v, TOL, f"{msg} baseline {k}")
    assert int(state.step) == int(jnew.step)


@pytest.mark.parametrize("case", list(S2S_CASES))
def test_seq2slate_trainer_lockstep_with_jax(case):
    """5 IPS steps, each from JAX's state of that step: the metrics, the
    policy, the baseline and the Adam moments; the warm-up holds the policy
    for 2 steps."""
    jtrainer, jstate, trainer = seq2slate_trainers(case)
    for i in range(5):
        state = carry_seq2slate_state(jstate)
        first = {k: v.clone() for k, v in state.policy_params.items()}
        jstate = _np_tree(jstate)  # JAX's step donates its state
        jnew, jm = jtrainer.train_step(jstate, ranking_batch(jrlt, jnp.asarray, 10 + i))
        state, m = trainer.train_step(state, ranking_batch(rlt, torch.tensor, 10 + i))
        assert m.keys() == jm.keys()
        for k in jm:
            _close(m[k], jm[k], TOL, f"{i} {k}")
        if i < S2S_CASES[case].get("warmup", 0):
            assert all(torch.equal(first[k], v) for k, v in state.policy_params.items())
        else:
            check_seq2slate_step(state, jstate, jnew, f"step {i}")
        jstate = jnew


def test_teacher_forcing_trainer_lockstep_with_jax():
    jtrainer = jtf.Seq2SlateTeacherForcingTrainer(jax_model(), policy_optimizer={"Adam": {"lr": LR}})
    trainer = Seq2SlateTeacherForcingTrainer(port_model(J.Seq2SlateOutputArch.AUTOREGRESSIVE),
                                             policy_optimizer={"Adam": {"lr": LR}}, device="cpu")
    jstate = jtrainer.init(jax.random.PRNGKey(0), ranking_batch(jrlt, jnp.asarray, 0))
    for i in range(5):
        state = trainer.state_from_networks()
        state.policy_params = seq2slate_state_from_flax(_np_tree(jstate.policy_params))
        state.policy_opt_state = _opt(jstate.policy_opt_state)
        state.step = torch.tensor(int(jstate.step), dtype=torch.int32)
        jstate = _np_tree(jstate)  # JAX's step donates its state
        jnew, jm = jtrainer.train_step(jstate, ranking_batch(jrlt, jnp.asarray, 20 + i))
        state, m = trainer.train_step(state, ranking_batch(rlt, torch.tensor, 20 + i))
        _close(m["kl_loss"], jm["kl_loss"], msg=f"step {i}")
        assert_step_close(state.policy_params, state.policy_opt_state, jnew.policy_params,
                          jstate.policy_opt_state, jnew.policy_opt_state, f"step {i}")
        jstate = jnew


def test_pairwise_attention_trainer_lockstep_with_jax():
    """The encoder-only trainer 5 steps, each from JAX's state (its tree has
    no decoder; the slate is every candidate, as the validation metrics
    need), then the validation metrics against JAX's."""
    arch = J.Seq2SlateOutputArch.ENCODER_SCORE
    jtrainer = jattn.Seq2SlatePairwiseAttnTrainer(jax_model(arch), slate_size=S,
                                                  policy_optimizer={"Adam": {"lr": LR}})
    trainer = Seq2SlatePairwiseAttnTrainer(port_model(arch), slate_size=S,
                                           policy_optimizer={"Adam": {"lr": LR}}, device="cpu")
    jstate = jtrainer.init(jax.random.PRNGKey(0), ranking_batch(jrlt, jnp.asarray, 0))
    for i in range(5):
        state = trainer.state_from_networks()
        state.params = seq2slate_state_from_flax(_np_tree(jstate.params))
        state.opt_state = _opt(jstate.opt_state)
        jstate = _np_tree(jstate)  # JAX's step donates its state
        jnew, jm = jtrainer.train_step(jstate, ranking_batch(jrlt, jnp.asarray, 30 + i, tgt_len=S))
        state, m = trainer.train_step(state, ranking_batch(rlt, torch.tensor, 30 + i, tgt_len=S))
        _close(m["train_cross_entropy_loss"], jm["train_cross_entropy_loss"], msg=f"step {i}")
        assert_step_close(state.params, state.opt_state, jnew.params, jstate.opt_state,
                          jnew.opt_state, f"step {i}")
        jstate = jnew
    state.params = seq2slate_state_from_flax(_np_tree(jstate.params))
    want = jtrainer.validation_metrics(jstate, ranking_batch(jrlt, jnp.asarray, 40, batch=16, tgt_len=S),
                                       jax.random.PRNGKey(0))
    got = trainer.validation_metrics(state, ranking_batch(rlt, torch.tensor, 40, batch=16, tgt_len=S))
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], msg=k)


@pytest.mark.parametrize("kind", ["gru", "transformer"])
def test_simulation_trainer_lockstep_on_jax_draws(kind):
    """Rank (sampled, on the draws JAX makes from each step's key), score
    with the reward net, step: 3 steps, each from JAX's state."""
    jreward, rparams, reward = reward_nets(kind)
    jtrainer = jtf.Seq2SlateSimulationTrainer(jax_model(), jreward, rparams,
                                              policy_optimizer={"Adam": {"lr": LR}})
    trainer = Seq2SlateSimulationTrainer(port_model(J.Seq2SlateOutputArch.AUTOREGRESSIVE),
                                         reward, None, policy_optimizer={"Adam": {"lr": LR}},
                                         device="cpu")
    jstate = jtrainer.init(jax.random.PRNGKey(0), ranking_batch(jrlt, jnp.asarray, 0))
    for i in range(3):
        key = jax.random.PRNGKey(50 + i)
        state = carry_seq2slate_state(jstate)
        jstate = _np_tree(jstate)  # JAX's step donates its state
        jnew, jm = jtrainer.train_step(jstate, ranking_batch(jrlt, jnp.asarray, 50 + i), key)
        state, m = trainer.train_step(state, ranking_batch(rlt, torch.tensor, 50 + i),
                                      gumbel=jax_draws(key, T, B, S + 2))
        for k in jm:
            _close(m[k], jm[k], TOL, f"{i} {k}")
        check_seq2slate_step(state, jstate, jnew, f"step {i}")
        jstate = jnew
