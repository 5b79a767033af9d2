"""The port's optimizer union in lockstep with the JAX package's (optax).

Both take the same numpy gradients for 5 steps from the same parameters;
parameters must agree to rtol 1e-5, atol 1e-6 (float32 elementwise
arithmetic, the two libraries' ``pow`` and ``sqrt``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from reagent_tpu.optim import make_optimizer as jax_make_optimizer
from reagent_tpu.optim import soft_update as jax_soft_update
from reagent_tpu_torch.optim import Adam, OptState, make_optimizer, soft_update

SHAPES = {"w": (4, 3), "b": (3,)}
CONFIGS = {
    "adam": {"Adam": {"lr": 0.01}},
    "adam_betas_eps": {"Adam": {"lr": 0.003, "betas": [0.8, 0.95], "eps": 1e-6}},
    "adam_weight_decay": {"Adam": {"lr": 0.01, "weight_decay": 0.1}},
    "adam_amsgrad": {"Adam": {"lr": 0.01, "amsgrad": True}},
    "adam_weight_decay_amsgrad": {"Adam": {"lr": 0.01, "weight_decay": 0.1, "amsgrad": True}},
    "adamw": {"AdamW": {"lr": 0.01}},
    "adamw_amsgrad": {"AdamW": {"lr": 0.001, "amsgrad": True}},
    "sgd": {"SGD": {"lr": 0.05}},
    "sgd_momentum": {"SGD": {"lr": 0.05, "momentum": 0.9}},
    "sgd_nesterov_decay": {
        "SGD": {"lr": 0.05, "momentum": 0.9, "nesterov": True, "weight_decay": 0.01}},
    "none": None,
}


def _data(seed=0, steps=5):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    # gradients that shrink, so amsgrad's running max binds from step 2 on
    grads = [{k: (rng.normal(size=s) * 0.5 ** i).astype(np.float32)
              for k, s in SHAPES.items()} for i in range(steps)]
    return params, grads


def _run_port(config, params, grads):
    opt = make_optimizer(config)
    p = {k: torch.tensor(v) for k, v in params.items()}
    state = opt.init(p)
    for g in grads:
        p, state = opt.update({k: torch.tensor(v) for k, v in g.items()}, state, p)
    return p, state


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_five_steps_in_lockstep_with_optax(name):
    params, grads = _data()
    opt = jax_make_optimizer(CONFIGS[name])
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, p)
        p = optax.apply_updates(p, updates)
    ours, our_state = _run_port(CONFIGS[name], params, grads)
    for k in params:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(p[k]), rtol=1e-5, atol=1e-6)
    assert int(our_state.count) == 5
    # the moments are optax's: find its Adam/amsgrad/trace state in the chain
    for leaf in jax.tree_util.tree_leaves(state, is_leaf=lambda x: hasattr(x, "_fields")):
        for field in ("mu", "nu", "nu_max", "trace"):
            if hasattr(leaf, field):
                for k in params:
                    np.testing.assert_allclose(
                        getattr(our_state, field)[k].numpy(), np.asarray(getattr(leaf, field)[k]),
                        rtol=1e-5, atol=1e-7)


def test_amsgrad_is_optax_not_torch_optim():
    """optax keeps the max of the bias-corrected second moment;
    ``torch.optim.Adam(amsgrad=True)`` keeps the max of the raw one and
    corrects afterwards.  They part at the second step; the port follows
    optax, so it must differ from ``torch.optim`` by far more than rounding."""
    params, grads = _data()
    ours, _ = _run_port(CONFIGS["adam_amsgrad"], params, grads)
    p = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    opt = torch.optim.Adam(p.values(), lr=0.01, amsgrad=True)
    for g in grads:
        for k in p:
            p[k].grad = torch.tensor(g[k])
        opt.step()
    diff = max((ours[k] - p[k].detach()).abs().max().item() for k in params)
    assert diff > 1e-4, diff


def test_update_returns_new_tensors():
    params, grads = _data()
    opt = make_optimizer({"Adam": {"amsgrad": True}})
    p = {k: torch.tensor(v) for k, v in params.items()}
    state = opt.init(p)
    before = {k: v.clone() for k, v in p.items()}
    new_p, new_state = opt.update({k: torch.tensor(v) for k, v in grads[0].items()}, state, p)
    for k in p:
        assert torch.equal(p[k], before[k]) and not torch.equal(new_p[k], before[k])
        assert not state.mu[k].any() and new_state.mu[k].any()
    assert int(state.count) == 0 and int(new_state.count) == 1
    assert isinstance(new_state, OptState) and new_state.trace is None


def test_config_forms():
    assert make_optimizer(Adam(lr=0.5)).lr == 0.5
    assert make_optimizer(None).lr == 1e-3
    assert make_optimizer({"AdamW": {}}).weight_decay == 0.01
    assert make_optimizer("SGD").momentum is None


@pytest.mark.parametrize("name", [
    "RMSprop", "Adagrad", "Lion", "Adadelta", "Adamax", "NAdam", "RAdam", "Rprop", "LBFGS",
    "ASGD", "SparseAdam", "Lamb", "Adafactor"])
def test_unported_members_raise(name):
    """The members the port once refused now build at their defaults and
    step, except LBFGS, whose update raises ``TypeError`` as optax's does
    in the JAX package (it needs the loss's value, gradient and
    ``value_fn``, which no trainer passes)."""
    params, grads = _data()
    opt = make_optimizer({name: {}})
    p = {k: torch.tensor(v) for k, v in params.items()}
    state = opt.init(p)
    g = {k: torch.tensor(v) for k, v in grads[0].items()}
    if name == "LBFGS":
        jopt = jax_make_optimizer({name: {}})
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        with pytest.raises(TypeError):
            jopt.update({k: jnp.asarray(v) for k, v in grads[0].items()}, jopt.init(jp), jp)
        with pytest.raises(TypeError, match="value_fn"):
            opt.update(g, state, p)
        return
    new_p, new_state = opt.update(g, state, p)
    if name == "Rprop":  # optax's rprop returns the previous step: none yet
        new_p, new_state = opt.update(g, new_state, new_p)
    assert int(new_state.count) == (2 if name == "Rprop" else 1)
    assert all(torch.isfinite(new_p[k]).all() and not torch.equal(new_p[k], p[k]) for k in p)


def test_lr_scheduler_raises():
    """The ``lr_scheduler`` key no longer raises: it composes the schedule
    after the optimizer, as the JAX package's ``with_scheduler``."""
    config = {"Adam": {"lr": 1e-3, "lr_scheduler": {"StepLR": {"step_size": 2, "gamma": 0.5}}}}
    params, grads = _data()
    ours, state = _run_port(config, params, grads)
    want, _ = _run_optax(config, params, grads)
    for k in params:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6)
    assert int(state.schedule_count) == 5 and int(state.count) == 5


# every member added since, and every scheduler, at a width where Adafactor
# factors its second moment ("big": the two largest dims >= 128)
WIDE_SHAPES = {"w": (4, 3), "b": (3,), "big": (160, 128)}
NEW_CONFIGS = {
    "rmsprop": {"RMSprop": {"lr": 0.01}},
    "rmsprop_momentum_centered": {"RMSprop": {"lr": 0.01, "momentum": 0.9, "centered": True}},
    "adagrad": {"Adagrad": {"lr": 0.05}},
    "lion": {"Lion": {"lr": 0.001, "weight_decay": 0.1}},
    "adadelta": {"Adadelta": {"lr": 1.0}},
    "adadelta_decay": {"Adadelta": {"lr": 0.5, "weight_decay": 0.01}},
    "adamax": {"Adamax": {"lr": 0.01}},
    "adamaxw": {"Adamax": {"lr": 0.01, "weight_decay": 0.05}},
    "nadam": {"NAdam": {"lr": 0.01}},
    "nadamw": {"NAdam": {"lr": 0.01, "weight_decay": 0.05}},
    # b2 0.9: optax's rectification starts at the 6th step; run 8
    "radam": {"RAdam": {"lr": 0.01, "betas": [0.9, 0.9]}},
    "radam_decay": {"RAdam": {"lr": 0.01, "betas": [0.9, 0.9], "weight_decay": 0.01}},
    "rprop": {"Rprop": {"lr": 0.01}},
    "asgd": {"ASGD": {"lr": 0.05, "weight_decay": 0.01}},
    "sparse_adam": {"SparseAdam": {"lr": 0.01}},
    "lamb": {"Lamb": {"lr": 0.01, "weight_decay": 0.01}},
    "adafactor": {"Adafactor": {}},
    "adafactor_lr": {"Adafactor": {"lr": 0.05}},
    "step_lr": {"Adam": {"lr": 0.01, "lr_scheduler": {"StepLR": {"step_size": 2, "gamma": 0.5}}}},
    "multi_step_lr": {"SGD": {"lr": 0.05, "momentum": 0.9, "lr_scheduler": {
        "MultiStepLR": {"milestones": [1, 3], "gamma": 0.3}}}},
    "exponential_lr": {"AdamW": {"lr": 0.01, "lr_scheduler": {"ExponentialLR": {"gamma": 0.8}}}},
    "linear_lr": {"RMSprop": {"lr": 0.01, "lr_scheduler": {"LinearLR": {"total_iters": 3}}}},
    "cosine_lr": {"RAdam": {"lr": 0.01, "lr_scheduler": {"CosineAnnealingLR": {"T_max": 4}}}},
    "one_cycle_lr": {"Lamb": {"lr": 0.01, "lr_scheduler": {
        "OneCycleLR": {"max_lr_factor": 5.0, "total_steps": 6, "pct_start": 0.5}}}},
    "adafactor_cosine": {"Adafactor": {"lr_scheduler": {"CosineAnnealingLR": {"T_max": 3}}}},
}
# optax state fields -> the port's, and the chain's count
_FIELDS = ("mu", "nu", "nu_max", "trace", "sum_of_squares", "e_g", "e_x", "step_sizes",
           "prev_updates", "v_row", "v_col", "v")


def _run_optax(config, params, grads):
    opt = jax_make_optimizer(config)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, p)
        p = optax.apply_updates(p, updates)
    return p, state


@pytest.mark.parametrize("name", sorted(NEW_CONFIGS))
def test_new_members_and_schedulers_in_lockstep_with_optax(name):
    config = NEW_CONFIGS[name]
    steps = 8 if "radam" in name else 5
    rng = np.random.default_rng(3)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in WIDE_SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * 0.7 ** i).astype(np.float32)
              for k, s in WIDE_SHAPES.items()} for i in range(steps)]
    # a sign flip and a zero, so Rprop takes every branch
    grads[2]["w"] = -grads[1]["w"]
    grads[3]["b"][0] = 0.0
    want, jstate = _run_optax(config, params, grads)
    ours, state = _run_port(config, params, grads)
    for k in params:
        atol = 1e-6
        if name.startswith("adafactor"):
            # Adafactor's factored means and block RMS are float32 means over 128 to
            # 20,480 elements; XLA's CPU reduce sums in another order than torch
            # (which order depends on the host's vector width) and the two part
            # by an ulp in most rows. An update of a few units then lands a
            # parameter near 0 with an absolute error of an ulp of its operands,
            # so the bound here is in those ulps: 4 * eps32 * the largest |param|
            # of the run (measured: at most 2 of them over the three configs)
            eps32 = float(np.finfo(np.float32).eps)
            atol = 4 * eps32 * max(np.abs(params[k]).max(), np.abs(np.asarray(want[k])).max())
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=atol,
                                   err_msg=k)
    assert int(state.count) == steps
    if "lr_scheduler" in next(iter(config.values())):
        assert int(state.schedule_count) == steps
    seen = set()
    for leaf in jax.tree_util.tree_leaves(jstate, is_leaf=lambda x: hasattr(x, "_fields")):
        for field in _FIELDS:
            if hasattr(leaf, field) and getattr(leaf, field) is not None:
                seen.add(field)
                for k in params:
                    np.testing.assert_allclose(
                        getattr(state, field)[k].numpy(), np.asarray(getattr(leaf, field)[k]),
                        rtol=1e-5, atol=1e-7, err_msg=f"{field}/{k}")
    assert seen or name == "asgd", jstate  # plain SGD keeps no state
    if name.startswith("adafactor"):
        # the wide tensor's second moment is factored: a row and a column
        assert state.v_row["big"].shape == (128,) and state.v_col["big"].shape == (160,)


@pytest.mark.parametrize("tau", [0.05, 1.0])
def test_soft_update(tau):
    rng = np.random.default_rng(1)
    src = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    tgt = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    want = jax_soft_update(
        {k: jnp.asarray(v) for k, v in src.items()}, {k: jnp.asarray(v) for k, v in tgt.items()}, tau)
    t_tgt = {k: torch.tensor(v) for k, v in tgt.items()}
    got = soft_update({k: torch.tensor(v) for k, v in src.items()}, t_tgt, tau)
    for k in SHAPES:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(t_tgt[k].numpy(), tgt[k])  # not written
