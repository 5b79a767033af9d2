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
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 3"):
        make_optimizer({name: {}})


def test_lr_scheduler_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 3"):
        make_optimizer({"Adam": {"lr": 1e-3, "lr_scheduler": {"StepLR": {"step_size": 100}}}})


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
