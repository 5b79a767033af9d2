"""What the references share: the MLP, the sampler, Adam and the polyak step."""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Iterator, List, Tuple

import torch

Tensor = torch.Tensor
Layers = List[Tuple[Tensor, Tensor]]


@contextmanager
def full_float32() -> Iterator[None]:
    """Products in full float32 (TF32 off) inside the block."""
    before = torch.get_float32_matmul_precision()
    cudnn = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)
        torch.backends.cudnn.allow_tf32 = cudnn


def activate(name: str, z: Tensor) -> Tensor:
    if name == "leaky_relu":
        return torch.where(z > 0, z, 0.01 * z)  # negative slope 0.01
    if name == "relu":
        return torch.clamp(z, min=0.0)
    if name == "linear":
        return z
    raise ValueError(f"unknown activation {name!r}")


def mlp(layers: Layers, x: Tensor, cfg: dict) -> Tensor:
    """The q-network: ``x W^T + b`` a layer, the hidden activation after every
    layer but the last, which is linear."""
    for i, (w, b) in enumerate(layers):
        x = x @ w.T + b
        if i < len(layers) - 1:
            x = activate(cfg["activation"], x)
    return x


def sample_indices(generator: torch.Generator, rows: int, minibatch: int) -> Tensor:
    """One minibatch of row indices, uniform with replacement: the sampler's
    draw, ``torch.randint`` on the sampler's generator."""
    return torch.randint(0, rows, (minibatch,), generator=generator, device=generator.device)


def first_possible_argmax(values: Tensor, possible: Tensor) -> Tensor:
    """The first index of the largest value among the possible actions."""
    masked = torch.where(possible > 0, values, torch.full_like(values, -torch.inf))
    return torch.argmax(masked, dim=1)


class Adam:
    """Adam with bias correction; ``amsgrad`` takes the running maximum of the
    bias-corrected second moment (optax's ``scale_by_amsgrad``, the
    formulation the configurations state)."""

    def __init__(self, spec: dict, like: Dict[str, Tensor]) -> None:
        self.lr = float(spec.get("lr", 1e-3))
        self.b1, self.b2 = (float(b) for b in spec.get("betas", (0.9, 0.999)))
        self.eps = float(spec.get("eps", 1e-8))
        self.amsgrad = bool(spec.get("amsgrad", False))
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in like.items()}
        self.v = {k: torch.zeros_like(v) for k, v in like.items()}
        self.v_max = {k: torch.zeros_like(v) for k, v in like.items()}

    def step(self, params: Dict[str, Tensor], grads: Dict[str, Tensor]) -> Dict[str, Tensor]:
        self.t += 1
        out = {}
        for k, g in grads.items():
            self.m[k] = self.b1 * self.m[k] + (1.0 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1.0 - self.b2) * g * g
            m_hat = self.m[k] / (1.0 - self.b1 ** self.t)
            v_hat = self.v[k] / (1.0 - self.b2 ** self.t)
            if self.amsgrad:
                v_hat = self.v_max[k] = torch.maximum(self.v_max[k], v_hat)
            out[k] = params[k] - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)
        return out


def polyak(online: Dict[str, Tensor], target: Dict[str, Tensor], tau: float) -> Dict[str, Tensor]:
    return {k: tau * online[k] + (1.0 - tau) * target[k] for k in target}


def leaves(layers: Layers) -> Dict[str, Tensor]:
    """The layers as named leaves, ``layer<i>.weight`` and ``layer<i>.bias``."""
    out = {}
    for i, (w, b) in enumerate(layers):
        out[f"layer{i}.weight"] = w
        out[f"layer{i}.bias"] = b
    return out


def layers_of(named: Dict[str, Tensor]) -> Layers:
    n = len(named) // 2
    return [(named[f"layer{i}.weight"], named[f"layer{i}.bias"]) for i in range(n)]


def gather(table: Dict[str, Tensor], idx: Tensor) -> Dict[str, Tensor]:
    return {k: v[idx] for k, v in table.items()}


def follow_steps(cfg: dict, table: Dict[str, Tensor], weights: Layers, sampler_seed: int,
                 minibatch: int, steps: int, device, step_fn) -> dict:
    """``steps`` updates from ``weights``, each on a minibatch drawn as the
    sampler draws it; ``step_fn(online, target, rows) -> (loss, grads)``.
    Returns the loss of each step, the gradient of the first step, and the
    online and target leaves and Adam's first moment after the last."""
    generator = torch.Generator(device=device).manual_seed(sampler_seed)
    rows_in_table = next(iter(table.values())).shape[0]
    online = {k: v.clone() for k, v in leaves(weights).items()}
    target = {k: v.clone() for k, v in online.items()}
    adam = Adam(cfg["optimizer"]["Adam"], online)
    losses, first_grads = [], None
    with full_float32():
        for _ in range(steps):
            rows = gather(table, sample_indices(generator, rows_in_table, minibatch))
            loss, grads = step_fn(online, target, rows)
            if first_grads is None:
                first_grads = grads
            online = adam.step(online, grads)
            target = polyak(online, target, cfg["target_update_rate"])
            losses.append(loss)
    return {"losses": [float(x) for x in torch.stack(losses).cpu()], "grads1": first_grads,
            "online": online, "target": target, "moment": adam.m}
