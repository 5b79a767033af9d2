"""Double-Q DQN with the mean-squared TD error (Mnih et al. 2015; van Hasselt
et al. 2016), as ReAgent's offline trainer states it:

    a* = argmax over possible a of Q_online(s', a)   (first index on ties)
    y  = r + gamma * not_terminal * Q_target(s', a*)  (no gradient)
    L  = mean over the batch of (Q_online(s, a) - y)^2

then Adam on the online weights and ``target <- tau online + (1 - tau)
target``.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference.common import first_possible_argmax, follow_steps, layers_of, mlp

Tensor = torch.Tensor


def loss_and_grads(cfg: dict, online: Dict[str, Tensor], target: Dict[str, Tensor],
                   rows: Dict[str, Tensor]):
    with torch.no_grad():
        next_online = mlp(layers_of(online), rows["next_state"], cfg)
        if cfg.get("double_q_learning", True):
            chooser = next_online
        else:
            chooser = mlp(layers_of(target), rows["next_state"], cfg)
        best = first_possible_argmax(chooser, rows["possible_next_actions_mask"])
        next_target = mlp(layers_of(target), rows["next_state"], cfg)
        chosen = next_target.gather(1, best[:, None])
        y = rows["reward"] + cfg["gamma"] * rows["not_terminal"] * chosen
    params = {k: v.detach().requires_grad_(True) for k, v in online.items()}
    q = mlp(layers_of(params), rows["state"], cfg)
    q_taken = (q * rows["action"]).sum(dim=1, keepdim=True)
    loss = torch.mean((q_taken - y) ** 2)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def follow(cfg: dict, table, weights, sampler_seed: int, minibatch: int, steps: int, device):
    return follow_steps(cfg, table, weights, sampler_seed, minibatch, steps, device,
                        lambda o, t, rows: loss_and_grads(cfg, o, t, rows))
