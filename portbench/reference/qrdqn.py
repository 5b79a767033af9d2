"""Double-Q QR-DQN (Dabney et al. 2018, arXiv:1710.10044, eq. 10 and alg. 1):

    Z(s, a) = the net's N quantiles of action a   (output a * N + j)
    a*      = argmax over possible a of mean_j Z_online(s', a)_j
    T_i     = r + gamma * not_terminal * Z_target(s', a*)_i   (no gradient)
    td_ij   = T_i - Z_online(s, a)_j,   tau_j = (j + 0.5) / N
    rho_k(u) = 0.5 u^2 where |u| <= k, else k (|u| - k / 2)
    L       = mean over the batch of (1/N^2) sum_ij |tau_j - 1{td_ij < 0}| rho_k(td_ij)

then Adam on the online weights and the polyak step.  The pairwise terms
are formed a block of rows at a time, so the ``[B, N, N]`` tensor never
exists whole.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference.common import first_possible_argmax, follow_steps, layers_of, mlp

Tensor = torch.Tensor
ROWS_PER_BLOCK = 1024


def quantiles(cfg: dict, layers, x: Tensor) -> Tensor:
    """``[B, A, N]``."""
    return mlp(layers, x, cfg).reshape(x.shape[0], cfg["num_actions"], cfg["num_atoms"])


def pairwise_loss(target: Tensor, current: Tensor, kappa: float) -> Tensor:
    """Per-row loss ``[b]`` of ``target [b, N]`` against ``current [b, N]``."""
    N = target.shape[1]
    tau = (torch.arange(N, dtype=torch.float32, device=target.device) + 0.5) / N
    td = target[:, :, None] - current[:, None, :]
    weight = torch.abs(tau[None, None, :] - (td < 0).to(torch.float32))
    a = td.abs()
    rho = torch.where(a <= kappa, 0.5 * td * td, kappa * (a - 0.5 * kappa))
    return (weight * rho).sum(dim=(1, 2)) / (N * N)


def loss_and_grads(cfg: dict, online: Dict[str, Tensor], target: Dict[str, Tensor],
                   rows: Dict[str, Tensor]):
    B = rows["state"].shape[0]
    with torch.no_grad():
        next_target = quantiles(cfg, layers_of(target), rows["next_state"])
        chooser = (quantiles(cfg, layers_of(online), rows["next_state"])
                   if cfg.get("double_q_learning", True) else next_target)
        best = first_possible_argmax(chooser.mean(dim=2), rows["possible_next_actions_mask"])
        chosen = next_target[torch.arange(B, device=best.device), best]
        T = rows["reward"] + cfg["gamma"] * rows["not_terminal"] * chosen
    params = {k: v.detach().requires_grad_(True) for k, v in online.items()}
    z = quantiles(cfg, layers_of(params), rows["state"])
    z_taken = (z * rows["action"][:, :, None]).sum(dim=1)
    # the loss and its gradient with respect to z_taken, a block of rows at a time
    current = z_taken.detach().requires_grad_(True)
    loss = torch.zeros((), device=current.device)
    for start in range(0, B, ROWS_PER_BLOCK):
        block = slice(start, start + ROWS_PER_BLOCK)
        part = pairwise_loss(T[block], current[block], cfg["kappa"]).sum() / B
        part.backward()
        loss = loss + part.detach()
    grads = torch.autograd.grad(z_taken, list(params.values()), grad_outputs=current.grad)
    return loss, dict(zip(params, grads))


def follow(cfg: dict, table, weights, sampler_seed: int, minibatch: int, steps: int, device):
    return follow_steps(cfg, table, weights, sampler_seed, minibatch, steps, device,
                        lambda o, t, rows: loss_and_grads(cfg, o, t, rows))
