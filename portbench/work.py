"""The yardstick: work counted from the shapes, and the card's published peaks.

Every count here comes from a configuration's sizes and the formula it
computes, never from how a kernel of the program computes it, so a redesign
that does the same work in fewer instructions reads a higher share and one
that counts its own work differently cannot read more than 100%.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# Published peaks (NVIDIA data sheets, dense rates, at the card's full power
# limit): float32 outside the tensor cores and the HBM rate.  The first name
# fragment that the card's name contains wins, so "H100 PCIe" precedes "H100".
PEAKS: Dict[str, Dict[str, float]] = {
    "H100 PCIe": {"f32_flops": 51e12, "hbm_bytes": 2.0e12},
    "H100": {"f32_flops": 67e12, "hbm_bytes": 3.35e12},  # SXM
}

F32 = 4  # bytes


def peaks_for(card_name: str) -> Dict[str, float]:
    """The peaks of the card named ``card_name``; an unknown card fails."""
    for fragment, peaks in PEAKS.items():
        if fragment in card_name:
            return peaks
    raise RuntimeError(f"no published peaks recorded for {card_name!r}")


def output_dim(cfg: dict) -> int:
    """The q-network's outputs: one per action, or actions x quantiles."""
    return cfg["num_actions"] * cfg.get("num_atoms", 1)


def layer_dims(cfg: dict) -> List[Tuple[int, int]]:
    """``(in, out)`` of each linear layer of the q-network."""
    sizes = [cfg["state_dim"], *cfg["hidden_sizes"], output_dim(cfg)]
    return list(zip(sizes[:-1], sizes[1:]))


def forward_macs(cfg: dict) -> int:
    """F: multiply-adds of one row through one forward pass."""
    return sum(i * o for i, o in layer_dims(cfg))


def parameter_count(cfg: dict) -> int:
    """Weights and biases of one net."""
    return sum(i * o + o for i, o in layer_dims(cfg))


def matmul_flops_per_step(cfg: dict, batch: int) -> float:
    """Matrix-product FLOPs of one double-Q (or plain max-Q) update of ``batch``
    rows: the online forward of the states, the target forward of the next
    states and, for double Q, the online forward of the next states; then the
    weight gradients (F a row) and the activation gradients, which the first
    layer does not need (F less the first layer's MACs).  That is
    ``2 B (3F + F + F - in_0 out_0)`` with double Q.  Elementwise work, the
    loss and the optimizer are not counted."""
    dims = layer_dims(cfg)
    F = forward_macs(cfg)
    forwards = 3 if cfg.get("double_q_learning", True) else 2
    return 2.0 * batch * (forwards * F + F + (F - dims[0][0] * dims[0][1]))


def fused_update_bytes(cfg: dict, batch: int) -> float:
    """Least bytes of one fused DQN update (K1): the batch's states, next
    states, actions, masks, rewards and not-terminal flags read once, the two
    step scalars, the eight parameter groups (online and target weights and
    biases, both Adam moments) read and written once, and the four metrics
    written, all float32."""
    D, A, B = cfg["state_dim"], output_dim(cfg), batch
    P = parameter_count(cfg)
    return F32 * (2 * B * D + 2 * B * A + 2 * B + 2 + 2 * 8 * P + 4)


def fused_update_bound_s(cfg: dict, batch: int, peaks: Dict[str, float]) -> Tuple[float, str]:
    """The least time of one fused update on the card: the larger of its
    matrix-product FLOPs over the f32 peak and its bytes over the HBM rate,
    and which of the two it is."""
    t_ops = matmul_flops_per_step(cfg, batch) / peaks["f32_flops"]
    t_bytes = fused_update_bytes(cfg, batch) / peaks["hbm_bytes"]
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


# The quantile-Huber loss over one (target i, current j) pair, with the
# gradient with respect to current j, as the formula states it:
#   td = T_i - theta_j                                     1 subtraction
#   rho(td) = 0.5 td^2 where |td| < k, else k (|td| - k/2)   2 operations
#             (a square and a scaling, or a multiply-add)
#   w |tau_j - 1{td < 0}| times rho, summed over i and j   2 (multiply, add)
#   dL/dtheta_j gathers w clip(td, -k, k), summed over i   2 (multiply, add)
# The weight is a choice between tau_j and 1 - tau_j, and abs, min and the
# comparison are not arithmetic, so they count nothing.
QUANTILE_HUBER_FLOPS_PER_PAIR = 7


def quantile_huber_flops(batch: int, atoms: int) -> float:
    """Least FLOPs of the loss and its gradient over ``batch`` rows of
    ``atoms`` target and ``atoms`` current quantiles."""
    return float(QUANTILE_HUBER_FLOPS_PER_PAIR * batch * atoms * atoms)


def quantile_huber_bytes(batch: int, atoms: int) -> float:
    """Least bytes: the targets and the current quantiles read once, the
    per-row losses and the gradient with respect to the current quantiles
    written once, float32."""
    return float(F32 * (2 * batch * atoms + batch + batch * atoms))


def quantile_huber_bound_s(batch: int, atoms: int, peaks: Dict[str, float]) -> Tuple[float, str]:
    """The least time of the loss and its gradient on the card, and which
    bound it is."""
    t_ops = quantile_huber_flops(batch, atoms) / peaks["f32_flops"]
    t_bytes = quantile_huber_bytes(batch, atoms) / peaks["hbm_bytes"]
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
