"""The inputs both sides of an ``offline_q`` cell get: the logged table and the
initial weights, made on the device from ``--seed``.

One general generator reads every traffic file of the kind.  A table row is a logged
transition: a state and a next state of ``state_dim`` standard-normal
features, a one-hot action drawn uniformly, a standard-normal reward, a
``not_terminal`` flag (0 with probability ``terminal_share``) and the masks of
possible actions now and next (each action impossible with probability
``impossible_action_share``; the logged action, and at least one next action,
always possible).  The weights are the q-network's published init: each
weight ``N(0, gain * sqrt(2 / fan_in))`` (gain sqrt(2) for relu, 1 otherwise),
every bias 0.

Each draw is a few large calls on one generator of the device, so the same
seed gives the same table and weights, and set-up stays short.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

from portbench.work import layer_dims

Tensor = torch.Tensor


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose ("table", "weights", "sampler") from any
    whole number ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def make_table(cfg: dict, traffic: dict, seed: int, device) -> Dict[str, Tensor]:
    """The logged table of ``traffic["rows"]`` transitions, float32, on
    ``device``."""
    N, S, A = int(traffic["rows"]), cfg["state_dim"], cfg["num_actions"]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "table"))
    features = torch.randn((2, N, S), generator=g, device=device)
    actions = torch.randint(0, A, (2, N), generator=g, device=device)
    uniform = torch.rand((N, 1 + 2 * A), generator=g, device=device)
    reward = torch.randn((N, 1), generator=g, device=device)
    not_terminal = (uniform[:, :1] >= traffic["terminal_share"]).to(torch.float32)
    masks = (uniform[:, 1:] >= traffic["impossible_action_share"]).to(torch.float32)
    masks = masks.reshape(N, 2, A)
    # the logged action was possible, and so is some next action
    masks.scatter_(2, actions.T.reshape(N, 2, 1), 1.0)
    return {
        "state": features[0],
        "next_state": features[1],
        "action": torch.nn.functional.one_hot(actions[0], A).to(torch.float32),
        "reward": reward,
        "not_terminal": not_terminal,
        "possible_actions_mask": masks[:, 0].contiguous(),
        "possible_next_actions_mask": masks[:, 1].contiguous(),
    }


def make_weights(cfg: dict, seed: int, device) -> List[Tuple[Tensor, Tensor]]:
    """``[(W [out, in], b [out])]`` of the q-network, float32, on ``device``:
    one draw for every weight, then each layer scaled by its own std."""
    dims = layer_dims(cfg)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    draw = torch.randn((sum(i * o for i, o in dims),), generator=g, device=device)
    gain = math.sqrt(2.0) if cfg["activation"] == "relu" else 1.0
    layers, at = [], 0
    for fan_in, fan_out in dims:
        w = draw[at:at + fan_in * fan_out].reshape(fan_out, fan_in)
        w = w * (gain * math.sqrt(2.0 / fan_in))
        layers.append((w, torch.zeros((fan_out,), device=device)))
        at += fan_in * fan_out
    return layers
