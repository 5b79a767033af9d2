"""Convolutional backbone for image observations.

Port of ``reagent_tpu/models/convolutional_network.py:21`` (reference
reagent/models/convolutional_network.py): the conv stack of
``ConvNetParameters`` (each conv with flax's ``'SAME'`` padding, a relu,
then a ``'VALID'`` max or average pool with stride = window), then a
``FullyConnectedNetwork`` head.  Images are NHWC as flax's ``nn.Conv``
takes them; the features are flattened in (H, W, C) order, so the head's
weights map one to one from JAX's.  The convolutions and pools are plain
torch operations, as JAX computes them outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from reagent_tpu_torch.core.parameters import ConvNetParameters
from reagent_tpu_torch.models.fully_connected_network import FullyConnectedNetwork
from reagent_tpu_torch.models.mdn_rnn import _lecun_normal_fill

Tensor = torch.Tensor


def _same_pads(k: int):
    """flax's 'SAME' padding at stride 1: (k - 1) // 2 before, the rest after."""
    lo = (k - 1) // 2
    return lo, k - 1 - lo


class ConvolutionalNetwork(nn.Module):
    """[B, H, W, C] (or [B, H, W]) image -> [B, output_dim]."""

    def __init__(self, conv_params: ConvNetParameters, input_height: int, input_width: int,
                 input_channels: int, sizes: Sequence[int], activations: Sequence[str],
                 output_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        p = conv_params
        self.conv_params = p
        widths = p.conv_width_kernels or p.conv_height_kernels
        self.kernels = [(p.conv_height_kernels[i], widths[i]) for i in range(len(p.conv_dims))]
        self.convs = nn.ModuleList()
        h, w, c = input_height, input_width, input_channels
        for i, dim in enumerate(p.conv_dims):
            self.convs.append(nn.Conv2d(c, dim, self.kernels[i]))
            pool = p.pool_kernel_sizes[i]
            h, w, c = h // pool, w // pool, dim
        self.net = FullyConnectedNetwork([h * w * c, *sizes, output_dim],
                                         [*activations, "linear"], generator=generator)
        self.reset_parameters(generator if generator is not None
                              else torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's ``nn.Conv`` init (lecun-normal over kh * kw * in, zero
        bias), then the head's."""
        for conv in self.convs:
            out_c, in_c, kh, kw = conv.weight.shape
            kernel = torch.empty((kh * kw * in_c, out_c))
            _lecun_normal_fill(kernel, generator)
            with torch.no_grad():
                conv.weight.copy_(kernel.reshape(kh, kw, in_c, out_c).permute(3, 2, 0, 1))
                conv.bias.zero_()
        self.net.reset_parameters(generator)

    def forward(self, x: Tensor, training: bool = False) -> Tensor:
        if x.ndim == 3:
            x = x[..., None]
        x = x.permute(0, 3, 1, 2)  # NCHW
        p = self.conv_params
        for i, conv in enumerate(self.convs):
            (h_lo, h_hi), (w_lo, w_hi) = (_same_pads(k) for k in self.kernels[i])
            x = F.relu(conv(F.pad(x, (w_lo, w_hi, h_lo, h_hi))))
            k = p.pool_kernel_sizes[i]
            x = F.max_pool2d(x, k, k) if p.pool_types[i] == "max" else F.avg_pool2d(x, k, k)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flattened as (H, W, C)
        return self.net(x, training=training)
