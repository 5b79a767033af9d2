"""One-time key remaps for checkpoints that predate param-tree renames.

Port of ``reagent_tpu/utils/checkpoint_compat.py``, a copy on plain dicts.
The KV-cache rewrite of the seq2slate decoder (``models/seq2slate.py``, see
the ``DecoderLayer`` docstring there) moved ``DecoderLayer`` /
``PointerLastLayer`` from ``@nn.compact`` auto-naming to ``setup()``
attributes, renaming -- but NOT reshaping -- every param:

    DecoderLayer_i/MultiHeadDotProductAttention_0/query -> .../self_attn/q_proj
    DecoderLayer_i/LayerNorm_0                          -> .../norm1
    PointerLastLayer_0/Dense_0                          -> .../q_ptr
    ...

``remap_pre_kv_cache_seq2slate_params`` converts an old checkpoint's flax
variables (a nested dict, numpy leaves) to the current layout; shapes are
untouched (the old MHA kernels [D, H, dh] / [H, dh, D] are exactly the new
DenseGeneral projections).  Apply it first, then
``utils/interop.py::seq2slate_state_from_flax`` to the result, which turns
the current layout into the port's state dict:

    state_dict = seq2slate_state_from_flax(
        remap_pre_kv_cache_seq2slate_params(old_variables))
"""

from __future__ import annotations

from typing import Any, Dict

# inner renames for a flax MultiHeadDotProductAttention -> CachedSelfAttention
_ATTN_INNER = {
    "query": "q_proj",
    "key": "k_proj",
    "value": "v_proj",
    "out": "out_proj",
}

_DECODER_LAYER = {
    "MultiHeadDotProductAttention_0": ("self_attn", _ATTN_INNER),
    "LayerNorm_0": ("norm1", None),
    "MultiHeadDotProductAttention_1": ("cross_attn", None),
    "LayerNorm_1": ("norm2", None),
    "FeedForward_0": ("ff", None),
    "LayerNorm_2": ("norm3", None),
}

_POINTER_LAYER = {
    "MultiHeadDotProductAttention_0": ("self_attn", _ATTN_INNER),
    "LayerNorm_0": ("norm1", None),
    "Dense_0": ("q_ptr", None),
    "Dense_1": ("k_ptr", None),
}


def _remap_children(node: Dict[str, Any], table) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, child in node.items():
        new_key, inner = table.get(key, (key, None))
        if inner is not None and isinstance(child, dict):
            child = {inner.get(k, k): v for k, v in child.items()}
        out[new_key] = child
    return out


def remap_pre_kv_cache_seq2slate_params(params: Any) -> Any:
    """Old-layout seq2slate params pytree -> current layout (pure rename)."""

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for key, child in node.items():
            if key.startswith("decoder_layers_") and isinstance(child, dict):
                # the pointer layer (last in the stack) has the bare q/k
                # Dense projections; full decoder layers have a second MHA
                table = (
                    _POINTER_LAYER if "Dense_0" in child else _DECODER_LAYER
                )
                child = _remap_children(child, table)
            out[key] = walk(child)
        return out

    return walk(params)
