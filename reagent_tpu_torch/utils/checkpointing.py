"""Checkpoint / resume of trainer state.

Port of ``reagent_tpu/utils/checkpointing.py`` (``CheckpointManager`` :22,
``save_checkpoint`` :49, ``restore_checkpoint`` :56; reference: Lightning's
resume_from_checkpoint + warm-start overwrite, workflow/utils.py:161,173-176).
A trainer state is a tree of dataclasses, dicts, tuples and lists whose
leaves are tensors (``None`` where a field is unset, e.g. a ``DQNTrainerState``
without CPE heads), so a checkpoint is one ``torch.save`` of a flat
``{path: tensor}`` dict.  The JAX package writes an orbax directory; the two
formats are not interchangeable.

Like orbax's, a restore is held to its template: a missing or extra field,
or a tensor of another shape or dtype, raises ``ValueError``.  The tensors
come back on the device of the template's and as the same tree, so a
state restored from a save continues the same trajectory bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
import re
import tempfile
from typing import Any, Dict, List, Optional

import torch

_SEP = "/"


def _flatten(node: Any, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    if node is None:
        return
    if isinstance(node, torch.Tensor):
        out[prefix] = node.detach()
    elif dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            _flatten(getattr(node, f.name), f"{prefix}{_SEP}{f.name}", out)
    elif isinstance(node, dict):
        for k, v in node.items():
            _flatten(v, f"{prefix}{_SEP}{k}", out)
    elif isinstance(node, (tuple, list)):
        for i, v in enumerate(node):
            _flatten(v, f"{prefix}{_SEP}{i}", out)
    else:
        raise TypeError(f"cannot checkpoint a {type(node).__name__} at {prefix or '/'}")


def flatten_state(state: Any) -> Dict[str, torch.Tensor]:
    """``{path: tensor}`` of every tensor in ``state``, keyed by field path."""
    out: Dict[str, torch.Tensor] = {}
    _flatten(state, "", out)
    return out


def _rebuild(like: Any, prefix: str, flat: Dict[str, torch.Tensor]) -> Any:
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        return flat[prefix]
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), f"{prefix}{_SEP}{f.name}", flat)
            for f in dataclasses.fields(like)})
    if isinstance(like, dict):
        return {k: _rebuild(v, f"{prefix}{_SEP}{k}", flat) for k, v in like.items()}
    return type(like)(_rebuild(v, f"{prefix}{_SEP}{i}", flat) for i, v in enumerate(like))


def _device_of(flat: Dict[str, torch.Tensor]) -> torch.device:
    return next(iter(flat.values())).device if flat else torch.device("cpu")


def save_checkpoint(path: str, state: Any) -> None:
    """Write ``state`` to the file ``path``, replacing it if present (as
    orbax's ``force=True``): the bytes go to a temporary file in the same
    directory, which is then renamed into place."""
    path = os.path.abspath(path)
    flat = {k: v.cpu() for k, v in flatten_state(state).items()}
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".ckpt-")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(flat, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def restore_checkpoint(path: str, state_like: Any) -> Any:
    """The state saved at ``path``, as the tree of ``state_like`` on its
    device; raises ``ValueError`` where the two disagree in a key, a shape
    or a dtype."""
    template = flatten_state(state_like)
    saved = torch.load(os.path.abspath(path), map_location=_device_of(template),
                       weights_only=True)
    missing = sorted(set(template) - set(saved))
    extra = sorted(set(saved) - set(template))
    if missing or extra:
        raise ValueError(f"checkpoint {path} does not match its template: missing "
                         f"{missing}, unexpected {extra}")
    for key, like in template.items():
        got = saved[key]
        if got.shape != like.shape or got.dtype != like.dtype:
            raise ValueError(
                f"checkpoint {path}: {key} is {got.dtype}{list(got.shape)}, the template "
                f"{like.dtype}{list(like.shape)}")
        saved[key] = got.to(like.device)
    return _rebuild(state_like, "", saved)


class CheckpointManager:
    """Step-indexed checkpoints in ``directory`` (``<step>.pt``) with
    keep-last-k retention."""

    _NAME = re.compile(r"^(\d+)\.pt$")

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(self._NAME.match, os.listdir(self.directory))
                      if m)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def save(self, step: int, state: Any) -> None:
        save_checkpoint(self._path(step), state)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.unlink(self._path(old))

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return restore_checkpoint(self._path(step), state_like)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def close(self) -> None:
        pass
