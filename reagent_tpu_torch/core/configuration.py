"""Config-from-function-signature machinery.

Port of ``reagent_tpu/core/configuration.py``, line for line (reference:
reagent/core/configuration.py:41 ``make_config_class`` — a dataclass
synthesized from a function's signature so YAML keys map 1:1 onto call kwargs,
and the CLI can drive any entry point (``reagent run module.func config.yaml``)).
"""

from __future__ import annotations

import dataclasses
import inspect
import typing
from typing import Any, Callable, Dict, Optional, Set, Type


def make_config_class(
    func: Callable,
    allowlist: Optional[Set[str]] = None,
    blocklist: Optional[Set[str]] = None,
) -> Callable[[type], type]:
    """Class decorator: fill the decorated class with fields from ``func``'s signature.

    Parameters without defaults become required fields; ``self`` and var-args
    are skipped.  Mirrors reagent/core/configuration.py:41-110 behavior.
    """
    blocklist = blocklist or set()

    def deco(cls: type) -> type:
        sig = inspect.signature(func)
        anns: Dict[str, Any] = {}
        for name, p in sig.parameters.items():
            if name in ("self", "cls") or name in blocklist:
                continue
            if allowlist is not None and name not in allowlist:
                continue
            if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
                continue
            ann = p.annotation if p.annotation is not inspect.Parameter.empty else Any
            anns[name] = (ann, p.default)
        # Required fields first (dataclass ordering constraint).
        required = {k: v for k, v in anns.items() if v[1] is inspect.Parameter.empty}
        optional = {k: v for k, v in anns.items() if v[1] is not inspect.Parameter.empty}
        cls.__annotations__ = {}
        for k, (ann, _) in {**required, **optional}.items():
            cls.__annotations__[k] = ann
        for k, (_, default) in optional.items():
            if isinstance(default, (list, dict, set)):
                setattr(cls, k, dataclasses.field(default_factory=lambda d=default: type(d)(d)))
            else:
                setattr(cls, k, default)
        return dataclasses.dataclass(cls)

    return deco


def config_class_for(func: Callable) -> type:
    """Synthesize ``@make_config_class(func) class ConfigClass: pass`` directly."""

    class ConfigClass:
        pass

    ConfigClass.__name__ = f"{getattr(func, '__name__', 'fn')}Config"
    return make_config_class(func)(ConfigClass)


def _coerce(value, annotation):
    """Coerce YAML values to annotated dataclass types (shallow)."""
    if annotation is None or annotation is typing.Any:
        return value
    origin = typing.get_origin(annotation)
    if origin is typing.Union:
        args = [a for a in typing.get_args(annotation) if a is not type(None)]
        if len(args) == 1:
            return _coerce(value, args[0])
        return value
    if dataclasses.is_dataclass(annotation) and isinstance(value, dict):
        return annotation(**value)
    return value


def kwargs_from_config(func: Callable, config: Dict[str, Any]) -> Dict[str, Any]:
    """The keyword arguments ``reagent run`` calls ``func`` with: each key of
    ``config`` that names a parameter, a dict coerced to the parameter's
    dataclass where it is annotated with one (reference cli.py:63-82)."""
    try:
        hints = typing.get_type_hints(func)  # resolves PEP-563 string annotations
    except (NameError, TypeError):
        hints = {}
    return {name: _coerce(config[name], hints.get(name))
            for name in inspect.signature(func).parameters if name in config}


def asdict_shallow(obj: Any) -> Dict[str, Any]:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def param_hash(self) -> int:
    """Hash helper for frozen config dataclasses containing lists/dicts."""

    def _freeze(x):
        if isinstance(x, list):
            return tuple(_freeze(v) for v in x)
        if isinstance(x, dict):
            return tuple(sorted((k, _freeze(v)) for k, v in x.items()))
        if isinstance(x, set):
            return frozenset(x)
        return x

    return hash(tuple(_freeze(getattr(self, f.name)) for f in dataclasses.fields(self)))
