"""Plugin registry + tagged-union config selection.

Port of ``reagent_tpu/core/registry.py``: classes register under a role and
YAML configs select one member by name with the ``{MemberName: {kwargs}}``
single-key-dict shape, so the JAX package's configs load unchanged:

    DiscreteDQN:
      net_builder:
        FullyConnected:
          sizes: [128, 128]
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Callable, Dict, Generic, Optional, Type, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    """A named registry of config-constructible classes for one plugin role."""

    def __init__(self, role: str):
        self.role = role
        self._members: Dict[str, Type[T]] = {}

    def register(self, name: Optional[str] = None) -> Callable[[Type[T]], Type[T]]:
        def deco(cls: Type[T]) -> Type[T]:
            key = name or cls.__name__
            if key in self._members and self._members[key] is not cls:
                raise ValueError(f"{self.role}: duplicate registration {key!r}")
            self._members[key] = cls
            return cls

        return deco

    def get(self, name: str) -> Type[T]:
        if name not in self._members:
            raise KeyError(
                f"{self.role}: unknown member {name!r}; known: {sorted(self._members)}"
            )
        return self._members[name]

    def members(self) -> Dict[str, Type[T]]:
        return dict(self._members)

    def build(self, config: Any, **extra_kwargs: Any) -> T:
        """Build an instance from a tagged-union config.

        Accepts ``{"MemberName": {...kwargs}}``, ``"MemberName"``, or an
        already-constructed instance (passed through).
        """
        if isinstance(config, str):
            return self.get(config)(**extra_kwargs)
        if isinstance(config, dict):
            if len(config) != 1:
                raise ValueError(
                    f"{self.role}: tagged-union config must have exactly one key, "
                    f"got {sorted(config)}"
                )
            (name, kwargs), = config.items()
            kwargs = dict(kwargs or {})
            kwargs.update(extra_kwargs)
            return construct_from_config(self.get(name), kwargs)
        for cls in self._members.values():
            if isinstance(config, cls):
                return config
        raise TypeError(f"{self.role}: cannot build from {type(config)}")


def construct_from_config(cls: Type[T], kwargs: Dict[str, Any]) -> T:
    """Instantiate ``cls``, recursively constructing nested dataclass fields."""
    if not dataclasses.is_dataclass(cls):
        return cls(**kwargs)
    field_types = {f.name: f.type for f in dataclasses.fields(cls)}
    coerced: Dict[str, Any] = {}
    for k, v in kwargs.items():
        target = _resolve_dataclass_type(field_types.get(k))
        if target is not None and isinstance(v, dict):
            coerced[k] = construct_from_config(target, v)
        else:
            coerced[k] = v
    return cls(**coerced)


def _resolve_dataclass_type(tp: Any) -> Optional[type]:
    """If ``tp`` is (or optionally wraps) a dataclass type, return it."""
    if tp is None or isinstance(tp, str):
        return None  # str: unresolved forward ref under postponed annotations
    if typing.get_origin(tp) is typing.Union:
        for arg in typing.get_args(tp):
            if arg is not type(None) and dataclasses.is_dataclass(arg):
                return arg
        return None
    return tp if dataclasses.is_dataclass(tp) else None


# The roles the port fills so far (the JAX package has fourteen).
DISCRETE_DQN_NET_BUILDERS: Registry = Registry("net_builder.discrete_dqn")
PARAMETRIC_DQN_NET_BUILDERS: Registry = Registry("net_builder.parametric_dqn")
QR_DQN_NET_BUILDERS: Registry = Registry("net_builder.quantile_dqn")
CATEGORICAL_DQN_NET_BUILDERS: Registry = Registry("net_builder.categorical_dqn")
CONTINUOUS_ACTOR_NET_BUILDERS: Registry = Registry("net_builder.continuous_actor")
DISCRETE_ACTOR_NET_BUILDERS: Registry = Registry("net_builder.discrete_actor")
VALUE_NET_BUILDERS: Registry = Registry("net_builder.value")
MODEL_MANAGERS: Registry = Registry("model_manager")
ENVS: Registry = Registry("env")
VALIDATORS: Registry = Registry("validator")
PUBLISHERS: Registry = Registry("publisher")
OPTIMIZERS: Registry = Registry("optimizer")
