"""The benchmark's own spans around entries of the program, for a traced
stretch: each named entry runs inside ``torch.profiler.record_function``
while the context lasts, so the trace can tell which device operations were
launched from inside it (``devtrace.ops_under``).

A per-layer reader names the entries it reads in ``SPANS``, a dict from a
span's name to the entries that open it.  An entry is
``"<module>:<attr>[.<attr>...]"`` (``"reagent_tpu_torch.ops.x:Fn.backward"``)
or ``"program:<attr>[.<attr>...]"``, an attribute of the kind's
``Run.program``.  An entry that is not found is left alone; the span then
holds nothing, and the reader reads nothing.
"""

from __future__ import annotations

import functools
import importlib
import inspect
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Tuple


def resolve(entry: str, program) -> Optional[Tuple[object, str]]:
    """The object that holds ``entry``'s last attribute, and its name; None
    where any part is missing."""
    head, _, path = entry.partition(":")
    parts = path.split(".")
    try:
        owner = program if head == "program" else importlib.import_module(head)
        for part in parts[:-1]:
            owner = getattr(owner, part)
        getattr(owner, parts[-1])
    except (ImportError, AttributeError):
        return None
    return owner, parts[-1]


def _wrap(fn, span: str):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def inside(*args, **kwargs):
        with record_function(span):
            return fn(*args, **kwargs)
    return inside


@contextmanager
def opened(targets: Dict[str, List[str]], program) -> Iterator[Dict[str, bool]]:
    """Every entry of ``targets`` wrapped in its span while the context lasts;
    yields, per entry, whether it was found."""
    undo, found = [], {}
    try:
        for span, entries in targets.items():
            for entry in entries:
                where = resolve(entry, program)
                found[entry] = where is not None
                if where is None:
                    continue
                owner, name = where
                raw = inspect.getattr_static(owner, name)
                own = name in getattr(owner, "__dict__", {})
                wrapped = _wrap(getattr(owner, name), span)
                setattr(owner, name, staticmethod(wrapped) if isinstance(raw, staticmethod)
                        else wrapped)
                undo.append((owner, name, raw, own))
        yield found
    finally:
        for owner, name, raw, own in reversed(undo):
            if own:
                setattr(owner, name, raw)
            else:
                delattr(owner, name)
