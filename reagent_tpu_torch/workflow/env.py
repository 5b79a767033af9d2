"""Workflow-environment hooks: workflow ids for recurring publishing.

Port of ``reagent_tpu/workflow/env.py`` (reference:
reagent/workflow/env.py:12-30) — a deliberately replaceable stub mapping
serving-module names to entity ids for the model publisher.
"""

from __future__ import annotations

import itertools
from typing import Dict, List

_BASE_WORKFLOW_ID = 987654321


def get_workflow_id() -> int:
    return _BASE_WORKFLOW_ID


def get_new_named_entity_ids(module_names: List[str]) -> Dict[str, int]:
    ids = itertools.count(_BASE_WORKFLOW_ID, -1)
    return {name: next(ids) for name in module_names}
