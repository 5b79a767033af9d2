"""Model publishers (port of ``reagent_tpu/publishers/``; reference: reagent/publishers/)."""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Any, Optional

from reagent_tpu_torch.core.registry import PUBLISHERS


@dataclasses.dataclass
class PublishingResult:
    success: bool = True
    path: Optional[str] = None


@PUBLISHERS.register()
@dataclasses.dataclass
class NoPublishing:
    """Reference: publishers/no_publishing.py."""

    def publish(self, model_config, training_output, recurring_period=None) -> PublishingResult:
        return PublishingResult(success=True)


@PUBLISHERS.register()
@dataclasses.dataclass
class FileSystemPublisher:
    """Key -> latest-model-path store (reference publishers/file_system_publisher.py:42-105,
    TinyDB there; a JSON index here)."""

    publishing_file: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "reagent_tpu_publisher.json"))

    def _load(self) -> dict:
        if os.path.exists(self.publishing_file):
            with open(self.publishing_file) as f:
                return json.load(f)
        return {}

    def get_latest_published_model(self, model_config, module_name: str = "default_model") -> Optional[str]:
        db = self._load()
        key = f"{json.dumps(model_config, sort_keys=True)}:{module_name}"
        entry = db.get(key)
        return entry["path"] if entry else None

    def publish(self, model_config, training_output, recurring_period=None) -> PublishingResult:
        db = self._load()
        path = None
        for module_name, model_path in training_output.output_paths.items():
            key = f"{json.dumps(model_config, sort_keys=True)}:{module_name}"
            db[key] = {"path": model_path, "ts": time.time()}
            path = model_path
        with open(self.publishing_file, "w") as f:
            json.dump(db, f)
        return PublishingResult(success=True, path=path)
