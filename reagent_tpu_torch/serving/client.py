"""HTTP client for the C++ decision service.

Port of ``reagent_tpu/serving/client.py``, a copy.

Reference: serving/examples/ecommerce/customer_simulator.py hits the REST
endpoints with the ``requests`` lib; stdlib urllib here.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Dict, List, Optional


class DecisionServiceClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 3000, timeout: float = 10.0):
        self.base = f"http://{host}:{port}"
        self.timeout = timeout

    def _post(self, path: str, payload: dict) -> dict:
        req = urllib.request.Request(
            self.base + path,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def request(
        self,
        plan_name: str,
        actions: List[str],
        input: Optional[dict] = None,
        request_id: Optional[str] = None,
    ) -> dict:
        payload: dict = {"plan_name": plan_name, "actions": {"names": actions}}
        if input is not None:
            payload["input"] = input
        if request_id is not None:
            payload["request_id"] = request_id
        return self._post("/api/request", payload)

    def feedback(
        self,
        request_id: str,
        plan_name: str,
        action_name: str,
        metrics: Dict[str, float],
    ) -> dict:
        return self._post(
            "/api/feedback",
            {
                "request_id": request_id,
                "plan_name": plan_name,
                "action_name": action_name,
                "metrics": metrics,
            },
        )

    def healthy(self) -> bool:
        try:
            with urllib.request.urlopen(self.base + "/healthz", timeout=2) as resp:
                return json.loads(resp.read()).get("status") == "healthy"
        except Exception:
            return False
