"""Structured step logging; counterpart of `fashion_nerf.logging_`: one
JSON object per line on stdout, with the seconds since the logger began."""

from __future__ import annotations

import json
import time


class MetricLogger:
    def __init__(self, cfg=None):
        self.t0 = time.perf_counter()
        if cfg is not None:
            self._print({"config": cfg.name, "t": 0.0})

    @staticmethod
    def _print(entry: dict) -> None:
        print(f"[fashion-nerf-torch] {json.dumps(entry)}", flush=True)

    def __call__(self, entry: dict) -> None:
        entry = dict(entry)
        entry["t"] = round(time.perf_counter() - self.t0, 2)
        self._print(entry)
