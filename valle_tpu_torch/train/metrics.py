"""Metrics accumulation with an EMA window: the twin of
``valle_tpu/train/metrics.py`` (icefall's MetricsTracker as the reference
trainer uses it):

    tot = tot * (1 - 1/reset_interval) + new * (1/reset_interval)

over the summed metrics of each step, normalised by frames for display.
"""

from __future__ import annotations

from typing import Dict


class MetricsTracker:
    def __init__(self, reset_interval: int = 200):
        self.reset_interval = reset_interval
        self.tot: Dict[str, float] = {}

    def update(self, metrics: Dict[str, float]) -> None:
        a = 1.0 - 1.0 / self.reset_interval
        b = 1.0 / self.reset_interval
        for k, v in metrics.items():
            self.tot[k] = self.tot.get(k, 0.0) * a + float(v) * b

    def normalized(self) -> Dict[str, float]:
        frames = max(self.tot.get("frames", 0.0), 1e-9)
        return {k: v if k in ("frames", "lr") else v / frames for k, v in self.tot.items()}

    def summary(self) -> str:
        n = self.normalized()
        return " ".join(f"{k}={v:.4f}" for k, v in sorted(n.items()) if k != "frames")
