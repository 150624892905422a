"""Tiny metrics registry (SURVEY.md §5 observability slot).

The reference appends FE values to notebook lists and prints wall-clocks;
this records named scalar series with timestamps and dumps CSV/JSON.

Counterpart of ``gaussianprocessnode_tpu/utils/logging.py``, the same
registry (the port keeps its own copy).
"""

import json
import time
from collections import defaultdict

__all__ = ["MetricsLogger"]


class MetricsLogger:
    def __init__(self):
        self._t0 = time.time()
        self.series = defaultdict(list)

    def log(self, name: str, value, step: int | None = None):
        self.series[name].append(
            {"t": time.time() - self._t0,
             "step": step if step is not None else len(self.series[name]),
             "value": float(value)}
        )

    def last(self, name: str):
        return self.series[name][-1]["value"]

    def to_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.series, f)

    def to_csv(self, path: str):
        with open(path, "w") as f:
            f.write("name,step,t,value\n")
            for name, rows in self.series.items():
                for r in rows:
                    f.write(f"{name},{r['step']},{r['t']:.3f},{r['value']}\n")

    def summary(self) -> dict:
        return {k: v[-1]["value"] for k, v in self.series.items()}
