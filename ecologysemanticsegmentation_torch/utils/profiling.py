"""Structured metrics of the port (counterpart of
``ecologysemanticsegmentation_tpu/utils/profiling.py``).

* :class:`MetricsLogger`: append-only CSV, one row per log event, with the
  columns of its first row.
* :class:`StepTimer`: step time and images per second, the first
  ``warmup`` steps excluded.

Device time by layer comes from ``train/profile_step.py`` (``torch.profiler``).
"""

from __future__ import annotations

import csv
import os
import time


class MetricsLogger:
    """Append-only CSV metrics: ``log(step=…, epoch=…, **scalars)``."""

    def __init__(self, path: str):
        self.path = path
        self._fieldnames: list[str] | None = None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, **scalars) -> None:
        row = {k: (float(v) if hasattr(v, "__float__") else v) for k, v in scalars.items()}
        new_file = self._fieldnames is None and not os.path.exists(self.path)
        if self._fieldnames is None:
            if os.path.exists(self.path):
                with open(self.path) as f:
                    reader = csv.reader(f)
                    self._fieldnames = next(reader, None) or sorted(row)
            else:
                self._fieldnames = sorted(row)
        with open(self.path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames, extrasaction="ignore")
            if new_file:
                writer.writeheader()
            writer.writerow(row)


class StepTimer:
    """Images/sec + step-time tracker; first ``warmup`` steps are excluded
    (compilation)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.reset()

    def reset(self) -> None:
        self._steps = 0
        self._images = 0
        self._t0: float | None = None

    def step(self, batch_size: int) -> None:
        self._steps += 1
        if self._steps == self.warmup:
            self._t0 = time.perf_counter()
            self._images = 0
        elif self._steps > self.warmup:
            self._images += batch_size

    @property
    def images_per_sec(self) -> float:
        if self._t0 is None or self._images == 0:
            return 0.0
        return self._images / (time.perf_counter() - self._t0)

    @property
    def step_ms(self) -> float:
        steady = self._steps - self.warmup
        if self._t0 is None or steady <= 0:
            return 0.0
        return 1000.0 * (time.perf_counter() - self._t0) / steady
