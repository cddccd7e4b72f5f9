"""Wall-clock and device timing (counterpart of `mpm_flip98a_tpu/utils/timing.py`).

PyTorch returns before the card finishes, so a host clock around CUDA
work measures the enqueue unless the scope synchronises.  `Timers.scope`
given a CUDA device synchronises at its end and also records CUDA events
around the block, so each name carries its host time and its device time.
`profiler_trace(logdir)` writes a Chrome trace of a block (torch.profiler).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


def device_sync(device) -> None:
    """Block until all queued work on `device` has finished (no-op on CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Timers:
    """Named scoped timers with accumulated totals."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.device_total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def scope(self, name: str, sync: Optional[torch.device] = None):
        events = None
        if sync is not None and torch.device(sync).type == "cuda":
            events = (
                torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True),
            )
            events[0].record()
        t0 = time.perf_counter()
        yield
        if events is not None:
            events[1].record()
        if sync is not None:
            device_sync(sync)
        self.total[name] += time.perf_counter() - t0
        if events is not None:
            self.device_total[name] += events[0].elapsed_time(events[1]) / 1e3
        self.count[name] += 1

    def summary(self) -> str:
        rows = []
        for name in sorted(self.total):
            t, c = self.total[name], self.count[name]
            row = f"{name:24s} {t:8.3f} s  x{c:<6d} {t / c * 1e3:8.2f} ms/call"
            if name in self.device_total:
                row += f"  (cuda events {self.device_total[name]:8.3f} s)"
            rows.append(row)
        return "\n".join(rows)


class ThroughputMeter:
    """Substeps/sec + particle-transfer-ops/sec tracking."""

    def __init__(self, particles: int, stencil: int):
        self.particles = particles
        self.stencil = stencil
        self.substeps = 0
        self.elapsed = 0.0

    def update(self, substeps: int, seconds: float) -> None:
        self.substeps += substeps
        self.elapsed += seconds

    @property
    def substeps_per_sec(self) -> float:
        return self.substeps / self.elapsed if self.elapsed else 0.0

    @property
    def transfer_ops_per_sec(self) -> float:
        return self.substeps_per_sec * self.particles * self.stencil * 2


@contextlib.contextmanager
def profiler_trace(logdir: str, device=None):
    """Trace the enclosed block with torch.profiler (the counterpart of
    timing.py:54-60's Xprof trace): CPU activity, and CUDA activity when
    `device` is a card (default: when one is available), written as a
    Chrome trace, `<logdir>/trace-<pid>.json`.  Yields the profiler, whose
    `key_averages()` sums the block by op."""
    from torch.profiler import ProfilerActivity, profile

    if device is None:
        on_card = torch.cuda.is_available()
    else:
        on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if on_card:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace-{os.getpid()}.json"))
