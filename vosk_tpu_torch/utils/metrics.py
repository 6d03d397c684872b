"""Per-stage timing/observability.

Copy of `StageTimers` from `vosk_tpu/utils/metrics.py`, and its profiler
scope `trace` on torch.profiler in place of jax.profiler;
tests/test_torch_copies.py holds them to their source.  Every Recognizer
owns a `StageTimers`; `report()` returns stage totals, counts and realtime
factors.

On the card the stage timers measure host time: torch launches kernels
asynchronously, so a stage's time is the time the host spent enqueuing its
work plus any wait for a result it reads back, as the source's timers
measure under jax's asynchronous dispatch.  No synchronisation is added.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict


class StageTimers:
    def __init__(self):
        self.total_s: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.audio_seconds = 0.0

    @contextlib.contextmanager
    def timer(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total_s[stage] += time.perf_counter() - t0
            self.count[stage] += 1

    def add(self, stage: str, seconds: float) -> None:
        """One call of `stage` that took `seconds` (a step timed elsewhere)."""
        self.total_s[stage] += seconds
        self.count[stage] += 1

    def add_audio(self, seconds: float) -> None:
        self.audio_seconds += seconds

    def report(self) -> dict:
        total = sum(self.total_s.values())
        out = {
            "stages": {
                k: {
                    "seconds": round(v, 4),
                    "calls": self.count[k],
                    "share": round(v / total, 3) if total else 0.0,
                }
                for k, v in sorted(self.total_s.items(), key=lambda kv: -kv[1])
            },
            "audio_seconds": round(self.audio_seconds, 3),
            "wall_seconds": round(total, 4),
        }
        if total > 0 and self.audio_seconds > 0:
            out["xrt"] = round(total / self.audio_seconds, 4)
            out["audio_seconds_per_second"] = round(self.audio_seconds / total, 2)
        return out


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace scope: host activity, and the card's where one is
    visible, written on exit as a Chrome trace (trace_<time>_<pid>.json,
    for chrome://tracing or Perfetto) into log_dir; yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        name = f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"
        prof.export_chrome_trace(os.path.join(log_dir, name))
