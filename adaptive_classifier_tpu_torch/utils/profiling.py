"""Stage timers and device traces.

Counterpart of ``adaptive_classifier_tpu/utils/profiling.py``: named stage
timers with aggregate figures (``AdaptiveClassifier.enable_profiling``
attaches one to a classifier, which then times ``tokenize``,
``encoder_forward`` and ``knn_fusion``), a context manager around
``torch.profiler`` for a device trace in the Chrome trace format, and named
regions that show on that trace.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, Optional, Union

import torch

logger = logging.getLogger(__name__)


class StageTimers:
    """Aggregating named timers for pipeline stages.

    Kernel launches return before the device has run them; a stage given
    ``block_on`` (a tensor or a device) waits for its device to finish
    before it stops the clock, so the device time lands in that stage and
    not in a later one.
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def record(self, name: str, seconds: float):
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": round(self.totals[name], 6),
                "count": self.counts[name],
                "mean_ms": round(1000 * self.totals[name] / max(self.counts[name], 1), 3),
            }
            for name in sorted(self.totals)
        }

    def reset(self):
        self.totals.clear()
        self.counts.clear()

    def report(self) -> str:
        lines = [f"{'stage':<24}{'calls':>8}{'total s':>12}{'mean ms':>12}"]
        for name, s in self.summary().items():
            lines.append(f"{name:<24}{s['count']:>8}{s['total_s']:>12.4f}{s['mean_ms']:>12.3f}")
        return "\n".join(lines)


def _synchronize(block_on: Union[torch.Tensor, torch.device, str]):
    """Wait for the CUDA device of ``block_on`` (a tensor or a device); a
    CPU one has nothing queued.  A device error raises here."""
    device = block_on.device if isinstance(block_on, torch.Tensor) else torch.device(block_on)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


#: process-wide timers for callers that want one set across classifiers
GLOBAL_TIMERS = StageTimers()


@contextlib.contextmanager
def device_trace(log_dir: Union[str, Path], name: Optional[str] = None) -> Iterator[
        "torch.profiler.profile"]:
    """Trace the host and, when a GPU is present, the device while the
    block runs; writes ``log_dir/<name or trace>.json`` (Chrome trace
    format: chrome://tracing or Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = out / f"{name or 'trace'}.json"
    prof.export_chrome_trace(str(path))
    logger.info(f"Device trace written to {path}")


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region that shows on the trace of :func:`device_trace`."""
    with torch.profiler.record_function(name):
        yield
