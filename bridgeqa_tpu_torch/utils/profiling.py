"""Profiling hooks: ``torch.profiler`` traces + per-phase step timers
(counterpart of ``bridgeqa_tpu/utils/profiling.py``).

The reference only had manual wall-clock timing (``lib/solver.py:524-543``,
``utils/eta.py``); here we add real device traces on demand — set
``BRIDGEQA_PROFILE_DIR`` or pass ``trace_dir`` to capture a timeline of the
host and the card (a Chrome trace, viewable in ``chrome://tracing`` or
Perfetto) of each traced block, and the card's busy share in it.
"""

import contextlib
import dataclasses
import os
import time

import torch


@dataclasses.dataclass
class TraceSummary:
    """What a traced block took: its host wall time, the card's kernel time
    in it (0 without a card), and where its Chrome trace went."""

    wall_ms: float = 0.0
    device_ms: float = 0.0
    path: str = ""

    @property
    def busy(self) -> float:
        """The card's busy share of the block's wall time."""
        return self.device_ms / self.wall_ms if self.wall_ms else 0.0


@contextlib.contextmanager
def maybe_trace(trace_dir=None, *, step: int = 0, enabled=None):
    """Trace the enclosed block with ``torch.profiler`` when enabled; yield a
    ``TraceSummary`` that is filled when the block ends (None when not
    tracing). The card's work is waited for before the block and at its
    end, so the trace holds the block's kernels and no others; the trace is
    written to ``trace_dir/trace_step{step}.json``.

    enabled=None -> auto: on iff trace_dir or BRIDGEQA_PROFILE_DIR is set.
    """
    trace_dir = trace_dir or os.environ.get("BRIDGEQA_PROFILE_DIR")
    if enabled is None:
        enabled = trace_dir is not None
    if not enabled or trace_dir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    summary = TraceSummary()
    if cuda:  # the card's earlier work stays out of the trace and its busy share
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        # no record_function range here: on the card it adds an annotation
        # event spanning the block, which the sum below would count as busy
        yield summary
        if cuda:
            torch.cuda.synchronize()
        summary.wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels run on one stream, so their durations add up to the busy time
    summary.device_ms = sum(e.device_time_total for e in prof.events()
                            if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    os.makedirs(trace_dir, exist_ok=True)
    summary.path = os.path.join(trace_dir, f"trace_step{step}.json")
    prof.export_chrome_trace(summary.path)


class PhaseTimer:
    """Accumulates wall time per named phase (fetch/forward/backward/eval),
    mirroring the per-iter time report of ``solver.py:573-579``. Host time:
    on the card a phase that only queues work ends before the work does."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def means(self) -> dict:
        return {k: self.totals[k] / max(self.counts[k], 1) for k in self.totals}

    def reset(self):
        self.totals.clear()
        self.counts.clear()
