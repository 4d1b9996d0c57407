"""Spans and device traces of the traced run (``--trace 1``).

- ``StageSpans``: CUDA events at the forward hooks of the program's modules
  (a copy of ``chip_smoke.py::stage_times``). A span is the stream's time
  from a module's first operation to its last: where the host issues a
  module's work more slowly than the card runs it, the span holds the card's
  wait for the host too.
- ``profile``: ``torch.profiler`` over a few batches, opened as
  ``chip_smoke.py::device_ms`` opens its traces (a throwaway trace first,
  then ``LEAD_KERNELS`` tiny kernels whose records are not read), and the
  card records matched to the host's launch calls by correlation id (a CUDA
  graph's replayed kernels by their graph launch's). A trace that lacks the
  record of some kernel or graph launch is taken again, up to five times;
  ``Trace.lacking`` counts those traces.
"""

import sys
import time
from collections import Counter, defaultdict

import torch

LEAD_KERNELS = 16
# the host's calls that put work on the card, as the profiler names them; a
# graph launch's kernels carry the graph launch's correlation id
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cuGraphLaunch",
                "cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy", "cudaMemset")
KERNEL_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")
TRIES = 5


class StageSpans:
    """The spans of each stage's module calls over the batches run inside
    the block (``stages``: stage name -> its modules)."""

    def __init__(self, stages: dict, device):
        self.stages, self.device = stages, device
        self.calls = defaultdict(list)
        self._open, self._handles = {}, []

    def __enter__(self):
        cuda = self.device.type == "cuda"
        for name, modules in self.stages.items():
            for mod in modules:
                def pre(_m, _a, name=name):
                    ev = torch.cuda.Event(enable_timing=True) if cuda else time.perf_counter()
                    if cuda:
                        ev.record()
                    self._open.setdefault(name, []).append(ev)

                def post(_m, _a, _o, name=name):
                    start = self._open[name].pop()
                    if cuda:
                        end = torch.cuda.Event(enable_timing=True)
                        end.record()
                        self.calls[name].append((start, end))
                    else:
                        self.calls[name].append((start, time.perf_counter()))

                self._handles += [mod.register_forward_pre_hook(pre),
                                  mod.register_forward_hook(post)]
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def ms(self) -> dict:
        """stage -> list of ms of each call."""
        cuda = self.device.type == "cuda"
        return {name: [a.elapsed_time(b) if cuda else (b - a) * 1e3 for a, b in spans]
                for name, spans in self.calls.items()}


class Trace:
    """The card's records of the profiled batches."""

    def __init__(self, kernels: list, launches: int, window_s: float, busy_s: float,
                 gaps: list, lacking: int, graph_launches: int = 0, graph_kernels: int = 0):
        self.kernels = kernels  # (name, start_ns, duration_ns), by start
        self.launches = launches  # kernel launch calls
        # graph launch calls, and the card records they put there
        self.graph_launches, self.graph_kernels = graph_launches, graph_kernels
        self.window_s, self.busy_s = window_s, busy_s
        self.gaps = gaps  # (seconds, what the host was doing), longest first
        self.lacking = lacking

    def by_name(self) -> dict:
        total = defaultdict(int)
        for name, _, dur in self.kernels:
            total[name] += dur
        return dict(total)


def _union_ns(intervals) -> int:
    busy, end = 0, None
    for start, stop in sorted(intervals):
        if end is None or start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy


def _host_at(cpu_events, start_ns: int, end_ns: int) -> str:
    """What the host was doing in a gap of the card: the innermost host span
    that covers its middle, else the host's last call before it and its
    first call after it."""
    mid = (start_ns + end_ns) // 2
    inner, before, after = None, None, None
    for e in cpu_events:
        s, d = e.start_ns(), e.duration_ns()
        if s <= mid <= s + d and (inner is None or d < inner[1]):
            inner = (e.name(), d)
        if s + d <= mid and (before is None or s + d > before[1]):
            before = (e.name(), s + d)
        if s >= mid and (after is None or s < after[1]):
            after = (e.name(), s)
    if inner:
        return inner[0]
    return (f"host between {before[0] if before else 'start'} and "
            f"{after[0] if after else 'end'}")


def profile(run, lead_device) -> Trace | None:
    """Profile ``run()`` (which ends in a host sync) after the lead kernels.
    None where the profiler records no device activity (the CPU)."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = lead_device.type == "cuda"
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    scratch = torch.zeros(1, device=lead_device)

    def lead():
        for _ in range(LEAD_KERNELS):
            scratch.add_(1.0)
        return LEAD_KERNELS

    lacking = 0
    for _ in range(TRIES):
        with torch.profiler.profile(activities=acts):  # throwaway
            lead()
            if cuda:
                torch.cuda.synchronize(lead_device)
        with torch.profiler.profile(activities=acts) as prof:
            led = lead()
            if cuda:
                torch.cuda.synchronize(lead_device)
            run()
        events = prof.profiler.kineto_results.events()
        cpu = [e for e in events if e.device_type() == DeviceType.CPU]
        calls = sorted((e for e in cpu if e.name().startswith(LAUNCH_CALLS)),
                       key=lambda e: e.start_ns())[led:]
        ids = {e.correlation_id() for e in calls}
        work = sorted((e for e in events if e.device_type() == DeviceType.CUDA
                       and e.correlation_id() in ids), key=lambda e: e.start_ns())
        if not calls or not cuda:
            return None
        recorded = {e.correlation_id() for e in work}
        missing = Counter(e.name() for e in calls if e.correlation_id() not in recorded)
        # a copy or fill can run on the host alone (no card record); a
        # kernel or graph launch cannot
        if not any(name.startswith(KERNEL_LAUNCHES + GRAPH_LAUNCHES) for name in missing):
            break
        lacking += 1
        print(f"a trace lacked the card records of {dict(missing)} among "
              f"{dict(Counter(e.name() for e in calls))}; taken again", file=sys.stderr)
    else:
        raise RuntimeError(f"the profiler lost card records in {TRIES} traces in a row")
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in work]
    t0, t1 = calls[0].start_ns(), max(s for _, s in spans)
    gaps, end = [], spans[0][0]
    for start, stop in sorted(spans):
        if start > end:
            gaps.append((start - end, end, start))
        end = max(end, stop)
    gaps.sort(reverse=True)
    host = [e for e in cpu if not e.name().startswith(LAUNCH_CALLS)]
    named = [((g / 1e9), _host_at(host, a, b)) for g, a, b in gaps[:10]]
    kernels = [(e.name(), e.start_ns(), e.duration_ns()) for e in work]
    launches = sum(1 for e in calls if e.name().startswith(KERNEL_LAUNCHES))
    graphs = {e.correlation_id() for e in calls if e.name().startswith(GRAPH_LAUNCHES)}
    return Trace(kernels, launches, (t1 - t0) / 1e9, _union_ns(spans) / 1e9, named, lacking,
                 len(graphs), sum(1 for e in work if e.correlation_id() in graphs))
