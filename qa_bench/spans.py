"""The program's own spans and counters in the traced run
(``bridgeqa_tpu_torch/utils/profiling.py``: ``span``, ``count``,
``recording``), for the per-layer metrics that read them.

The first reader of such a metric runs two passes of the cell's session
after the harness's profiled batches (``of``; once a run):

- the profiled pass: ``harness.TRACE_PROFILED_BATCHES`` batches inside
  ``recording()`` under ``torch.profiler``, opened as ``trace.profile`` opens
  it (a throwaway trace, the lead kernels, a retake for a lost kernel
  record). Every span opens a host range ``bridgeqa/<name>`` on the
  profiler's clock. Each card record (kernel, copy or fill) goes to the
  innermost range whose host interval holds the start of the record's
  launch call, matched by correlation id (``attribute``); a span's card ms
  is the union of the records of the span and of the spans under it.
- the span pass: the traffic's ``trace_batches`` batches (else
  ``harness.TRACE_WALL_BATCHES``) inside ``recording()`` with the profiler
  off: each span's host and stream ms without the profiler's host cost, and
  the counters' increments.

Both passes run with ``slot`` None, so the check's samples are the
harness's. The run logs each span's totals, the counters, the card time
left unattributed and the span pass's batch wall to standard error. A
program without the facility (such as one older than it) reads None for
every metric here, and the run goes on.
"""

import sys
import time
from collections import Counter, defaultdict

import torch

from qa_bench import harness
from qa_bench import trace as tracing

PREFIX = "bridgeqa/"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def facility():
    """The program's profiling module if it has spans, else None."""
    try:
        from bridgeqa_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "recording") else None


def attribute(ranges: list, launch_at: dict, records: list) -> list:
    """For each card record, the index of the innermost range whose host
    interval holds the start of the record's launch call, else None.

    ``ranges``: (start_ns, end_ns) host intervals, nested as a program's
    spans nest, in order of their starts; ``launch_at``: correlation id ->
    start ns of the launch call; ``records``: (correlation id, ...) card
    records."""
    at = sorted((launch_at[r[0]], k) for k, r in enumerate(records) if r[0] in launch_at)
    out = [None] * len(records)
    stack, nxt = [], 0
    for t, k in at:
        while nxt < len(ranges) and ranges[nxt][0] <= t:
            while stack and ranges[stack[-1]][1] < ranges[nxt][0]:
                stack.pop()
            stack.append(nxt)
            nxt += 1
        while stack and ranges[stack[-1]][1] < t:
            stack.pop()
        out[k] = stack[-1] if stack else None
    return out


def profiled_records(run, device):
    """``run()`` under the profiler after the lead kernels. Returns (what
    the last ``run()`` returned, ranges as (name, start_ns, end_ns),
    correlation id -> launch start ns, card records as (correlation id,
    name, start_ns, end_ns)), or None off the card."""
    from torch.autograd import DeviceType

    if device.type != "cuda":
        run()
        return None
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    scratch = torch.zeros(1, device=device)

    def lead():
        for _ in range(tracing.LEAD_KERNELS):
            scratch.add_(1.0)
        return tracing.LEAD_KERNELS

    for _ in range(tracing.TRIES):
        with torch.profiler.profile(activities=acts):  # throwaway
            lead()
            torch.cuda.synchronize(device)
        with torch.profiler.profile(activities=acts) as prof:
            led = lead()
            torch.cuda.synchronize(device)
            ran = run()
        events = prof.profiler.kineto_results.events()
        cpu = [e for e in events if e.device_type() == DeviceType.CPU]
        calls = sorted((e for e in cpu if e.name().startswith(tracing.LAUNCH_CALLS)),
                       key=lambda e: e.start_ns())[led:]
        launch_at = {e.correlation_id(): e.start_ns() for e in calls}
        work = [e for e in events if e.device_type() == DeviceType.CUDA
                and not e.is_user_annotation() and e.correlation_id() in launch_at]
        recorded = {e.correlation_id() for e in work}
        missing = Counter(e.name() for e in calls if e.correlation_id() not in recorded)
        if not any(n.startswith(tracing.KERNEL_LAUNCHES + tracing.GRAPH_LAUNCHES)
                   for n in missing):
            break
        log(f"a trace of the program's spans lacked the card records of {dict(missing)}; "
            "taken again")
    else:
        raise RuntimeError(f"the profiler lost card records in {tracing.TRIES} traces in a row")
    ranges = sorted(((e.name()[len(PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in cpu if e.name().startswith(PREFIX)),
                    key=lambda r: (r[1], -r[2]))  # an outer range before an inner one
    records = [(e.correlation_id(), e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
               for e in work]
    return ran, ranges, launch_at, records


class ProgramSpans:
    """What the two passes found: per request (a root span: a forward or a
    scene), each span's card ms (profiled pass) and stream and host ms
    (span pass), and the counters of the span pass."""

    def __init__(self, card_ms: dict, card_requests: int, totals: dict, requests: int,
                 counts: Counter):
        self.card_ms, self.card_requests = card_ms, card_requests
        self.totals, self.requests, self.counts = totals, requests, counts

    def busy_ms(self, name: str) -> float | None:
        """Card ms a request of the records attributed to the spans ``name``
        and the spans under them, as the union of their intervals."""
        return self.card_ms[name] / self.card_requests if name in self.card_ms else None

    def stream_ms(self, name: str) -> float | None:
        """Stream ms a request of the spans ``name`` (span pass)."""
        t = self.totals.get(name, {})
        return t["stream_ms"] / self.requests if "stream_ms" in t else None

    def self_host_ms(self, names) -> float | None:
        found = [self.totals[n]["self_host_ms"] for n in names if n in self.totals]
        return sum(found) / self.requests if found else None


def card_ms_by_span(spans: list, ranges: list, launch_at: dict, records: list):
    """(span name -> card ns of the union of the records under each span of
    that name, share of the card time attributed to no span, the longest
    unattributed records by name), or None where the profiler's ``ranges``
    are not the recording's ``spans`` in the order they opened."""
    if [r[0] for r in ranges] != [s.name for s in spans]:
        log(f"the profiler's {len(ranges)} ranges do not match the recording's {len(spans)} "
            "spans: the card ms of the spans read nothing")
        return None
    owner = attribute([(a, b) for _, a, b in ranges], launch_at, records)
    under = defaultdict(list)
    lost, total, lost_by_name = 0, 0, Counter()
    for (_, name, a, b), k in zip(records, owner):
        total += b - a
        if k is None:
            lost += b - a
            lost_by_name[name] += b - a
            continue
        seen = set()
        while k is not None:
            if spans[k].name not in seen:  # a name once a record
                under[spans[k].name].append((a, b))
                seen.add(spans[k].name)
            k = spans[k].parent
    busy = {name: tracing._union_ns(iv) for name, iv in under.items()}
    return busy, (lost / total if total else 0.0), lost_by_name.most_common(5)


def _collect(t):
    prof = facility()
    if prof is None:
        log("the program has no spans: the span metrics read nothing")
        return None
    session = t.session
    cuda = session.device.type == "cuda"
    i = max(t.profiled) + 1 if t.profiled else 0

    def batches(n):
        nonlocal i
        for _ in range(n):
            session.batch(i, None)
            i += 1

    def profiled():
        with prof.recording() as rec:
            batches(harness.TRACE_PROFILED_BATCHES)
        return rec

    card, card_requests = {}, 0
    found = profiled_records(profiled, session.device)
    by_span = None if found is None else card_ms_by_span(found[0].spans, *found[1:])
    if by_span is not None:
        rec = found[0]
        busy, unattributed, lost = by_span
        card = {name: ns / 1e6 for name, ns in busy.items()}
        card_requests = sum(1 for s in rec.spans if s.parent is None)
        log(f"program spans, profiled pass ({card_requests} requests): card ms "
            + ", ".join(f"{n} {ms:.3f}" for n, ms in sorted(card.items()))
            + f"; unattributed {100 * unattributed:.3f}% of the card time, longest "
            + ", ".join(f"{n[:60]} {ns / 1e6:.3f} ms" for n, ns in lost))

    timed = session.t.get("trace_batches", harness.TRACE_WALL_BATCHES)
    if cuda:
        torch.cuda.synchronize(session.device)
    t0 = time.perf_counter()
    with prof.recording() as rec:
        batches(timed)
        wall = time.perf_counter() - t0
    requests = sum(1 for s in rec.spans if s.parent is None)
    totals = rec.totals()
    for name, tot in sorted(totals.items()):
        log(f"span {name}: " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                                         for k, v in tot.items()))
    log(f"counters of the span pass: {dict(rec.counts)}")
    if t.wall_s and t.batches_spanned:
        before = t.wall_s / t.batches_spanned
        log(f"span pass {1e3 * wall / timed:.3f} ms a batch against {1e3 * before:.3f} ms a "
            f"batch timed before the profiler ({100 * (wall / timed / before - 1):+.2f}%)")
    return ProgramSpans(card, card_requests, totals, requests, rec.counts)


def of(t) -> ProgramSpans | None:
    """The program's spans of the traced run ``t`` (a ``harness.TraceRun``),
    collected by the first reader that asks; None without the facility."""
    if not hasattr(t, "_program_spans"):
        t._program_spans = _collect(t)
    return t._program_spans
