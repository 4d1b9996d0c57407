"""One run of one cell: set-up, the measured window or the traced run, the
check against the reference, and the result line.

A cell's traffic kind (``qa_bench/kinds/<kind>.py``) supplies a
``Session``: it builds the program and the inputs from the seed, runs one
closed-loop batch at a time (issue, then read the results back to the
host), keeps the outputs of the batches the check samples, and after the
window compares them with the plain reference. The per-layer metrics are
read by ``qa_bench/metrics/<name>.py``, each from the traced run.
"""

import importlib
import importlib.util
import json
import math
import random
import statistics
import sys
import time
from pathlib import Path

import torch

from qa_bench import trace as tracing

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "bridgeqa_tpu")
# batches the traced run times on the host before its profiler opens (and
# again under the stage spans), unless the traffic sets ``trace_batches``;
# and batches it profiles
TRACE_WALL_BATCHES = 4
TRACE_PROFILED_BATCHES = 2


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, the part before the first dot compared whole."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})


def p90(values) -> float:
    """Nearest-rank 90th percentile."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.9 * len(ordered)) - 1)]


class Sample:
    """A reservoir of ``k`` batch indices drawn uniformly from the seed over
    all batches offered, decided before each batch runs."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen = k, random.Random(seed), 0

    def offer(self) -> int | None:
        """The slot the next batch's outputs go to, or None."""
        i, self.seen = self.seen, self.seen + 1
        if i < self.k:
            return i
        j = self.rng.randrange(i + 1)
        return j if j < self.k else None


def find_cell(name: str, checkout: Path = ROOT.parent) -> tuple[dict, dict, dict, dict]:
    """(manifest, cell, configuration, traffic) of the cell ``name``: the
    cell from ``BENCHMARK.json`` under ``checkout``, its configuration from
    the file the manifest names for it, its traffic from
    ``qa_bench/workloads/<traffic>.json``. KeyError for an unknown cell."""
    bench = load_json(checkout / "BENCHMARK.json")
    cell = {c["name"]: c for c in bench["workloads"]}[name]
    cfg_file = {c["name"]: c["file"] for c in bench["configs"]}[cell["config"]]
    traffic = load_json(checkout / "qa_bench" / "workloads" / f"{cell['traffic']}.json")
    return bench, cell, load_json(checkout / cfg_file), traffic


def session_for(cfg: dict, traffic: dict, seed: int, device):
    kind = importlib.import_module(f"qa_bench.kinds.{traffic['kind']}")
    return kind.Session(cfg, traffic, seed, device)


def load_reader(name: str, metrics_dir: Path = ROOT / "metrics"):
    """``read`` of ``metrics/<name>.py``, else of the file of the quantity
    the name splits (``gemm_roofline.py`` for ``gemm_roofline.views``)."""
    path = metrics_dir / f"{name}.py"
    if not path.exists():
        path = metrics_dir / f"{name.split('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"qa_bench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def per_layer_for(bench: dict, cell: str) -> list:
    """The per-layer metrics a cell reports: those that list it, and those
    without a list that move an end-to-end metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


class TraceRun:
    """What the readers of per-layer metrics read."""

    def __init__(self, session, stage_ms: dict, batches_spanned: int, wall: tuple,
                 trace, profiled: list, groups: dict):
        self.session = session
        self.stage_ms, self.batches_spanned = stage_ms, batches_spanned
        self.wall_flops, self.wall_s = wall
        self.trace, self.profiled, self.groups = trace, profiled, groups
        self.peak = session.peak_flops

    def stage_per_batch(self, stage: str) -> float | None:
        calls = self.stage_ms.get(stage)
        return sum(calls) / self.batches_spanned if calls else None

    def stage_per_call(self, stage: str) -> float | None:
        calls = self.stage_ms.get(stage)
        return statistics.fmean(calls) if calls else None

    def group_s(self, group: str) -> tuple[float, int]:
        """(seconds, records) of the profiled kernels a group's names match."""
        if self.trace is None:
            return 0.0, 0
        names = self.groups[group]
        hits = [d for n, _, d in self.trace.kernels if any(k in n for k in names)]
        return sum(hits) / 1e9, len(hits)

    def roofline(self, group: str) -> float | None:
        """% of the least time the products of ``group`` could take, the
        larger of operations over the peak and bytes over the HBM rate,
        against the profiler's time of the group's kernels."""
        calls = [c for i in self.profiled for c in self.session.products(group, i)]
        seconds, records = self.group_s(group)
        if not calls or not seconds:
            return None
        log(f"{group}: {records} kernel records and {len(calls)} calls counted over "
            f"{len(self.profiled)} batches")
        least = sum(max(f / self.peak, b / self.session.hbm_bytes_per_s) for f, b in calls)
        return 100.0 * least / seconds

    def mfu(self) -> float | None:
        if not self.wall_s or self.session.device.type != "cuda":
            return None
        return 100.0 * self.wall_flops / self.wall_s / self.peak


def run(bench: dict, cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float,
        traced: bool, device, start: float, metrics_dir: Path = ROOT / "metrics") -> dict:
    """One run of ``cell``; returns the result line's object."""
    session = session_for(cfg, traffic, seed, device)
    log(f"program and inputs built at {time.perf_counter() - start:.3f} s")
    sample = Sample(traffic["check_batches"], seed)
    session.warm()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - start
    log(f"set-up {setup_s:.3f} s")
    if traced:
        metrics, extra, batches = traced_run(bench, cell, session, sample, metrics_dir)
    else:
        metrics, extra, batches = window(session, sample, seconds)
    metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: {found}")
    session.release()
    checks = session.check()
    failed = sum(1 for c in checks if not c["ok"])
    for c in checks:
        log(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})"
            f"{'' if c['ok'] else ' FAILED'}")
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": peak, **extra.pop("device", {})}
    result = {"correct": failed == 0 and bool(checks), "attempted": batches,
              "failed": 1 if failed else 0, "metrics": metrics, "device": device_info,
              **extra,
              "checks": {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}}
    return result


def window(session, sample: Sample, seconds: float) -> tuple[dict, dict, int]:
    durations, units = [], 0
    t_start = time.perf_counter()
    while True:
        slot = sample.offer()
        t0 = time.perf_counter()
        units += session.batch(len(durations), slot)
        t1 = time.perf_counter()
        durations.append(t1 - t0)
        if t1 - t_start >= seconds:
            break
    window_s = t1 - t_start
    log(f"window {window_s:.3f} s, {len(durations)} batches, {units} {session.unit_name}; "
        f"batch ms median {statistics.median(durations) * 1e3:.2f}, "
        f"max {max(durations) * 1e3:.2f}")
    metrics = {session.rate_metric: {"value": units / window_s, "unit": session.rate_unit},
               session.tail_metric: {"value": p90(durations) * 1e3, "unit": "ms"}}
    return metrics, {}, len(durations)


def traced_run(bench: dict, cell: dict, session, sample: Sample,
               metrics_dir: Path) -> tuple[dict, dict, int]:
    """The host clock over a few batches before the profiler opens (for
    ``mfu``), the stage spans over the same count, then the profiled batches;
    the cell's per-layer readers read them."""
    i, timed = 0, session.t.get("trace_batches", TRACE_WALL_BATCHES)
    flops, t0 = 0, time.perf_counter()
    for _ in range(timed):
        flops += session.flops(i)
        session.batch(i, sample.offer())
        i += 1
    wall_s = time.perf_counter() - t0
    with tracing.StageSpans(session.stages(), session.device) as spans:
        for _ in range(timed):
            session.batch(i, sample.offer())
            i += 1
    ran = []  # the batches of the trace kept (the profiler may take it again)

    def profiled():
        nonlocal i
        ran.clear()
        for _ in range(TRACE_PROFILED_BATCHES):
            ran.append(i)
            session.batch(i, sample.offer())
            i += 1

    trace = tracing.profile(profiled, session.device)
    if trace is not None:
        log(f"profiled {len(ran)} batches: {trace.launches} kernel launches, "
            f"{trace.graph_launches} graph launches of {trace.graph_kernels} records, busy "
            f"{trace.busy_s:.4f} s of {trace.window_s:.4f} s; traces that lacked card "
            f"records: {trace.lacking}")
    groups = load_json(ROOT / "kernel_groups.json")
    run_ = TraceRun(session, spans.ms(), timed, (flops, wall_s), trace, list(ran), groups)
    metrics = {}
    for m in per_layer_for(bench, cell["name"]):
        value = load_reader(m["name"], metrics_dir)(run_)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    extra = {}
    if trace is not None:
        extra["device"] = {"busy_s": trace.busy_s, "window_s": trace.window_s}
        top = sorted(trace.by_name().items(), key=lambda kv: -kv[1])[:10]
        extra["breakdown"] = {"device_ops": [[n, d / 1e9] for n, d in top],
                              "idle_gaps": [[what, s] for s, what in trace.gaps]}
    return metrics, extra, i
