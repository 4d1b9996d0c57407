#!/usr/bin/env python3
"""Find what makes ``torch.profiler`` lose the card's records in a long run.

    python3 profiler_probe.py                  # every variant, each in a process of its own
    python3 profiler_probe.py --only V [V ...]  # these variants, each in a process of its own
    python3 profiler_probe.py VARIANT          # one variant, in this process

Late in a ``chip_smoke.py`` run (phases 10-11, after the drivers' phase 8
and the parallel phase 9) a ``device_ms`` trace came back with no card
record at all, then the next one held them all. This probe times one fixed
loop with ``chip_smoke.device_ms`` (5 calls of the row gather's kernel at
the ``sa2-like`` bf16 shape, ``gather.launch``), ``READINGS`` readings in a
fresh process, each after a little unprofiled work on the card (3 calls of
the gather's plain version), and counts the traces each reading lost
(``chip_smoke.dropped_traces``; a reading that lost five fails). A variant
first does one of the things ``chip_smoke.py`` does before the losses start:

- ``fresh``: nothing;
- ``sessions``: ``SESSIONS`` profiler sessions of the same loop, more than
  a whole ``chip_smoke.py`` run opens (its last lines print how many);
- ``big_trace``: one session of ``BIG_TRACE`` launches (a traced train step
  holds ~21400 card records);
- ``modules``: a tiny model's rank forward and a train step (loads the
  kernels of cuBLAS, cuDNN and PyTorch that the phases load);
- ``forkserver``: one epoch of the feed (``BatchIterator``, two worker
  processes forked by a fork server, ``device_batches``' pin thread), as
  phase 8's drivers run it;
- ``sync_debug``: ``torch.cuda.set_sync_debug_mode("error")`` and back, as
  ``--check_syncs`` does around each train step;
- ``traced``: two steps under ``utils.profiling.maybe_trace`` (a trace
  exported to JSON), as ``--trace_dir`` does;
- ``gloo``: two fresh processes (gloo ranks) on the same card, all-reduces
  of CUDA tensors and a product each, as phase 9 (a) does;
- ``nccl``: ``torch.distributed.run --nproc_per_node 1`` of a process that
  runs DDP over NCCL at world size 1, as phase 9 (c) does;
- ``spin``: ``chip_smoke.queued_ms`` once (``torch.cuda._sleep``);
- ``phase5``, ``phase8``, ``phase9``: ``chip_smoke.py``'s own main path
  phases (5 and its f32 forward), drivers (8) or parallel phase (9).

Of those, only phase 8 loses traces, so its parts:

- ``phase8_steps``: phase 8 with ``STEP_READINGS`` readings after each of
  its driver runs (``train`` DET, VQA, the traced resume, ``predict``,
  ``eval``, ``score``), each run's own losses in ``steps``: they begin
  after the VQA run;
- ``det``: phase 8's first run alone (``train --stage DET``, full width,
  ``chip_smoke.DRIVER_ARGS``: two feed workers, ``--check_syncs``), and
  the same with one change each: ``det_serial`` (``--num_workers 1``, the
  feed in the process), ``det_nosync`` (no ``--check_syncs``),
  ``det_traced`` (``--trace_dir``);
- ``phase8_child``: phase 8 in a child process, the readings in this one;
- ``vqa``: phase 8's second run alone (``train`` at the VQA stage, two
  epochs of two steps and their validations), ``vqa_padded`` the same with
  every ``device_ms`` trace opening with a sleep of ``PAD_S``, ``phase7``:
  phase 7's full-width train steps.

``phase7`` loses the most, and its traces lose their first records, so
``phase7_padded`` is phase 7 with every ``device_ms`` trace padded by a
sleep of ``PAD_S`` before its first call; and, since the records lost are
the first few whatever the time, ``phase7_lead`` and ``phase8_lead`` are
phases 7 and 8 with
``device_ms``'s lead of throwaway kernels. The other variants trace as
``device_ms`` did before it had a lead (``lead_of``).

Each variant ends with 5 traces of the loop taken by ``trace_clocks`` (the
records a trace holds, and where they lie against the trace's start and
their own launches) and 5 by ``recording_start`` (a tiny kernel every 0.2
ms for 30 ms: how long after its start a trace begins to record).

When every variant runs, then, on the variant that lost traces soonest
(the fewest seconds), each candidate setting of the profiler's library
(``FIXES``: the environment variables kineto reads) in turn. Each variant
also times the host's launch of a tiny kernel (us, 2000 back to back)
before and after its trigger, so a setting's cost on the host shows, and
records what its trigger left behind: the Python threads alive, the OS
threads, the child processes and the sync debug mode. One JSON line per
variant, a table at the end, and everything in
``build/profiler_probe.json``; fails without a card.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

READINGS = 30
SESSIONS = 600
BIG_TRACE = 30000
# the candidate settings of kineto, the profiler's library: CUPTI torn down
# after every trace (its default) or kept; its lazy re-initialisation
FIXES = {"teardown off": {"TEARDOWN_CUPTI": "0"},
         "lazy reinit off": {"DISABLE_CUPTI_LAZY_REINIT": "1"}}
LIGHT = ("fresh", "sessions", "big_trace", "modules", "forkserver", "sync_debug", "traced",
         "gloo", "nccl", "spin")
HEAVY = ("phase5", "phase8", "phase9")
PHASE8 = ("phase8_steps", "det", "det_serial", "det_nosync", "det_traced", "phase8_child")
# phase 8's losses begin after its VQA run: that run alone, the same with
# each device_ms trace opening with a sleep of PAD_S, and phase 7's
# full-width train steps
VQA = ("vqa", "vqa_padded", "phase7", "phase7_padded")
PAD_S = 0.01
# phase 7's traces lose their first records, padded or not: phase 7 and
# phase 8 with chip_smoke.device_ms's lead of throwaway kernels
# (chip_smoke.TRACE_LEAD_KERNELS)
LEAD = ("phase7_lead", "phase8_lead")
VQA_ARGV = ["--epochs", "2", "--verbose", "2"]
STEP_READINGS = 6
# phase 8's first run, and the change each det variant makes to it
DET_ARGV = ["--stage", "DET", "--epochs", "1", "--verbose", "2"]
DET_CHANGES = {"det": {}, "det_serial": {"--num_workers": "1"}, "det_nosync": {"--check_syncs": None},
               "det_traced": {"--trace_dir": "TRACE"}}
ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "profiler_probe.json"
LOGS = ROOT / "build" / "profiler_probe"
VARIANT_TIMEOUT_S = 900


class TinySamples:
    """A feed dataset of 32 samples of a 40000-point cloud (module level:
    the feed's workers receive it pickled)."""

    def __len__(self):
        return 32

    def __getitem__(self, i):
        import numpy as np

        return {"point_clouds": np.full((40000, 4), i, np.float32)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def host_us_per_launch(device, reps: int = 2000) -> float:
    """The host's time to launch a tiny kernel, us a call, back to back."""
    import torch

    x = torch.zeros(16, device=device)
    x.add_(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        x.add_(1.0)
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def gloo_rank(rank: int, world: int, port: int) -> int:
    """One of the ``gloo`` variant's two ranks, on card 0."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    x = torch.randn(2048, 2048, device="cuda:0")
    for _ in range(5):
        y = x @ x
        dist.all_reduce(y)
    torch.cuda.synchronize()
    dist.destroy_process_group()
    return 0


def nccl_rank() -> int:
    """The ``nccl`` variant's process under torchrun: DDP over NCCL at world
    size 1, a few steps."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("nccl")
    model = torch.nn.parallel.DistributedDataParallel(torch.nn.Linear(1024, 1024).cuda(),
                                                      device_ids=[0])
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    for _ in range(5):
        opt.zero_grad()
        model(torch.randn(64, 1024, device="cuda:0")).sum().backward()
        opt.step()
    torch.cuda.synchronize()
    dist.destroy_process_group()
    return 0


def trigger(name: str, device) -> list:
    """What the variant does before its readings. Returns the numbers of
    the variant's own profiler sessions that held no card record."""
    import math

    import torch

    import chip_smoke as cs

    if name == "fresh":
        return []
    if name == "sessions":
        from torch.autograd import DeviceType

        fn, empty = _loop(device), []
        for k in range(SESSIONS):
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(6):
                    fn()
                torch.cuda.synchronize()
            if not any(e.device_type() == DeviceType.CUDA
                       for e in prof.profiler.kineto_results.events()):
                empty.append(k)
        return empty
    if name == "big_trace":
        x = torch.zeros(16, device=device)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            for _ in range(BIG_TRACE):
                x.add_(1.0)
            torch.cuda.synchronize()
        return []
    if name == "modules":
        from bridgeqa_tpu_torch.train.optim import OptimConfig, build_optimizer
        from bridgeqa_tpu_torch.train.step import train_step

        cfg = cs.no_dropout(cs.tiny_config())
        model = cs.build_model(cfg, device, seed=1)
        with torch.inference_mode():
            model(cs.make_batch(cfg, 2, 4096, 64, 20, 6, device), k_test=cfg.num_answers)
        batch = cs.make_train_batch(cfg, 2, 4096, 64, 20, 6, device)
        train_step(model, build_optimizer(model, OptimConfig()), batch)
        torch.cuda.synchronize()
        return []
    if name == "forkserver":
        from bridgeqa_tpu_torch.data.device_feed import device_batches
        from bridgeqa_tpu_torch.data.pipeline import BatchIterator

        feed = BatchIterator(TinySamples(), 4, num_workers=2)
        try:
            for batch in device_batches(feed, device):
                batch["point_clouds"].sum()
        finally:
            feed.shutdown()
        torch.cuda.synchronize()
        return []
    if name == "sync_debug":
        x = torch.zeros(16, device=device)
        for _ in range(3):
            torch.cuda.set_sync_debug_mode("error")
            try:
                x.add_(1.0)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return []
    if name == "traced":
        from bridgeqa_tpu_torch.utils.profiling import maybe_trace

        x = torch.randn(1024, 1024, device=device)
        for step in range(2):
            with maybe_trace(str(cs.OUT_DIR / "profiler_probe_traces"), step=step):
                for _ in range(200):
                    x = torch.tanh(x @ x)
        return []
    if name == "gloo":
        port = _free_port()
        procs = [subprocess.Popen([sys.executable, __file__, "--gloo-rank", str(r), "2",
                                   str(port)], cwd=ROOT) for r in range(2)]
        _wait(procs)
        return []
    if name == "nccl":
        proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                                 "--nproc_per_node", "1", __file__, "--nccl-rank"], cwd=ROOT)
        _wait([proc])
        return []
    if name == "spin":
        cs.queued_ms(_loop(device), 5)
        return []
    if name == "phase5":
        _, scores = cs.phase_main_path(device)
        cs.phase_main_path_f32(device, scores)
        return []
    if name == "phase8":
        cs.phase_drivers(device, math.nan)
        return []
    if name == "phase9":
        cs.phase_parallel(device, math.nan)
        return []
    if name == "phase8_steps":
        from bridgeqa_tpu_torch.scripts import eval as eval_script
        from bridgeqa_tpu_torch.scripts import predict, score, train

        fn = _loop(device)
        originals = {m: m.main for m in (train, predict, eval_script, score)}

        def after(module, label):
            def run(argv):
                out = originals[module](argv)
                step = (label if module is not train else
                        "train " + ("DET" if "DET" in argv else
                                    "resume" if "--use_checkpoint" in argv else "VQA"))
                _steps.append((step, readings(fn, STEP_READINGS, lead_of(name))[0]))
                return out
            return run

        for module, label in ((train, "train"), (predict, "predict"), (eval_script, "eval"),
                              (score, "score")):
            module.main = after(module, label)
        try:
            cs.phase_drivers(device, math.nan)
        finally:
            for module, main in originals.items():
                module.main = main
        return []
    if name in DET_CHANGES:
        from bridgeqa_tpu_torch.scripts import train

        argv = list(cs.DRIVER_ARGS) + ["--device", device.type, "--batch_size",
                                       str(cs.DRIVER_BATCH), "--synthetic_val_records",
                                       str(cs.DRIVER_BATCH), "--synthetic_records",
                                       str(2 * cs.DRIVER_BATCH)] + DET_ARGV
        for flag, value in DET_CHANGES[name].items():
            if flag in argv:
                at = argv.index(flag)
                del argv[at:at + (1 if value is None or argv[at + 1].startswith("--") else 2)]
            if value is not None:
                argv += [flag, str(cs.OUT_DIR / "probe_trace") if value == "TRACE" else value]
        train.main(argv + ["--output_root", str(cs.OUT_DIR / "probe_runs"), "--tag", name])
        return []
    if name in ("vqa", "vqa_padded"):
        from bridgeqa_tpu_torch.scripts import train

        train.main(list(cs.DRIVER_ARGS) + [
            "--device", device.type, "--batch_size", str(cs.DRIVER_BATCH),
            "--synthetic_val_records", str(cs.DRIVER_BATCH), "--synthetic_records",
            str(2 * cs.DRIVER_BATCH)] + VQA_ARGV + [
            "--output_root", str(cs.OUT_DIR / "probe_runs"), "--tag", name])
        return []
    if name in ("phase7", "phase7_padded", "phase7_lead"):
        cs.phase_train(device)
        return []
    if name == "phase8_lead":
        cs.phase_drivers(device, math.nan)
        return []
    if name == "phase8_child":
        code = ("import math, chip_smoke as cs; d = cs.phase_device(); cs.phase_build(); "
                "cs.phase_drivers(d, math.nan)")
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT)
        _wait([proc])
        return []
    raise ValueError(f"unknown variant {name!r}")


def _wait(procs) -> None:
    try:
        for p in procs:
            if p.wait(timeout=VARIANT_TIMEOUT_S) != 0:
                raise RuntimeError(f"{p.args} exited {p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


_loop_args = {}


def _loop(device):
    """The fixed loop's call: the gather's kernel alone at the sa2-like
    bf16 shape (8 tables of 2048 rows of 131 channels, 32768 rows each)."""
    import numpy as np
    import torch

    from bridgeqa_tpu_torch.ops import gather

    if not _loop_args:
        rng = np.random.RandomState(9)
        table = torch.from_numpy(rng.randn(8, 2048, 131).astype(np.float32)).to(device,
                                                                               torch.bfloat16)
        idx = torch.from_numpy(rng.randint(0, 2048, (8, 32768)).astype(np.int32)).to(device)
        _loop_args.update(table=table, idx=idx, out=torch.empty(8, 32768, 131,
                                                                dtype=torch.bfloat16,
                                                                device=device))
    a = _loop_args
    return lambda: gather.launch(a["table"], a["idx"], a["out"])


def run_variant(name: str) -> dict:
    """The variant in this process: its trigger, then ``READINGS``
    readings of the fixed loop."""
    import torch

    import chip_smoke as cs
    from bridgeqa_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    device = cs.phase_device()
    cuda_lib.lib()
    fn = _loop(device)
    host_before = host_us_per_launch(device)
    trigger_empty = trigger(name, device)
    host_after = host_us_per_launch(device)
    lead = lead_of(name)
    lost, failed, times = readings(fn, READINGS, lead)
    clocks = [trace_clocks(fn) for _ in range(5)]
    starts = [recording_start(device) for _ in range(5)]
    return {"variant": name, "lead": "chip_smoke.device_ms's" if lead is None else
            f"{PAD_S} s" if name.endswith("_padded") else "none", "clocks": clocks,
            "recording_start": starts, "env": {k: os.environ.get(k) for fix in FIXES.values() for k in fix},
            "seconds": round(time.perf_counter() - t0, 1), "readings": READINGS,
            "lost_per_reading": lost, "lost_traces": sum(lost), "failed_readings": failed,
            "trigger_empty_sessions": trigger_empty, "steps": _steps,
            "traces_taken": cs.traces_taken,
            "gather_ms_median": sorted(times)[len(times) // 2] if times else None,
            "host_us_per_launch": [round(host_before, 2), round(host_after, 2)],
            "left_behind": left_behind(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "card": cs.card_name_and_power()}


def lead_of(name: str):
    """What opens each of the variant's readings' traces (``device_ms``'s
    ``lead``): ``device_ms``'s own throwaway kernels for the ``_lead``
    variants, a sleep of ``PAD_S`` for the ``_padded`` ones, else nothing
    (how ``device_ms`` traced before it had a lead)."""
    if name.endswith("_lead"):
        return None
    if name.endswith("_padded"):
        return lambda: (time.sleep(PAD_S), 0)[1]
    return lambda: 0


def readings(fn, count: int, lead) -> tuple[list, int, list]:
    """``count`` readings of ``fn`` by ``chip_smoke.device_ms`` with
    ``lead`` and without its throwaway trace (which came after these
    variants), each after 3 unprofiled calls of the gather's plain version:
    the traces each lost, the readings that failed, the readings' ms."""
    import torch

    import chip_smoke as cs
    from bridgeqa_tpu_torch.ops import gather

    a = _loop_args
    lost, failed, times = [], 0, []
    for _ in range(count):
        for _ in range(3):  # unprofiled work between readings, as in chip_smoke.py's rows
            gather.gather_rows_plain(a["table"], a["idx"])
        torch.cuda.synchronize()
        before = len(cs.dropped_traces)
        try:
            times.append(cs.device_ms(fn, 5, lead, throwaway=False))
        except RuntimeError:
            failed += 1
        lost.append(len(cs.dropped_traces) - before)
    return lost, failed, times


def trace_clocks(fn, reps: int = 5) -> dict:
    """One trace of the fixed loop (as device_ms takes it, unpadded): its
    launches and card records, and where the records lie in ns against the
    trace's start and their own launches (a record's start minus its
    launch's, matched by correlation id)."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps + 1):
            fn()
        torch.cuda.synchronize()
    results = prof.profiler.kineto_results
    start, events = results.trace_start_ns(), results.events()
    launches = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() == DeviceType.CPU and e.name().startswith("cudaLaunchKernel")}
    cards = [e for e in events if e.device_type() == DeviceType.CUDA]
    lag = [e.start_ns() - launches[e.correlation_id()] for e in cards
           if e.correlation_id() in launches]
    return {"launches": len(launches), "records": len(cards),
            "launch_span_ns": ([min(launches.values()) - start, max(launches.values()) - start]
                               if launches else None),
            "record_span_ns": ([min(e.start_ns() for e in cards) - start,
                                max(e.end_ns() for e in cards) - start] if cards else None),
            "record_minus_launch_ns": [min(lag), max(lag)] if lag else None}


def recording_start(device, launches: int = 150, gap_s: float = 2e-4) -> dict:
    """A trace of ``launches`` tiny kernels, one every ``gap_s`` from the
    trace's start: the kernels the trace recorded, and the ms from its start
    to the launch of the first one recorded (how long the profiler took to
    begin recording)."""
    import torch
    from torch.autograd import DeviceType

    x = torch.zeros(16, device=device)
    x.add_(1.0)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(launches):
            while time.perf_counter() - t0 < k * gap_s:
                pass
            x.add_(1.0)
        torch.cuda.synchronize()
    results = prof.profiler.kineto_results
    start, events = results.trace_start_ns(), results.events()
    launched = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() == DeviceType.CPU and e.name().startswith("cudaLaunchKernel")}
    recorded = [launched[e.correlation_id()] for e in events
                if e.device_type() == DeviceType.CUDA and e.correlation_id() in launched]
    return {"launched": len(launched), "recorded": len(recorded),
            "first_recorded_launch_ms": (min(recorded) - start) / 1e6 if recorded else None,
            "first_launch_ms": (min(launched.values()) - start) / 1e6 if launched else None}


def left_behind() -> dict:
    """What runs in this process beside the main thread, and its sync debug
    mode."""
    import multiprocessing
    import threading

    import torch

    return {"python_threads": sorted(t.name for t in threading.enumerate()),
            "os_threads": len(os.listdir("/proc/self/task")),
            "children": len(multiprocessing.active_children()),
            "sync_debug_mode": torch.cuda.get_sync_debug_mode()}


# each driver run's losses in phase8_steps: (run, lost traces of its readings)
_steps = []


def spawn(name: str, env: dict, tag: str) -> dict:
    """The variant in a fresh process, with ``env`` added; its output in
    ``build/profiler_probe/<tag>.log``."""
    proc = subprocess.run([sys.executable, __file__, name], cwd=ROOT, capture_output=True,
                          text=True, timeout=VARIANT_TIMEOUT_S, env={**os.environ, **env})
    LOGS.mkdir(parents=True, exist_ok=True)
    (LOGS / f"{tag}.log").write_text(proc.stdout + proc.stderr)
    lines = [line for line in proc.stdout.splitlines() if line.startswith('{"variant"')]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"variant {name} {env} exited {proc.returncode}:\n"
                           f"{(proc.stdout + proc.stderr)[-3000:]}")
    return json.loads(lines[-1])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probe reads the card's profiler")
    only = sys.argv[2:] if sys.argv[1:2] == ["--only"] else None
    results = []
    for name in only or LIGHT + HEAVY + PHASE8 + VQA + LEAD:
        results.append(spawn(name, {}, name))
        print(json.dumps(results[-1]), flush=True)
    lossy = sorted((r for r in results if r["lost_traces"]), key=lambda r: r["seconds"])
    for r in ([] if only else lossy[:1]):
        for fix, env in FIXES.items():
            results.append(dict(spawn(r["variant"], env, f"{r['variant']}, {fix}"), fix=fix))
            print(json.dumps(results[-1]), flush=True)
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(results, indent=1))
    print(f"{'variant':<14} {'fix':<16} {'s':>6} {'lost':>5} {'failed':>6} "
          f"{'host us before/after':>22}  lost per reading")
    for r in results:
        print(f"{r['variant']:<14} {r.get('fix', '-'):<16} {r['seconds']:>6} "
              f"{r['lost_traces']:>5} {r['failed_readings']:>6} "
              f"{str(r['host_us_per_launch']):>22}  {''.join(map(str, r['lost_per_reading']))}")
        for step, lost in r["steps"]:
            print(f"    after {step:<14} lost per reading {''.join(map(str, lost))}")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-rank"]:
        sys.exit(gloo_rank(*map(int, sys.argv[2:5])))
    if sys.argv[1:2] == ["--nccl-rank"]:
        sys.exit(nccl_rank())
    if len(sys.argv) > 1 and sys.argv[1] != "--only":
        print(json.dumps(run_variant(sys.argv[1])), flush=True)
        sys.exit(0)
    sys.exit(main())
