#!/usr/bin/env python3
"""Time the port's train loop with and without its data feed, in turns, in
one process on one CUDA card.

    python3 feed_variants.py

The configuration of ``chip_smoke.py`` phase 8's VQA stage: the ``train``
script's full-width model (``--synthetic --bf16 --remat``, batch 16, random
weights from seed 0), ``build_optimizer``, the config's dropout from a
seeded generator, BN momentum 0.5, and its synthetic dataset (4 scenes of
40000 points, 480 px images, ``per_sample`` rng). Each variant is one epoch
of 3 steps (or 3 batches), timed by the host clock from its start to a
``torch.cuda.synchronize()`` after its last step, so it holds the epoch's
first fetch as the script's loop does:

- "resident": 3 ``train_step`` calls on one batch already on the card;
- "loop, 2 workers": 3 steps on the feed's batches (``device_batches`` over
  a ``BatchIterator`` with two worker processes), as the ``train`` script runs;
- "loop, serial": the same with the feed's one build thread in this process;
- "loop, host batches": 3 steps on 3 numpy batches built beforehand, through
  ``device_batches`` (its pin thread and copies, no assembly);
- "loop, 2 workers, sync check": "loop, 2 workers" with each fetch and step
  under ``torch.cuda.set_sync_debug_mode("error")``, as ``train
  --check_syncs`` runs them;
- "solver epoch": one epoch of ``train.solver.Solver`` over the 2-worker
  feed (its log point's metric read included, no validation, no
  checkpoint);
- "feed, 2 workers" and "feed, serial": the feed alone, 3 batches onto the
  card and no step.

In each of 3 rounds (the order reversed every other round) every variant
runs once and prints one JSON line (samples/s, seconds); the fetch and step
host times of the loop variants come from ``PhaseTimer``. Then one step
runs under ``torch.profiler`` (as ``chip_smoke.py`` phase 7 profiles one),
and "resident" and "loop, 2 workers" run twice more, marked
``after_profile``: whether a finished trace leaves the host slower. Comparing them in
one process takes the host's drift between processes out of the
comparison. Fails without a card.
"""

import json
import time

import torch

import chip_smoke as cs

ROUNDS = 3
STEPS = 3
BATCH = 16


def main() -> int:
    device = cs.phase_device()
    cs.phase_build()
    from bridgeqa_tpu_torch.data.device_feed import device_batches
    from bridgeqa_tpu_torch.data.pipeline import BatchIterator
    from bridgeqa_tpu_torch.scripts import common, train
    from bridgeqa_tpu_torch.train import solver as solver_module
    from bridgeqa_tpu_torch.train.optim import build_optimizer
    from bridgeqa_tpu_torch.train.step import train_step
    from bridgeqa_tpu_torch.utils.profiling import PhaseTimer

    args = train.parse_args(["--synthetic", "--bf16", "--remat", "--batch_size", str(BATCH),
                             "--num_workers", "2", "--synthetic_records", str(STEPS * BATCH)])
    datasets, _, answers, _ = common.build_datasets(args, splits=("train",))
    model, _, _ = common.build_model(args, num_answers=len(answers), device=device, seed=0)
    optimizer = build_optimizer(model)
    gen = torch.Generator(device=device).manual_seed(2)
    loaders = {"2 workers": BatchIterator(datasets["train"], BATCH, seed=0, num_workers=2),
               "serial": BatchIterator(datasets["train"], BATCH, seed=0, num_workers=1)}
    host_batches = []
    for batch in loaders["serial"]:
        host_batches.append(batch)
        if len(host_batches) == STEPS:
            break
    resident = next(device_batches(host_batches[:1], device))
    timer = PhaseTimer()

    def step(batch):
        with timer.phase("step"):
            return train_step(model, optimizer, batch, bn_momentum=0.5, generator=gen)

    def loop(loader, check_syncs=False):
        feed = device_batches(loader, device)
        try:
            for _ in range(STEPS):
                with solver_module._sync_errors(check_syncs):
                    with timer.phase("fetch"):
                        batch = next(feed)
                    step(batch)
        finally:
            feed.close()

    solver = solver_module.Solver(
        model, optimizer, None, solver_module.StepConfig(),
        solver_module.SolverConfig(epochs=1, val_step=0, verbose_step=STEPS), device=device,
        run_dir=str(cs.OUT_DIR / "feed_variants_run"))

    def feed_alone(loader):
        for batch in device_batches(loader, device):
            pass

    variants = {"resident": lambda: [step(resident) for _ in range(STEPS)],
                "loop, 2 workers": lambda: loop(loaders["2 workers"]),
                "loop, serial": lambda: loop(loaders["serial"]),
                "loop, host batches": lambda: loop(host_batches),
                "loop, 2 workers, sync check": lambda: loop(loaders["2 workers"], True),
                "solver epoch": lambda: solver._train_epoch(loaders["2 workers"], None, 0, gen),
                "feed, 2 workers": lambda: feed_alone(loaders["2 workers"]),
                "feed, serial": lambda: feed_alone(loaders["serial"])}
    def timed(r, name, **extra):
        timer.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        variants[name]()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        print(json.dumps({"round": r, "variant": name, **extra, "seconds": round(seconds, 3),
                          "samples_per_s": round(STEPS * BATCH / seconds, 2),
                          **{f"{k}_ms": round(v * 1e3, 1) for k, v in timer.means().items()}}),
              flush=True)

    try:
        for run in variants.values():  # warm-up: the pool's start, the first steps
            run()
        torch.cuda.synchronize()
        for r in range(ROUNDS):
            for name in list(variants) if r % 2 == 0 else list(reversed(variants)):
                timed(r, name)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            step(resident)
            torch.cuda.synchronize()
        for r in range(ROUNDS, ROUNDS + 2):
            for name in ("resident", "loop, 2 workers"):
                timed(r, name, after_profile=True)
    finally:
        for loader in loaders.values():
            loader.shutdown()
    print(cs.card_name_and_power())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
