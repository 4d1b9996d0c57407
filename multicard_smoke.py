#!/usr/bin/env python3
"""The ``train`` driver at full width on the cards of one host, one
configuration after another, each under ``python -m torch.distributed.run``:

    python3 multicard_smoke.py            # every card the host has
    python3 multicard_smoke.py --cards 4

1. one card (``--nproc_per_node 1``: NCCL at world size 1, DDP);
2. every card data-parallel (``--nproc_per_node N``, global batch 16 x N);
3. every card as ``N / 2`` data-parallel pairs of ``--tp 2`` (global batch
   16 x N / 2).

Each runs ``train --distributed --synthetic --bf16 --remat --check_syncs``
(phase 7's configuration, batch 16 a rank, two feed workers a rank) for one
epoch of 4 steps and a validation, and must exit 0 (``--check_syncs``: no
host sync between log points). Read from each run's ``metrics.jsonl``: the
loop's samples/s over the global batch at each log point (every 2 steps:
the first holds the feed's start, the second is the one compared), the
feed's fetch and the step's host time. One JSON line a configuration, the
card's name and power limit beside them. Needs CUDA cards; fails without.
"""

import argparse
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
OUT = REPO / "build" / "multicard"  # listed in .gitignore
BATCH = 16
STEPS = 4
ARGS = ["--distributed", "--synthetic", "--bf16", "--remat", "--check_syncs", "--num_workers",
        "2", "--batch_size", str(BATCH), "--seed", "0", "--val_step", "0", "--verbose", "2",
        "--epochs", "1"]


def card_name_and_power() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return "; ".join(sorted(set(smi.splitlines())))


def run(name: str, cards: int, tp: int) -> dict:
    data = cards // tp
    tag_dir = OUT / name
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(cards), "-m", "bridgeqa_tpu_torch.scripts.train", *ARGS, "--tp", str(tp),
           "--synthetic_records", str(BATCH * data * STEPS),
           "--synthetic_val_records", str(BATCH * data), "--output_root", str(OUT),
           "--tag", name]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=1800)
    seconds = time.perf_counter() - t0
    (OUT / f"{name}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{name} exited {proc.returncode}:\n"
                           f"{(proc.stdout + proc.stderr)[-5000:]}")
    records = [json.loads(line) for line in (tag_dir / "metrics.jsonl").read_text().splitlines()]
    timing = [r for r in records if r["phase"] == "timing"]
    losses = [r["loss"] for r in records if r["phase"] == "train"]
    if len(timing) != STEPS // 2 or not all(map(math.isfinite, losses)):
        raise RuntimeError(f"{name}: timing records {timing}, losses {losses}")
    return {"config": name, "cards": cards, "data_parallel": data, "tp": tp,
            "global_batch": BATCH * data, "samples_per_s": [r["samples_per_s"] for r in timing],
            "fetch_ms": [r["fetch_ms"] for r in timing], "step_ms": [r["step_ms"] for r in timing],
            "losses": losses, "seconds": round(seconds, 1)}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cards", type=int, default=None, help="default: every card of the host")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the distributed driver runs on the cards")
    cards = args.cards or torch.cuda.device_count()
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    print(f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
          f"{card_name_and_power()}; torch {torch.__version__}", flush=True)
    configs = [("1card", 1, 1), (f"{cards}card_dp", cards, 1)]
    if cards >= 2 and cards % 2 == 0:
        configs.append((f"{cards}card_dp_tp2", cards, 2))
    for name, n, tp in configs:
        print(json.dumps(run(name, n, tp)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
