"""Run logging, running means, and ETA estimation.

Equivalent of the reference's ``utils/logger.py`` + ``utils/eta.py`` +
the iter/epoch report templates in ``lib/solver.py:27-116`` — rebuilt as a
small dependency-free module (no colorama/tensorboardX): scalar history is
kept in memory and flushed to ``log.txt`` and a JSONL metrics stream that
any dashboard can tail.

A copy of ``bridgeqa_tpu/utils/logging_utils.py``, kept in the port because the port imports
nothing of the JAX package; ``tests/test_torch_drivers.py`` holds the two equal.
"""

import json
import os
import sys
import time


class RunLogger:
    """Writes human-readable lines to stdout + ``log.txt`` and structured
    scalars to ``metrics.jsonl`` under the run directory.

    Optional sinks (the reference's tensorboardX/wandb logging,
    ``lib/solver.py:216-222,663-675``): ``tensorboard=True`` writes TB event
    files under ``run_dir/tb`` (tensorboardX, baked into the image);
    ``wandb=True`` initializes a wandb run if the package is installed
    (gated — not available offline)."""

    def __init__(self, run_dir, *, stdout=True, filename="log.txt",
                 tensorboard=False, wandb=False, wandb_kwargs=None):
        self.run_dir = run_dir
        self.stdout = stdout
        os.makedirs(run_dir, exist_ok=True)
        self._log_path = os.path.join(run_dir, filename)
        self._metrics_path = os.path.join(run_dir, "metrics.jsonl")
        self._log_f = open(self._log_path, "a")
        self._metrics_f = open(self._metrics_path, "a")
        self._tb = None
        self._wandb = None
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(os.path.join(run_dir, "tb"))
            except ImportError:
                self.info("tensorboardX not installed; TB sink disabled")
        if wandb:
            try:
                import wandb as _wandb

                self._wandb = _wandb
                _wandb.init(dir=run_dir, **(wandb_kwargs or {}))
            except ImportError:
                self.info("wandb not installed; wandb sink disabled")

    def info(self, msg: str):
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        line = f"[{stamp}] {msg}"
        if self.stdout:
            print(line, file=sys.stderr)
        self._log_f.write(line + "\n")
        self._log_f.flush()

    def scalars(self, step: int, phase: str, values: dict):
        rec = {"step": int(step), "phase": phase}
        rec.update({k: float(v) for k, v in values.items()})
        self._metrics_f.write(json.dumps(rec) + "\n")
        self._metrics_f.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(f"{phase}/{k}", float(v), int(step))
        if self._wandb is not None:
            self._wandb.log({f"{phase}/{k}": float(v) for k, v in values.items()},
                            step=int(step))

    def close(self):
        self._log_f.close()
        self._metrics_f.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


class RunningMeans:
    """Running means of a metric dict (per phase), like the reference's
    per-iter running loss/time reports."""

    def __init__(self):
        self._sums = {}
        self._counts = {}

    def update(self, values: dict):
        for k, v in values.items():
            self._sums[k] = self._sums.get(k, 0.0) + float(v)
            self._counts[k] = self._counts.get(k, 0) + 1

    def means(self) -> dict:
        return {k: self._sums[k] / max(self._counts[k], 1) for k in self._sums}

    def sum_count(self, key) -> tuple:
        """(sum, count) for one metric — the reducible form for
        cross-process (multi-host) aggregation."""
        return self._sums.get(key, 0.0), self._counts.get(key, 0)

    def reset(self):
        self._sums.clear()
        self._counts.clear()

    def format(self, keys=None, fmt="{:.4f}") -> str:
        means = self.means()
        keys = keys if keys is not None else sorted(means)
        return ", ".join(f"{k}: {fmt.format(means[k])}" for k in keys if k in means)


class EpochETA:
    """ETA from mean per-iter wall time (``utils/eta.py`` semantics)."""

    def __init__(self, total_iters: int):
        self.total = total_iters
        self.done = 0
        self.start = time.time()

    def tick(self, n: int = 1):
        self.done += n

    @property
    def seconds_left(self) -> float:
        if self.done == 0:
            return float("inf")
        per_iter = (time.time() - self.start) / self.done
        return per_iter * (self.total - self.done)

    def format(self) -> str:
        s = self.seconds_left
        if s == float("inf"):
            return "??:??:??"
        s = int(s)
        return f"{s // 3600:02d}:{(s % 3600) // 60:02d}:{s % 60:02d}"
