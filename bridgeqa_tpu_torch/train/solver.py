"""Training orchestrator: epoch/iter loop, in-loop validation, best-ckpt
(counterpart of ``bridgeqa_tpu/train/solver.py``).

Equivalent of the reference ``lib/solver.py`` (``Solver.__call__``,
288-757), over the port's ``train_step`` and ``eval_step``
(``train/step.py``):

- the loop issues each step's work to the card and never waits for it
  between log points: batches arrive through ``data.device_feed`` (pinned,
  non-blocking copies), and each step's metrics stay on the card, detached,
  until the logging interval reads them all at once (JAX's lazy fetch,
  ``solver.py:142-146``);
- validation every ``val_step`` iters (``solver.py:585-591``) with
  best-checkpoint selection on ``cur_criterion`` (598-610), falling back to
  ``-loss`` when the criterion is absent; validation runs its forwards in
  eval mode without grad, the fused kernels' gates;
- checkpoints: best weights, per-epoch last, resumable full state
  (= model.pth / model_last.pth / checkpoint.tar, 659-695);
- BN momentum schedule (0.5 -> x0.5 every ``bn_decay_step`` epochs,
  clamped at ``bn_momentum_min`` — ``pytorch_utils.BNMomentumScheduler``),
  passed to ``train_step(bn_momentum=...)``;
- dropout draws from one ``torch.Generator`` on the model's device, handed
  to the call (JAX splits a key per epoch and per step);
- ``KeyboardInterrupt`` checkpoints and exits cleanly (323-326).

``SolverConfig.check_syncs`` runs each fetch and step on a CUDA device
under ``torch.cuda.set_sync_debug_mode("error")``: a host sync between log
points raises where it happens.

Data parallelism (``--distributed``): ``model`` may be a
``DistributedDataParallel``; each rank trains on its loader's shard and the
step's losses and metrics cover the global batch (``parallel.global_batch``).
Validation runs on each rank's shard; the logged metrics and the
best-checkpoint criterion are means over every rank's batches
(``global_mean``, the JAX ``_global_mean``), so every rank takes the same
decision, and ``predictions.csv`` holds every rank's rows (gathered as the
reference's ``all_gather_object`` gathers them; the JAX solver writes rank
0's shard alone). Every rank calls the savers; rank 0 writes
(``train/checkpoints.py``).
"""

import contextlib
import csv
import dataclasses
import itertools
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from bridgeqa_tpu_torch.data.device_feed import device_batches
from bridgeqa_tpu_torch.parallel.global_batch import gather_rows, global_mean
from bridgeqa_tpu_torch.parallel.mesh import data_size, is_main_process
from bridgeqa_tpu_torch.train import checkpoints
from bridgeqa_tpu_torch.train.step import StepConfig, eval_step, train_step
from bridgeqa_tpu_torch.utils.logging_utils import EpochETA, RunLogger, RunningMeans
from bridgeqa_tpu_torch.utils.profiling import PhaseTimer, maybe_trace

ITER_REPORT = ("loss", "vote_loss", "objectness_loss", "box_loss", "sem_cls_loss",
               "ref_loss", "lang_loss", "answer_loss")


@dataclasses.dataclass
class SolverConfig:
    epochs: int = 30
    val_step: int = 2000            # in-loop val every N iters (0 = per-epoch only)
    verbose_step: int = 50          # log running means every N iters
    cur_criterion: str = "answer_acc_at1"
    criterion_higher_better: bool = True
    bn_momentum_init: float = 0.5
    bn_decay_step: int = 20
    bn_decay_rate: float = 0.5
    bn_momentum_min: float = 0.001
    k_test: int = 256
    max_iters_per_epoch: int = 0    # 0 = full epoch (tests cap this)
    trace_dir: str | None = None
    check_syncs: bool = False       # a host sync between log points raises


@contextlib.contextmanager
def _sync_errors(enabled: bool):
    if not enabled:
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


class Solver:
    def __init__(self, model, optimizer, dataset_config, step_cfg: StepConfig,
                 solver_cfg: SolverConfig, *, device, run_dir="runs/debug",
                 logger: RunLogger | None = None,
                 eval_metrics_fn: Callable[[dict, Any], dict] | None = None,
                 extra_eval_inputs: dict | None = None,
                 predictions_fn: Callable[[dict, Any], list] | None = None):
        """model: a ``BridgeQA`` on ``device``, or a
        ``DistributedDataParallel`` of one; optimizer: the
        ``build_optimizer`` of it. eval_metrics_fn(end_points, batch) ->
        scalar metrics dict (tensors) for validation (default: loss-only).
        extra_eval_inputs: arrays merged into every eval batch (e.g. the
        tokenized answer list for ranking). predictions_fn(end_points,
        batch) -> list of per-sample dicts; collected each validation pass
        and dumped to ``predictions.csv`` when the criterion improves (the
        reference's best-val CSV, ``solver.py:623-656``).
        """
        self.model = model
        self.module = getattr(model, "module", model)  # what DDP wraps
        self.optimizer = optimizer
        self.dataset_config = dataset_config
        self.step_cfg = step_cfg
        self.cfg = solver_cfg
        self.device = torch.device(device)
        self.run_dir = run_dir
        self.log = logger or RunLogger(run_dir)
        self.eval_metrics_fn = eval_metrics_fn
        self.extra_eval_inputs = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                                  for k, v in (extra_eval_inputs or {}).items()}
        self.predictions_fn = predictions_fn
        self.best_criterion = -np.inf if solver_cfg.criterion_higher_better else np.inf
        self.best_epoch = -1
        self.global_iter = 0
        self.timer = PhaseTimer()

    # --- schedules ------------------------------------------------------
    def bn_momentum(self, epoch: int) -> float:
        c = self.cfg
        m = c.bn_momentum_init * (c.bn_decay_rate ** (epoch // c.bn_decay_step))
        return max(m, c.bn_momentum_min)

    # --- main loop ------------------------------------------------------
    def __call__(self, train_loader, val_loader=None, *, generator: torch.Generator | None = None,
                 start_epoch: int = 0):
        """Train from ``start_epoch`` to ``cfg.epochs``; dropout draws from
        ``generator`` (on the model's device). An interrupt saves the
        resumable state at the epoch it stopped in, so a resume runs that
        epoch again."""
        epoch = start_epoch
        try:
            for epoch in range(start_epoch, self.cfg.epochs):
                self._train_epoch(train_loader, val_loader, epoch, generator)
                checkpoints.save_params(self.run_dir, "model_last", self.module)
                checkpoints.save_train_state(self.run_dir, self.module, self.optimizer, epoch + 1)
        except KeyboardInterrupt:
            self.log.info("interrupted — saving resumable checkpoint")
            checkpoints.save_train_state(self.run_dir, self.module, self.optimizer, epoch)
            raise

    def _train_epoch(self, train_loader, val_loader, epoch, generator):
        cfg = self.cfg
        bn_m = self.bn_momentum(epoch)
        n_iters = len(train_loader)
        if cfg.max_iters_per_epoch:
            n_iters = min(n_iters, cfg.max_iters_per_epoch)
        eta = EpochETA(n_iters)
        means = RunningMeans()
        pending = []  # the steps' metric tensors, read at the log interval
        self.log.info(f"epoch {epoch + 1}/{cfg.epochs} start (bn_momentum={bn_m:.4f}, "
                      f"{n_iters} iters)")

        feed = device_batches(train_loader, self.device)
        t_log, steps_since_log = time.perf_counter(), 0
        try:
            for i in range(n_iters):
                with maybe_trace(cfg.trace_dir, step=self.global_iter) as trace:
                    with _sync_errors(cfg.check_syncs and self.device.type == "cuda"):
                        with self.timer.phase("fetch"):
                            batch = next(feed, None)
                        if batch is None:
                            break
                        with self.timer.phase("step"):
                            metrics = train_step(self.model, self.optimizer, batch,
                                                 bn_momentum=bn_m, generator=generator,
                                                 step_cfg=self.step_cfg,
                                                 dataset_config=self.dataset_config)
                if trace is not None:
                    self.log.info(f"traced step {self.global_iter}: {trace.device_ms:.1f} ms of "
                                  f"card time in {trace.wall_ms:.1f} ms (busy {trace.busy:.0%}) "
                                  f"-> {trace.path}")
                    self.log.scalars(self.global_iter, "trace",
                                     {"wall_ms": trace.wall_ms, "device_ms": trace.device_ms,
                                      "busy": trace.busy})
                pending.append(metrics)
                eta.tick()
                self.global_iter += 1
                steps_since_log += 1

                if (i + 1) % cfg.verbose_step == 0 or i + 1 == n_iters:
                    self._log_train(epoch, i, n_iters, pending, means, eta, steps_since_log,
                                    t_log, batch["point_clouds"].shape[0] * data_size())
                    pending.clear()
                    t_log, steps_since_log = time.perf_counter(), 0

                if val_loader is not None and cfg.val_step and self.global_iter % cfg.val_step == 0:
                    self._validate(val_loader, epoch)
                    t_log = time.perf_counter()
        finally:
            feed.close()

        if val_loader is not None:
            self._validate(val_loader, epoch)

    def _log_train(self, epoch, i, n_iters, pending, means, eta, steps, t_log, batch_size):
        """Read the pending steps' metrics (the one wait for the card between
        log points) and log their means, the phase times and the loop's
        samples/s since ``t_log`` (the last log point), the read included;
        ``batch_size`` is the global batch."""
        stacked = {k: torch.stack([m[k] for m in pending]).float().cpu().numpy()
                   for k in pending[0]}
        seconds = time.perf_counter() - t_log
        for j in range(len(pending)):
            means.update({k: v[j] for k, v in stacked.items()})
        phase_means = self.timer.means()
        self.log.info(
            f"e{epoch + 1} it{i + 1}/{n_iters} | {means.format(ITER_REPORT)} | "
            + ", ".join(f"{k} {v * 1e3:.0f}ms" for k, v in phase_means.items())
            + f" | eta {eta.format()}"
        )
        self.log.scalars(self.global_iter, "train", means.means())
        self.log.scalars(self.global_iter, "timing",
                         {**{f"{k}_ms": v * 1e3 for k, v in phase_means.items()},
                          "samples_per_s": steps * batch_size / seconds})
        means.reset()
        self.timer.reset()

    # --- validation -----------------------------------------------------
    @torch.no_grad()
    def _validate(self, val_loader, epoch):
        cfg = self.cfg
        t0 = time.time()
        agg = RunningMeans()
        preds = []
        # every rank takes its loader's length in batches, so that the ranks'
        # collectives pair up when the shards differ by a record
        for batch in itertools.islice(device_batches(val_loader, self.device), len(val_loader)):
            batch.update(self.extra_eval_inputs)
            end_points = eval_step(self.module, batch, k_test=cfg.k_test, step_cfg=self.step_cfg,
                                   dataset_config=self.dataset_config)
            scalars = {"loss": end_points["loss"]}
            if self.eval_metrics_fn is not None:
                scalars.update(self.eval_metrics_fn(end_points, batch))
            agg.update({k: float(v) for k, v in scalars.items()})
            if self.predictions_fn is not None:
                preds.extend(self.predictions_fn(end_points, batch))
        # means over every rank's batches (identity on one process)
        counts = {k: agg.sum_count(k)[1] for k in agg.means()}
        val_metrics = {k: self._global_mean(*agg.sum_count(k)) for k in sorted(counts)}
        shown = ", ".join(f"{k}: {v:.4f}" for k, v in val_metrics.items())
        self.log.info(f"val @ epoch {epoch + 1}: {shown}  ({time.time() - t0:.1f}s)")
        self.log.scalars(self.global_iter, "val", val_metrics)

        key = cfg.cur_criterion if cfg.cur_criterion in val_metrics else "loss"
        crit = val_metrics.get(key, 0.0)
        if key != cfg.cur_criterion:  # fallback: criterion absent -> -loss
            crit = -crit if counts.get(key) else -np.inf
        better = crit > self.best_criterion if cfg.criterion_higher_better else crit < self.best_criterion
        if better:
            self.best_criterion = crit
            self.best_epoch = epoch
            self.log.info(f"new best {cfg.cur_criterion}={crit:.4f} — saving model")
            checkpoints.save_params(self.run_dir, "model", self.module)
            preds = gather_rows(preds)
            if preds and is_main_process():
                self._write_predictions_csv(preds)

    def _global_mean(self, local_sum, local_count):
        """Cross-rank mean of a (sum, count) pair (JAX's
        ``Solver._global_mean``); identity on one process. Every rank gets
        the same value, so every rank takes the same best-checkpoint
        decision."""
        return global_mean(local_sum, local_count, self.device)

    def _write_predictions_csv(self, preds):
        path = os.path.join(self.run_dir, "predictions.csv")
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=sorted(preds[0].keys()))
            writer.writeheader()
            writer.writerows(preds)
        self.log.info(f"wrote {len(preds)} best-val predictions -> predictions.csv")
