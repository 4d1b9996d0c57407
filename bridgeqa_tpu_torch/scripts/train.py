"""Train BridgeQA with the PyTorch port (DET pretraining or VQA stage).

Counterpart of ``scripts/train.py`` (the reference's argparse surface
40-179, 3-group AdamW routing 385-417, Solver hookup). Run metadata
(``info.json``, ``answer_vocab.json``, ``cmdline.txt``) is written like
``train.py:495-512`` so predict/eval can replay the configuration. The
weights are drawn from ``--seed``, dropout from a generator on the device
seeded with ``--seed + 2`` (and the data-parallel rank).

Demo (no ScanNet), on the CPU:
``python -m bridgeqa_tpu_torch.scripts.train --synthetic --tiny --epochs 1 --device cpu``

Several processes (``--distributed``, under ``python -m torch.distributed.run
--nproc_per_node N``): each rank joins torchrun's process group
(``parallel.mesh.initialize_distributed``; NCCL on the cards, gloo with
``--device cpu``) and its ``LOCAL_RANK``'s card, and the ranks form a
``(data, model)`` mesh with ``--tp`` on the model axis. ``--batch_size`` is
per rank: the global batch is ``batch_size * world / tp``, the loaders are
sharded by data-parallel rank, and the model is wrapped in
``DistributedDataParallel`` over the data axis (``find_unused_parameters``,
as the reference sets it). BatchNorm statistics, losses and metrics cover
the global batch (``parallel/global_batch.py``). ``--tp > 1`` shards the
transformer products Megatron-style (``parallel/tp.py``); checkpoints hold
the unsharded layout either way. Only rank 0 writes the run's files; the
other ranks log under ``<run>/rank<r>/``.
"""

import argparse
import os
import sys

import torch

from bridgeqa_tpu_torch.data.tokenization import make_answer_list
from bridgeqa_tpu_torch.eval.qa_eval import get_eval
from bridgeqa_tpu_torch.parallel import mesh as pmesh
from bridgeqa_tpu_torch.scripts import common
from bridgeqa_tpu_torch.train import checkpoints
from bridgeqa_tpu_torch.train.optim import OptimConfig, build_optimizer
from bridgeqa_tpu_torch.train.solver import Solver, SolverConfig
from bridgeqa_tpu_torch.train.step import StepConfig
from bridgeqa_tpu_torch.utils.logging_utils import RunLogger

DROPOUT_SEED_STRIDE = 1_000_003
SCALAR_EVAL_KEYS = ("ref_acc_mean", "ref_iou_rate_0.25", "ref_iou_rate_0.5", "lang_acc",
                    "obj_acc", "sem_acc", "answer_acc_at1", "answer_acc_at10",
                    "answer_acc_at1_scene", "answer_acc_at1_2d", "answer_acc_at1_2d3d")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(p)
    common.add_data_args(p)
    p.add_argument("--tag", type=str, default="debug")
    p.add_argument("--output_root", type=str, default="runs")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--lr_blip", type=float, default=1e-4)
    p.add_argument("--lr_blip3d", type=float, default=1e-4)
    p.add_argument("--wd", type=float, default=1e-5)
    p.add_argument("--lr_decay_step", type=int, nargs="+", default=[100, 200])
    p.add_argument("--lr_decay_step_2d", type=int, nargs="+", default=[100, 200])
    p.add_argument("--lr_decay_rate", type=float, default=0.2)
    p.add_argument("--scheduler_type", type=str, default="step",
                   choices=["step", "step_except_2d", "linear", "cosine", "none"])
    p.add_argument("--val_step", type=int, default=2000)
    p.add_argument("--verbose", type=int, default=50)
    p.add_argument("--cur_criterion", type=str, default="answer_acc_at1")
    p.add_argument("--max_iters_per_epoch", type=int, default=0)
    p.add_argument("--k_test", type=int, default=256)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel size: the mesh's model axis (needs --distributed "
                        "and must divide the world size)")
    p.add_argument("--distributed", action="store_true",
                   help="one process per rank under torchrun (python -m "
                        "torch.distributed.run); batch_size is PER RANK")
    p.add_argument("--use_checkpoint", type=str, default=None,
                   help="run dir to resume from (checkpoint.tar equivalent)")
    p.add_argument("--first_stage_ckpt_path", type=str, default=None,
                   help="DET-stage run dir: load detector weights")
    p.add_argument("--trace_dir", type=str, default=None,
                   help="trace every step with torch.profiler into this directory")
    p.add_argument("--check_syncs", action="store_true",
                   help="on a CUDA device, raise at any host sync between log points")
    p.add_argument("--tensorboard", action="store_true",
                   help="also write TB event files under <run>/tb (tensorboardX)")
    p.add_argument("--wandb", action="store_true",
                   help="log scalars to wandb (no-op if wandb is not installed)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.tp > 1 and not args.distributed:
        raise ValueError("--tp > 1 shards over ranks: run under torchrun with --distributed")
    device = common.resolve_device(args.device)
    if args.distributed:
        # replaces the reference's torchrun + NCCL env:// init (train.py:181-187)
        device = pmesh.initialize_distributed(device=args.device)
        pmesh.make_mesh(model=args.tp)
    rank, dp_rank, dp_size = pmesh.rank(), pmesh.data_rank(), pmesh.data_size()
    if args.stage == "DET":
        args.no_answer = True  # train.py:632-636
        args.no_blip = True
        args.no_lang_cls = True
        # the detector alone has no grounding head to take a reference loss
        # from (the JAX driver leaves it on, and its loss then lacks
        # cluster_ref)
        args.no_reference = True
        args.cur_criterion = "loss"

    run_dir = os.path.join(args.output_root, args.tag)
    if rank == 0:
        logger = RunLogger(run_dir, tensorboard=args.tensorboard, wandb=args.wandb)
    else:  # the run's files are rank 0's; each other rank keeps its own log
        logger = RunLogger(os.path.join(run_dir, f"rank{rank}"), stdout=False)
    logger.info(f"device: {device}"
                + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
                + (f"; rank {rank}/{pmesh.world_size()}, data-parallel {dp_rank}/{dp_size}, "
                   f"tp {args.tp}, global batch {args.batch_size * dp_size}"
                   if args.distributed else ""))

    datasets, tokenizer, answer_cands, answer_counter = common.build_datasets(args)
    logger.info(f"train {len(datasets['train'])} / val {len(datasets['val'])} samples, "
                f"{len(answer_cands)} answers")
    model, cfg, dc = common.build_model(args, num_answers=max(len(answer_cands), 1),
                                        device=device, seed=args.seed)

    # per-rank loader shards (the DistributedSampler equivalent, reference
    # train.py:241-247); the ranks of one model-axis group read the same shard
    train_loader = common.make_loader(datasets["train"], args, shuffle=True, seed=args.seed,
                                      num_shards=dp_size, shard_index=dp_rank)
    val_loader = common.make_loader(datasets["val"], args, shuffle=False,
                                    num_shards=dp_size, shard_index=dp_rank)
    try:
        if args.first_stage_ckpt_path:
            # two-stage flow (qa_module.py:386-407): graft detector weights
            checkpoints.graft_detector(args.first_stage_ckpt_path, "model_last", model)
            logger.info(f"loaded stage-1 detector from {args.first_stage_ckpt_path}")
        if args.tp > 1:
            from bridgeqa_tpu_torch.parallel.tp import shard_model

            shard_model(model)
            logger.info(f"tensor parallelism: model axis {args.tp}")

        steps_per_epoch = max(len(train_loader), 1)
        opt_cfg = OptimConfig(lr=args.lr, lr_blip=args.lr_blip, lr_blip3d=args.lr_blip3d,
                              wd=args.wd, lr_decay_step=tuple(args.lr_decay_step),
                              lr_decay_step_2d=tuple(args.lr_decay_step_2d),
                              lr_decay_rate=args.lr_decay_rate,
                              scheduler_type=args.scheduler_type,
                              steps_per_epoch=steps_per_epoch, total_epochs=args.epochs)
        optimizer = build_optimizer(model, opt_cfg)
        start_epoch = 0
        if args.use_checkpoint:
            start_epoch = checkpoints.load_train_state(args.use_checkpoint, model, optimizer)
            logger.info(f"resumed from {args.use_checkpoint} at epoch {start_epoch}")
        if args.distributed:
            # gradients averaged over the data axis; unused parameters found
            # each step, as the reference's DDP(find_unused_parameters=True);
            # the running statistics are the global batch's on every rank
            model = torch.nn.parallel.DistributedDataParallel(
                model, process_group=pmesh.ddp_group(), find_unused_parameters=True,
                broadcast_buffers=False)

        step_cfg = StepConfig(detection=True, use_reference=not args.no_reference,
                              use_lang_classifier=not args.no_lang_cls,
                              use_answer=not args.no_answer)
        solver_cfg = SolverConfig(epochs=args.epochs, val_step=args.val_step,
                                  verbose_step=args.verbose, cur_criterion=args.cur_criterion,
                                  criterion_higher_better=args.cur_criterion != "loss",
                                  k_test=args.k_test,
                                  max_iters_per_epoch=args.max_iters_per_epoch,
                                  trace_dir=args.trace_dir, check_syncs=args.check_syncs)

        extra_eval = {}
        if not args.no_blip and args.stage != "DET":
            ids, mask = make_answer_list(tokenizer, answer_cands, args.answer_len)
            extra_eval = {"answer_list_ids": ids, "answer_list_mask": mask}

        def eval_metrics(end_points, batch):
            ep = get_eval(end_points, dc, use_lang_classifier=not args.no_lang_cls)
            return {k: ep[k] for k in SCALAR_EVAL_KEYS if k in ep}

        def predictions(end_points, batch):
            """Per-sample rows for the best-val CSV (solver.py:623-656 schema)."""
            if "answer_scores" not in end_points or "question_id_str" not in batch:
                return []
            top1 = end_points["answer_scores"].argmax(dim=1).cpu().numpy()
            rows = []
            for i, qid in enumerate(batch["question_id_str"]):
                rows.append({
                    "question_id": qid,
                    "scene_id": batch["scene_id_str"][i],
                    "question": batch["question"][i],
                    "pred_answer": answer_cands[top1[i]] if answer_cands else "",
                    "gt_answers": batch["answers"][i],
                })
            return rows

        solver = Solver(model, optimizer, dc, step_cfg, solver_cfg, device=device,
                        run_dir=run_dir, logger=logger, eval_metrics_fn=eval_metrics,
                        extra_eval_inputs=extra_eval, predictions_fn=predictions)

        checkpoints.save_run_info(run_dir, common.args_to_dict(args))
        checkpoints.save_answer_vocab(run_dir, answer_cands, answer_counter)
        if rank == 0:
            with open(os.path.join(run_dir, "cmdline.txt"), "w") as f:  # solver.py:331-336
                f.write(" ".join(sys.argv if argv is None else ["train"] + list(argv)) + "\n")

        # one dropout stream per data-parallel rank (JAX draws one mask over
        # the global array); the ranks of a model-axis group share theirs
        generator = torch.Generator(device=device).manual_seed(
            args.seed + 2 + DROPOUT_SEED_STRIDE * dp_rank)
        solver(train_loader, val_loader, generator=generator, start_epoch=start_epoch)
        best = solver.best_criterion
        logger.info(f"done; best {args.cur_criterion}={best:.4f} @ epoch {solver.best_epoch + 1}")
    finally:
        train_loader.shutdown()
        val_loader.shutdown()
        logger.close()
    return solver


if __name__ == "__main__":
    main()
