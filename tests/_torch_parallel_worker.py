"""One rank of ``tests/test_torch_parallel.py``: a fresh interpreter (the test
starts it as a new process, never a fork of its own), two of them joined
over gloo on the CPU. It imports no JAX.

Usage: ``python -m tests._torch_parallel_worker RANK WORLD PORT WORKDIR``.
``WORKDIR/inputs.pt`` holds the port's config, the f64 weights, the f64
global batch and the f32 eval batch; the rank writes what it measured to
``WORKDIR/result<RANK>.pt``. In order, on one process group:

1. ``ddp``: data parallelism on a (2, 1) mesh, each rank on its half of the
   global batch, through ``DistributedDataParallel`` and ``train_step``: two
   steps; the loss and metrics of each, the gradients after the first
   backward, the BatchNorm statistics after the first step, and the weights
   and optimizer state after the second.
2. ``global_mean``: ``Solver._global_mean`` with divergent shards (0.8 over
   3 samples on rank 0, 0.2 over 5 on rank 1).
3. ``eval``: ``parallel.eval.make_sharded_eval_step`` on each rank's half of
   the eval batch.
4. ``tp``: tensor parallelism on a (1, 2) mesh, each rank on the whole
   batch: two steps; the losses, the gathered weights and optimizer state;
   then a load of the dp run's weights into the sharded model and back.
5. ``driver``: ``scripts.train.main`` with ``--distributed`` (a VQA run of
   one epoch, then a resume for a second).
"""

import os
import sys
import types

import torch

rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port, RANK=str(rank),
                  WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
torch.set_num_threads(2)

from bridgeqa_tpu_torch.data.scannet_config import ScannetDatasetConfig  # noqa: E402
from bridgeqa_tpu_torch.models import bridgeqa  # noqa: E402
from bridgeqa_tpu_torch.parallel import mesh  # noqa: E402
from bridgeqa_tpu_torch.parallel.eval import make_sharded_eval_step  # noqa: E402
from bridgeqa_tpu_torch.parallel.tp import shard_model  # noqa: E402
from bridgeqa_tpu_torch.train.optim import build_optimizer  # noqa: E402
from bridgeqa_tpu_torch.train.solver import Solver  # noqa: E402
from bridgeqa_tpu_torch.train.step import StepConfig, train_step  # noqa: E402

DC = ScannetDatasetConfig()
STEP_CFG = StepConfig(use_lang_classifier=True)


def _model(inputs, dtype=torch.float64):
    model = bridgeqa.BridgeQA(inputs["cfg"], DC.mean_size_arr, device="cpu").to(dtype)
    model.load_state_dict(inputs["state"])
    return model


def _rows(batch, lo, hi, replicated=()):
    return {k: torch.from_numpy(v.copy() if k in replicated else v[lo:hi].copy())
            for k, v in batch.items()}


def _train(ddp_model, module, batch, steps=2):
    """``steps`` train steps; what the test compares."""
    optimizer = build_optimizer(module)
    out = {"metrics": [], "grads": None, "stats": None}

    def mark(part):
        if part == "backward" and out["grads"] is None:
            out["grads"] = {n: (p.grad.detach().clone() if p.grad is not None else None)
                            for n, p in module.named_parameters()}

    for k in range(steps):
        metrics = train_step(ddp_model, optimizer, batch, bn_momentum=0.1, step_cfg=STEP_CFG,
                             dataset_config=DC, mark=mark)
        out["metrics"].append({key: float(v) for key, v in metrics.items()})
        if k == 0:
            out["stats"] = {n: b.clone() for n, b in module.named_buffers()
                            if n.endswith(("running_mean", "running_var"))}
    out["state"] = module.state_dict()
    out["optimizer"] = optimizer.state_dict()["state"]
    return out


def main():
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    batch, eval_batch = inputs["batch"], inputs["eval_batch"]
    half = batch["point_clouds"].shape[0] // world
    mesh.initialize_distributed(device="cpu")
    result = {"rank": rank}

    # 1. data parallelism
    mesh.make_mesh()
    module = _model(inputs)
    ddp = torch.nn.parallel.DistributedDataParallel(
        module, process_group=mesh.ddp_group(), find_unused_parameters=True,
        broadcast_buffers=False)
    result["ddp"] = _train(ddp, module, _rows(batch, rank * half, (rank + 1) * half))

    # 2. the best-checkpoint criterion over divergent shards
    crit, n = ((0.8, 3), (0.2, 5))[rank]
    result["global_crit"] = Solver._global_mean(types.SimpleNamespace(device="cpu"), crit * n, n)

    # 3. the sharded eval step
    ev_half = eval_batch["point_clouds"].shape[0] // world
    step = make_sharded_eval_step(_model(inputs, torch.float32), DC, STEP_CFG, k_test=8)
    ev = step(_rows(eval_batch, rank * ev_half, (rank + 1) * ev_half,
                    replicated=("answer_list_ids", "answer_list_mask")))
    result["eval"] = {k: ev[k] for k in ("loss", "vote_loss", "answer_scores", "lang_scores",
                                         "point_clouds")}

    # 4. tensor parallelism
    tp_mesh = mesh.make_mesh(data=1, model=world)
    module = shard_model(_model(inputs))
    widths = {n: tuple(p.shape) for n, p in module.named_parameters()}
    ddp = torch.nn.parallel.DistributedDataParallel(
        module, process_group=mesh.ddp_group(), find_unused_parameters=True,
        broadcast_buffers=False)
    result["tp"] = _train(ddp, module, _rows(batch, 0, 2 * half))
    result["tp"]["shard_widths"] = widths
    result["tp"]["model_rank"] = tp_mesh.get_local_rank("model")
    module.load_state_dict(result["ddp"]["state"])
    result["tp"]["reloaded"] = module.state_dict()

    # 5. the driver
    from bridgeqa_tpu_torch.scripts import train

    common = ["--synthetic", "--tiny", "--device", "cpu", "--num_workers", "1", "--batch_size",
              "2", "--num_points", "2048", "--val_step", "0", "--verbose", "1", "--k_test", "8",
              "--synthetic_records", "8", "--synthetic_val_records", "4", "--distributed",
              "--max_iters_per_epoch", "2", "--output_root", workdir, "--tag", "run"]
    solver = train.main(common + ["--epochs", "1"])
    best = [solver.best_criterion]
    solver = train.main(common + ["--epochs", "2", "--use_checkpoint",
                                  os.path.join(workdir, "run"), "--tag", "resumed"])
    best.append(solver.best_criterion)
    result["driver"] = {"best": best, "data_size": mesh.data_size()}
    result["jax_imported"] = any(m in ("jax", "bridgeqa_tpu")
                                 or m.startswith(("jax.", "bridgeqa_tpu."))
                                 for m in sys.modules)
    torch.save(result, os.path.join(workdir, f"result{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
