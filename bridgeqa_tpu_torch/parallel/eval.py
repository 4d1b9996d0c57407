"""The sharded rank-eval step (counterpart of
``bridgeqa_tpu/parallel/eval.py::make_sharded_eval_step``).

JAX ``shard_map``s its eval body over the mesh's ``data`` axis, so that each
device runs the whole per-shard program, fused kernels included. Here each
data-parallel rank runs ``train.step.eval_step`` on its shard (the fused
scoring, ViT and point kernels run on the card as in one process), then:

- the answer table (``answer_list_ids``, ``answer_list_mask``) is
  replicated: every rank passes the whole table;
- each scalar (a loss or metric) is averaged over the ranks, JAX's
  ``pmean`` of per-shard values. This is not the global-batch loss of
  training (``parallel/global_batch.py``): inside the step each loss covers
  this rank's shard only (``mesh.local_batch``);
- every per-sample output is gathered along axis 0 in rank order, the
  global batch's rows in JAX's order.

Every shard must have the same shape (all_gather): the loaders drop a last
partial batch.
"""

import torch
import torch.distributed as dist

from bridgeqa_tpu_torch.parallel.mesh import data_size, ddp_group, local_batch
from bridgeqa_tpu_torch.train.step import StepConfig, eval_step

# batch entries that are global state shared by every sample (the ranked
# answer table), not per-sample data
REPLICATED_KEYS = ("answer_list_ids", "answer_list_mask")


def _gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def make_sharded_eval_step(model, dataset_config=None, step_cfg: StepConfig = StepConfig(),
                           k_test: int = 256):
    """An eval step over the data-parallel ranks: ``step(shard)`` takes this
    rank's shard of the batch (tensors, with the whole answer table) and
    returns the end points' tensors for the global batch (see the module
    note). With one data-parallel rank it is ``eval_step``."""

    def sharded_eval_step(shard: dict) -> dict:
        with local_batch():
            end_points = eval_step(model, shard, k_test=k_test, step_cfg=step_cfg,
                                   dataset_config=dataset_config)
        out = {k: v for k, v in end_points.items() if torch.is_tensor(v)}
        group, n = ddp_group(), data_size()
        if n == 1:
            return out
        scalars = sorted(k for k, v in out.items() if v.dim() == 0)
        if scalars:  # one all-reduce for every scalar, then / n: the pmean
            stacked = torch.stack([out[k].to(torch.float64) for k in scalars])
            dist.all_reduce(stacked, group=group)
            for i, k in enumerate(scalars):
                out[k] = (stacked[i] / n).to(out[k].dtype)
        for k, v in out.items():
            if v.dim() and k not in REPLICATED_KEYS:
                out[k] = _gather_rows(v, group)
        return out

    return sharded_eval_step
