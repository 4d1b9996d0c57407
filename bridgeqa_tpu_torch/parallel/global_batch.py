"""The collectives that JAX's global arrays imply.

JAX's BatchNorm statistics, loss normalisers and metrics cover the global
batch, because the step runs on one array spread over the mesh. Here each
data-parallel rank holds its shard, so each batch-wide sum is all-reduced
over ``mesh.data_group()`` before it is used; where that is None (one
process, one data-parallel rank, ``mesh.local_batch``) every function here
computes what the single-process code always computed.

Gradients. The sums are all-reduced by ``all_reduce_sum``, whose backward
all-reduces the cotangent too. Every rank computes the same global loss and
backpropagates it, so the backward of each all-reduce adds the cotangents
of the W replicas of the loss: each rank's gradient comes out W times its
share of the global gradient, and DDP's mean over the W ranks leaves the
gradient of the global loss. That factor W is the loss scaling DDP's mean
needs; no comm hook is installed, and no loss is rescaled by hand.
"""

import torch
import torch.distributed as dist

from bridgeqa_tpu_torch.parallel.mesh import data_group, ddp_group


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the cotangents over it too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, differentiably (see the module note)."""
    return _AllReduceSum.apply(x, group)


def _global_sums(*values):
    """The values (tensors or Python numbers, the first a tensor) summed over
    the data-parallel ranks in one all-reduce; each comes back in its own
    dtype (numbers in the first tensor's)."""
    group = data_group()
    if group is None:
        return values
    ref = values[0]
    dtype = torch.promote_types(ref.dtype, torch.float32)
    for v in values:
        if torch.is_tensor(v):
            dtype = torch.promote_types(dtype, v.dtype)
    flat = torch.stack([v.to(dtype) if torch.is_tensor(v)
                        else torch.full((), v, dtype=dtype, device=ref.device) for v in values])
    total = all_reduce_sum(flat, group)
    return tuple(total[i].to(v.dtype if torch.is_tensor(v) else ref.dtype)
                 for i, v in enumerate(values))


def global_ratio(num: torch.Tensor, den, eps: float = 0.0) -> torch.Tensor:
    """``num / (den + eps)`` over the global batch: the numerator (a sum
    over this rank's samples) and the count or weight ``den`` are each
    summed over the data-parallel ranks first, never per-rank ratios
    averaged."""
    num, den = _global_sums(num, den)
    return num / (den + eps) if eps else num / den


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``x.mean()`` over the global batch: the per-sample mean of a loss."""
    if data_group() is None:
        return x.mean()
    return global_ratio(x.sum(), x.numel())


def batch_moments(x: torch.Tensor, dims) -> tuple:
    """(mean, mean of squares, n / (n - 1)) of ``x`` over ``dims`` and the
    global batch, n the global count: BatchNorm's one-pass train statistics
    and the factor that makes its variance unbiased. One all-reduce carries
    the two sums and the count."""
    n = 1
    for d in dims:
        n *= x.shape[d]
    group = data_group()
    if group is None:
        return x.mean(dims), (x * x).mean(dims), n / max(n - 1, 1)
    c = x.shape[-1]
    local = torch.cat([x.sum(dims), (x * x).sum(dims),
                       torch.full((1,), n, dtype=x.dtype, device=x.device)])
    total = all_reduce_sum(local, group)
    count = total[2 * c]
    return total[:c] / count, total[c:2 * c] / count, count / (count - 1).clamp(min=1)


def global_mean(local_sum: float, local_count: int, device) -> float:
    """The mean over the data-parallel ranks of a (sum, count) pair on the
    host (the counterpart of the JAX ``Solver._global_mean``): every rank
    gets the same value, so every rank takes the same best-checkpoint
    decision. A host value: read at validation, not between log points."""
    group = ddp_group()
    if group is None or dist.get_world_size(group) == 1:
        return local_sum / max(local_count, 1)
    totals = torch.tensor([local_sum, float(local_count)], dtype=torch.float64, device=device)
    dist.all_reduce(totals, group=group)
    total_sum, total_count = totals.tolist()
    return total_sum / max(total_count, 1.0)


def gather_rows(rows: list) -> list:
    """The data-parallel ranks' rows (picklable objects) in rank order: the
    reference's ``all_gather_object`` of its prediction rows."""
    group = ddp_group()
    if group is None or dist.get_world_size(group) == 1:
        return list(rows)
    gathered = [None] * dist.get_world_size(group)
    dist.all_gather_object(gathered, list(rows), group=group)
    return [row for part in gathered for row in part]
