"""Three-nearest-neighbour interpolation (counterpart of
``bridgeqa_tpu/ops/interpolate.py``), plain PyTorch: the JAX package runs
these in XLA, with no Pallas kernel."""

import torch

from bridgeqa_tpu_torch.ops.grouping import pairwise_sqdist


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """The 3 nearest known points of each unknown point.

    unknown (B, N, 3), known (B, M, 3) with M >= 3. Returns euclidean
    distances (B, N, 3), ascending, and int32 indices (B, N, 3); ties go to
    the lowest index (three argmin passes, as the JAX op)."""
    d2 = pairwise_sqdist(unknown.float(), known.float())
    dists, idxs = [], []
    for _ in range(3):
        i = d2.argmin(dim=-1, keepdim=True)  # first minimum
        dists.append(d2.gather(-1, i)[..., 0])
        idxs.append(i[..., 0])
        d2 = d2.scatter(-1, i, torch.inf)
    dist = torch.stack(dists, -1).clamp_min(0.0).sqrt()
    return dist, torch.stack(idxs, -1).to(torch.int32)


def three_interpolate(points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``out[b, n, c] = sum_k points[b, idx[b, n, k], c] * weight[b, n, k]``."""
    b, n, k = idx.shape
    c = points.shape[-1]
    gathered = points.gather(1, idx.long().reshape(b, n * k, 1).expand(-1, -1, c))
    gathered = gathered.reshape(b, n, k, c)
    return (gathered * weight[..., None].to(gathered.dtype)).sum(dim=2)
