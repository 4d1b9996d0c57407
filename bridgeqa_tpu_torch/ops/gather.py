"""Batched row gather: ``out[b, r, :] = table[b, idx[b, r], :]``, exact.

Counterpart of the two Pallas row gathers of ``bridgeqa_tpu/ops/gather.py``,
``_gather_rows_one`` (rows copied out of a VMEM-resident table) and
``_gather_rows_onehot`` (the gather as one-hot MXU products, about 17 bits
in f32): one hand-written kernel, ``csrc/gather_rows.cu``, copies rows bit
for bit in f32 and bf16 and stands for both. Off the TPU the JAX package
gathers with ``take_along_axis``, and no path of either package calls these
kernels today: the point ops gather inside their own kernels or with
``torch.gather``.

On a CUDA tensor ``gather_rows`` checks the indices on the host side
(0 <= idx < N, else ``IndexError``; the check waits for the card),
launches the kernel and counts the launch in ``launches``; on a CPU tensor
it runs ``gather_rows_plain`` (``torch.gather``, which checks the indices
itself).
"""

import torch

from bridgeqa_tpu_torch.ops import cuda_lib

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (B, N, C) or (N, C), f32 or bf16; idx (B, R) or (R,) integer
    row numbers in [0, N). Returns (B, R, C) or (R, C) in the table's
    dtype."""
    global launches
    batched = table.dim() == 3
    if table.dim() not in (2, 3) or idx.dim() != table.dim() - 1 or \
            (batched and idx.shape[0] != table.shape[0]):
        raise ValueError(f"gather_rows: table {tuple(table.shape)}, idx {tuple(idx.shape)}")
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    cuda_lib.check_cuda("gather_rows", table.dtype, table, idx)
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"gather_rows: integer indices, got {idx.dtype}")
    n, c = table.shape[-2:]
    if max(n, idx.shape[-1]) * c * table.element_size() >= 2**31:
        raise ValueError("gather_rows: a table or an output of 2 GiB or more")
    if idx.numel():
        lo, hi = torch.aminmax(idx)
        if int(lo) < 0 or int(hi) >= n:
            raise IndexError(f"gather_rows: indices outside [0, {n})")
    t3 = table if batched else table[None]
    i2 = (idx if batched else idx[None]).to(torch.int32)
    b, r = i2.shape
    out = torch.empty((b, r, c), dtype=table.dtype, device=table.device)
    rc = cuda_lib.lib().bq_gather_rows(t3.data_ptr(), i2.data_ptr(), out.data_ptr(), b, n, r, c,
                                       table.element_size(), cuda_lib.stream_handle(table.device))
    cuda_lib.check(rc, "bq_gather_rows")
    launches += 1
    return out if batched else out[0]


def gather_rows_plain(table, idx):
    """Plain PyTorch ``gather_rows``: ``torch.gather`` along the rows."""
    dim = table.dim() - 2
    index = idx.long().unsqueeze(-1).expand(*idx.shape, table.shape[-1])
    return torch.gather(table, dim, index)
