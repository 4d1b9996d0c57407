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
launches the kernel with ``gather_plan``'s launch and counts the launch
(``kernel/gather_rows``); on a CPU tensor it runs ``gather_rows_plain``
(``torch.gather``, which checks the indices itself).
"""

import torch

from bridgeqa_tpu_torch.ops import cuda_lib
from bridgeqa_tpu_torch.utils.profiling import count

# the last launch's plan (chip_smoke.py prints it)
last_plan = None

# gather_rows.cu's constants: warps a block, rows a work unit, the longest
# row a group of lanes takes, the shortest row the long-row kernel takes,
# the shortest row a whole warp takes; and the grid's blocks an SM (8 of
# 256 threads fill an SM's 2048 where registers allow)
GATHER_WARPS = 8
GATHER_ROWS_PER_UNIT = 32
GATHER_GROUP_MAX_BYTES = 64
GATHER_ONE_PASS_BYTES = 528
GATHER_HALF_WARP_BYTES = 272
GATHER_BLOCKS_PER_SM = 8


def gather_plan(b: int, r: int, row_bytes: int, table_addr: int, out_addr: int,
                sms: int) -> dict:
    """The kernel's launch for ``b`` tables of rows of ``row_bytes`` bytes,
    ``r`` rows gathered from each, at these base addresses, on a card of
    ``sms`` SMs. A warp takes a work unit of 32 rows of one table at a time
    (``units`` of them, ``b * ceil(r / 32)``), walking them by the grid's
    stride over a grid of at most ``GATHER_BLOCKS_PER_SM`` blocks an SM. A
    row of at most 64 bytes
    goes to ``lanes_per_row`` lanes (the least power of two that holds the
    row's units) in the widest unit of 16, 8, 4 or 2 bytes that divides the
    row and both addresses ("groups"); a longer row to 16 lanes under
    ``GATHER_HALF_WARP_BYTES``, else to a warp, in 16-byte stores aligned in
    the output, the table's bytes realigned in registers: 4 rows a group at
    once under ``GATHER_ONE_PASS_BYTES`` ("rows"), a row at a time from it
    ("long rows")."""
    row_blocks = -(-r // GATHER_ROWS_PER_UNIT)
    units = b * row_blocks
    blocks = max(1, min(-(-units // GATHER_WARPS), sms * GATHER_BLOCKS_PER_SM))
    common = dict(row_blocks=row_blocks, units=units, blocks=blocks,
                  warps_per_block=GATHER_WARPS)
    if row_bytes > GATHER_GROUP_MAX_BYTES:
        kernel = "rows" if row_bytes < GATHER_ONE_PASS_BYTES else "long rows"
        lanes = 16 if row_bytes < GATHER_HALF_WARP_BYTES else 32
        return dict(kernel=kernel, unit_bytes=16, lanes_per_row=lanes, **common)
    align = table_addr | out_addr | row_bytes
    unit = next(u for u in (16, 8, 4, 2) if align % u == 0)
    lanes = 1 << (row_bytes // unit - 1).bit_length()
    return dict(kernel="groups", unit_bytes=unit, lanes_per_row=lanes, **common)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (B, N, C) or (N, C), f32 or bf16; idx (B, R) or (R,) integer
    row numbers in [0, N). Returns (B, R, C) or (R, C) in the table's
    dtype."""
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
    out = torch.empty((*i2.shape, c), dtype=table.dtype, device=table.device)
    launch(t3, i2, out)
    return out if batched else out[0]


def launch(table: torch.Tensor, idx: torch.Tensor, out: torch.Tensor) -> None:
    """The kernel alone, into ``out``: table (B, N, C), idx (B, R) int32
    already checked, out (B, R, C), all contiguous on one card. The timing
    harness calls it to read the kernel's own card time."""
    global last_plan
    b, n, c = table.shape
    r = idx.shape[1]
    es = table.element_size()
    plan = gather_plan(b, r, c * es, table.data_ptr(), out.data_ptr(),
                       torch.cuda.get_device_properties(table.device).multi_processor_count)
    rc = cuda_lib.lib().bq_gather_rows(table.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, r,
                                       c, es, plan["unit_bytes"], plan["lanes_per_row"],
                                       plan["blocks"], cuda_lib.stream_handle(table.device))
    cuda_lib.check(rc, "bq_gather_rows")
    count("kernel/gather_rows")
    last_plan = plan


def gather_rows_plain(table, idx):
    """Plain PyTorch ``gather_rows``: ``torch.gather`` along the rows."""
    dim = table.dim() - 2
    index = idx.long().unsqueeze(-1).expand(*idx.shape, table.shape[-1])
    return torch.gather(table, dim, index)
