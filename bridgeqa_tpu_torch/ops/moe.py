"""A mixture-of-experts layer's routed work: routing, the permutation of
rows by expert, the grouped expert products and the combine.

No kernel of the port computed a product whose row count varies by group
before this module. ``moe_gemm`` (``csrc/moe_gemm.cu``) runs every expert's
product in one persistent launch on the wgmma main loop of
``csrc/wgmma_gemm.cuh``, scheduled on the card from the experts' row
offsets, so nothing here reads a count back to the host. As the port's
other fused paths do, it runs the kernel on a CUDA tensor and its plain
version (which reads the offsets to the host) on a CPU tensor; on a CUDA
tensor the kernel never falls back: a tensor it does not take raises.

Layout of the experts' weights (the port's; the published checkpoint holds
``experts.<e>.gate_proj``, ``up_proj`` and ``down_proj`` of each expert):

- ``gate_up`` (E, 2 I, K): each expert's gate and up rows interleaved in
  blocks of ``BLOCK`` (``pack_gate_up``), so that one 128-column tile of the
  product holds the gate and up values of the same 64 features and the
  kernel's epilogue computes ``silu(gate) * up`` in registers;
- ``down`` (E, N, I): the experts' down products stacked.

A layer's shared experts run as experts of the same launch that every
token visits with weight 1 (``route(..., always=...)``): the published
shared MLP of width ``n_shared * I`` is the sum of ``n_shared`` SwiGLUs of
width I over the matching slices of its three weights.

Numerics: bf16 (or f32) operands, f32 accumulators; the gate and up values
rounded to the working type, silu rounded, the product rounded (as the
model's module path rounds them); the down product rounded, times the f32
routing weight, rounded; the combine sums a token's slots in f32 and rounds
once.
"""

import torch
import torch.nn.functional as F

from bridgeqa_tpu_torch.ops import cuda_lib
from bridgeqa_tpu_torch.utils.profiling import count

# rows of gate and of up that alternate in the packed gate/up weight
BLOCK = 64


def pack_gate_up(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """(E, I, K) gate and up weights -> (E, 2 I, K), interleaved in blocks of
    ``BLOCK`` rows: rows 2 BLOCK j .. + BLOCK - 1 are gate rows BLOCK j ..,
    the next BLOCK the matching up rows."""
    e, i, k = gate.shape
    if up.shape != gate.shape or i % BLOCK:
        raise ValueError(f"pack_gate_up: gate {tuple(gate.shape)}, up {tuple(up.shape)}; the "
                         f"width must be a multiple of {BLOCK}")
    return torch.stack([gate.reshape(e, i // BLOCK, BLOCK, k), up.reshape(e, i // BLOCK, BLOCK, k)],
                       dim=2).reshape(e, 2 * i, k)


def unpack_gate_up(gate_up: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The inverse of ``pack_gate_up``: (gate, up), each (E, I, K)."""
    e, i2, k = gate_up.shape
    blocks = gate_up.reshape(e, i2 // (2 * BLOCK), 2, BLOCK, k)
    return blocks[:, :, 0].reshape(e, i2 // 2, k), blocks[:, :, 1].reshape(e, i2 // 2, k)


def route(h: torch.Tensor, gate_weight: torch.Tensor, top_k: int, scaling: float = 1.0,
          always: int = 0, norm_topk: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy softmax routing in f32 over all experts (DeepSeek-V2's
    ``MoEGate`` with ``topk_method`` "greedy"): (T, H) tokens and the (E, H)
    router -> f32 weights and int64 expert ids, each (T, top_k + always),
    the routed experts first, largest first, then the ``always`` experts
    E .. E + always - 1 that every token visits with weight 1."""
    scores = torch.softmax(F.linear(h.float(), gate_weight.float()), dim=-1)
    weights, ids = torch.topk(scores, top_k, dim=-1)
    if norm_topk:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    weights = weights * scaling
    if always:
        t, e = h.shape[0], gate_weight.shape[0]
        fixed = torch.arange(e, e + always, device=h.device).expand(t, always)
        ids = torch.cat([ids, fixed], dim=1)
        weights = torch.cat([weights, weights.new_ones(t, always)], dim=1)
    return weights, ids


def dispatch(ids: torch.Tensor, experts: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The permutation of a layer's (token, slot) pairs by expert, on the
    device with no host read: (order, offsets, counts). ``order`` (T k,)
    lists the flat slot indices sorted by expert (stable, so each expert's
    tokens keep their order); ``offsets`` (experts + 1,) int32 are the
    experts' first rows in that order; ``counts`` (experts,) int32."""
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(experts, dtype=torch.int32, device=ids.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    offsets = torch.zeros(experts + 1, dtype=torch.int32, device=ids.device)
    torch.cumsum(counts, 0, dtype=torch.int32, out=offsets[1:])
    return order, offsets, counts


def combine(y_sorted: torch.Tensor, order: torch.Tensor, tokens: int) -> torch.Tensor:
    """Each token's sum of its slots' (already weighted) expert outputs: the
    sorted rows put back in slot order, summed in f32, rounded once."""
    slots = torch.empty_like(y_sorted).index_copy_(0, order, y_sorted)
    return slots.view(tokens, -1, slots.shape[-1]).sum(dim=1, dtype=torch.float32).to(
        y_sorted.dtype)


def moe_ffn(x: torch.Tensor, weights: torch.Tensor, ids: torch.Tensor, gate_up: torch.Tensor,
            down: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The routed (and always-visited) experts' SwiGLU of tokens ``x`` (T,
    K) under ``route``'s weights and ids: permute, the two grouped
    products, combine. Returns the (T, K) output and the experts' row
    counts (on the device)."""
    t, slots = ids.shape
    order, offsets, counts = dispatch(ids, gate_up.shape[0])
    rows = x.index_select(0, order // slots)
    h = moe_gemm(rows, gate_up, offsets, swiglu=True)
    y = moe_gemm(h, down, offsets, row_weight=weights.reshape(-1).index_select(0, order))
    count("moe/rows_routed", t * slots)
    return combine(y, order, t), counts


# -------------------------------------------------------------- the product

def moe_gemm(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
             row_weight: torch.Tensor | None = None, swiglu: bool = False) -> torch.Tensor:
    """The grouped product: x (M, K) with rows sorted by expert (expert e's
    rows ``offsets[e]`` to ``offsets[e + 1]``), w (E, N, K). With
    ``swiglu``, w is ``pack_gate_up``'s and the result is (M, N / 2)
    ``silu(gate) * up``; else (M, N), each row's product times its f32
    ``row_weight`` (1 where None). Every row of x belongs to an expert."""
    e, n, k = w.shape
    if (x.dim() != 2 or x.shape[1] != k or offsets.shape != (e + 1,)
            or (row_weight is not None and row_weight.shape != (x.shape[0],))):
        raise ValueError(f"moe_gemm: x {tuple(x.shape)}, w {tuple(w.shape)}, offsets "
                         f"{tuple(offsets.shape)}")
    if x.device.type == "cpu":
        return moe_gemm_plain(x, w, offsets, row_weight, swiglu)
    extra = () if row_weight is None else (row_weight,)
    cuda_lib.check_cuda("moe_gemm", x.dtype, x, w, offsets, *extra)
    m = x.shape[0]
    if (x.dtype != torch.bfloat16 or w.dtype != x.dtype or offsets.dtype != torch.int32
            or (row_weight is not None and row_weight.dtype != torch.float32)):
        raise ValueError(f"moe_gemm: the kernel takes bf16 x and w, int32 offsets and f32 row "
                         f"weights, got {x.dtype}, {w.dtype}, {offsets.dtype}")
    if k % 8 or n % 8 or (swiglu and n % (2 * BLOCK)) or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"moe_gemm: needs K and N multiples of 8 (N of {2 * BLOCK} with swiglu) "
                         f"and 16-byte aligned x and w, got K {k}, N {n}")
    y = torch.empty((m, n // 2 if swiglu else n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    rc = cuda_lib.lib().bq_moe_gemm(
        x.data_ptr(), w.data_ptr(), offsets.data_ptr(),
        None if row_weight is None else row_weight.data_ptr(), y.data_ptr(), m, e, n, k,
        int(swiglu), cuda_lib.stream_handle(x.device))
    cuda_lib.check(rc, "bq_moe_gemm")
    count("kernel/moe_gemm")
    return y


def swiglu_rounded(g: torch.Tensor, u: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``silu(g) * u`` on f32 products, rounded to ``dtype`` where the model
    rounds: each product, silu, their product."""
    g, u = g.to(dtype), u.to(dtype)
    return (F.silu(g.float()).to(dtype) * u).to(dtype)


def moe_gemm_plain(x, w, offsets, row_weight=None, swiglu: bool = False) -> torch.Tensor:
    """Plain PyTorch ``moe_gemm``: a loop over the experts (the offsets
    read on the host), each product of the up-cast operands in f32, the
    kernel's roundings."""
    bounds = offsets.tolist()
    n = w.shape[1]
    y = x.new_empty((x.shape[0], n // 2 if swiglu else n))
    for e in range(w.shape[0]):
        a, b = bounds[e], bounds[e + 1]
        if a == b:
            continue
        acc = x[a:b].float() @ w[e].float().T
        if swiglu:
            blocks = acc.view(b - a, -1, 2, BLOCK)
            y[a:b] = swiglu_rounded(blocks[:, :, 0].reshape(b - a, -1),
                                    blocks[:, :, 1].reshape(b - a, -1), x.dtype)
        else:
            scale = 1.0 if row_weight is None else row_weight[a:b, None].float()
            y[a:b] = (acc.to(x.dtype).float() * scale).to(x.dtype)
    return y

