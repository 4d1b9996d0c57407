"""Fused answer-scoring decoder layer.

Counterpart of ``bridgeqa_tpu/ops/scoring_layer.py``. The TPU runs a whole
post-LN decoder layer over grouped 12-token answers in one Pallas kernel
with all its weights in VMEM; a Hopper block has 227 KB of shared memory,
so here the layer is eleven launches of three hand-written kernels:

- ``scoring_gemm`` (``csrc/scoring_gemm.cu``): the six products, QKV,
  attention output, cross query, cross output, FFN in (with exact GELU) and
  FFN out (the fused ViT block, ``ops/vit_block.py``, runs its four products
  here too, the last with a residual);
- ``self_attention`` and ``cross_attention`` (``csrc/scoring_attention.cu``):
  causal attention inside each answer, and each answer's attention to its
  question's pre-projected keys and values (at head width 64 on the tensor
  cores: bf16 on a TMA-fed pipeline, f32 in 3xTF32);
- ``add_layernorm`` (``csrc/scoring_layernorm.cu``): the three residual adds
  and LayerNorms (and the ViT block's LayerNorms: without a residual, or
  keeping the sum).

On a CUDA tensor each wrapper launches its kernel and counts the launch
(the counter ``kernel/<kernel>``); on a CPU tensor it runs its ``*_plain``
version. There is no fallback: a CUDA tensor the kernel does not take
raises, and so does one that wants a gradient (the kernels have no
backward; the model takes the fused path only without grad).

Numerics, the Pallas kernel's: every product takes working-type inputs,
accumulates in f32, adds an f32 bias and rounds once; the residual sum is
taken in the working type before the f32 LayerNorm, whose variance is
``mean(y^2) - mu^2``; softmax normalisation is deferred (``exp(s - max)``
rounded to the working type before the product with V, the f32 context
divided by the f32 sum afterwards); GELU is exact (erf). The answer padding
mask is dropped, as in the TPU kernel: answers are right-padded, so every
row whose loss counts sees only valid tokens under the causal mask. The
question keys are not padded to 128, a TPU layout choice: masked keys
contribute exactly 0 either way.

Weights are in ``nn.Linear`` layout, (out, in): the transposed flax kernel,
as everywhere in the port.
"""

import ctypes
import math

import torch

from bridgeqa_tpu_torch.models.layers import param_as
from bridgeqa_tpu_torch.ops import cuda_lib
from bridgeqa_tpu_torch.utils.profiling import count

NEG = -1e9
# longest answer a self-attention block holds whole (kTileRows in the kernel)
MAX_ANSWER_LEN = 128
# shared memory one block of the attention kernel may use on Hopper
_MAX_SMEM = 232448
# question keys the f32 tensor-core attention holds whole (kF32CrossKeys)
_F32_MAX_KEYS = 128

# launches of each kernel that one ``scoring_layer`` call makes
LAUNCHES_PER_LAYER = {"scoring_gemm": 6, "scoring_attention": 2, "scoring_layernorm": 3}
# the fields of an attention launch as the C entry reports them (kLaunchFields
# in csrc/scoring_attention.cu): "pipeline" 1 for the bf16 tensor-core
# pipeline, 2 for the f32 tensor-core kernel, 0 for the CUDA-core kernel;
# "blocks"; "threads" a block; "smem" bytes of dynamic shared memory a block;
# "resident" blocks an SM holds and "sms" of the card (the tensor-core
# kernels' persistent grids); "stages" of the pipeline's TMA ring; "units" of
# (segment, head); "seg" row tiles a unit; "tile_rows"
ATTENTION_LAUNCH_FIELDS = ("pipeline", "blocks", "threads", "smem", "resident", "sms", "stages",
                           "units", "seg", "tile_rows")
# the last attention launch, a dict of ATTENTION_LAUNCH_FIELDS
last_attention_launch = None


def _attention(device: torch.device, *args) -> None:
    """Launch ``bq_scoring_attention`` with ``args`` (all but its launch
    record and stream) on ``device``'s current stream, count the launch and
    keep its record."""
    global last_attention_launch
    record = (ctypes.c_int * len(ATTENTION_LAUNCH_FIELDS))()
    rc = cuda_lib.lib().bq_scoring_attention(*args, record, cuda_lib.stream_handle(device))
    cuda_lib.check(rc, "bq_scoring_attention")
    count("kernel/scoring_attention")
    last_attention_launch = dict(zip(ATTENTION_LAUNCH_FIELDS, record))


def _check_f32(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: biases, LayerNorm parameters and masks must be float32, "
                             f"got {t.dtype}")


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU on f32 values, written out as the kernel computes it."""
    return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865475))


# ------------------------------------------------------------------ products

def scoring_gemm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, gelu: bool = False,
                 residual: torch.Tensor | None = None) -> torch.Tensor:
    """``epilogue(x @ w.T + b)``: x (M, K) and w (N, K) in the working type,
    b (N,) f32, epilogue exact GELU or none, rounded to the working type;
    then ``residual + that`` where a residual (M, N) in the working type is
    given, rounded again. Returns (M, N) in the working type."""
    if (x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1] or b.shape != (w.shape[0],)
            or (residual is not None and residual.shape != (x.shape[0], w.shape[0]))):
        raise ValueError(f"scoring_gemm: shapes {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}"
                         + ("" if residual is None else f", {tuple(residual.shape)}"))
    if x.device.type == "cpu":
        return scoring_gemm_plain(x, w, b, gelu, residual)
    res = () if residual is None else (residual,)
    cuda_lib.check_cuda("scoring_gemm", x.dtype, x, w, b, *res)
    _check_f32("scoring_gemm", b)
    if w.dtype != x.dtype or (residual is not None and residual.dtype != x.dtype):
        raise ValueError(f"scoring_gemm: x is {x.dtype}, w is {w.dtype}"
                         + ("" if residual is None else f", residual is {residual.dtype}"))
    m, k = x.shape
    n = w.shape[0]
    if x.dtype == torch.bfloat16 and (k % 8 or n % 8 or x.data_ptr() % 16 or w.data_ptr() % 16
                                      or (residual is not None and residual.data_ptr() % 16)):
        raise ValueError(f"scoring_gemm: bf16 needs K and N multiples of 8 and 16-byte aligned "
                         f"x, w and residual (the kernel's TMA boxes), got {k}, {n}")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = cuda_lib.lib().bq_scoring_gemm(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), None if residual is None else residual.data_ptr(),
        y.data_ptr(), m, n, k, int(gelu), cuda_lib.DTYPE_CODES[x.dtype],
        cuda_lib.stream_handle(x.device))
    cuda_lib.check(rc, "bq_scoring_gemm")
    count("kernel/scoring_gemm")
    if x.dtype == torch.float32:
        count("kernel/f32_gemm_wgmma" if cuda_lib.f32_tma_route(k, x, w) else "kernel/f32_gemm_mma")
    return y


def scoring_gemm_plain(x, w, b, gelu: bool = False, residual=None):
    """Plain PyTorch ``scoring_gemm``: the product of the up-cast inputs in
    f32, the f32 bias, the epilogue, one rounding; the residual added in the
    working type."""
    y = x.float() @ w.float().T + b.float()
    if gelu:
        y = gelu_exact(y)
    y = y.to(x.dtype)
    return y if residual is None else residual + y


# ---------------------------------------------------------------- attentions

def _attend_plain(s: torch.Tensor, v: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """softmax(s) @ v with the deferred normalisation of the TPU kernel."""
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    return (torch.einsum("...qk,...kd->...qd", e.to(dt).float(), v.float()) / denom).to(dt)


def self_attention(qkv: torch.Tensor, *, la: int, heads: int) -> torch.Tensor:
    """Causal attention inside each answer: qkv (R, 3H) holds R / la
    sequences of la rows; returns the context (R, H)."""
    r, h3 = qkv.shape
    h = h3 // 3
    if h3 % 3 or h % heads or r % la:
        raise ValueError(f"self_attention: qkv {tuple(qkv.shape)}, la {la}, heads {heads}")
    if qkv.device.type == "cpu":
        return self_attention_plain(qkv, la=la, heads=heads)
    cuda_lib.check_cuda("self_attention", qkv.dtype, qkv)
    hd = h // heads
    if hd % 2 or la > MAX_ANSWER_LEN:
        raise ValueError(f"self_attention: needs an even head width and la <= {MAX_ANSWER_LEN}, "
                         f"got {hd}, {la}")
    out = torch.empty((r, h), dtype=qkv.dtype, device=qkv.device)
    base, step = qkv.data_ptr(), h * qkv.element_size()
    _attention(qkv.device, base, base + step, base + 2 * step, None, out.data_ptr(), r, heads, hd,
               h3, h3, h, la, 0, 0, 0, 1.0 / math.sqrt(hd), cuda_lib.DTYPE_CODES[qkv.dtype])
    return out


def self_attention_plain(qkv, *, la: int, heads: int):
    r, h3 = qkv.shape
    h = h3 // 3
    hd = h // heads
    q, k, v = qkv.reshape(r // la, la, 3, heads, hd).permute(2, 0, 3, 1, 4)
    causal = torch.tril(torch.ones(la, la, dtype=torch.bool, device=qkv.device))
    s = (torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(hd))
         + torch.where(causal, 0.0, NEG))
    return _attend_plain(s, v, qkv.dtype).permute(0, 2, 1, 3).reshape(r, h)


def cross_attention_smem(lk: int, head_dim: int, dtype: torch.dtype) -> int:
    """Bytes of shared memory a cross-attention block needs. The f32
    tensor-core kernel (head width 64, at most 128 keys): 128 query rows,
    the keys and values of one head (rows of 72 and 68 floats, the keys
    rounded up to 8) and their bias. The CUDA-core kernel: the keys and
    values of one head (rows padded by two elements), and each warp's query
    row and scores in f32."""
    if dtype == torch.float32 and head_dim == 64 and lk <= _F32_MAX_KEYS:
        keys = -(-lk // 8) * 8
        return (128 * 72 + keys * (72 + 68 + 1)) * 4
    return 2 * lk * (head_dim + 2) * (torch.finfo(dtype).bits // 8) + 8 * (head_dim + lk) * 4


def cross_attention(qc: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, cbias: torch.Tensor, *,
                    heads: int) -> torch.Tensor:
    """Grouped cross-attention: qc (R, H), the R / Q rows of question q in
    the q-th block; ck, cv (Q, Lk, H) the questions' projected keys and
    values; cbias (Q, Lk) the additive f32 question-padding bias. Returns
    (R, H)."""
    r, h = qc.shape
    nq, lk, _ = ck.shape
    if (h % heads or r % nq or ck.shape != cv.shape or ck.shape[2] != h
            or cbias.shape != (nq, lk)):
        raise ValueError(f"cross_attention: shapes {tuple(qc.shape)}, {tuple(ck.shape)}, "
                         f"{tuple(cv.shape)}, {tuple(cbias.shape)}")
    if qc.device.type == "cpu":
        return cross_attention_plain(qc, ck, cv, cbias, heads=heads)
    cuda_lib.check_cuda("cross_attention", qc.dtype, qc, ck, cv, cbias)
    _check_f32("cross_attention", cbias)
    if ck.dtype != qc.dtype or cv.dtype != qc.dtype:
        raise ValueError("cross_attention: queries, keys and values need one dtype")
    hd = h // heads
    if hd % 2 or cross_attention_smem(lk, hd, qc.dtype) > _MAX_SMEM:
        raise ValueError(f"cross_attention: head width {hd} (must be even) or {lk} keys do not "
                         "fit one block")
    out = torch.empty_like(qc)
    _attention(qc.device, qc.data_ptr(), ck.data_ptr(), cv.data_ptr(), cbias.data_ptr(),
               out.data_ptr(), r, heads, hd, h, h, h, 1, r // nq, lk, 1, 1.0 / math.sqrt(hd),
               cuda_lib.DTYPE_CODES[qc.dtype])
    return out


def cross_attention_plain(qc, ck, cv, cbias, *, heads: int):
    r, h = qc.shape
    nq, lk, _ = ck.shape
    hd = h // heads
    q = qc.reshape(nq, r // nq, heads, hd).transpose(1, 2)
    k = ck.reshape(nq, lk, heads, hd).transpose(1, 2)
    v = cv.reshape(nq, lk, heads, hd).transpose(1, 2)
    s = (torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(hd))
         + cbias.float()[:, None, None, :])
    return _attend_plain(s, v, qc.dtype).transpose(1, 2).reshape(r, h)


# ---------------------------------------------------------------- LayerNorm

def add_layernorm(a: torch.Tensor, r: torch.Tensor | None, scale: torch.Tensor,
                  bias: torch.Tensor, eps: float, keep_sum: bool = False):
    """LayerNorm(a + r), or LayerNorm(a) where r is None: the sum in the
    working type, statistics in f32; a, r (R, H); scale, bias (H,) f32.
    Returns the normalised rows, or ``(a + r, normalised)`` with
    ``keep_sum``."""
    if (a.dim() != 2 or (r is not None and r.shape != a.shape) or scale.shape != (a.shape[1],)
            or bias.shape != scale.shape):
        raise ValueError(f"add_layernorm: shapes {tuple(a.shape)}, "
                         f"{None if r is None else tuple(r.shape)}, {tuple(scale.shape)}, "
                         f"{tuple(bias.shape)}")
    if a.device.type == "cpu":
        return add_layernorm_plain(a, r, scale, bias, eps, keep_sum)
    res = () if r is None else (r,)
    cuda_lib.check_cuda("add_layernorm", a.dtype, a, *res, scale, bias)
    _check_f32("add_layernorm", scale, bias)
    if (r is not None and r.dtype != a.dtype) or a.shape[1] % 2:
        raise ValueError("add_layernorm: a and r need one dtype and an even width")
    out = torch.empty_like(a)
    total = torch.empty_like(a) if keep_sum else None
    rc = cuda_lib.lib().bq_scoring_layernorm(
        a.data_ptr(), None if r is None else r.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), None if total is None else total.data_ptr(), a.shape[0], a.shape[1], eps,
        cuda_lib.DTYPE_CODES[a.dtype], cuda_lib.stream_handle(a.device))
    cuda_lib.check(rc, "bq_scoring_layernorm")
    count("kernel/scoring_layernorm")
    return (total, out) if keep_sum else out


def add_layernorm_plain(a, r, scale, bias, eps: float, keep_sum: bool = False):
    total = a if r is None else a + r
    y = total.float()
    mu = y.mean(dim=-1, keepdim=True)
    var = (y * y).mean(dim=-1, keepdim=True) - mu * mu
    out = ((y - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()).to(a.dtype)
    return (total, out) if keep_sum else out


# --------------------------------------------------------------- the layer

def _layer(ops, x, wqkv, bqkv, wo, bo, ln1s, ln1b, wcq, bcq, wco, bco, ln2s, ln2b,
           wi, bi, wo2, bo2, ln3s, ln3b, ck, cv, cbias, *, la, heads, eps):
    gemm, attn_self, attn_cross, add_ln = ops
    attn = gemm(attn_self(gemm(x, wqkv, bqkv), la=la, heads=heads), wo, bo)
    x1 = add_ln(attn, x, ln1s, ln1b, eps)
    cattn = gemm(attn_cross(gemm(x1, wcq, bcq), ck, cv, cbias, heads=heads), wco, bco)
    x2 = add_ln(cattn, x1, ln2s, ln2b, eps)
    y = gemm(gemm(x2, wi, bi, gelu=True), wo2, bo2)
    return add_ln(y, x2, ln3s, ln3b, eps)


_KERNELS = (scoring_gemm, self_attention, cross_attention, add_layernorm)
_PLAIN = (scoring_gemm_plain, self_attention_plain, cross_attention_plain, add_layernorm_plain)


def scoring_layer(x, wqkv, bqkv, wo, bo, ln1s, ln1b, wcq, bcq, wco, bco, ln2s, ln2b,
                  wi, bi, wo2, bo2, ln3s, ln3b, ck, cv, cbias, *, la: int, heads: int,
                  eps: float):
    """One decoder layer over grouped answer sequences.

    x: (S * la, H) rows, sequence-major; sequence s belongs to question
    ``s // (S / Q)``. Weights (out, in) in the working type, biases and
    LayerNorm parameters (out,) f32; wqkv (3H, H) is [query; key; value].
    ck/cv: (Q, Lk, H) pre-projected cross keys and values (bias folded in);
    cbias: (Q, Lk) additive f32 question-padding bias. Returns (S * la, H).
    The JAX function's ``group`` and ``interpret`` (TPU block size and
    interpret mode) have no counterpart."""
    return _layer(_KERNELS, x, wqkv, bqkv, wo, bo, ln1s, ln1b, wcq, bcq, wco, bco, ln2s, ln2b,
                  wi, bi, wo2, bo2, ln3s, ln3b, ck, cv, cbias, la=la, heads=heads, eps=eps)


def scoring_layer_plain(x, wqkv, bqkv, wo, bo, ln1s, ln1b, wcq, bcq, wco, bco, ln2s, ln2b,
                        wi, bi, wo2, bo2, ln3s, ln3b, ck, cv, cbias, *, la: int, heads: int,
                        eps: float):
    """``scoring_layer`` through the plain versions, on any device."""
    return _layer(_PLAIN, x, wqkv, bqkv, wo, bo, ln1s, ln1b, wcq, bcq, wco, bco, ln2s, ln2b,
                  wi, bi, wo2, bo2, ln3s, ln3b, ck, cv, cbias, la=la, heads=heads, eps=eps)


def fused_scoring_capable(config, batch: int, enc_batch: int, la: int, lk: int,
                          dtype: torch.dtype = torch.bfloat16) -> bool:
    """Gate of the fused scoring path.

    Semantic conditions, the JAX gate's: a grouped batch, ``batch`` answers
    over ``enc_batch`` questions with g = batch / enc_batch >= 2. Kernel
    conditions: widths that are multiples of 8 (16-byte rows for the
    tensor-core tiles), an even head width (the attention reads pairs),
    answers of at most ``MAX_ANSWER_LEN`` tokens (one attention block holds
    whole sequences) and ``lk`` question keys that fit one block's shared
    memory. The TPU's layout conditions (hidden % 128, sublane-aligned
    groups) do not apply."""
    if enc_batch <= 0 or batch % enc_batch or batch // enc_batch < 2:
        return False
    hidden, heads = config.hidden_size, config.num_attention_heads
    if hidden % heads or hidden % 8 or config.intermediate_size % 8:
        return False
    head_dim = hidden // heads
    return (head_dim % 2 == 0 and la <= MAX_ANSWER_LEN
            and cross_attention_smem(lk, head_dim, dtype) <= _MAX_SMEM)


def scoring_decoder_body(encoder, emb, question_states, question_mask, *, config,
                         layernorm_idx: int = 0, layer=scoring_layer):
    """Run the whole decoder stack of ``encoder`` (a ``med.BertEncoder``)
    through ``layer``, ``scoring_layer`` or ``scoring_layer_plain``.

    emb: (S, La, H) embedded answer tokens, S = Q * g grouped by question,
    in the working type. question_states: (Q, Lq, H); question_mask: (Q, Lq)
    1/0. layernorm_idx picks the FFN-output LayerNorm: 0 =
    ``output_LayerNorm``, i >= 1 = ``output_LayerNorms_{i-1}``. Returns
    (S, La, H); padded answer rows carry causal-only values.
    """
    s, la, h = emb.shape
    dt = emb.dtype
    qs = question_states.to(dt)
    cbias = torch.where(question_mask > 0, 0.0, NEG).float()
    x = emb.reshape(s * la, h).contiguous()

    def w(dense):  # the working-type copy ``set_compute_dtype`` made
        return param_as(dense, "weight", dt).contiguous()

    def f32(p):
        return p.float().contiguous()

    for lp in encoder.layer:
        a, ao = lp.attention.self, lp.attention.output
        ca, cao = lp.crossattention.self, lp.crossattention.output
        ln3 = lp.output_LayerNorm if layernorm_idx == 0 else lp.output_LayerNorms[layernorm_idx - 1]
        wqkv = torch.cat([w(a.query), w(a.key), w(a.value)])
        bqkv = torch.cat([f32(a.query.bias), f32(a.key.bias), f32(a.value.bias)])
        # cross K/V once per question per layer, shared by its g answers
        # (module-path products: the bias in the working type, as JAX's)
        ck, cv = ca.key(qs), ca.value(qs)
        x = layer(x, wqkv, bqkv, w(ao.dense), f32(ao.dense.bias),
                  f32(ao.LayerNorm.weight), f32(ao.LayerNorm.bias),
                  w(ca.query), f32(ca.query.bias), w(cao.dense), f32(cao.dense.bias),
                  f32(cao.LayerNorm.weight), f32(cao.LayerNorm.bias),
                  w(lp.intermediate_dense), f32(lp.intermediate_dense.bias),
                  w(lp.output_dense), f32(lp.output_dense.bias),
                  f32(ln3.weight), f32(ln3.bias), ck, cv, cbias,
                  la=la, heads=config.num_attention_heads, eps=config.layer_norm_eps)
    return x.reshape(s, la, h)
