"""Fused ViT encoder block (pre-LN), inference.

Counterpart of ``bridgeqa_tpu/ops/vit_block.py``. The TPU runs a whole block
(LN1, QKV, 12-head softmax attention, projection and residual, LN2, MLP with
exact GELU, residual) in one Pallas kernel with the block's weights in VMEM;
a Hopper block has 227 KB of shared memory, so here a block is seven
launches of three hand-written kernels:

- ``scoring_layer.add_layernorm`` (``csrc/scoring_layernorm.cu``): LN1 with
  no residual, and LN2 after the attention's residual, keeping the sum
  ``x1 = x + attn`` (the block's second residual);
- ``scoring_layer.scoring_gemm`` (``csrc/scoring_gemm.cu``): QKV, the
  attention output, MLP in with GELU, and MLP out with ``x1`` added in its
  epilogue;
- ``vit_attention`` (``csrc/vit_attention.cu``): bidirectional attention over
  the N tokens, per image and head.

``fused_vit_blocks`` runs every block of a ``models.vit.VisionTransformer``;
the model's final LayerNorm follows as one more ``add_layernorm`` launch.

``FUSED_MODE`` picks the path of ``VisionTransformer.forward``: "auto" runs
the kernels on a CUDA tensor and the module loop on the CPU, "force" runs the
fused path on the CPU too, through the plain versions (the CPU tests), and
"off" runs the module loop. On a CUDA tensor the wrappers launch their
kernels and never fall back: a tensor a kernel does not take raises.

Numerics, the Pallas kernel's but one: LayerNorm statistics in f32 with the
one-pass variance ``mean(y^2) - mu^2``, scale and shift in f32, one rounding
to the working type; every product takes working-type inputs, accumulates
in f32, adds the f32 bias and rounds once; scores ``(q . k) * scale`` in f32;
the residual sums in the working type; exact erf GELU. The one: the softmax
is normalised after the product with V, as the scoring kernel does
(``scoring_layer._attend_plain``): ``e = exp(s - max)`` is rounded to the
working type for the product and the f32 context is divided by the f32 sum
of the unrounded ``e``. The TPU kernel rounds ``p = e / sum(e)`` instead,
only because the deferred form's buffers did not fit Mosaic's scoped VMEM
(``bridgeqa_tpu/ops/vit_block.py:71-75``); on the card the deferred form
lets the kernel sweep the keys once. Both ``e`` and ``p`` lie in [0, 1] and
round with the same relative error, so the two orders agree to a few f32
ulps in f32 and within the bf16 rounding in bf16 (``tests/test_torch_vit.py``
holds both against JAX). The TPU kernel pads 901 tokens to 912 and masks the
padded keys with -1e9, which gives them exactly 0 weight; here N is not
padded.

Weights are in ``nn.Linear`` layout, (out, in); biases and LayerNorm
parameters (out,) f32.
"""

import math

import torch

from bridgeqa_tpu_torch.ops import cuda_lib
from bridgeqa_tpu_torch.ops.scoring_layer import (
    _attend_plain,
    add_layernorm,
    add_layernorm_plain,
    scoring_gemm,
    scoring_gemm_plain,
)

# "auto": kernels on a CUDA tensor, module loop on the CPU; "force": the
# fused path on any device; "off": the module loop
FUSED_MODE = "auto"
# the head width the attention kernel takes
HEAD_DIM = 64

# launches of the attention kernel since the last reset (chip_smoke.py reads
# and resets it)
launches = 0
# launches of each kernel that one ``vit_block`` call makes (the model's
# final LayerNorm adds one ``scoring_layernorm`` launch per forward)
LAUNCHES_PER_BLOCK = {"scoring_gemm": 4, "vit_attention": 1, "scoring_layernorm": 2}


def fused_vit_capable(embed_dim: int, heads: int, mlp_dim: int | None = None) -> bool:
    """The kernels' conditions: widths that are multiples of 8 (16-byte
    rows for the tensor-core tiles) and the head width the attention kernel
    takes. The TPU's ``embed_dim % 128`` does not apply. ``mlp_dim`` defaults
    to the ViT's 4 x ``embed_dim``."""
    mlp_dim = 4 * embed_dim if mlp_dim is None else mlp_dim
    return (heads > 0 and embed_dim % heads == 0 and embed_dim // heads == HEAD_DIM
            and embed_dim % 8 == 0 and mlp_dim % 8 == 0)


def use_fused(embed_dim: int, heads: int, mlp_dim: int, device: torch.device) -> bool:
    """Whether ``VisionTransformer.forward`` takes the fused path, as
    ``FUSED_MODE`` allows (the JAX model's ``_use_fused_blocks``)."""
    if FUSED_MODE not in ("auto", "force", "off"):
        raise ValueError(f"vit_block.FUSED_MODE must be 'auto', 'force' or 'off', got "
                         f"{FUSED_MODE!r}")
    if FUSED_MODE == "off" or not fused_vit_capable(embed_dim, heads, mlp_dim):
        return False
    return device.type == "cuda" or FUSED_MODE == "force"


# ---------------------------------------------------------------- attention

def vit_attention(qkv: torch.Tensor, *, heads: int) -> torch.Tensor:
    """Softmax attention over all N tokens of each image: qkv (B, N, 3H),
    [queries | keys | values] along each row; returns the context (B, N, H)."""
    global launches
    if qkv.dim() != 3 or qkv.shape[2] % (3 * heads):
        raise ValueError(f"vit_attention: qkv {tuple(qkv.shape)}, heads {heads}")
    if qkv.device.type == "cpu":
        return vit_attention_plain(qkv, heads=heads)
    cuda_lib.check_cuda("vit_attention", qkv.dtype, qkv)
    b, n, h3 = qkv.shape
    h = h3 // 3
    if h // heads != HEAD_DIM or qkv.data_ptr() % 16:
        raise ValueError(f"vit_attention: the kernel takes head width {HEAD_DIM} and a 16-byte "
                         f"aligned qkv, got {h // heads}")
    out = torch.empty((b, n, h), dtype=qkv.dtype, device=qkv.device)
    rc = cuda_lib.lib().bq_vit_attention(qkv.data_ptr(), out.data_ptr(), b, n, heads, HEAD_DIM,
                                         1.0 / math.sqrt(HEAD_DIM), cuda_lib.DTYPE_CODES[qkv.dtype],
                                         cuda_lib.stream_handle(qkv.device))
    cuda_lib.check(rc, "bq_vit_attention")
    launches += 1
    return out


def vit_attention_plain(qkv, *, heads: int):
    """Plain PyTorch ``vit_attention``: f32 scores of the up-cast inputs and
    the deferred normalisation of ``scoring_layer._attend_plain`` (``e``
    rounded to the working type, f32 context over the f32 sum, one
    rounding)."""
    b, n, h3 = qkv.shape
    h = h3 // 3
    hd = h // heads
    q, k, v = qkv.reshape(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(hd))
    return _attend_plain(s, v, qkv.dtype).transpose(1, 2).reshape(b, n, h)


# ---------------------------------------------------------------- the block

def _block(ops, x, wqkv, bqkv, wo, bo, ln1s, ln1b, wi, bi, wo2, bo2, ln2s, ln2b, *, heads, eps):
    gemm, attention, layernorm = ops
    b, n, h = x.shape
    x = x.reshape(b * n, h)
    qkv = gemm(layernorm(x, None, ln1s, ln1b, eps), wqkv, bqkv)
    ctx = attention(qkv.reshape(b, n, 3 * h), heads=heads).reshape(b * n, h)
    x1, y2 = layernorm(gemm(ctx, wo, bo), x, ln2s, ln2b, eps, keep_sum=True)
    out = gemm(gemm(y2, wi, bi, gelu=True), wo2, bo2, residual=x1)
    return out.reshape(b, n, h)


_KERNELS = (scoring_gemm, vit_attention, add_layernorm)
_PLAIN = (scoring_gemm_plain, vit_attention_plain, add_layernorm_plain)


def vit_block(x, wqkv, bqkv, wo, bo, ln1s, ln1b, wi, bi, wo2, bo2, ln2s, ln2b, *, heads: int,
              eps: float):
    """One pre-LN ViT block on x (B, N, H) in the working type: weights
    (out, in) in the working type, wqkv (3H, H) is [query; key; value];
    biases and LayerNorm parameters (out,) f32. Returns (B, N, H). The JAX
    function's ``valid`` and ``interpret`` (token padding and interpret mode)
    have no counterpart."""
    return _block(_KERNELS, x, wqkv, bqkv, wo, bo, ln1s, ln1b, wi, bi, wo2, bo2, ln2s, ln2b,
                  heads=heads, eps=eps)


def vit_block_plain(x, wqkv, bqkv, wo, bo, ln1s, ln1b, wi, bi, wo2, bo2, ln2s, ln2b, *,
                    heads: int, eps: float):
    """``vit_block`` through the plain versions, on any device."""
    return _block(_PLAIN, x, wqkv, bqkv, wo, bo, ln1s, ln1b, wi, bi, wo2, bo2, ln2s, ln2b,
                  heads=heads, eps=eps)


def fused_vit_blocks(vit, x, *, eps: float = 1e-6, block=vit_block):
    """Run every block of ``vit`` (a ``models.vit.VisionTransformer``)
    through ``block``, ``vit_block`` or ``vit_block_plain``. x: (B, N, H)
    tokens after the position embedding, in the working type. Returns
    (B, N, H) before the final LayerNorm, as the JAX function does."""
    dt = x.dtype
    x = x.contiguous()

    def w(dense):
        return dense.weight.to(dt).contiguous()

    def f32(p):
        return p.float().contiguous()

    for blk in vit.blocks:
        a, mlp = blk.attn, blk.mlp
        x = block(x, w(a.qkv), f32(a.qkv.bias), w(a.proj), f32(a.proj.bias),
                  f32(blk.norm1.weight), f32(blk.norm1.bias), w(mlp.fc1), f32(mlp.fc1.bias),
                  w(mlp.fc2), f32(mlp.fc2.bias), f32(blk.norm2.weight), f32(blk.norm2.bias),
                  heads=a.num_heads, eps=eps)
    return x
