"""Vision Transformer, BLIP's ViT-B/16 (counterpart of
``bridgeqa_tpu/models/vit.py``): patch embedding, CLS token, learned
position embedding, pre-LN blocks (LayerNorm eps 1e-6, exact GELU), final
LayerNorm. A 480 px image gives 901 tokens.

As in the JAX model, the blocks run either as a module loop or through the
fused block (``ops/vit_block.py``), as ``vit_block.FUSED_MODE`` allows: by
default the fused kernels on the card and the module loop on the CPU. The
fused path runs only in eval mode and without grad; training runs the module
loop, with stochastic depth (``drop_path_rate``, linear over the depth) and,
with ``remat``, each block ("block") or only its attention scores and
probabilities ("attn") recomputed in the backward. The JAX model's
``drop_rate`` and ``attn_drop_rate`` are 0 in every ViT it builds
(``create_vit`` sets neither) and have no counterpart here."""

import torch
from torch import nn

from bridgeqa_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    PatchEmbed,
    _trunc_normal_,
    add_indexed,
    at_least_f32,
    drop_path,
    gelu,
    remat,
)
from bridgeqa_tpu_torch.ops import vit_block as vb
from bridgeqa_tpu_torch.ops.scoring_layer import add_layernorm


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Dense(dim, hidden, init="trunc_normal")
        self.fc2 = Dense(hidden, dim, init="trunc_normal")

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


def _attention_probs_context(q, k, v):
    """softmax(q k^T) v with the softmax in f32: the (B, H, N, N) part, which
    the "attn" remat recomputes."""
    attn = torch.einsum("bhnd,bhmd->bhnm", q, k)
    attn = torch.softmax(at_least_f32(attn), dim=-1).to(q.dtype)  # f32 softmax at least
    return torch.einsum("bhnm,bhmd->bhnd", attn, v)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, dim * 3, bias=qkv_bias, init="trunc_normal")
        self.proj = Dense(dim, dim, init="trunc_normal")
        # recompute the scores and probabilities in the backward ("attn" remat)
        self.remat_probs = False

    def forward(self, x):
        b, n, c = x.shape
        hd = c // self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * hd**-0.5, qkv[1], qkv[2]  # (B, H, N, D)
        if self.remat_probs:
            x = remat(_attention_probs_context, q, k, v)
        else:
            x = _attention_probs_context(q, k, v)
        return self.proj(x.transpose(1, 2).reshape(b, n, c))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path: float = 0.0):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = LayerNorm(dim, 1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias)
        self.norm2 = LayerNorm(dim, 1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        x = x + drop_path(self.attn(self.norm1(x)), self.drop_path, self.training)
        return x + drop_path(self.mlp(self.norm2(x)), self.drop_path, self.training)


class VisionTransformer(nn.Module):
    def __init__(self, img_size: int = 480, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.0, remat: bool = False,
                 remat_mode: str = "block"):
        super().__init__()
        if remat_mode not in ("block", "attn"):
            raise ValueError(f"remat_mode must be 'block' or 'attn', got {remat_mode!r}")
        num_patches = (img_size // patch_size) ** 2
        self.embed_dim = embed_dim
        self.remat_blocks = remat and remat_mode == "block"
        self.patch_embed_proj = PatchEmbed(3, embed_dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, num_patches + 1, embed_dim))
        # per-block stochastic depth, linear over the depth
        rates = [drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
        self.blocks = add_indexed(self, "blocks_", (Block(embed_dim, num_heads, mlp_ratio, qkv_bias,
                                                          rate) for rate in rates))
        for blk in self.blocks:
            blk.attn.remat_probs = remat and remat_mode == "attn"
        self.norm = LayerNorm(embed_dim, 1e-6)

    def embed(self, x):
        """x (B, H, W, 3) channel-last image -> the tokens the first block
        takes, (B, 1 + N, embed_dim): patches, CLS token, position."""
        x = self.patch_embed_proj(x)
        b = x.shape[0]
        cls = self.cls_token.to(x.dtype).expand(b, 1, self.embed_dim)
        x = torch.cat([cls, x], dim=1)
        return x + self.pos_embed[:, : x.shape[1]].to(x.dtype)

    def forward(self, x):
        """x (B, H, W, 3) channel-last image -> (B, 1 + N, embed_dim)."""
        x = self.embed(x)
        attn = self.blocks[0].attn
        # the fused block reads a QKV bias, as the JAX one does; it runs only
        # in eval mode (JAX's deterministic)
        if not self.training and attn.qkv.bias is not None and vb.use_fused(
                self.embed_dim, attn.num_heads, self.blocks[0].mlp.fc1.out_features, x.device):
            x = vb.fused_vit_blocks(self, x)
            n = self.norm
            return add_layernorm(x.reshape(-1, self.embed_dim), None, n.weight.float(),
                                 n.bias.float(), n.eps).reshape(x.shape)
        for blk in self.blocks:
            x = remat(blk, x) if self.remat_blocks else blk(x)
        return self.norm(x)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        _trunc_normal_(self.cls_token, 0.02, generator)
        _trunc_normal_(self.pos_embed, 0.02, generator)


def create_vit(vit: str, image_size: int, custom_embed_dim: int = 256, custom_depth: int = 2,
               custom_heads: int = 4, drop_path_rate: float = 0.0, remat: bool = False,
               remat_mode: str = "block"):
    """(model, width) for "base" (768 wide, 12 deep), "large" (1024, 24) or
    "custom" (tests)."""
    train = dict(drop_path_rate=drop_path_rate, remat=remat, remat_mode=remat_mode)
    if vit == "custom":
        return VisionTransformer(image_size, 16, custom_embed_dim, custom_depth,
                                 custom_heads, **train), custom_embed_dim
    if vit == "base":
        return VisionTransformer(image_size, 16, 768, 12, 12, **train), 768
    if vit == "large":
        return VisionTransformer(image_size, 16, 1024, 24, 16, **train), 1024
    raise ValueError(f"unknown vit size {vit}")
