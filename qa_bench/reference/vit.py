"""BLIP's ViT-B/16 of the reference, plain PyTorch: the module loop
of ``bridgeqa_tpu_torch/models/vit.py`` (pre-LN blocks, LayerNorm eps 1e-6,
exact GELU, final LayerNorm), without the fused blocks, stochastic depth or
remat."""

import torch
from torch import nn

from qa_bench.reference.nn import Dense, LayerNorm, PatchEmbed, add_indexed, gelu, operand, softmax


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp: int):
        super().__init__()
        self.heads = heads
        self.norm1 = LayerNorm(dim, 1e-6)
        self.attn = nn.Module()
        self.attn.qkv = Dense(dim, 3 * dim)
        self.attn.proj = Dense(dim, dim)
        self.norm2 = LayerNorm(dim, 1e-6)
        self.mlp = nn.Module()
        self.mlp.fc1 = Dense(dim, mlp)
        self.mlp.fc2 = Dense(mlp, dim)

    def forward(self, x):
        b, n, _ = x.shape
        qkv = self.attn.qkv(self.norm1(x)).reshape(b, n, 3, self.heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * qkv.shape[-1] ** -0.5, qkv[1], qkv[2]
        probs = softmax(torch.einsum("bhnd,bhmd->bhnm", operand(q), operand(k)))
        ctx = torch.einsum("bhnm,bhmd->bhnd", operand(probs), operand(v))
        ctx = ctx.transpose(1, 2).reshape(b, n, -1)
        x = x + self.attn.proj(ctx)
        return x + self.mlp.fc2(gelu(self.mlp.fc1(self.norm2(x))))


class VisionTransformer(nn.Module):
    def __init__(self, image_size: int, patch: int, dim: int, depth: int, heads: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        tokens = (image_size // patch) ** 2 + 1
        self.dim = dim
        self.patch_embed_proj = PatchEmbed(3, dim, patch)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.empty(1, tokens, dim))
        self.blocks = add_indexed(self, "blocks_", (Block(dim, heads, int(dim * mlp_ratio))
                                                    for _ in range(depth)))
        self.norm = LayerNorm(dim, 1e-6)

    def forward(self, images):
        """(B, H, W, 3) -> (B, 1 + N, dim)."""
        x = self.patch_embed_proj(images)
        x = torch.cat([self.cls_token.to(x.dtype).expand(x.shape[0], 1, self.dim), x], dim=1)
        x = x + self.pos_embed[:, : x.shape[1]].to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)


def vit(c: dict) -> VisionTransformer:
    """The ViT a configuration names: "base" (768 wide, 12 deep, 12 heads)
    or its own sizes under ``vit_embed_dim``, ``vit_depth``, ``vit_heads``."""
    if c.get("vit", "base") == "base":
        return VisionTransformer(c["image_size"], 16, 768, 12, 12)
    return VisionTransformer(c["image_size"], 16, c["vit_custom_embed_dim"],
                             c["vit_custom_depth"], c["vit_custom_heads"])
