"""MCAN fusion modules (counterpart of ``bridgeqa_tpu/models/mcan.py``): the
std-based LayerNorm, MLP, MHAtt, FFN, the SA and SGA blocks, AttFlat pooling
with its top-k attention drop, and the MCAN_E / MCAN_ED cascades. The BLIP
path's grounding head runs SGA; the MCAN path runs MCAN_ED and AttFlat.

Boolean masks are True where masked, as in the reference. Dropout (``pdrop``)
acts in train mode, as the JAX modules place it."""

import math

import torch
from torch import nn

from bridgeqa_tpu_torch.models.generation import top_k_stable
from bridgeqa_tpu_torch.models.layers import (Dense, add_indexed, at_least_f32, dropout, gelu,
                                              uniform)


class McanLayerNorm(nn.Module):
    """``(x - mean) / (std + eps)`` with the unbiased std, then ``a_2`` and
    ``b_2``; in the input's dtype, promoted by the f32 parameters."""

    def __init__(self, size: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.a_2 = nn.Parameter(torch.ones(size))
        self.b_2 = nn.Parameter(torch.zeros(size))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        n = x.shape[-1]
        var = ((x - mean) ** 2).sum(dim=-1, keepdim=True) / max(n - 1, 1)
        return self.a_2 * (x - mean) / (var.sqrt() + self.eps) + self.b_2

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        self.a_2.fill_(1.0)
        self.b_2.zero_()


class MLP(nn.Module):
    def __init__(self, in_size: int, mid_size: int, out_size: int, pdrop: float = 0.0):
        super().__init__()
        self.pdrop = pdrop
        self.fc = Dense(in_size, mid_size)
        self.linear = Dense(mid_size, out_size)

    def forward(self, x):
        return self.linear(dropout(gelu(self.fc(x)), self.pdrop, self.training))


class MHAtt(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int = 8, pdrop: float = 0.1):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.pdrop = pdrop
        self.linear_v = Dense(hidden_size, hidden_size)
        self.linear_k = Dense(hidden_size, hidden_size)
        self.linear_q = Dense(hidden_size, hidden_size)
        self.linear_merge = Dense(hidden_size, hidden_size)

    def forward(self, v, k, q, mask):
        """mask broadcastable to (B, H, Lq, Lk), True = masked."""
        b = q.shape[0]
        hd = self.hidden_size // self.num_heads

        def split(x, dense):
            return dense(x).reshape(b, -1, self.num_heads, hd).transpose(1, 2)

        vh, kh, qh = split(v, self.linear_v), split(k, self.linear_k), split(q, self.linear_q)
        scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / math.sqrt(hd)
        if mask is not None:
            scores = scores.masked_fill(mask, -1e9)
        att = dropout(torch.softmax(at_least_f32(scores), dim=-1).to(v.dtype), self.pdrop,
                      self.training)
        dt = torch.promote_types(att.dtype, vh.dtype)  # the JAX einsum promotes
        out = torch.einsum("bhqk,bhkd->bhqd", att.to(dt), vh.to(dt))
        return self.linear_merge(out.transpose(1, 2).reshape(b, -1, self.hidden_size))


class FFN(nn.Module):
    def __init__(self, hidden_size: int, pdrop: float = 0.1):
        super().__init__()
        self.mlp = MLP(hidden_size, hidden_size * 4, hidden_size, pdrop)

    def forward(self, x):
        return self.mlp(x)


class SGA(nn.Module):
    """Self-attention over x, guided attention from x to y, FFN; each with a
    residual and an MCAN LayerNorm."""

    def __init__(self, hidden_size: int, num_heads: int = 8, pdrop: float = 0.1):
        super().__init__()
        self.pdrop = pdrop
        self.mhatt1 = MHAtt(hidden_size, num_heads, pdrop)
        self.norm1 = McanLayerNorm(hidden_size)
        self.mhatt2 = MHAtt(hidden_size, num_heads, pdrop)
        self.norm2 = McanLayerNorm(hidden_size)
        self.ffn = FFN(hidden_size, pdrop)
        self.norm3 = McanLayerNorm(hidden_size)

    def forward(self, x, y, x_mask, y_mask):
        def drop(t):
            return dropout(t, self.pdrop, self.training)

        x = self.norm1(x + drop(self.mhatt1(x, x, x, x_mask)))
        x = self.norm2(x + drop(self.mhatt2(y, y, x, y_mask)))
        return self.norm3(x + drop(self.ffn(x)))


class SA(nn.Module):
    """Self-attention and FFN, each with a residual and an MCAN LayerNorm."""

    def __init__(self, hidden_size: int, num_heads: int = 8, pdrop: float = 0.1):
        super().__init__()
        self.pdrop = pdrop
        self.mhatt = MHAtt(hidden_size, num_heads, pdrop)
        self.norm1 = McanLayerNorm(hidden_size)
        self.ffn = FFN(hidden_size, pdrop)
        self.norm2 = McanLayerNorm(hidden_size)

    def forward(self, x, x_mask):
        x = self.norm1(x + dropout(self.mhatt(x, x, x, x_mask), self.pdrop, self.training))
        return self.norm2(x + dropout(self.ffn(x), self.pdrop, self.training))


def attention_drop(att: torch.Tensor, att_pdrop: float, topk: int,
                   draws: torch.Tensor) -> torch.Tensor:
    """AttFlat's top-k attention drop (JAX ``AttFlat``, ``mcan.py:161-175``):
    att (B, N, G) scores, ``draws`` (N,) uniform draws, one a token column.
    Each glimpse's top ``min(topk, N)`` tokens are marked, the marks are
    taken off again at the ``int(N * (1 - att_pdrop))`` columns with the
    largest draws, and the tokens still marked get -inf."""
    ntoken = att.shape[1]
    ind = top_k_stable(att.transpose(1, 2), min(topk, ntoken))  # (B, G, k)
    marked = torch.zeros(att.transpose(1, 2).shape, dtype=torch.bool, device=att.device)
    marked.scatter_(-1, ind, True)
    keep_cols = top_k_stable(draws, int(ntoken * (1 - att_pdrop)))
    marked[:, :, keep_cols] = False
    return att.masked_fill(marked.transpose(1, 2), float("-inf"))


class AttFlat(nn.Module):
    """Attention-flatten pooling: an MLP scores each token for each of
    ``flat_glimpses`` glimpses, masked tokens get -1e9, a softmax over the
    tokens weighs their sum, and ``linear_merge`` maps the glimpses'
    concatenation to ``flat_out_size``. In train mode with ``att_pdrop`` > 0
    the top-k attention drop (``attention_drop``) acts first, its column
    draws from the generator ``layers.dropout_rng`` made current."""

    def __init__(self, hidden_size: int, flat_mlp_size: int = 512, flat_glimpses: int = 1,
                 flat_out_size: int = 1024, pdrop: float = 0.1):
        super().__init__()
        self.flat_glimpses = flat_glimpses
        self.mlp = MLP(hidden_size, flat_mlp_size, flat_glimpses, pdrop)
        self.linear_merge = Dense(hidden_size * flat_glimpses, flat_out_size)

    def forward(self, x, x_mask, att_pdrop: float = 0.0, att_drop_topk: int = 100):
        """x (B, N, H); x_mask (B, 1, 1, N) True where masked, or None."""
        att = self.mlp(x)  # (B, N, G)
        if x_mask is not None:
            att = att.masked_fill(x_mask[:, 0, 0, :, None], -1e9)
        if att_pdrop > 0 and self.training:
            att = attention_drop(att, att_pdrop, att_drop_topk, uniform((att.shape[1],), att.device))
        att = torch.softmax(at_least_f32(att), dim=1).to(x.dtype)
        glimpses = [(att[:, :, i:i + 1] * x).sum(dim=1) for i in range(self.flat_glimpses)]
        return self.linear_merge(torch.cat(glimpses, dim=1))


class MCAN_E(nn.Module):  # noqa: N801 (the JAX package's name)
    """``num_layers`` SA blocks."""

    def __init__(self, hidden_size: int, num_heads: int = 8, num_layers: int = 6,
                 pdrop: float = 0.1):
        super().__init__()
        self.enc = add_indexed(self, "enc_", (SA(hidden_size, num_heads, pdrop)
                                              for _ in range(num_layers)))

    def forward(self, x, x_mask):
        for enc in self.enc:
            x = enc(x, x_mask)
        return x


class MCAN_ED(nn.Module):  # noqa: N801 (the JAX package's name)
    """Encoder-decoder cascade: ``num_layers`` SA blocks over x, then
    ``num_layers`` SGA blocks over y, each guided by the encoded x."""

    def __init__(self, hidden_size: int, num_heads: int = 8, num_layers: int = 6,
                 pdrop: float = 0.1):
        super().__init__()
        self.enc = add_indexed(self, "enc_", (SA(hidden_size, num_heads, pdrop)
                                              for _ in range(num_layers)))
        self.dec = add_indexed(self, "dec_", (SGA(hidden_size, num_heads, pdrop)
                                              for _ in range(num_layers)))

    def forward(self, x, y, x_mask, y_mask):
        for enc in self.enc:
            x = enc(x, x_mask)
        for dec in self.dec:
            y = dec(y, x, y_mask, x_mask)
        return x, y
