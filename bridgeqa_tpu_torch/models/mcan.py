"""MCAN blocks used by the grounding head (counterpart of ``McanLayerNorm``,
``MLP``, ``MHAtt``, ``FFN`` and ``SGA`` in ``bridgeqa_tpu/models/mcan.py``).

Boolean masks are True where masked, as in the reference. Dropout (``pdrop``)
acts in train mode, as the JAX modules place it."""

import math

import torch
from torch import nn

from bridgeqa_tpu_torch.models.layers import Dense, at_least_f32, dropout, gelu


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
