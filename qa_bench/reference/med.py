"""med-BERT of the reference (BLIP's encoder and decoder, BridgeQA's twin
encoder), plain PyTorch, eval mode.

Frozen from the module path of ``bridgeqa_tpu_torch/models/med.py``:
attention written out with einsum and a softmax; the answer-scoring decoder
runs its full stack and the vocabulary head a chunk of sequences at a time,
with the label-smoothed (0.1) per-sequence loss. The fused scoring path,
dropout, remat and the KV-cache decode are left out.
"""

import math

import torch
from torch import nn

from qa_bench.reference.nn import Dense, Embed, LayerNorm, add_indexed, gelu, operand, softmax

NEG_INF = -10000.0
IGNORE_INDEX = -100


def mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, L) 1/0 -> (B, 1, 1, L) additive bias."""
    return (1.0 - mask[:, None, None, :].float()) * NEG_INF


def causal_bias(mask: torch.Tensor) -> torch.Tensor:
    length = mask.shape[-1]
    causal = torch.tril(torch.ones(length, length, device=mask.device))
    return ((1.0 - causal[None] * mask[:, None, :].float()) * NEG_INF)[:, None]


def attend(q, k, v, bias=None):
    scores = torch.einsum("bhqd,bhkd->bhqk", operand(q), operand(k)) / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", operand(softmax(scores)), operand(v))


class Embeddings(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.word_embeddings = Embed(c["vocab_size"], c["hidden_size"])
        self.position_embeddings = Embed(c["max_position_embeddings"], c["hidden_size"])
        self.LayerNorm = LayerNorm(c["hidden_size"], c["layer_norm_eps"])

    def forward(self, ids):
        pos = torch.arange(ids.shape[1], device=ids.device)
        return self.LayerNorm(self.word_embeddings(ids) + self.position_embeddings(pos)[None])


class SelfAttention(nn.Module):
    def __init__(self, c: dict, kv_width: int):
        super().__init__()
        h = c["hidden_size"]
        self.heads = c["num_attention_heads"]
        self.query, self.key, self.value = Dense(h, h), Dense(kv_width, h), Dense(kv_width, h)

    def forward(self, x, bias, kv_src):
        b, lq, _ = x.shape
        kb, lk = kv_src.shape[:2]
        nh = self.heads
        k = self.key(kv_src).reshape(kb, lk, nh, -1).transpose(1, 2)
        v = self.value(kv_src).reshape(kb, lk, nh, -1).transpose(1, 2)
        if kb != b:  # the answers of one question share its keys and values
            x = x.reshape(kb, (b // kb) * lq, -1)
        q = self.query(x).reshape(kb, x.shape[1], nh, -1).transpose(1, 2)
        ctx = attend(q, k, v, bias).transpose(1, 2).reshape(kb, x.shape[1], -1)
        return ctx.reshape(b, lq, -1)


class Attention(nn.Module):
    def __init__(self, c: dict, kv_width: int):
        super().__init__()
        h = c["hidden_size"]
        self.self = SelfAttention(c, kv_width)
        self.output = nn.Module()
        self.output.dense = Dense(h, h)
        self.output.LayerNorm = LayerNorm(h, c["layer_norm_eps"])

    def forward(self, x, bias, kv_src):
        o = self.output
        return o.LayerNorm(o.dense(self.self(x, bias, kv_src)) + x)


class Layer(nn.Module):
    """Post-LN: self-attention, cross-attention, FFN."""

    def __init__(self, c: dict, encoder_width: int):
        super().__init__()
        h = c["hidden_size"]
        self.attention = Attention(c, h)
        if c.get("add_cross_attention", True):
            self.crossattention = Attention(c, encoder_width)
        self.intermediate_dense = Dense(h, c["intermediate_size"])
        self.output_dense = Dense(c["intermediate_size"], h)
        self.output_LayerNorm = LayerNorm(h, c["layer_norm_eps"])

    def forward(self, x, bias, enc=None, enc_bias=None):
        x = self.attention(x, bias, x)
        if enc is not None:
            x = self.crossattention(x, enc_bias, enc)
        return self.output_LayerNorm(self.output_dense(gelu(self.intermediate_dense(x))) + x)


class Encoder(nn.Module):
    def __init__(self, c: dict, encoder_width: int, layers: int):
        super().__init__()
        self.layer = add_indexed(self, "layer_", (Layer(c, encoder_width) for _ in range(layers)))

    def forward(self, x, bias, enc=None, enc_bias=None):
        for layer in self.layer:
            x = layer(x, bias, enc, enc_bias)
        return x


class BertModel(nn.Module):
    """Embeddings and encoder: the text tower of ITM (``multimodal=False``:
    no cross-attention) and the body of each decoder."""

    def __init__(self, c: dict, encoder_width: int):
        super().__init__()
        self.embeddings = Embeddings(c)
        self.encoder = Encoder(c, encoder_width, c["num_hidden_layers"])

    def forward(self, ids, mask, enc=None, enc_mask=None, causal=False):
        bias = causal_bias(mask) if causal else mask_bias(mask)
        enc_bias = None if enc is None else mask_bias(enc_mask)
        return self.encoder(self.embeddings(ids), bias, enc, enc_bias)


class TwinEncoder(nn.Module):
    """Two streams exchanging states every layer: the 2D stream attends to
    ``[image ‖ twin state]``, the 3D stream to ``[scene ‖ main state]``,
    both from before the layer."""

    def __init__(self, c: dict, encoder_width: int):
        super().__init__()
        n = c["num_hidden_layers"]
        self.layer = add_indexed(self, "layer_", (Layer(c, encoder_width) for _ in range(n)))
        self.layer_twin = add_indexed(self, "layer_twin_",
                                      (Layer(c, encoder_width) for _ in range(n)))

    def forward(self, x, bias, enc, enc_bias, enc_twin, enc_bias_twin):
        twin = x
        for layer, layer_twin in zip(self.layer, self.layer_twin):
            mix = torch.cat([enc, twin], dim=1)
            mix_twin = torch.cat([enc_twin, x], dim=1)
            x, twin = layer(x, bias, mix, enc_bias), layer_twin(twin, bias, mix_twin,
                                                                enc_bias_twin)
        return x, twin


class BertModelTwin(nn.Module):
    def __init__(self, c: dict, encoder_width: int):
        super().__init__()
        self.embeddings = Embeddings(c)
        self.encoder = TwinEncoder(c, encoder_width)

    def forward(self, ids, mask, image, image_mask, scene, scene_mask):
        return self.encoder(self.embeddings(ids), mask_bias(mask),
                            image, mask_bias(torch.cat([image_mask, mask], dim=1)),
                            scene, mask_bias(torch.cat([scene_mask, mask], dim=1)))


def smoothed_loss(logits, labels, epsilon: float = 0.1):
    """Per-sequence label-smoothed cross entropy of already shifted logits
    (S, L, V) and labels (S, L), ignore index -100."""
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, 0)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    target = logits.gather(-1, safe[..., None])[..., 0]
    per_token = (1.0 - epsilon) * (lse - target) + epsilon * (lse - logits.mean(dim=-1))
    return torch.where(valid, per_token, 0.0).sum(dim=-1)


class LMHeadModel(nn.Module):
    """Causal decoder with cross-attention and the tied LM head."""

    def __init__(self, c: dict, encoder_width: int):
        super().__init__()
        h = c["hidden_size"]
        self.bert = BertModel(c, encoder_width)
        self.cls = nn.Module()
        self.cls.transform_dense = Dense(h, h)
        self.cls.transform_LayerNorm = LayerNorm(h, c["layer_norm_eps"])
        self.cls.bias = nn.Parameter(torch.empty(c["vocab_size"]))

    def states(self, ids, mask, enc, enc_mask):
        """Transformed states (S, L, H) ahead of the vocabulary product."""
        x = self.bert(ids, mask, enc, enc_mask, causal=True)
        return self.cls.transform_LayerNorm(gelu(self.cls.transform_dense(x)))

    def logits(self, states):
        """Against the tied word table, the float32 bias added."""
        return (operand(states) @ operand(self.bert.embeddings.word_embeddings.weight).T
                + self.cls.bias)

    def sequence_loss(self, ids, mask, enc, enc_mask, pad_id: int, chunk: int = 512):
        """Per-sequence loss of each answer (S,), the vocabulary taken a
        chunk of ``chunk`` sequences at a time."""
        h = self.states(ids, mask, enc, enc_mask)[:, :-1]
        labels = torch.where(ids == pad_id, IGNORE_INDEX, ids)[:, 1:]
        return torch.cat([smoothed_loss(self.logits(h[s:s + chunk]), labels[s:s + chunk])
                          for s in range(0, h.shape[0], chunk)])
