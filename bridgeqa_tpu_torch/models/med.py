"""med-BERT, BLIP's mixture of encoder and decoder, with BridgeQA's twin
encoder (counterpart of ``bridgeqa_tpu/models/med.py``, module path).

Attention is written out: einsum for the scores, softmax in f32, einsum for
the context, as the JAX module does. The JAX package's large-batch VPU
branch computes the same thing and has no counterpart here. Inference only:
no dropout, no KV-cache decode (generation is a later part of the port).
"""

import dataclasses
import math

import torch
from torch import nn

from bridgeqa_tpu_torch.models.layers import Dense, Embed, LayerNorm, add_indexed, gelu

NEG_INF = -10000.0  # HF additive-mask constant
IGNORE_INDEX = -100


@dataclasses.dataclass(frozen=True)
class MedConfig:
    """configs/med_config.json values; the JAX ``MedConfig``'s fields and
    defaults. The port reads the model widths, ``layer_norm_eps``,
    ``add_cross_attention`` and ``parallel_layernorms``; dropout, remat and
    ``fused_scoring`` (the module path is the only one so far) are kept so a
    JAX config carries over unchanged."""

    vocab_size: int = 30524
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_hidden_layers_twin: int | None = None
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    encoder_width: int = 768
    pad_token_id: int = 0
    add_cross_attention: bool = True
    parallel_layernorms: int = 0
    remat: bool = False
    remat_mode: str = "block"
    fused_scoring: str = "auto"

    @property
    def twin_layers(self):
        return self.num_hidden_layers_twin if self.num_hidden_layers_twin is not None else self.num_hidden_layers


def extend_attention_mask(mask: torch.Tensor) -> torch.Tensor:
    """(B, L) 1/0 mask -> (B, 1, 1, L) additive bias."""
    return (1.0 - mask[:, None, None, :].float()) * NEG_INF


def causal_attention_bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, L) padding mask -> (B, 1, L, L) additive causal + padding bias."""
    length = mask.shape[-1]
    causal = torch.tril(torch.ones(length, length, device=mask.device))
    combined = causal[None] * mask[:, None, :].float()
    return ((1.0 - combined) * NEG_INF)[:, None]


def attend(q, k, v, bias=None):
    """q (B, H, Lq, D), k/v (B, H, Lk, D), bias broadcastable to
    (B, H, Lq, Lk) -> context (B, H, Lq, D)."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    probs = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


class BertEmbeddings(nn.Module):
    def __init__(self, c: MedConfig):
        super().__init__()
        self.word_embeddings = Embed(c.vocab_size, c.hidden_size)
        self.position_embeddings = Embed(c.max_position_embeddings, c.hidden_size)
        self.LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps)

    def forward(self, input_ids, position_offset: int = 0):
        x = self.word_embeddings(input_ids)
        pos = torch.arange(input_ids.shape[1], device=input_ids.device) + position_offset
        return self.LayerNorm(x + self.position_embeddings(pos)[None])


class BertSelfAttention(nn.Module):
    def __init__(self, c: MedConfig, is_cross_attention: bool = False):
        super().__init__()
        self.num_heads = c.num_attention_heads
        self.is_cross_attention = is_cross_attention
        kv_width = c.encoder_width if is_cross_attention else c.hidden_size
        self.query = Dense(c.hidden_size, c.hidden_size)
        self.key = Dense(kv_width, c.hidden_size)
        self.value = Dense(kv_width, c.hidden_size)

    def forward(self, hidden_states, attention_bias=None, encoder_hidden_states=None):
        b, lq, h = hidden_states.shape
        nh = self.num_heads
        hd = h // nh
        kv_src = encoder_hidden_states if self.is_cross_attention else hidden_states
        kb, lk = kv_src.shape[:2]
        q = self.query(hidden_states)
        k = self.key(kv_src).reshape(kb, lk, nh, hd).transpose(1, 2)
        v = self.value(kv_src).reshape(kb, lk, nh, hd).transpose(1, 2)
        if self.is_cross_attention and kb != b:
            # grouped cross-attention: g query rows per encoder row (the k
            # answers ranked against one question) fold into the query
            # length, so each question's K/V is projected once
            g = b // kb
            q = q.reshape(kb, g * lq, nh, hd).transpose(1, 2)
        else:
            q = q.reshape(b, lq, nh, hd).transpose(1, 2)
        ctx = attend(q, k, v, attention_bias)
        return ctx.transpose(1, 2).reshape(b, lq, h)


class BertSelfOutput(nn.Module):
    def __init__(self, c: MedConfig):
        super().__init__()
        self.dense = Dense(c.hidden_size, c.hidden_size)
        self.LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps)

    def forward(self, hidden_states, input_tensor):
        return self.LayerNorm(self.dense(hidden_states) + input_tensor)


class BertAttention(nn.Module):
    def __init__(self, c: MedConfig, is_cross_attention: bool = False):
        super().__init__()
        self.self = BertSelfAttention(c, is_cross_attention)
        self.output = BertSelfOutput(c)

    def forward(self, hidden_states, attention_bias=None, encoder_hidden_states=None):
        ctx = self.self(hidden_states, attention_bias, encoder_hidden_states)
        return self.output(ctx, hidden_states)


class BertLayer(nn.Module):
    """Post-LN layer: self-attention, optional cross-attention, FFN. The FFN
    output LayerNorm is ``output_LayerNorm`` for ``layernorm_idx`` 0 and
    ``output_LayerNorms_{idx-1}`` otherwise (``BertOutputParallel``)."""

    def __init__(self, c: MedConfig):
        super().__init__()
        self.attention = BertAttention(c)
        if c.add_cross_attention:
            self.crossattention = BertAttention(c, is_cross_attention=True)
        self.intermediate_dense = Dense(c.hidden_size, c.intermediate_size)
        self.output_dense = Dense(c.intermediate_size, c.hidden_size)
        self.output_LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps)
        self.output_LayerNorms = add_indexed(
            self, "output_LayerNorms_",
            (LayerNorm(c.hidden_size, c.layer_norm_eps) for _ in range(c.parallel_layernorms)))

    def forward(self, hidden_states, attention_bias=None, encoder_hidden_states=None,
                encoder_attention_bias=None, multimodal: bool = True, layernorm_idx: int = 0):
        attention_output = self.attention(hidden_states, attention_bias)
        if multimodal and encoder_hidden_states is not None:
            attention_output = self.crossattention(attention_output, encoder_attention_bias,
                                                   encoder_hidden_states)
        layer_output = self.output_dense(gelu(self.intermediate_dense(attention_output)))
        ln = self.output_LayerNorm if layernorm_idx == 0 else self.output_LayerNorms[layernorm_idx - 1]
        return ln(layer_output + attention_output)


class BertEncoder(nn.Module):
    def __init__(self, c: MedConfig):
        super().__init__()
        self.layer = add_indexed(self, "layer_", (BertLayer(c) for _ in range(c.num_hidden_layers)))

    def forward(self, hidden_states, attention_bias=None, encoder_hidden_states=None,
                encoder_attention_bias=None, multimodal: bool = True, layernorm_idx: int = 0):
        for layer in self.layer:
            hidden_states = layer(hidden_states, attention_bias, encoder_hidden_states,
                                  encoder_attention_bias, multimodal, layernorm_idx)
        return hidden_states


class BertEncoderTwin(nn.Module):
    """Two streams exchanging hidden states every layer: the main (2D)
    stream cross-attends to ``[encoder_hidden ‖ hidden_twin]``, the twin
    (3D) stream to ``[encoder_hidden_twin ‖ hidden_main]``, both using the
    other stream's value from before the layer."""

    def __init__(self, c: MedConfig):
        super().__init__()
        self.layer = add_indexed(self, "layer_", (BertLayer(c) for _ in range(c.num_hidden_layers)))
        self.layer_twin = add_indexed(self, "layer_twin_", (BertLayer(c) for _ in range(c.twin_layers)))

    def forward(self, hidden_states, attention_bias, encoder_hidden_states, encoder_attention_bias,
                encoder_hidden_states_twin, encoder_attention_bias_twin):
        hidden_twin = hidden_states
        for i, layer in enumerate(self.layer):
            cross_mix = torch.cat([encoder_hidden_states, hidden_twin], dim=1)
            cross_mix_twin = torch.cat([encoder_hidden_states_twin, hidden_states], dim=1)
            new_hidden = layer(hidden_states, attention_bias, cross_mix, encoder_attention_bias)
            if i < len(self.layer_twin):
                hidden_twin = self.layer_twin[i](hidden_twin, attention_bias, cross_mix_twin,
                                                 encoder_attention_bias_twin)
            hidden_states = new_hidden
        return hidden_states, hidden_twin


class BertModelTwin(nn.Module):
    """Embeddings + twin encoder; the question mask is appended to the image
    and scene masks for the cross-attention."""

    def __init__(self, c: MedConfig):
        super().__init__()
        self.embeddings = BertEmbeddings(c)
        self.encoder = BertEncoderTwin(c)

    def forward(self, input_ids, attention_mask, encoder_hidden_states, encoder_attention_mask,
                encoder_hidden_states_twin, encoder_attention_mask_twin):
        cross_mask = torch.cat([encoder_attention_mask, attention_mask], dim=1)
        cross_mask_twin = torch.cat([encoder_attention_mask_twin, attention_mask], dim=1)
        return self.encoder(self.embeddings(input_ids), extend_attention_mask(attention_mask),
                            encoder_hidden_states, extend_attention_mask(cross_mask),
                            encoder_hidden_states_twin, extend_attention_mask(cross_mask_twin))


class BertModel(nn.Module):
    def __init__(self, c: MedConfig):
        super().__init__()
        self.embeddings = BertEmbeddings(c)
        self.encoder = BertEncoder(c)

    def forward(self, input_ids, attention_mask=None, encoder_hidden_states=None,
                encoder_attention_mask=None, is_decoder: bool = False, multimodal: bool = True,
                layernorm_idx: int = 0):
        if attention_mask is None:
            attention_mask = torch.ones(input_ids.shape[:2], dtype=torch.int32, device=input_ids.device)
        attention_bias = (causal_attention_bias(attention_mask) if is_decoder
                          else extend_attention_mask(attention_mask))
        cross_bias = None
        if encoder_hidden_states is not None:
            if encoder_attention_mask is None:
                encoder_attention_mask = torch.ones(encoder_hidden_states.shape[:2],
                                                    dtype=torch.int32, device=input_ids.device)
            cross_bias = extend_attention_mask(encoder_attention_mask)
        return self.encoder(self.embeddings(input_ids), attention_bias, encoder_hidden_states,
                            cross_bias, multimodal, layernorm_idx)


class BertLMPredictionHead(nn.Module):
    """Transform (dense, GELU, LayerNorm), then the tied word table and a
    free f32 bias."""

    def __init__(self, c: MedConfig):
        super().__init__()
        self.transform_dense = Dense(c.hidden_size, c.hidden_size)
        self.transform_LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps)
        self.bias = nn.Parameter(torch.zeros(c.vocab_size))

    def transform(self, hidden_states):
        return self.transform_LayerNorm(gelu(self.transform_dense(hidden_states)))

    def forward(self, hidden_states, word_embed: Embed):
        return word_embed.attend(self.transform(hidden_states)) + self.bias

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        self.bias.zero_()


def label_smoothed_from_shifted(shifted_logits, shifted_labels, epsilon: float = 0.1):
    """Per-sequence sum of the label-smoothed (0.1) cross entropy, ignore
    index -100, in logsumexp form: ``nll = lse - logit_target``,
    ``smooth = lse - mean(logits)``; the reductions run in f32."""
    valid = shifted_labels != IGNORE_INDEX
    safe = torch.where(valid, shifted_labels, 0)
    logits32 = shifted_logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    target = shifted_logits.gather(-1, safe[..., None].long())[..., 0].float()
    per_token = (1.0 - epsilon) * (lse - target) + epsilon * (lse - logits32.mean(dim=-1))
    return torch.where(valid, per_token, 0.0).sum(dim=-1)


def label_smoothed_lm_loss(logits, labels, epsilon: float = 0.1):
    """Shift by one, then ``label_smoothed_from_shifted``: (B, L, V), (B, L)
    -> (B,)."""
    return label_smoothed_from_shifted(logits[:, :-1], labels[:, 1:], epsilon)


class BertLMHeadModel(nn.Module):
    """Causal LM decoder with cross-attention and the tied LM head."""

    def __init__(self, c: MedConfig):
        super().__init__()
        self.bert = BertModel(c)
        self.cls = BertLMPredictionHead(c)

    def forward(self, input_ids, attention_mask=None, encoder_hidden_states=None,
                encoder_attention_mask=None, labels=None, loss_chunk_size: int | None = None,
                layernorm_idx: int = 0):
        """Returns (logits | None, per-sequence loss | None).

        With labels and ``loss_chunk_size`` below the batch, the vocabulary
        projection and the loss run one chunk of sequences at a time, so the
        (B, L, vocab) logits never exist at once; logits come back None."""
        sequence_output = self.bert(input_ids, attention_mask, encoder_hidden_states,
                                    encoder_attention_mask, is_decoder=True,
                                    layernorm_idx=layernorm_idx)
        word_embed = self.bert.embeddings.word_embeddings
        b = sequence_output.shape[0]
        if labels is not None and loss_chunk_size is not None and b > loss_chunk_size:
            # the last position predicts nothing: drop it before the head
            h_t = self.cls.transform(sequence_output)[:, :-1]
            shifted = labels[:, 1:]
            table = word_embed.weight.to(h_t.dtype)
            losses = [label_smoothed_from_shifted(h_t[s:s + loss_chunk_size] @ table.T + self.cls.bias,
                                                  shifted[s:s + loss_chunk_size])
                      for s in range(0, b, loss_chunk_size)]
            return None, torch.cat(losses)
        logits = self.cls(sequence_output, word_embed)
        loss = label_smoothed_lm_loss(logits, labels) if labels is not None else None
        return logits, loss
