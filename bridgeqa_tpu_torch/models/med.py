"""med-BERT, BLIP's mixture of encoder and decoder, with BridgeQA's twin
encoder (counterpart of ``bridgeqa_tpu/models/med.py``).

Module path: attention is written out, einsum for the scores, softmax in
f32, einsum for the context, as the JAX module does. The JAX package's
large-batch VPU branch computes the same thing and has no counterpart here.
The answer-scoring call of ``BertLMHeadModel`` takes the fused path instead
where ``MedConfig.fused_scoring`` lets it (``_fused_scoring_loss``):
``ops/scoring_layer.py`` and ``ops/vocab_loss.py``, hand-written kernels on
the card. Generation decodes one token at a time against a KV cache
(``BertLMHeadModel.init_cache`` and ``decode_step``), in plain PyTorch as the
JAX package decodes in plain XLA.

Training (``model.train()``, JAX's ``deterministic=False``): dropout after
the embeddings, on the attention probabilities and after the attention and
FFN output products, as the JAX modules place it, drawn from the generator
``layers.dropout_rng`` makes current; with ``remat`` each layer ("block"),
or only its attention scores and probabilities ("attn"), is recomputed in
the backward (``layers.remat``). The fused path runs only in eval mode.
"""

import dataclasses
import math

import torch
from torch import nn

from bridgeqa_tpu_torch.models.layers import (
    Dense,
    Embed,
    LayerNorm,
    add_indexed,
    at_least_f32,
    compute_dtype,
    dropout,
    gelu,
    param_as,
    remat,
)
from bridgeqa_tpu_torch.ops.scoring_layer import fused_scoring_capable, scoring_decoder_body
from bridgeqa_tpu_torch.ops.vocab_loss import label_smoothed_loss_streaming

NEG_INF = -10000.0  # HF additive-mask constant
IGNORE_INDEX = -100


@dataclasses.dataclass(frozen=True)
class MedConfig:
    """configs/med_config.json values; the JAX ``MedConfig``'s fields and
    defaults. The port reads every field; ``remat`` and the dropout rates
    act in train mode only.

    ``fused_scoring`` routes the answer-scoring call (labels, a grouped
    batch): "auto" takes the fused kernels on a CUDA tensor and the module
    path on the CPU (the JAX package's "TPU only"); "force" takes the fused
    path on the CPU too, through the kernels' plain versions (the JAX
    package's interpret mode); "off" always takes the module path."""

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


def attend(q, k, v, bias=None, drop: float = 0.0):
    """q (B, H, Lq, D), k/v (B, H, Lk, D), bias broadcastable to
    (B, H, Lq, Lk) -> context (B, H, Lq, D); ``drop``: the dropout rate of
    the probabilities (0 outside training)."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    probs = torch.softmax(at_least_f32(scores), dim=-1).to(scores.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", dropout(probs, drop, drop > 0.0), v)


class BertEmbeddings(nn.Module):
    def __init__(self, c: MedConfig):
        super().__init__()
        self.word_embeddings = Embed(c.vocab_size, c.hidden_size)
        self.position_embeddings = Embed(c.max_position_embeddings, c.hidden_size)
        self.LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps)
        self.drop = c.hidden_dropout_prob

    def forward(self, input_ids, position_offset: int = 0):
        x = self.word_embeddings(input_ids)
        pos = torch.arange(input_ids.shape[1], device=input_ids.device) + position_offset
        return dropout(self.LayerNorm(x + self.position_embeddings(pos)[None]), self.drop,
                       self.training)


class BertSelfAttention(nn.Module):
    def __init__(self, c: MedConfig, is_cross_attention: bool = False):
        super().__init__()
        self.num_heads = c.num_attention_heads
        self.is_cross_attention = is_cross_attention
        kv_width = c.encoder_width if is_cross_attention else c.hidden_size
        self.query = Dense(c.hidden_size, c.hidden_size)
        self.key = Dense(kv_width, c.hidden_size)
        self.value = Dense(kv_width, c.hidden_size)
        self.drop = c.attention_probs_dropout_prob
        # recompute the scores and probabilities in the backward ("attn" remat)
        self.remat_probs = c.remat and c.remat_mode == "attn"

    def project_kv(self, kv_src):
        """(B, Lk, *) -> K, V (B, nh, Lk, hd): the cacheable half."""
        kb, lk = kv_src.shape[:2]
        nh = self.num_heads
        hd = self.key.out_features // nh
        k = self.key(kv_src).reshape(kb, lk, nh, hd).transpose(1, 2)
        v = self.value(kv_src).reshape(kb, lk, nh, hd).transpose(1, 2)
        return k, v

    def attend_cached(self, hidden_states, k, v, attention_bias=None, drop: float = 0.0):
        """Queries from ``hidden_states`` (B, Lq, H) against K/V already
        projected (``project_kv``, or a KV cache) -> context (B, Lq, H).
        ``drop``: the probabilities' dropout rate (the forward's; 0 when
        decoding)."""
        b, lq, h = hidden_states.shape
        nh = self.num_heads
        q = self.query(hidden_states).reshape(b, lq, nh, h // nh).transpose(1, 2)
        if self.remat_probs:
            ctx = remat(attend, q, k, v, attention_bias, drop)
        else:
            ctx = attend(q, k, v, attention_bias, drop)
        return ctx.transpose(1, 2).reshape(b, lq, h)

    def forward(self, hidden_states, attention_bias=None, encoder_hidden_states=None):
        b, lq, h = hidden_states.shape
        k, v = self.project_kv(encoder_hidden_states if self.is_cross_attention
                               else hidden_states)
        kb = k.shape[0]
        drop = self.drop if self.training else 0.0
        if self.is_cross_attention and kb != b:
            # grouped cross-attention: g query rows per encoder row (the k
            # answers ranked against one question) fold into the query
            # length, so each question's K/V is projected once
            grouped = hidden_states.reshape(kb, (b // kb) * lq, h)
            return self.attend_cached(grouped, k, v, attention_bias, drop).reshape(b, lq, h)
        return self.attend_cached(hidden_states, k, v, attention_bias, drop)


class BertSelfOutput(nn.Module):
    def __init__(self, c: MedConfig):
        super().__init__()
        self.dense = Dense(c.hidden_size, c.hidden_size)
        self.LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps)
        self.drop = c.hidden_dropout_prob

    def forward(self, hidden_states, input_tensor):
        hidden_states = dropout(self.dense(hidden_states), self.drop, self.training)
        return self.LayerNorm(hidden_states + input_tensor)


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
        self.drop = c.hidden_dropout_prob

    def forward(self, hidden_states, attention_bias=None, encoder_hidden_states=None,
                encoder_attention_bias=None, multimodal: bool = True, layernorm_idx: int = 0):
        attention_output = self.attention(hidden_states, attention_bias)
        if multimodal and encoder_hidden_states is not None:
            attention_output = self.crossattention(attention_output, encoder_attention_bias,
                                                   encoder_hidden_states)
        layer_output = dropout(self.output_dense(gelu(self.intermediate_dense(attention_output))),
                               self.drop, self.training)
        return self._ffn_layernorm(layernorm_idx)(layer_output + attention_output)

    def _ffn_layernorm(self, layernorm_idx: int) -> LayerNorm:
        return self.output_LayerNorm if layernorm_idx == 0 else self.output_LayerNorms[layernorm_idx - 1]

    # ---- KV-cache decode (inference only; JAX ``med.py:307-331``) ----

    def decode_kv_init(self, encoder_hidden_states):
        """The cross-attention's K/V from the encoder states, projected once
        per generation instead of once per decode step."""
        return self.crossattention.self.project_kv(encoder_hidden_states)

    def decode_step(self, hidden, layer_cache: dict, pos: int, self_bias, cross_bias,
                    layernorm_idx: int = 0):
        """One token through the layer: write its self K/V into the cache
        at ``pos``, attend over the cached prefix (``self_bias`` masks the
        positions after ``pos``) and to the fixed cross K/V. The write goes
        into ``layer_cache``'s buffers in place (JAX returns updated
        copies): the beam search's reorder gives every step new buffers.
        Returns (output (B, 1, H), the layer's cache)."""
        k_new, v_new = self.attention.self.project_kv(hidden)
        self_k, self_v = layer_cache["self_k"], layer_cache["self_v"]
        self_k[:, :, pos:pos + 1] = k_new
        self_v[:, :, pos:pos + 1] = v_new
        ctx = self.attention.self.attend_cached(hidden, self_k, self_v, self_bias)
        attention_output = self.attention.output(ctx, hidden)
        cctx = self.crossattention.self.attend_cached(attention_output, layer_cache["cross_k"],
                                                      layer_cache["cross_v"], cross_bias)
        attention_output = self.crossattention.output(cctx, attention_output)
        layer_output = self.output_dense(gelu(self.intermediate_dense(attention_output)))
        return self._ffn_layernorm(layernorm_idx)(layer_output + attention_output), layer_cache


def _remat_whole_layers(c: MedConfig) -> bool:
    """Whether each layer is recomputed whole in the backward ("block")."""
    if c.remat_mode not in ("block", "attn"):
        raise ValueError(f"remat_mode must be 'block' or 'attn', got {c.remat_mode!r}")
    return c.remat and c.remat_mode == "block"


class BertEncoder(nn.Module):
    def __init__(self, c: MedConfig):
        super().__init__()
        self.remat_layers = _remat_whole_layers(c)
        self.layer = add_indexed(self, "layer_", (BertLayer(c) for _ in range(c.num_hidden_layers)))

    def forward(self, hidden_states, attention_bias=None, encoder_hidden_states=None,
                encoder_attention_bias=None, multimodal: bool = True, layernorm_idx: int = 0):
        for layer in self.layer:
            args = (hidden_states, attention_bias, encoder_hidden_states, encoder_attention_bias,
                    multimodal, layernorm_idx)
            hidden_states = remat(layer, *args) if self.remat_layers else layer(*args)
        return hidden_states


class BertEncoderTwin(nn.Module):
    """Two streams exchanging hidden states every layer: the main (2D)
    stream cross-attends to ``[encoder_hidden ‖ hidden_twin]``, the twin
    (3D) stream to ``[encoder_hidden_twin ‖ hidden_main]``, both using the
    other stream's value from before the layer."""

    def __init__(self, c: MedConfig):
        super().__init__()
        self.remat_layers = _remat_whole_layers(c)
        self.layer = add_indexed(self, "layer_", (BertLayer(c) for _ in range(c.num_hidden_layers)))
        self.layer_twin = add_indexed(self, "layer_twin_", (BertLayer(c) for _ in range(c.twin_layers)))

    def forward(self, hidden_states, attention_bias, encoder_hidden_states, encoder_attention_bias,
                encoder_hidden_states_twin, encoder_attention_bias_twin):
        def run(layer, *args):
            return remat(layer, *args) if self.remat_layers else layer(*args)

        hidden_twin = hidden_states
        for i, layer in enumerate(self.layer):
            cross_mix = torch.cat([encoder_hidden_states, hidden_twin], dim=1)
            cross_mix_twin = torch.cat([encoder_hidden_states_twin, hidden_states], dim=1)
            new_hidden = run(layer, hidden_states, attention_bias, cross_mix, encoder_attention_bias)
            if i < len(self.layer_twin):
                hidden_twin = run(self.layer_twin[i], hidden_twin, attention_bias, cross_mix_twin,
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
    ``smooth = lse - mean(logits)``; the reductions run in at least f32."""
    valid = shifted_labels != IGNORE_INDEX
    safe = torch.where(valid, shifted_labels, 0)
    logits32 = at_least_f32(shifted_logits)
    lse = torch.logsumexp(logits32, dim=-1)
    target = at_least_f32(shifted_logits.gather(-1, safe[..., None].long())[..., 0])
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
        self.config = c
        self.bert = BertModel(c)
        self.cls = BertLMPredictionHead(c)

    def forward(self, input_ids, attention_mask=None, encoder_hidden_states=None,
                encoder_attention_mask=None, labels=None, loss_chunk_size: int | None = None,
                layernorm_idx: int = 0):
        """Returns (logits | None, per-sequence loss | None).

        The fused scoring path is tried first (``_fused_scoring_loss``);
        where it runs, logits come back None. Otherwise, with labels and
        ``loss_chunk_size`` below the batch, the vocabulary projection and
        the loss run one chunk of sequences at a time, so the (B, L, vocab)
        logits never exist at once; logits come back None."""
        fused = self._fused_scoring_loss(input_ids, encoder_hidden_states, encoder_attention_mask,
                                         labels, layernorm_idx)
        if fused is not None:
            return None, fused
        sequence_output = self.bert(input_ids, attention_mask, encoder_hidden_states,
                                    encoder_attention_mask, is_decoder=True,
                                    layernorm_idx=layernorm_idx)
        word_embed = self.bert.embeddings.word_embeddings
        b = sequence_output.shape[0]
        if labels is not None and loss_chunk_size is not None and b > loss_chunk_size:
            # the last position predicts nothing: drop it before the head
            h_t = self.cls.transform(sequence_output)[:, :-1]
            shifted = labels[:, 1:]
            table = param_as(word_embed, "weight", h_t.dtype)
            losses = [label_smoothed_from_shifted(h_t[s:s + loss_chunk_size] @ table.T + self.cls.bias,
                                                  shifted[s:s + loss_chunk_size])
                      for s in range(0, b, loss_chunk_size)]
            return None, torch.cat(losses)
        logits = self.cls(sequence_output, word_embed)
        loss = label_smoothed_lm_loss(logits, labels) if labels is not None else None
        return logits, loss

    def _fused_scoring_loss(self, input_ids, encoder_hidden_states, encoder_attention_mask,
                            labels, layernorm_idx: int = 0):
        """Answer-scoring fast path (JAX ``med.py:595-644``): the decoder
        stack through ``scoring_decoder_body`` and the loss through the
        streaming vocabulary reductions. Returns the per-sequence loss, or
        None where the module path should run.

        It runs for a call with labels and encoder states over a grouped
        batch (``fused_scoring_capable``), as ``fused_scoring`` allows, and
        never in train mode or where a gradient is wanted
        (``torch.is_grad_enabled()``; together the port's counterpart of
        JAX's ``not deterministic``) or with ``remat``: the kernels have no
        backward. It drops the answer padding
        mask (equivalent for right-padded answers) and projects the
        vocabulary in f32 where the module path rounds the logits to the
        working type."""
        c = self.config
        if c.fused_scoring not in ("auto", "force", "off"):
            raise ValueError(f"fused_scoring must be 'auto', 'force' or 'off', got "
                             f"{c.fused_scoring!r}")
        if (labels is None or encoder_hidden_states is None or c.fused_scoring == "off"
                or c.remat or self.training or torch.is_grad_enabled()):
            return None
        if c.fused_scoring == "auto" and input_ids.device.type != "cuda":
            return None
        word_embed = self.bert.embeddings.word_embeddings
        (batch, la), (enc_batch, lk) = input_ids.shape, encoder_hidden_states.shape[:2]
        if not fused_scoring_capable(c, batch, enc_batch, la, lk, compute_dtype(word_embed)):
            return None
        if encoder_attention_mask is None:
            encoder_attention_mask = torch.ones((enc_batch, lk), dtype=torch.int32,
                                                device=input_ids.device)
        x = scoring_decoder_body(self.bert.encoder, self.bert.embeddings(input_ids),
                                 encoder_hidden_states, encoder_attention_mask, config=c,
                                 layernorm_idx=layernorm_idx)
        h_t = self.cls.transform(x)[:, :-1]
        return label_smoothed_loss_streaming(h_t, labels[:, 1:],
                                             param_as(word_embed, "weight", h_t.dtype),
                                             self.cls.bias)

    # ---- KV-cache decode path (generation; see BertLayer.decode_step) ----

    def init_cache(self, question_states, question_mask, max_length: int) -> dict:
        """The decode cache: each layer's cross K/V projected once from the
        question states (B, Lq, H), zeroed self K/V buffers (B, nh,
        max_length, hd) in the compute dtype, the question mask's additive
        bias and the position ``pos`` (a Python int: the decode loop runs on
        the host). Not with ``config.remat``, as in JAX."""
        c = self.config
        if c.remat:
            raise ValueError("KV-cache decode requires remat=False layers")
        nh = c.num_attention_heads
        hd = c.hidden_size // nh
        b = question_states.shape[0]
        layers = []
        for layer in self.bert.encoder.layer:
            ck, cv = layer.decode_kv_init(question_states)
            layers.append({"self_k": ck.new_zeros((b, nh, max_length, hd)),
                           "self_v": cv.new_zeros((b, nh, max_length, hd)),
                           "cross_k": ck, "cross_v": cv})
        return {"pos": 0, "layers": layers, "cross_bias": extend_attention_mask(question_mask)}

    def decode_step(self, token_ids, cache: dict, layernorm_idx: int = 0):
        """token_ids (B, 1) at position ``cache["pos"]`` -> (next-token logits
        (B, V), the cache with ``pos`` one further). No host sync."""
        pos = cache["pos"]
        hidden = self.bert.embeddings(token_ids, position_offset=pos)
        max_len = cache["layers"][0]["self_k"].shape[2]
        positions = torch.arange(max_len, device=token_ids.device)
        self_bias = torch.where(positions <= pos, 0.0, NEG_INF)[None, None, None, :]
        layers = []
        for layer, lc in zip(self.bert.encoder.layer, cache["layers"]):
            hidden, lc = layer.decode_step(hidden, lc, pos, self_bias, cache["cross_bias"],
                                           layernorm_idx)
            layers.append(lc)
        logits = self.cls(hidden, self.bert.embeddings.word_embeddings)
        return logits[:, 0], {"pos": pos + 1, "layers": layers, "cross_bias": cache["cross_bias"]}
