"""Language encoders of the MCAN (3D-only) path (counterpart of
``bridgeqa_tpu/models/lang.py``): the (bi)LSTM over pre-embedded words
(``LangModule``), the projection over CLIP token features
(``CLIPLangModule``) and the BERT encoder whose states feed the LSTM
(``BertLangEncoder``).

The JAX package builds these modules without a dtype, so flax computes them
in their parameters' dtype (f32) under any compute dtype of the model; here
they set ``keeps_param_dtype``, and ``layers.set_compute_dtype`` leaves them
so. The LSTM is plain PyTorch, as the JAX package leaves it to XLA: one
input product over every step, then a loop over the steps (at most
``MAX_TEXT_LEN``, 36, in the data).
"""

import torch
from torch import nn

from bridgeqa_tpu_torch.models.layers import Dense, dropout
from bridgeqa_tpu_torch.models.med import BertModel, MedConfig, extend_attention_mask

GATES = ("i", "f", "g", "o")


class OptimizedLSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell`` under its parameter names: the input
    products ``ii``, ``if``, ``ig``, ``io`` (kernels only, lecun normal) and
    the hidden products ``hi``, ``hf``, ``hg``, ``ho`` (kernels, orthogonal,
    and biases). ``i, f, o = sigmoid``, ``g = tanh`` of the two products'
    sum; ``c' = f c + i g``, ``h' = o tanh(c')``."""

    def __init__(self, in_features: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        for gate in GATES:  # ``if`` is a keyword: registered by name
            self.add_module(f"i{gate}", Dense(in_features, hidden_size, bias=False, init="lecun"))
            self.add_module(f"h{gate}", Dense(hidden_size, hidden_size, init="orthogonal"))

    def project_inputs(self, x: torch.Tensor) -> torch.Tensor:
        """The input products of every step at once: (B, L, E) -> (B, L, 4, H)."""
        return torch.stack([getattr(self, f"i{gate}")(x) for gate in GATES], dim=-2)

    def step(self, carry, x_proj: torch.Tensor):
        """One step: carry (c, h), each (B, H); x_proj (B, 4, H), this
        step's input products. Returns the new (c, h)."""
        c, h = carry
        i, f, g, o = (getattr(self, f"h{gate}")(h) + x_proj[:, k] for k, gate in enumerate(GATES))
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)


def flip_sequences(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Each row of x (B, L, ...) reversed within its own length, the padding
    kept at the end in reverse (flax ``flip_sequences``); its own inverse."""
    steps = x.shape[1]
    order = (torch.arange(steps - 1, -1, -1, device=x.device)[None] + lengths[:, None]) % steps
    return x.gather(1, order.reshape(order.shape + (1,) * (x.dim() - 2)).expand_as(x))


def run_lstm(cell: OptimizedLSTMCell, x: torch.Tensor, lengths: torch.Tensor,
             reverse: bool = False):
    """flax ``nn.RNN(cell, return_carry=True, reverse=..., keep_order=True)``
    with ``seq_lengths``: a zero carry, every step run, the carry taken at
    each row's last true step (``lengths - 1``); with ``reverse`` each row
    runs reversed within its length and its outputs come back in input
    order. Returns ((c, h) (B, H) each, outputs (B, L, H))."""
    if reverse:
        x = flip_sequences(x, lengths)
    b, steps = x.shape[:2]
    x_proj = cell.project_inputs(x)
    h = x_proj.new_zeros((b, cell.hidden_size))
    carry = (h, h)
    cs, hs = [], []
    for t in range(steps):
        carry = cell.step(carry, x_proj[:, t])
        cs.append(carry[0])
        hs.append(carry[1])
    cs, hs = torch.stack(cs, dim=1), torch.stack(hs, dim=1)
    last = ((lengths.long() - 1) % steps)[:, None, None].expand(-1, 1, cell.hidden_size)
    carry = (cs.gather(1, last)[:, 0], hs.gather(1, last)[:, 0])
    return carry, flip_sequences(hs, lengths) if reverse else hs


class LangModule(nn.Module):
    """Word dropout, then the LSTM over the padded words with their true
    lengths (forward, and backward with ``use_bidir``), outputs past a row's
    length zeroed; optionally the language classifier ``lang_cls``.

    Parameters under the flax paths: ``OptimizedLSTMCell_0`` (forward),
    ``OptimizedLSTMCell_1`` (backward), ``lang_cls``."""

    keeps_param_dtype = True

    def __init__(self, in_features: int, num_object_class: int,
                 use_lang_classifier: bool = True, use_bidir: bool = False,
                 hidden_size: int = 256, pdrop: float = 0.1):
        super().__init__()
        self.pdrop = pdrop
        self.use_bidir = use_bidir
        self.OptimizedLSTMCell_0 = OptimizedLSTMCell(in_features, hidden_size)
        if use_bidir:
            self.OptimizedLSTMCell_1 = OptimizedLSTMCell(in_features, hidden_size)
        self.lang_cls = (Dense(hidden_size * (2 if use_bidir else 1), num_object_class)
                         if use_lang_classifier else None)

    def forward(self, lang_feat: torch.Tensor, lang_len: torch.Tensor) -> dict:
        """lang_feat (B, L, E) embedded words, lang_len (B,) true lengths.
        Returns lang_out (B, L, H * dirs), lang_emb (B, H * dirs), lang_mask
        (B, L) True past the length, and lang_scores with the classifier."""
        x = dropout(lang_feat, self.pdrop, self.training)
        (_, h_f), out_f = run_lstm(self.OptimizedLSTMCell_0, x, lang_len)
        if self.use_bidir:
            (_, h_b), out_b = run_lstm(self.OptimizedLSTMCell_1, x, lang_len, reverse=True)
            lang_out = torch.cat([out_f, out_b], dim=-1)
            lang_emb = torch.cat([h_f, h_b], dim=-1)
        else:
            lang_out, lang_emb = out_f, h_f
        valid = torch.arange(lang_out.shape[1], device=lang_out.device)[None] < lang_len[:, None]
        out = {"lang_out": torch.where(valid[..., None], lang_out, 0.0), "lang_emb": lang_emb,
               "lang_mask": ~valid}
        if self.lang_cls is not None:
            out["lang_scores"] = self.lang_cls(dropout(lang_emb, self.pdrop, self.training))
        return out


class CLIPLangModule(nn.Module):
    """Pre-extracted CLIP token features through the projection ``proj``,
    zeroed past each row's length; the embedding is the mean over the true
    tokens."""

    keeps_param_dtype = True

    def __init__(self, in_features: int, out_size: int = 256, pdrop: float = 0.1):
        super().__init__()
        self.pdrop = pdrop
        self.proj = Dense(in_features, out_size)

    def forward(self, clip_feat: torch.Tensor, lang_len: torch.Tensor) -> dict:
        lang_out = self.proj(dropout(clip_feat, self.pdrop, self.training))
        valid = torch.arange(lang_out.shape[1], device=lang_out.device)[None] < lang_len[:, None]
        lang_out = torch.where(valid[..., None], lang_out, 0.0)
        lang_emb = lang_out.sum(dim=1) / lang_len[:, None].clamp(min=1)
        return {"lang_out": lang_out, "lang_emb": lang_emb, "lang_mask": ~valid}


class BertLangEncoder(nn.Module):
    """A med-BERT text encoder (no cross-attention) over the question ids
    whose last states feed the LSTM in place of word vectors. ``freeze``
    detaches its output (no gradient reaches it); ``finetune_last_layer``
    detaches the input of its last layer, so only that layer trains (the
    JAX module's ``stop_gradient``s)."""

    keeps_param_dtype = True

    def __init__(self, config: MedConfig, freeze: bool = False, finetune_last_layer: bool = False):
        super().__init__()
        if freeze and finetune_last_layer:
            raise ValueError("freeze and finetune_last_layer exclude each other")
        self.freeze = freeze
        self.finetune_last_layer = finetune_last_layer
        self.bert = BertModel(config)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """(B, L) ids and mask -> (B, L, hidden) word states."""
        bias = extend_attention_mask(attention_mask)
        h = self.bert.embeddings(input_ids)
        layers = self.bert.encoder.layer
        for i, layer in enumerate(layers):
            if self.finetune_last_layer and i == len(layers) - 1:
                h = h.detach()
            h = layer(h, bias, multimodal=False)
        return h.detach() if self.freeze else h
