"""DeepSeek-V2 (V2-Lite's shape) as a causal LM for batched greedy
generation on the card: the pipeline's declaration composer
(``tools/compose_llm.py``).

The equations are those of the model's public ``modeling_deepseek.py``:
pre-norm RMSNorm blocks; multi-head latent attention (MLA) without a query
low-rank (``q_lora_rank`` null): ``q_proj`` to heads of a non-rotary and a
rotary part, ``kv_a_proj_with_mqa`` to a latent of ``kv_lora_rank`` and one
shared rotary key, ``kv_a_layernorm`` on the latent, ``kv_b_proj`` to each
head's non-rotary key and value; YaRN rotary embedding whose halves are
de-interleaved before ``rotate_half``; a softmax scale of ``q_head_dim ** -0.5``
times ``yarn_get_mscale(factor, mscale_all_dim) ** 2``; the first
``first_k_dense_replace`` layers a SwiGLU MLP, the rest mixture-of-experts
layers (softmax routing in f32, greedy top-k, ``routed_scaling_factor``,
shared experts added); a final RMSNorm and an untied ``lm_head``.

How it runs:

- ``prefill(ids, lens)``: the prompts' tokens packed (no padding) through
  every product; the expanded attention (each head's keys and values built
  from the latent) on a padded (B, L) view through
  ``F.scaled_dot_product_attention``, causal; the latent cache written: per
  token and layer the normalised latent and the rotated rotary key,
  ``kv_lora_rank + qk_rope_head_dim`` values.
- ``decode(cache, ids)``: one token a row through the absorbed attention
  over the latent cache (W_UK folded into the query, W_UV applied after the
  weighted sum of latents): the expanded keys and values are never built.
- The products: ``ops/scoring_layer.py::scoring_gemm`` (a zero bias) for
  attention, the dense MLP and the head; ``ops/moe.py`` for the experts,
  one grouped launch for the gate and up products of every expert (the
  shared experts too, as experts every token visits) and one for the down
  products, scheduled on the card with no host read.
- ``generate_greedy``: argmax on the card; a row stops at its own
  ``max_new_tokens`` or at EOS; the batch runs to its longest row, and no
  step reads a flag or a count back to the host.

Parameters are in the model's dtype (bf16 on the card) and named after the
published checkpoint, but for the experts: ``mlp.experts.gate_up`` (E + S,
2 I, H) holds each routed expert's ``gate_proj`` and ``up_proj`` packed
(``moe.pack_gate_up``), then the shared MLP's as S experts of width I;
``mlp.experts.down`` (E + S, H, I) their ``down_proj``. ``load_published``
builds them from the published tensors (experts stacked:
``published_shapes``). Inference only: nothing here has a backward.
"""

import contextlib
import dataclasses
import math
import weakref
from collections import Counter

import torch
import torch.nn.functional as F
from torch import nn

from bridgeqa_tpu_torch.ops import moe
from bridgeqa_tpu_torch.ops.scoring_layer import scoring_gemm
from bridgeqa_tpu_torch.utils.profiling import count, counts, span

# the cache's columns are a multiple of this, so batches share a step's graphs
COLUMNS = 64


@dataclasses.dataclass
class DeepseekV2Config:
    """The published ``config.json`` keys (DeepSeek-V2-Lite's values), plus
    the published BOS and EOS ids."""

    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    routed_scaling_factor: float = 1.0
    kv_lora_rank: int = 512
    q_lora_rank: int | None = None
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    qk_nope_head_dim: int = 128
    topk_method: str = "greedy"
    n_group: int = 1
    topk_group: int = 1
    num_experts_per_tok: int = 6
    moe_layer_freq: int = 1
    first_k_dense_replace: int = 1
    norm_topk_prob: bool = False
    scoring_func: str = "softmax"
    hidden_act: str = "silu"
    max_position_embeddings: int = 163840
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: dict | None = dataclasses.field(default_factory=lambda: {
        "type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
        "beta_fast": 32, "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707})
    attention_bias: bool = False
    tie_word_embeddings: bool = False
    bos_token_id: int = 100000
    eos_token_id: int = 100001

    @classmethod
    def from_dict(cls, d: dict) -> "DeepseekV2Config":
        """The fields ``d`` names (a ``config.json``); other keys are left."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def __post_init__(self):
        unsupported = {"q_lora_rank": self.q_lora_rank is not None,
                       "topk_method": self.topk_method != "greedy",
                       "scoring_func": self.scoring_func != "softmax",
                       "hidden_act": self.hidden_act != "silu",
                       "attention_bias": self.attention_bias,
                       "tie_word_embeddings": self.tie_word_embeddings,
                       "rope_scaling": (self.rope_scaling is not None
                                        and self.rope_scaling.get("type") != "yarn")}
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(f"DeepseekV2Config: unsupported settings {bad} (the port "
                                      "runs V2-Lite's: no query low-rank, greedy softmax "
                                      "routing, SiLU, no biases, untied head, YaRN or no scaling)")

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def is_moe(self, layer: int) -> bool:
        return (self.n_routed_experts is not None and layer >= self.first_k_dense_replace
                and layer % self.moe_layer_freq == 0)


# ------------------------------------------------------------------ YaRN rope

def yarn_find_correction_dim(num_rotations, dim, base=10000, max_position_embeddings=2048):
    return (dim * math.log(max_position_embeddings / (num_rotations * 2 * math.pi))) / (
        2 * math.log(base))


def yarn_find_correction_range(low_rot, high_rot, dim, base=10000, max_position_embeddings=2048):
    low = math.floor(yarn_find_correction_dim(low_rot, dim, base, max_position_embeddings))
    high = math.ceil(yarn_find_correction_dim(high_rot, dim, base, max_position_embeddings))
    return max(low, 0), min(high, dim - 1)


def yarn_get_mscale(scale=1.0, mscale=1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_linear_ramp_mask(low, high, dim) -> torch.Tensor:
    if low == high:
        high += 0.001
    return torch.clamp((torch.arange(dim, dtype=torch.float32) - low) / (high - low), 0, 1)


def rope_inv_freq(cfg: DeepseekV2Config) -> torch.Tensor:
    """The rotary frequencies (qk_rope_head_dim / 2,) f32: YaRN's blend of
    the extrapolated and the interpolated ones (``DeepseekV2YarnRotaryEmbedding``),
    or the plain ones without scaling."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    rs = cfg.rope_scaling
    if rs is None:
        return freq_extra
    freq_inter = 1.0 / (rs["factor"] * base ** (torch.arange(0, dim, 2, dtype=torch.float32)
                                                 / dim))
    low, high = yarn_find_correction_range(rs.get("beta_fast", 32), rs.get("beta_slow", 1), dim,
                                           base, rs["original_max_position_embeddings"])
    inv_freq_mask = 1.0 - yarn_linear_ramp_mask(low, high, dim // 2)
    return freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask


def rope_mscale(cfg: DeepseekV2Config) -> float:
    """The cos/sin scale, ``mscale / mscale_all_dim`` of YaRN (1 for V2-Lite)."""
    rs = cfg.rope_scaling
    if rs is None:
        return 1.0
    return float(yarn_get_mscale(rs["factor"], rs.get("mscale", 1))
                 / yarn_get_mscale(rs["factor"], rs.get("mscale_all_dim", 0)))


def softmax_scale(cfg: DeepseekV2Config) -> float:
    scale = cfg.q_head_dim ** -0.5
    rs = cfg.rope_scaling
    if rs is not None and rs.get("mscale_all_dim"):
        m = yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def rotary(inv_freq: torch.Tensor, positions: torch.Tensor, mscale: float,
           dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin (N, rope_dim) in ``dtype`` at the positions (N,), as the
    model's cached tables hold them: ``cat(freqs, freqs)`` of the f32
    products position x frequency."""
    freqs = positions.float()[:, None] * inv_freq[None]
    emb = torch.cat([freqs, freqs], dim=-1)
    return (emb.cos() * mscale).to(dtype), (emb.sin() * mscale).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (N, ..., d) with cos, sin (N, d): the interleaved pairs
    de-interleaved, then ``x cos + rotate_half(x) sin``."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    shape = (cos.shape[0],) + (1,) * (x.dim() - 2) + (d,)
    cos, sin = cos.view(shape), sin.view(shape)
    rotated = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * cos + rotated * sin


# ------------------------------------------------------------------ modules

_ZERO_BIAS = {}


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` over the last axis through ``scoring_gemm`` (a zero f32
    bias: the model has none)."""
    key = (w.shape[0], x.device)
    if key not in _ZERO_BIAS:
        _ZERO_BIAS[key] = torch.zeros(w.shape[0], dtype=torch.float32, device=x.device)
    y = scoring_gemm(x.reshape(-1, x.shape[-1]).contiguous(), w, _ZERO_BIAS[key])
    return y.view(*x.shape[:-1], w.shape[0])


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, device, dtype):
        super().__init__()
        self.weight = _param((out_features, in_features), device, dtype)

    def forward(self, x):
        return linear(x, self.weight)


class RMSNorm(nn.Module):
    """``weight * (x / rms(x))``, the statistics in f32, the normalised
    value rounded to the input's type before the scale."""

    def __init__(self, features: int, eps: float, device, dtype):
        super().__init__()
        self.eps = eps
        self.weight = _param((features,), device, dtype)

    def forward(self, x):
        # the statistics and the product with their reciprocal in f32 (the
        # fused kernel's accumulate type), one rounding to x's type
        return self.weight * F.rms_norm(x, (x.shape[-1],), eps=self.eps)


class LatentCache:
    """The compressed cache of a batch of B rows: per layer (B, S,
    kv_lora_rank + qk_rope_head_dim), each row's tokens from column 0 (its
    prompt, then the decoded tokens); ``lens`` (B,) on the device and
    ``lens_host`` the prompt lengths; ``step`` the decode steps taken. One
    allocation, reused by every batch of its shape (``reset``)."""

    def __init__(self, layers: int, batch: int, columns: int, width: int, device, dtype):
        self.storage = torch.zeros(layers, batch, columns, width, device=device, dtype=dtype)
        self.kv = list(self.storage.unbind(0))
        self.lens = torch.zeros(batch, dtype=torch.long, device=device)
        self.lens_host, self.columns, self.step = [], columns, 0

    def reset(self, lens_host: list) -> None:
        self.storage.zero_()
        self.lens.copy_(torch.tensor(lens_host))
        self.lens_host, self.step = list(lens_host), 0


class Attention(nn.Module):
    """MLA without a query low-rank."""

    def __init__(self, cfg: DeepseekV2Config, device, dtype):
        super().__init__()
        self.cfg = cfg
        h, nh = cfg.hidden_size, cfg.num_attention_heads
        self.q_proj = Linear(h, nh * cfg.q_head_dim, device, dtype)
        self.kv_a_proj_with_mqa = Linear(h, cfg.kv_lora_rank + cfg.qk_rope_head_dim, device, dtype)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps, device, dtype)
        self.kv_b_proj = Linear(cfg.kv_lora_rank, nh * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                                device, dtype)
        self.o_proj = Linear(nh * cfg.v_head_dim, h, device, dtype)
        self.scale = softmax_scale(cfg)

    def _latent(self, x, cos, sin):
        """The queries (N, heads, q_head_dim) split into their non-rotary and
        rotated parts, and the cache rows (N, kv_lora_rank + rope): the
        normalised latent and the rotated shared key."""
        c = self.cfg
        q = self.q_proj(x).view(x.shape[0], c.num_attention_heads, c.q_head_dim)
        q_nope, q_pe = q.split([c.qk_nope_head_dim, c.qk_rope_head_dim], dim=-1)
        kv_a = self.kv_a_proj_with_mqa(x)
        latent, k_pe = kv_a.split([c.kv_lora_rank, c.qk_rope_head_dim], dim=-1)
        rows = torch.cat([self.kv_a_layernorm(latent), apply_rope(k_pe, cos, sin)], dim=-1)
        return q_nope, apply_rope(q_pe, cos, sin), rows

    def prefill(self, x, cos, sin, cache_kv, pack):
        """x (T, H) packed tokens; ``pack`` the batch's indices (``Prefill``)."""
        c = self.cfg
        nh, rank = c.num_attention_heads, c.kv_lora_rank
        q_nope, q_pe, rows = self._latent(x, cos, sin)
        cache_kv.view(-1, rows.shape[-1]).index_copy_(0, pack.cache_index, rows)
        kv = self.kv_b_proj(rows[:, :rank]).view(-1, nh, c.qk_nope_head_dim + c.v_head_dim)
        k_nope, v = kv.split([c.qk_nope_head_dim, c.v_head_dim], dim=-1)
        k_pe = rows[:, None, rank:].expand(-1, nh, -1)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe], dim=-1)
        b, length = pack.batch, pack.length

        def padded(t):  # (T, heads, d) -> (B, heads, L, d)
            out = t.new_zeros(b * length, *t.shape[1:]).index_copy_(0, pack.flat, t)
            return out.view(b, length, *t.shape[1:]).transpose(1, 2)

        ctx = F.scaled_dot_product_attention(padded(q), padded(k), padded(v), is_causal=True,
                                             scale=self.scale)
        ctx = ctx.transpose(1, 2).reshape(b * length, nh * c.v_head_dim).index_select(0, pack.flat)
        return self.o_proj(ctx)

    def decode(self, x, cos, sin, cache_kv, write, bias):
        """x (B, H), one token a row written at (row, column) ``write`` of
        the cache, attending to the columns ``bias`` (B, 1, S) leaves at 0."""
        c = self.cfg
        nh, rank, nope = c.num_attention_heads, c.kv_lora_rank, c.qk_nope_head_dim
        b = x.shape[0]
        q_nope, q_pe, rows = self._latent(x, cos, sin)
        cache_kv[write] = rows
        keys = cache_kv[:, : bias.shape[-1]]
        w = self.kv_b_proj.weight.view(nh, nope + c.v_head_dim, rank)
        q_latent = torch.bmm(q_nope.transpose(0, 1), w[:, :nope]).transpose(0, 1)  # (B, nh, rank)
        q = torch.cat([q_latent, q_pe], dim=-1)
        scores = torch.baddbmm(bias, q, keys.transpose(1, 2), alpha=self.scale)
        p = torch.softmax(scores, dim=-1, dtype=torch.float32).to(x.dtype)
        ctx = torch.bmm(p, keys[..., :rank])  # (B, nh, rank)
        out = torch.bmm(ctx.transpose(0, 1), w[:, nope:].transpose(1, 2))  # (nh, B, v)
        return self.o_proj(out.transpose(0, 1).reshape(b, nh * c.v_head_dim))


class DenseMLP(nn.Module):
    def __init__(self, hidden: int, width: int, device, dtype):
        super().__init__()
        self.gate_proj = Linear(hidden, width, device, dtype)
        self.up_proj = Linear(hidden, width, device, dtype)
        self.down_proj = Linear(width, hidden, device, dtype)

    span = "lm/dense"

    def forward(self, x, log=None):
        h = moe.swiglu_rounded(self.gate_proj(x), self.up_proj(x), x.dtype)
        return self.down_proj(h)


class MoE(nn.Module):
    """Routed experts and shared experts: one grouped launch for every
    expert's gate and up products, one for the down products."""

    def __init__(self, cfg: DeepseekV2Config, device, dtype):
        super().__init__()
        self.cfg = cfg
        e, s = cfg.n_routed_experts, cfg.n_shared_experts or 0
        h, i = cfg.hidden_size, cfg.moe_intermediate_size
        self.gate = nn.Module()
        self.gate.weight = _param((e, h), device, dtype)
        # the router's f32 copy (it computes in f32), made by load_published
        self.gate.register_buffer("weight_f32", None, persistent=False)
        self.experts = nn.Module()
        self.experts.gate_up = _param((e + s, 2 * i, h), device, dtype)
        self.experts.down = _param((e + s, h, i), device, dtype)

    span = "lm/moe"

    def forward(self, x, log=None):
        c = self.cfg
        if self.gate.weight_f32 is None:
            self.gate.weight_f32 = self.gate.weight.float()
        weights, ids = moe.route(x, self.gate.weight_f32, c.num_experts_per_tok,
                                 c.routed_scaling_factor, always=c.n_shared_experts or 0,
                                 norm_topk=c.norm_topk_prob)
        out, counts = moe.moe_ffn(x, weights, ids, self.experts.gate_up, self.experts.down)
        if log is not None:
            log.append((ids[:, : c.num_experts_per_tok], counts))
        return out


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, layer: int, device, dtype):
        super().__init__()
        h = cfg.hidden_size
        self.input_layernorm = RMSNorm(h, cfg.rms_norm_eps, device, dtype)
        self.self_attn = Attention(cfg, device, dtype)
        self.post_attention_layernorm = RMSNorm(h, cfg.rms_norm_eps, device, dtype)
        self.mlp = (MoE(cfg, device, dtype) if cfg.is_moe(layer)
                    else DenseMLP(h, cfg.intermediate_size, device, dtype))


@dataclasses.dataclass
class Prefill:
    """A batch's packing, built on the host from its prompt lengths: the
    packed tokens' flat indices into (B, L) (``flat``) and into the cache's
    (B, S) (``cache_index``), their positions, and each row's last token."""

    batch: int
    length: int
    flat: torch.Tensor
    cache_index: torch.Tensor
    positions: torch.Tensor
    last: torch.Tensor

    @classmethod
    def of(cls, lens: list, length: int, columns: int, device) -> "Prefill":
        lens_t = torch.tensor(lens)
        row = torch.repeat_interleave(torch.arange(len(lens)), lens_t)
        starts = torch.cumsum(lens_t, 0) - lens_t
        pos = torch.arange(int(lens_t.sum())) - starts[row]
        moved = [t.to(device) for t in (row * length + pos, row * columns + pos, pos,
                                        starts + lens_t - 1)]
        return cls(len(lens), length, *moved)


class DecodeStep:
    """One decode step of a batch of B rows over a cache of S columns, on
    buffers that keep their addresses: the token ids in, the hidden state,
    the positions, rotary tables and mask, the logits out. The step is a
    list of pieces, each under its span: the embedding and the step's
    tables; each layer's attention (``lm/attention``) and MLP (``lm/moe``,
    ``lm/dense``); the head (``lm/head``), which also advances the
    positions. On the card, with no profiler or recording open, the first
    step runs eagerly and warms every kernel; the next captures each piece
    as a CUDA graph in one memory pool, and every step after replays them:
    the host issues 56 replays a step instead of some 1700 launches. The
    counters count what each replay launches, and the route log gets copies
    of each MoE layer's ids and counts."""

    def __init__(self, model: "DeepseekV2ForCausalLM", batch: int, columns: int, device):
        c = model.cfg
        # the model holds its steps; a proxy back keeps it collectable
        self.model, self.cuda = weakref.proxy(model), device.type == "cuda"
        self.cache = LatentCache(c.num_hidden_layers, batch, columns,
                                 c.kv_lora_rank + c.qk_rope_head_dim, device, model.dtype)
        self.ids = torch.zeros(batch, dtype=torch.long, device=device)
        self.pos = torch.zeros(batch, dtype=torch.long, device=device)
        self.rows = torch.arange(batch, device=device)
        self.h = torch.zeros(batch, c.hidden_size, device=device, dtype=model.dtype)
        self.cos = torch.zeros(batch, c.qk_rope_head_dim, device=device, dtype=model.dtype)
        self.sin = torch.zeros_like(self.cos)
        self.bias = torch.zeros(batch, 1, columns, device=device, dtype=model.dtype)
        self.logits = torch.zeros(batch, c.vocab_size, device=device, dtype=model.dtype)
        self.pieces = [(None, self._prep)]
        for n, layer in enumerate(model.model.layers):
            self.pieces += [("lm/attention", self._attention(n, layer)),
                            (layer.mlp.span, self._mlp(layer))]
        self.pieces.append(("lm/head", self._head))
        self.warm, self.graphs, self.routes, self.launched = False, None, [], Counter()

    def _prep(self, log):
        m = self.model
        self.h.copy_(m.model.embed_tokens.weight[self.ids])
        cos, sin = rotary(m.inv_freq, self.pos, m.mscale, m.dtype)
        self.cos.copy_(cos)
        self.sin.copy_(sin)
        columns = torch.arange(self.bias.shape[-1], device=self.pos.device)
        self.bias.copy_(torch.where(columns[None] <= self.pos[:, None], 0.0,
                                    torch.finfo(m.dtype).min)[:, None])

    def _attention(self, n, layer):
        def piece(log):
            x = layer.input_layernorm(self.h)
            self.h.add_(layer.self_attn.decode(x, self.cos, self.sin, self.cache.kv[n],
                                               (self.rows, self.pos), self.bias))
        return piece

    def _mlp(self, layer):
        def piece(log):
            self.h.add_(layer.mlp(layer.post_attention_layernorm(self.h), log))
        return piece

    def _head(self, log):
        m = self.model
        self.logits.copy_(m.lm_head(m.model.norm(self.h)))
        self.pos.add_(1)

    def start(self, lens: list) -> LatentCache:
        """A new batch: the cache cleared and the positions at the prompts' ends."""
        self.cache.reset(lens)
        self.pos.copy_(self.cache.lens)
        return self.cache

    def _capturable(self) -> bool:
        from bridgeqa_tpu_torch.utils import profiling

        return (self.cuda and self.warm and profiling._recorder is None
                and not torch.autograd.profiler._is_profiler_enabled)

    def _capture(self) -> None:
        before, pool, graphs, refs = counts(), torch.cuda.graph_pool_handle(), [], []
        for name, piece in self.pieces:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=pool):
                piece(refs)
            graphs.append((name, g))
        # the captures launched nothing: take their counts back, and count
        # them again at every replay
        self.launched = counts() - before
        for key, n in self.launched.items():
            count(key, -n)
        self.graphs, self.routes = graphs, refs

    def run(self, ids: torch.Tensor) -> torch.Tensor:
        """The step on ids (B,); returns the logits buffer (B, vocab), valid
        until the next step."""
        self.ids.copy_(ids)
        log = self.model.route_log
        if self.graphs is None and self._capturable():
            self._capture()
        if self.graphs is None:
            for name, piece in self.pieces:
                with span(name) if name else contextlib.nullcontext():
                    piece(log)
            self.warm = True
            return self.logits
        for name, g in self.graphs:
            with span(name) if name else contextlib.nullcontext():
                g.replay()
        for key, n in self.launched.items():
            count(key, n)
        if log is not None:
            log += [(ids.clone(), n.clone()) for ids, n in self.routes]
        return self.logits


@dataclasses.dataclass
class Generated:
    """``generate_greedy``'s result: each row's new tokens (EOS and what
    follows it left out), the positions each row generated (``steps``, with
    the EOS), the (B, steps) ids as the batch generated them, and the logits
    of the rows asked for, (R, steps, vocab) on the device (else None)."""

    tokens: list
    steps: list
    ids: torch.Tensor
    logits: torch.Tensor | None


class DeepseekV2ForCausalLM(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, device=None, dtype=torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.model = nn.Module()
        self.model.embed_tokens = nn.Module()
        self.model.embed_tokens.weight = _param((cfg.vocab_size, cfg.hidden_size), device, dtype)
        self.model.layers = nn.ModuleList(DecoderLayer(cfg, i, device, dtype)
                                          for i in range(cfg.num_hidden_layers))
        self.model.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device, dtype)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, device, dtype)
        self.register_buffer("inv_freq", rope_inv_freq(cfg).to(device), persistent=False)
        self.mscale = rope_mscale(cfg)
        # (ids of the routed experts, the experts' row counts) of every MoE
        # layer call, appended while this is a list (device tensors: no read)
        self.route_log = None
        self._steps = {}  # (batch, columns, device) -> DecodeStep

    # --------------------------------------------------------------- weights

    @torch.no_grad()
    def load_published(self, fetch) -> "DeepseekV2ForCausalLM":
        """Fill every parameter from the published tensors, ``fetch(name)``
        (names and shapes as ``published_shapes``), one at a time."""
        c = self.cfg
        s, i = c.n_shared_experts or 0, c.moe_intermediate_size
        for name, p in self.named_parameters():
            if ".mlp.experts." not in name:
                p.copy_(fetch(name))
                continue
            pre = name.rsplit(".experts.", 1)[0]
            if name.endswith("gate_up"):
                p[: c.n_routed_experts] = moe.pack_gate_up(fetch(f"{pre}.experts.gate_proj.weight"),
                                                           fetch(f"{pre}.experts.up_proj.weight"))
                if s:
                    p[c.n_routed_experts:] = moe.pack_gate_up(
                        fetch(f"{pre}.shared_experts.gate_proj.weight").view(s, i, -1),
                        fetch(f"{pre}.shared_experts.up_proj.weight").view(s, i, -1))
            else:
                p[: c.n_routed_experts] = fetch(f"{pre}.experts.down_proj.weight")
                if s:
                    down = fetch(f"{pre}.shared_experts.down_proj.weight")
                    p[c.n_routed_experts:] = down.view(down.shape[0], s, i).transpose(0, 1)
        for layer in self.model.layers:
            if isinstance(layer.mlp, MoE):
                layer.mlp.gate.weight_f32 = layer.mlp.gate.weight.float()
        return self

    # --------------------------------------------------------------- forward

    def _step(self, batch: int, columns: int, device) -> DecodeStep:
        """The decode step of this batch size and a cache of at least
        ``columns`` columns, rounded up to ``COLUMNS`` so that batches of
        other prompt lengths share it (and its graphs)."""
        columns = -(-columns // COLUMNS) * COLUMNS
        key = (batch, columns, device)
        if key not in self._steps:
            self._steps[key] = DecodeStep(self, batch, columns, device)
        return self._steps[key]

    @torch.no_grad()
    def prefill(self, ids: torch.Tensor, lens: list, extra: int = 0):
        """ids (B, L) on the device, each row's prompt from column 0, ``lens``
        the prompt lengths on the host. Returns the latent cache (room for
        ``extra`` decoded tokens a row) and the logits (B, vocab) of each
        row's last prompt token."""
        b, length = ids.shape
        step = self._step(b, length + extra, ids.device)
        cache = step.start(lens)
        pack = Prefill.of(lens, length, cache.columns, ids.device)
        count("lm/tokens_prefilled", sum(lens))
        h = self.model.embed_tokens.weight[ids.reshape(-1).index_select(0, pack.flat)]
        cos, sin = rotary(self.inv_freq, pack.positions, self.mscale, self.dtype)
        for n, layer in enumerate(self.model.layers):
            with span("lm/attention"):
                x = layer.input_layernorm(h)
                h = h + layer.self_attn.prefill(x, cos, sin, cache.kv[n], pack)
            with span(layer.mlp.span):
                h = h + layer.mlp(layer.post_attention_layernorm(h), self.route_log)
        with span("lm/head"):
            return cache, self.lm_head(self.model.norm(h.index_select(0, pack.last)))

    @torch.no_grad()
    def decode(self, cache: LatentCache, ids: torch.Tensor) -> torch.Tensor:
        """One token a row, ids (B,), at each row's next position. Returns
        the logits (B, vocab), a buffer the next step overwrites."""
        if max(cache.lens_host) + cache.step + 1 > cache.columns:
            raise ValueError(f"decode: the cache holds {cache.columns} columns")
        step = self._steps[(ids.shape[0], cache.columns, ids.device)]
        count("lm/tokens_decoded", ids.shape[0])
        logits = step.run(ids)
        cache.step += 1
        return logits

    @torch.no_grad()
    def generate_greedy(self, prompt_ids: torch.Tensor, prompt_lens: list,
                        max_new_tokens_per_row: list, eos: int | None = None,
                        logit_rows: torch.Tensor | None = None) -> Generated:
        """Greedy generation: row b stops after ``max_new_tokens_per_row[b]``
        tokens or at ``eos`` (the config's by default). The batch runs to
        its longest row; the ids come to the host once, at the end.
        ``logit_rows`` (R,) on the device: keep those rows' logits at every
        step."""
        eos = self.cfg.eos_token_id if eos is None else eos
        steps = max(max_new_tokens_per_row)
        with span("lm/prefill"):
            cache, logits = self.prefill(prompt_ids, prompt_lens, extra=steps)
        with span("lm/decode"):
            b = prompt_ids.shape[0]
            out = torch.empty(b, steps, dtype=torch.long, device=prompt_ids.device)
            kept = (None if logit_rows is None else
                    logits.new_empty(logit_rows.shape[0], steps, logits.shape[-1]))
            for s in range(steps):
                if kept is not None:
                    kept[:, s] = logits.index_select(0, logit_rows)
                out[:, s] = logits.argmax(dim=-1)
                if s + 1 < steps:
                    logits = self.decode(cache, out[:, s])
        ids = out.cpu()
        tokens, taken = [], []
        for row, limit in zip(ids.tolist(), max_new_tokens_per_row):
            row = row[:limit]
            n = row.index(eos) + 1 if eos in row else len(row)
            tokens.append(row[: n - 1] if row[n - 1] == eos else row[:n])
            taken.append(n)
        return Generated(tokens, taken, ids, kept)


def published_shapes(cfg: DeepseekV2Config) -> dict:
    """name -> shape of the published checkpoint's tensors, each layer's
    routed experts stacked (``mlp.experts.gate_proj.weight`` is the (E, I,
    H) stack of ``mlp.experts.<e>.gate_proj.weight``)."""
    c = cfg
    h, nh = c.hidden_size, c.num_attention_heads
    e, i = c.n_routed_experts, c.moe_intermediate_size
    shapes = {"model.embed_tokens.weight": (c.vocab_size, h)}
    for n in range(c.num_hidden_layers):
        p = f"model.layers.{n}."
        shapes.update({
            p + "input_layernorm.weight": (h,),
            p + "self_attn.q_proj.weight": (nh * c.q_head_dim, h),
            p + "self_attn.kv_a_proj_with_mqa.weight": (c.kv_lora_rank + c.qk_rope_head_dim, h),
            p + "self_attn.kv_a_layernorm.weight": (c.kv_lora_rank,),
            p + "self_attn.kv_b_proj.weight": (nh * (c.qk_nope_head_dim + c.v_head_dim),
                                               c.kv_lora_rank),
            p + "self_attn.o_proj.weight": (h, nh * c.v_head_dim),
            p + "post_attention_layernorm.weight": (h,)})
        if c.is_moe(n):
            shapes.update({p + "mlp.gate.weight": (e, h),
                           p + "mlp.experts.gate_proj.weight": (e, i, h),
                           p + "mlp.experts.up_proj.weight": (e, i, h),
                           p + "mlp.experts.down_proj.weight": (e, h, i)})
            if c.n_shared_experts:
                w = c.n_shared_experts * i
                shapes.update({p + "mlp.shared_experts.gate_proj.weight": (w, h),
                               p + "mlp.shared_experts.up_proj.weight": (w, h),
                               p + "mlp.shared_experts.down_proj.weight": (h, w)})
        else:
            w = c.intermediate_size
            shapes.update({p + "mlp.gate_proj.weight": (w, h), p + "mlp.up_proj.weight": (w, h),
                           p + "mlp.down_proj.weight": (h, w)})
    shapes.update({"model.norm.weight": (h,), "lm_head.weight": (c.vocab_size, h)})
    return shapes
