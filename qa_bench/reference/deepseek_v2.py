"""DeepSeek-V2 of the reference: the forward of one whole sequence in plain
PyTorch, inference only.

Written from the model's public ``modeling_deepseek.py`` (DeepSeek-V2-Lite's
``config.json``): ``DeepseekV2RMSNorm``, ``DeepseekV2YarnRotaryEmbedding``
and ``apply_rotary_pos_emb`` (the rotary halves de-interleaved before
``rotate_half``), ``DeepseekV2Attention`` without a query low-rank (each
head's keys and values expanded from the latent, ``matmul``, the causal
mask at the type's smallest value, softmax in f32), ``MoEGate`` (f32 logits,
softmax, greedy top-k, ``routed_scaling_factor``), ``moe_infer`` (each
expert's tokens gathered and run through its SwiGLU, the outputs put back,
weighted and summed in f32) plus the shared experts' MLP, and the untied
head. The parameters carry the published names, each layer's routed experts
stacked in one tensor a weight (``mlp.experts.gate_proj.weight`` is (E, I,
H)), in whatever type they were loaded in.

Departures: one sequence a call, with no batch, padding or attention mask
beyond the causal one; no cache; the experts are looped over with
``index_select`` and a product each; the cos/sin tables are computed for the
sequence's own length (the model caches them to the longest length it has
seen: the same values); the gate's top-k is sorted (the model's
``sorted=False`` leaves the order to the device; the set is the same); a
forward may be given the routing (``routes``: each MoE layer's experts a
token), and each MoE layer then runs those experts, weighted by its own
gate's scores, in place of its gate's top-k, and returns the gate's own
top-k all the same (the comparison holds the logits to one routing and the
routing to the gate apart: a near tie rounded the other way swaps experts
of about equal weight, which moves the logits as much as a lost expert's
output does). Every
product of the layers takes its operands through ``nn.operand`` (the
working type, rounded below it for the control); the router's product stays
in f32 as the model computes it. It imports nothing of either package.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from qa_bench.reference.nn import operand, softmax, working


def _yarn_find_correction_dim(num_rotations, dim, base, max_position_embeddings):
    return (dim * math.log(max_position_embeddings / (num_rotations * 2 * math.pi))) / (
        2 * math.log(base))


def _yarn_get_mscale(scale=1.0, mscale=1.0):
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def rotary_tables(cfg: dict, length: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``DeepseekV2YarnRotaryEmbedding``'s cos and sin (length, rope dim),
    f32."""
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    rs = cfg.get("rope_scaling")
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    if rs is None:
        inv_freq, scale = freq_extra, 1.0
    else:
        factor = rs["factor"]
        freq_inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
        low = max(math.floor(_yarn_find_correction_dim(rs["beta_fast"], dim, base,
                                                       rs["original_max_position_embeddings"])), 0)
        high = min(math.ceil(_yarn_find_correction_dim(rs["beta_slow"], dim, base,
                                                       rs["original_max_position_embeddings"])),
                   dim - 1)
        if low == high:
            high += 0.001
        ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
        mask = 1.0 - ramp
        inv_freq = freq_inter * (1 - mask) + freq_extra * mask
        scale = float(_yarn_get_mscale(factor, rs["mscale"])
                      / _yarn_get_mscale(factor, rs["mscale_all_dim"]))
    t = torch.arange(length, dtype=torch.float32)
    freqs = torch.outer(t.to(device), inv_freq.to(device))
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos() * scale, emb.sin() * scale


def rotate_half(x):
    x1, x2 = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def apply_rotary_pos_emb(q, k, cos, sin):
    """q (heads, L, d), k (1, L, d), cos and sin (L, d) in the working type."""
    h, s, d = q.shape
    q = q.view(h, s, d // 2, 2).transpose(3, 2).reshape(h, s, d)
    h, s, d = k.shape
    k = k.view(h, s, d // 2, 2).transpose(3, 2).reshape(h, s, d)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


def linear(x, w):
    return F.linear(operand(x), operand(w))


class RMSNorm(nn.Module):
    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features), requires_grad=False)

    def forward(self, x):
        input_dtype = x.dtype
        h = x.to(torch.float32)
        variance = h.pow(2).mean(-1, keepdim=True)
        h = h * torch.rsqrt(variance + self.eps)
        return self.weight.to(input_dtype) * h.to(input_dtype)


def _linear_module(in_features, out_features):
    m = nn.Module()
    m.weight = nn.Parameter(torch.empty(out_features, in_features), requires_grad=False)
    return m


class MLP(nn.Module):
    def __init__(self, hidden: int, width: int):
        super().__init__()
        self.gate_proj = _linear_module(hidden, width)
        self.up_proj = _linear_module(hidden, width)
        self.down_proj = _linear_module(width, hidden)

    def forward(self, x):
        return linear(F.silu(linear(x, self.gate_proj.weight)) * linear(x, self.up_proj.weight),
                      self.down_proj.weight)


class Attention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        h, nh = c["hidden_size"], c["num_attention_heads"]
        self.q_head_dim = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
        self.q_proj = _linear_module(h, nh * self.q_head_dim)
        self.kv_a_proj_with_mqa = _linear_module(h, c["kv_lora_rank"] + c["qk_rope_head_dim"])
        self.kv_a_layernorm = RMSNorm(c["kv_lora_rank"], c["rms_norm_eps"])
        self.kv_b_proj = _linear_module(c["kv_lora_rank"],
                                        nh * (c["qk_nope_head_dim"] + c["v_head_dim"]))
        self.o_proj = _linear_module(nh * c["v_head_dim"], h)
        self.softmax_scale = self.q_head_dim ** -0.5
        rs = c.get("rope_scaling")
        if rs is not None and rs.get("mscale_all_dim"):
            m = _yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
            self.softmax_scale = self.softmax_scale * m * m

    def forward(self, x, cos, sin):
        c = self.c
        length = x.shape[0]
        nh, nope, rope, vd = (c["num_attention_heads"], c["qk_nope_head_dim"],
                              c["qk_rope_head_dim"], c["v_head_dim"])
        q = linear(x, self.q_proj.weight).view(length, nh, self.q_head_dim).transpose(0, 1)
        q_nope, q_pe = torch.split(q, [nope, rope], dim=-1)
        compressed_kv = linear(x, self.kv_a_proj_with_mqa.weight)
        compressed_kv, k_pe = torch.split(compressed_kv, [c["kv_lora_rank"], rope], dim=-1)
        k_pe = k_pe.view(length, 1, rope).transpose(0, 1)
        kv = (linear(self.kv_a_layernorm(compressed_kv), self.kv_b_proj.weight)
              .view(length, nh, nope + vd).transpose(0, 1))
        k_nope, value_states = torch.split(kv, [nope, vd], dim=-1)
        q_pe, k_pe = apply_rotary_pos_emb(q_pe, k_pe, cos.to(x.dtype), sin.to(x.dtype))
        query_states = torch.cat([q_nope, q_pe], dim=-1)
        key_states = torch.cat([k_nope, k_pe.expand(nh, -1, -1)], dim=-1)
        scores = torch.matmul(operand(query_states), operand(key_states).transpose(1, 2))
        scores = scores * self.softmax_scale
        causal = torch.triu(torch.ones(length, length, dtype=torch.bool, device=x.device), 1)
        scores = scores.masked_fill(causal, torch.finfo(scores.dtype).min)
        weights = softmax(scores)
        out = torch.matmul(operand(weights), operand(value_states))
        return linear(out.transpose(0, 1).reshape(length, nh * vd), self.o_proj.weight)


class MoE(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        h, e, i = c["hidden_size"], c["n_routed_experts"], c["moe_intermediate_size"]
        self.gate = _linear_module(h, e)
        self.experts = nn.Module()
        for name, shape in (("gate_proj", (e, i, h)), ("up_proj", (e, i, h)),
                            ("down_proj", (e, h, i))):
            m = nn.Module()
            m.weight = nn.Parameter(torch.empty(shape), requires_grad=False)
            self.experts.add_module(name, m)
        self.shared_experts = (MLP(h, i * c["n_shared_experts"]) if c["n_shared_experts"]
                               else None)

    def forward(self, x, route=None):
        """x (L, H) -> (output, the gate's routed experts' ids (L, k)). With
        ``route`` (L, k), those experts run in place of the gate's."""
        c = self.c
        logits = F.linear(x.float(), self.gate.weight.float())
        scores = logits.softmax(dim=-1, dtype=torch.float32)
        topk_weight, topk_idx = torch.topk(scores, k=c["num_experts_per_tok"], dim=-1)
        own = topk_idx
        if route is not None:
            topk_idx, topk_weight = route, scores.gather(1, route)
        if c["norm_topk_prob"]:
            topk_weight = topk_weight / (topk_weight.sum(dim=-1, keepdim=True) + 1e-20)
        topk_weight = topk_weight * c["routed_scaling_factor"]
        idxs = topk_idx.view(-1).argsort(stable=True)
        sorted_tokens = x[idxs // topk_idx.shape[1]]
        counts = torch.bincount(topk_idx.view(-1), minlength=c["n_routed_experts"]).tolist()
        outputs, start = [], 0
        ex = self.experts
        for e, n in enumerate(counts):
            if n == 0:
                continue
            t = sorted_tokens[start:start + n]
            h = F.silu(linear(t, ex.gate_proj.weight[e])) * linear(t, ex.up_proj.weight[e])
            outputs.append(linear(h, ex.down_proj.weight[e]))
            start += n
        outs = torch.cat(outputs, dim=0)
        new_x = torch.empty_like(outs)
        new_x[idxs] = outs
        y = (new_x.view(*topk_idx.shape, -1).type(topk_weight.dtype)
             .mul_(topk_weight.unsqueeze(dim=-1)).sum(dim=1).type(new_x.dtype))
        if self.shared_experts is not None:
            y = y + self.shared_experts(x)
        return y, own


class Layer(nn.Module):
    def __init__(self, c: dict, n: int):
        super().__init__()
        h = c["hidden_size"]
        self.input_layernorm = RMSNorm(h, c["rms_norm_eps"])
        self.self_attn = Attention(c)
        self.post_attention_layernorm = RMSNorm(h, c["rms_norm_eps"])
        moe = (c["n_routed_experts"] is not None and n >= c["first_k_dense_replace"]
               and n % c["moe_layer_freq"] == 0)
        self.mlp = MoE(c) if moe else MLP(h, c["intermediate_size"])


class DeepseekV2(nn.Module):
    """``DeepseekV2ForCausalLM`` over one sequence."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        self.model = nn.Module()
        self.model.embed_tokens = nn.Module()
        self.model.embed_tokens.weight = nn.Parameter(
            torch.empty(c["vocab_size"], c["hidden_size"]), requires_grad=False)
        self.model.layers = nn.ModuleList(Layer(c, n) for n in range(c["num_hidden_layers"]))
        self.model.norm = RMSNorm(c["hidden_size"], c["rms_norm_eps"])
        self.lm_head = _linear_module(c["hidden_size"], c["vocab_size"])

    def forward(self, ids: torch.Tensor, routes: list | None = None):
        """ids (L,) -> (f32 logits (L, vocab), each MoE layer's routed
        experts (L, k) as its gate chose them, in layer order). ``routes``:
        the experts each MoE layer runs, (L, k) a layer (else its gate's)."""
        h = self.model.embed_tokens.weight[ids].to(working())
        cos, sin = rotary_tables(self.c, ids.shape[0], ids.device)
        chosen = []
        for layer in self.model.layers:
            h = h + layer.self_attn(layer.input_layernorm(h), cos, sin)
            x = layer.post_attention_layernorm(h)
            if isinstance(layer.mlp, MoE):
                m, ids_k = layer.mlp(x, None if routes is None else routes[len(chosen)])
                chosen.append(ids_k)
            else:
                m = layer.mlp(x)
            h = h + m
        return linear(self.model.norm(h), self.lm_head.weight).float(), chosen
