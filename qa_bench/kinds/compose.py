"""Traffic kind "compose": question-answer pairs rewritten into declarative
sentences by an LLM, the first step of view selection, as
``tools/compose_llm.py::LocalLMComposer`` runs it: a closed loop of batches
of greedy generation with one batch in flight.

Set-up builds ``DeepseekV2ForCausalLM`` from the configuration file and
fills it with weights drawn on the device, tensor by tensor, each from a
generator of the seed and the tensor's published name, straight into the
traffic's type (``draw_fn``); ``qa_bench/weights.py``'s single f32 draw would
not fit this model on the card. It makes a pool of ``pool_batches`` batches
of ``batch`` rows: a row's prompt is the composer's template
(``template_tokens``, BOS first) and a question and an answer of
[``question_words``] and [``answer_words``] words at ``tokens_per_word``,
its ids drawn uniformly below the first special id; its declaration is
``new_tokens`` long at most, drawn with a tail toward the long end; and
``check_rows`` rows of each batch are drawn for the check. Batch ``i`` is
the pool's batch ``i % pool_batches``: ``generate_greedy`` under the span
``compose``, whose ids come to the host at its end.

The check compares the program's logits at every generated position of the
drawn rows with the reference's (``qa_bench/reference/deepseek_v2.py``)
full forward over the prompt and what the program generated, rebuilt after
the program is freed from the same draws. The reference runs the program's
routing (each MoE layer the experts the program chose for each token) and
reports its own gate's choice beside it: on random weights the gate's
top-6 of 64 often holds near ties, and a tie rounded the other way swaps
two experts of about equal weight, which moves the logits as much as an
expert's lost output would (PERF.md, section 4). So:

- ``logit_gap``: the largest relative L2 distance between the two
  log-softmax rows of a position, under one routing;
- ``route_miss``: the share of (token, MoE layer) pairs where the
  program's routed top-k set is not the reference gate's;
- ``token_miss``: the share of the program's tokens that are not the
  reference's argmax, counted where the reference's top-1 over top-2 margin
  (nats) exceeds the traffic's ``token_margin``;

and logs ``flip_margin`` (the largest such margin where they differ) and
``pick_gap`` (the largest log-softmax gap at either token), from which the
calibration sets ``token_margin``.
"""

import gc
import zlib

import torch

from qa_bench import compare, weights
from qa_bench.harness import ROOT, load_json, log
from qa_bench.reference.nn import computing

POOL_STREAM = 2
# the batches whose routing counts are kept for products(): the traced
# run's profiled batches, and the profiled pass of ``qa_bench/spans.py``
KEEP_ROUTES = 16


def port_config(cfg: dict):
    from bridgeqa_tpu_torch.models.deepseek_v2 import DeepseekV2Config

    return DeepseekV2Config.from_dict(cfg)


def draw_fn(cfg: dict, seed: int, device, dtype):
    """``fetch(name)``: the published tensor ``name`` drawn from a generator
    of the seed and the name, in ``dtype`` on ``device``: norm scales 1 +
    0.1 n, everything else ``initializer_range`` n (the published 0.02)."""
    from bridgeqa_tpu_torch.models.deepseek_v2 import published_shapes

    shapes = published_shapes(port_config(cfg))
    std = cfg["initializer_range"]

    def fetch(name: str) -> torch.Tensor:
        gen = torch.Generator(device=device).manual_seed(
            weights.stream_seed(seed, 16 + zlib.crc32(name.encode())))
        t = torch.randn(shapes[name], generator=gen, device=device, dtype=dtype)
        return t.mul_(0.1).add_(1.0) if t.dim() == 1 else t.mul_(std)

    return fetch, shapes


def reference_model(cfg: dict, device, seed: int, dtype):
    from qa_bench.reference.deepseek_v2 import DeepseekV2 as Reference

    with torch.device("meta"):
        ref = Reference(cfg)
        ref = ref.to(dtype)
    ref = ref.to_empty(device=device)
    fetch, _ = draw_fn(cfg, seed, device, dtype)
    with torch.no_grad():
        for name, p in ref.named_parameters():
            p.copy_(fetch(name))
    return ref.eval()


def make_pool(cfg: dict, t: dict, seed: int, device) -> list:
    gen = torch.Generator().manual_seed(weights.stream_seed(seed, POOL_STREAM))
    b, first_special = t["batch"], min(cfg["bos_token_id"], cfg["eos_token_id"])
    low, high = t["new_tokens"]
    pool = []
    for _ in range(t["pool_batches"]):
        q = torch.randint(t["question_words"][0], t["question_words"][1] + 1, (b,), generator=gen)
        a = torch.randint(t["answer_words"][0], t["answer_words"][1] + 1, (b,), generator=gen)
        lens = (t["template_tokens"] + torch.ceil((q + a) * t["tokens_per_word"])).long()
        # a tail toward the long end: density rising linearly to ``high``
        new = low + torch.floor((high - low + 1) * torch.rand(b, generator=gen).sqrt()).long()
        new = new.clamp(max=high)
        ids = torch.randint(0, first_special, (b, int(lens.max())), generator=gen)
        ids[:, 0] = cfg["bos_token_id"]
        ids = ids * (torch.arange(ids.shape[1])[None] < lens[:, None])
        rows = torch.randperm(b, generator=gen)[: t["check_rows"]].sort().values
        pool.append({"ids": ids.to(device), "lens": lens.tolist(), "new": new.tolist(),
                     "rows": rows.to(device), "rows_host": rows.tolist()})
    return pool


def layer_flops(c, tokens: int, keys_per_query: float, decode: bool) -> float:
    """Matrix products of one pass of ``tokens`` tokens through every layer
    and the head (``2 m k n`` a product; attention's scores and context),
    each query attending to ``keys_per_query`` keys on average."""
    h, nh, nope, rope, v = (c.hidden_size, c.num_attention_heads, c.qk_nope_head_dim,
                            c.qk_rope_head_dim, c.v_head_dim)
    rank, i = c.kv_lora_rank, c.moe_intermediate_size
    attn = 2 * h * nh * (nope + rope) + 2 * h * (rank + rope) + 2 * nh * v * h
    if decode:  # absorbed: W_UK into the query, W_UV after the latent sum
        attn += 2 * nh * nope * rank + 2 * nh * rank * v
        attn += 2 * nh * keys_per_query * ((rank + rope) + rank)
    else:
        attn += 2 * rank * nh * (nope + v)
        attn += 2 * nh * keys_per_query * ((nope + rope) + v)
    experts = c.num_experts_per_tok + (c.n_shared_experts or 0)
    moe_f = experts * 3 * 2 * h * i + 2 * h * c.n_routed_experts
    dense = 3 * 2 * h * c.intermediate_size
    per_token = sum(attn + (moe_f if c.is_moe(n) else dense) for n in range(c.num_hidden_layers))
    return tokens * per_token


class Session:
    rate_metric, rate_unit, unit_name = "qa_per_s", "QA/s", "declarations"
    tail_metric = "batch_ms_p90"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from bridgeqa_tpu_torch.models.deepseek_v2 import DeepseekV2ForCausalLM

        self.cfg, self.t, self.seed, self.device = cfg, traffic, seed, device
        self.dtype = getattr(torch, traffic["dtype"])
        self.c = port_config(cfg)
        fetch, _ = draw_fn(cfg, seed, device, self.dtype)
        self.model = DeepseekV2ForCausalLM(self.c, device=device, dtype=self.dtype)
        self.model.load_published(fetch)
        self.model.eval()
        self.pool = make_pool(cfg, traffic, seed, device)
        self.kept, self.routes = {}, {}
        peaks = load_json(ROOT / "peaks.json")
        self.peak_flops = peaks["flops_per_s"][traffic["dtype"]]
        self.hbm_bytes_per_s = peaks["hbm_bytes_per_s"]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)

    def warm(self) -> None:
        for i in range(self.t["warmup"]):
            self.batch(i, None)

    def batch(self, i: int, slot) -> int:
        from bridgeqa_tpu_torch.utils.profiling import span

        p = self.pool[i % len(self.pool)]
        # the routing is recorded only where something reads it: the checked
        # batches (their ids) and the profiled ones (``products``); the tool
        # records none, and neither do the timed batches
        logged = slot is not None or torch.autograd.profiler._is_profiler_enabled
        self.model.route_log = [] if logged else None
        with span("compose"):
            out = self.model.generate_greedy(p["ids"], p["lens"], p["new"],
                                             logit_rows=None if slot is None else p["rows"])
        log_, self.model.route_log = self.model.route_log, None
        if logged:
            self.routes[i] = [counts for _, counts in log_]
        self.routes.pop(i - KEEP_ROUTES, None)
        if slot is not None:
            self.kept[slot] = (i, out, [ids for ids, _ in log_])
        return len(out.tokens)

    def stages(self) -> dict:
        return {}

    def flops(self, i: int) -> float:
        p = self.pool[i % len(self.pool)]
        c, lens, steps = self.c, p["lens"], max(p["new"])
        b, vocab = len(lens), c.vocab_size
        prefill = layer_flops(c, sum(lens), sum(n * (n + 1) / 2 for n in lens) / sum(lens), False)
        keys = sum(n for n in lens) / b + steps / 2
        decode = layer_flops(c, b * (steps - 1), keys, True)
        return prefill + decode + 2 * c.hidden_size * vocab * b * steps

    def products(self, group: str, i: int) -> list:
        """(operations, bytes) of each grouped expert product of batch ``i``,
        from the experts' row counts the program recorded: the gate/up and
        the down product of every MoE layer call, each reading the weights
        of the experts that received rows, its rows once and writing its
        output once."""
        if group != "moe_gemm" or not self.routes.get(i):
            return []
        c, elem = self.c, self.dtype.itemsize
        h, w = c.hidden_size, c.moe_intermediate_size
        counts = torch.stack(self.routes[i]).cpu()
        calls = []
        for m, used in zip(counts.sum(dim=1).tolist(), (counts > 0).sum(dim=1).tolist()):
            calls.append((2 * m * h * 2 * w, (used * 2 * w * h + m * h + m * w) * elem))
            calls.append((2 * m * w * h, (used * h * w + m * w + m * h) * elem + m * 4))
        return calls

    def release(self) -> None:
        """Free the program's state (its decode steps' graphs and caches
        too); the kept outputs stay."""
        del self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def numbers(self, control: bool = False, exact: tuple = ()) -> list:
        """The comparison numbers of each kept batch against the reference in
        the traffic's type. With ``control``, the reference computed one
        precision below (``control``: "fp8") takes the program's place, and
        the reference in the traffic's type runs the control's routing."""
        ref = reference_model(self.cfg, self.device, self.seed, self.dtype)
        moe_layers = [n for n in range(self.c.num_hidden_layers) if self.c.is_moe(n)]
        found = []
        for slot in sorted(self.kept):
            i, out, routes = self.kept[slot]
            p = self.pool[i % len(self.pool)]
            starts = [sum(p["lens"][:b]) for b in range(len(p["lens"]))]
            rows = []
            for r, b in enumerate(p["rows_host"]):
                n, steps = p["lens"][b], out.steps[b]
                seq = torch.cat([p["ids"][b, :n], out.ids[b, : steps - 1].to(self.device)])
                with torch.no_grad():
                    if control:
                        with computing(self.dtype, self.t["control"]):
                            got, got_routes = ref(seq)
                        got = got[n - 1: n - 1 + steps]
                        tokens = got.argmax(dim=-1)
                    else:
                        got = out.logits[r, :steps].float()
                        tokens = out.ids[b, :steps].to(self.device)
                        got_routes = program_routes(routes, len(moe_layers), b, starts[b], n,
                                                    steps)
                    # a side that logged other lengths keeps the reference's own routing
                    fits = all(g.shape[0] == seq.shape[0] for g in got_routes)
                    with computing(self.dtype):
                        want, want_routes = ref(seq, got_routes if fits else None)
                rows.append(row_numbers(got, want[n - 1: n - 1 + steps], tokens, got_routes,
                                        want_routes, self.t["token_margin"]))
            found.append(merge(rows))
            log(f"batch {i}{' control' if control else ''}: {found[-1]}")
        return found

    def check(self) -> list:
        found = self.numbers()
        worst = {k: max(n[k] for n in found) for k in found[0]}
        return compare.within(worst, self.t["limits"])


def program_routes(log_ids: list, layers: int, b: int, start: int, n: int, steps: int) -> list:
    """Row ``b``'s routed experts in each MoE layer over its prompt and the
    tokens it fed back, (n + steps - 1, k) a layer, from the program's log:
    the prefill's calls (packed tokens, the row's from ``start``), then
    each decode step's, layer by layer."""
    out = []
    for layer in range(layers):
        parts = [log_ids[layer][start:start + n]]
        parts += [log_ids[layers * (1 + s) + layer][b:b + 1] for s in range(steps - 1)]
        out.append(torch.cat(parts))
    return out


def row_numbers(got, want, tokens, got_routes, want_routes, margin: float) -> dict:
    """One row's numbers over its generated positions: logits (steps, V)
    of the side under test and of the reference, the side's tokens, and
    both sides' routed experts a MoE layer."""
    lg, lw = torch.log_softmax(got.float(), -1), torch.log_softmax(want.float(), -1)
    gap = ((lg - lw).norm(dim=-1) / lw.norm(dim=-1)).max()
    top2 = lw.topk(2, dim=-1)
    best = top2.indices[:, 0]
    spread = top2.values[:, 0] - top2.values[:, 1]
    differ = tokens != best
    pick = torch.maximum((lg - lw).gather(1, best[:, None]).abs(),
                         (lg - lw).gather(1, tokens[:, None]).abs()).max()
    # a side that routed another number of tokens than the reference misses them all
    miss = sum(int((torch.sort(g, 1).values != torch.sort(w, 1).values).any(1).sum())
               if g.shape == w.shape else int(w.shape[0]) for g, w in zip(got_routes, want_routes))
    pairs = sum(int(w.shape[0]) for w in want_routes)
    return {"logit_gap": float(gap), "route_miss": miss, "pairs": pairs,
            "token_miss": int((differ & (spread > margin)).sum()), "tokens": int(tokens.numel()),
            "flip_margin": float(spread[differ].max()) if differ.any() else 0.0,
            "pick_gap": float(pick)}


def merge(rows: list) -> dict:
    """A batch's numbers from its rows': the largest gaps, the shares over all
    rows' pairs and tokens."""
    pairs = max(1, sum(r["pairs"] for r in rows))
    return {"logit_gap": max(r["logit_gap"] for r in rows),
            "route_miss": sum(r["route_miss"] for r in rows) / pairs,
            "token_miss": sum(r["token_miss"] for r in rows) / sum(r["tokens"] for r in rows),
            "flip_margin": max(r["flip_margin"] for r in rows),
            "pick_gap": max(r["pick_gap"] for r in rows)}
