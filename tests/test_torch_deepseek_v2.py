"""DeepSeek-V2 in the port (``models/deepseek_v2.py``, ``ops/moe.py``,
``tools/compose_llm.py``) against the benchmark's plain reference
(``qa_bench/reference/deepseek_v2.py``) at a tiny size on the CPU, in f32:
hidden 64, 4 layers (1 dense, 3 MoE), 8 routed experts top-2 and 1 shared,
4 heads, latent 32, rotary 16, non-rotary 16, values 16, vocabulary 512,
YaRN on. The reference follows the model's public equations with no cache
and no batching; the port runs packed prefill, the absorbed attention over
the latent cache and the grouped expert products' plain versions.

f32 tolerances: 2e-5 of the largest logit (both sides accumulate in f32 in
another order; the absorbed attention sums its products in another order
than the expanded one). The card test holds the grouped kernel to its
plain version at the full widths.
"""

import contextlib
import json
import math
import zlib

import pytest
import torch

from bridgeqa_tpu_torch.models import deepseek_v2 as ds
from bridgeqa_tpu_torch.ops import moe
from qa_bench.reference.deepseek_v2 import DeepseekV2 as Reference

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, moe_intermediate_size=64,
            num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=4,
            n_shared_experts=1, n_routed_experts=8, num_experts_per_tok=2, kv_lora_rank=32,
            qk_rope_head_dim=16, qk_nope_head_dim=16, v_head_dim=16,
            max_position_embeddings=4096, bos_token_id=510, eos_token_id=511,
            rope_scaling={"type": "yarn", "factor": 40, "original_max_position_embeddings": 64,
                          "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                          "mscale_all_dim": 0.707})
TOL = 2e-5


def tiny_config() -> ds.DeepseekV2Config:
    return ds.DeepseekV2Config(**TINY)


def draw(cfg, seed: int = 0) -> dict:
    """The published tensors, each from a generator of the seed and its name:
    norm scales near 1, products and embeddings at std 0.1 (0.02 at this
    width leaves the logits nearly flat)."""
    out = {}
    for name, shape in ds.published_shapes(cfg).items():
        gen = torch.Generator().manual_seed(seed * 1000003 + zlib.crc32(name.encode()))
        t = torch.randn(shape, generator=gen)
        out[name] = 1.0 + 0.1 * t if len(shape) == 1 else 0.1 * t
    return out


@pytest.fixture(scope="module")
def pair():
    torch.manual_seed(0)
    cfg = tiny_config()
    tensors = draw(cfg)
    port = ds.DeepseekV2ForCausalLM(cfg, device="cpu", dtype=torch.float32)
    port.load_published(tensors.__getitem__)
    ref_cfg = {**{f: getattr(cfg, f) for f in TINY}, **{
        k: getattr(cfg, k) for k in ("rope_theta", "rms_norm_eps", "first_k_dense_replace",
                                     "moe_layer_freq", "norm_topk_prob", "routed_scaling_factor")}}
    ref = Reference(ref_cfg)
    assert set(ref.state_dict()) == set(tensors)
    ref.load_state_dict(tensors)
    return cfg, port, ref


def prompts(lens, vocab, seed=1):
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, vocab, (len(lens), max(lens)), generator=gen)
    for b, n in enumerate(lens):
        ids[b, n:] = 0
    return ids


def assert_close(got, want):
    scale = want.abs().max()
    assert (got - want).abs().max() <= TOL * scale, float((got - want).abs().max() / scale)


def test_prefill_logits_match_reference(pair):
    cfg, port, ref = pair
    lens = [7, 3, 11]
    ids = prompts(lens, cfg.vocab_size)
    port.route_log = []
    _, logits = port.prefill(ids, lens)
    log, port.route_log = port.route_log, None
    starts = [sum(lens[:b]) for b in range(len(lens))]
    for b, n in enumerate(lens):
        want, routes = ref(ids[b, :n])
        assert_close(logits[b], want[-1])
        for (got_ids, counts), want_ids in zip(log, routes):
            got_ids = got_ids[starts[b]:starts[b] + n]
            assert torch.equal(got_ids.sort(dim=1).values, want_ids.sort(dim=1).values)
    # every token visits its top-k routed experts and the shared one
    assert all(int(counts.sum()) == sum(lens) * (cfg.num_experts_per_tok + cfg.n_shared_experts)
               for _, counts in log)


def test_cached_decode_matches_full_forward(pair):
    """Prefill, then decode through the latent cache: the logits at every
    generated position equal the reference's full forward over the prompt
    and what was generated; ragged rows in one batch equal each row alone."""
    cfg, port, ref = pair
    lens, new = [5, 9, 2], [6, 3, 8]
    ids = prompts(lens, cfg.vocab_size, seed=2)
    rows = torch.arange(len(lens))
    out = port.generate_greedy(ids, lens, new, eos=-1, logit_rows=rows)
    assert out.steps == new and [len(t) for t in out.tokens] == new
    for b, n in enumerate(lens):
        seq = torch.cat([ids[b, :n], out.ids[b, : new[b] - 1]])
        want, _ = ref(seq)
        got = out.logits[b, : new[b]]
        assert_close(got, want[n - 1:])
        assert torch.equal(got.argmax(-1), out.ids[b, : new[b]])
        alone = port.generate_greedy(ids[b:b + 1, :n], [n], [new[b]], eos=-1,
                                     logit_rows=torch.tensor([0]))
        assert alone.tokens[0] == out.tokens[b]
        assert_close(alone.logits[0], got)


def test_generation_stops_at_eos(pair):
    cfg, port, _ = pair
    lens = [4, 6]
    ids = prompts(lens, cfg.vocab_size, seed=3)
    first = port.generate_greedy(ids, lens, [5, 5], eos=-1)
    eos = first.ids[0, 2].item()  # row 0's third token stands in for EOS
    out = port.generate_greedy(ids, lens, [5, 2], eos=eos)
    assert out.tokens[0] == first.tokens[0][: first.tokens[0].index(eos)]
    assert out.steps[0] == first.tokens[0].index(eos) + 1
    assert out.tokens[1] == first.tokens[1][:2] or eos in first.tokens[1][:2]


@pytest.mark.parametrize("swiglu", [True, False])
def test_grouped_gemm_plain_matches_expert_loop(swiglu):
    """An expert with no rows, ragged runs, the routing weight on the down
    product; against a loop over the experts' own products."""
    torch.manual_seed(3)
    e, n, k = 5, 128, 24
    counts = [3, 0, 7, 1, 0]
    offsets = torch.tensor([0] + list(torch.tensor(counts).cumsum(0)), dtype=torch.int32)
    x = torch.randn(sum(counts), k)
    w = torch.randn(e, n, k)
    rw = torch.rand(sum(counts))
    got = moe.moe_gemm(x, w, offsets, None if swiglu else rw, swiglu=swiglu)
    start = 0
    for ex, c in enumerate(counts):
        rows = x[start:start + c]
        if swiglu:
            gate, up = moe.unpack_gate_up(w[ex:ex + 1])
            want = torch.nn.functional.silu(rows @ gate[0].T) * (rows @ up[0].T)
        else:
            want = (rows @ w[ex].T) * rw[start:start + c, None]
        torch.testing.assert_close(got[start:start + c], want, rtol=1e-5, atol=1e-5)
        start += c


def test_pack_gate_up_round_trip():
    gate, up = torch.randn(3, 128, 8), torch.randn(3, 128, 8)
    packed = moe.pack_gate_up(gate, up)
    assert torch.equal(packed[:, :64], gate[:, :64]) and torch.equal(packed[:, 64:128], up[:, :64])
    back = moe.unpack_gate_up(packed)
    assert torch.equal(back[0], gate) and torch.equal(back[1], up)


def test_yarn_frequencies_and_scale():
    """The published formulas, written out: YaRN's correction range from
    beta_fast 32 and beta_slow 1 over the original 4096 positions, the ramp
    between them, and the softmax scale q_head_dim^-0.5 m^2 with
    m = 0.1 x 0.707 x ln 40 + 1."""
    cfg = ds.DeepseekV2Config()
    dim, base = 64, 10000.0

    def corr(rot):
        return dim * math.log(4096 / (rot * 2 * math.pi)) / (2 * math.log(base))

    low, high = max(math.floor(corr(32)), 0), min(math.ceil(corr(1)), dim - 1)
    assert (low, high) == (10, 23)
    want = []
    for j in range(dim // 2):
        extra = 1.0 / base ** (2 * j / dim)
        ramp = min(max((j - low) / (high - low), 0.0), 1.0)
        want.append(extra / 40 * ramp + extra * (1 - ramp))
    torch.testing.assert_close(ds.rope_inv_freq(cfg), torch.tensor(want), rtol=1e-6, atol=0)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert ds.softmax_scale(cfg) == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    assert ds.rope_mscale(cfg) == 1.0


def test_published_config_file_builds_the_model():
    """The benchmark's configuration file holds every key of the published
    config.json, and the port's config reads them."""
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "qa_bench" / "configs" / "deepseek-v2-lite.json"
    d = json.loads(path.read_text())
    cfg = ds.DeepseekV2Config.from_dict(d)
    assert d["reduced"] == []
    assert (cfg.num_hidden_layers, cfg.n_routed_experts, cfg.vocab_size) == (27, 64, 102400)
    with torch.device("meta"):
        model = ds.DeepseekV2ForCausalLM(cfg, device="meta")
    total = sum(p.numel() for p in model.parameters())
    assert 15.6e9 < total < 15.8e9


# ------------------------------------------------------------------ the card

def _routing(tokens: int, experts: int, top_k: int, seed: int) -> torch.Tensor:
    """(tokens, top_k) distinct experts a token, expert 1 never chosen."""
    gen = torch.Generator().manual_seed(seed)
    scores = torch.rand(tokens, experts, generator=gen)
    scores[:, 1] = -1.0
    return scores.topk(top_k, dim=1).indices


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [256, 15360], ids=["decode", "prefill"])
def test_moe_gemm_kernel_matches_plain_at_full_width(tokens):
    """The grouped kernel against its plain version at DeepSeek-V2-Lite's
    widths (hidden 2048, expert width 1408, 64 routed experts and 2 shared
    ones every token visits), for a decode-sized batch (about 24 rows an
    expert) and a prefill-sized one (about 1400), with an expert that gets
    no rows. Both sum in f32 and round alike; a sum taken in another order
    can flip a rounding: 2^-6 of the largest output, as the other bf16
    kernels are held."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    from bridgeqa_tpu_torch.utils import profiling

    card = torch.device("cuda", 0)
    h, i, e, shared, k = 2048, 1408, 64, 2, 6
    gen = torch.Generator(device=card).manual_seed(tokens)
    x = torch.randn(tokens, h, generator=gen, device=card).to(torch.bfloat16)
    gate_up = (0.02 * torch.randn(e + shared, 2 * i, h, generator=gen, device=card)).bfloat16()
    down = (0.02 * torch.randn(e + shared, h, i, generator=gen, device=card)).bfloat16()
    ids = torch.cat([_routing(tokens, e, k, tokens).to(card),
                     torch.arange(e, e + shared, device=card).expand(tokens, shared)], dim=1)
    weights = torch.rand(tokens, k + shared, generator=gen, device=card)
    order, offsets, counts = moe.dispatch(ids, e + shared)
    assert int(counts[1]) == 0 and int(counts.sum()) == tokens * (k + shared)
    rows = x.index_select(0, order // (k + shared))
    rw = weights.reshape(-1).index_select(0, order)
    before = profiling.counts()["kernel/moe_gemm"]
    hidden = moe.moe_gemm(rows, gate_up, offsets, swiglu=True)
    out = moe.moe_gemm(hidden, down, offsets, row_weight=rw)
    assert profiling.counts()["kernel/moe_gemm"] == before + 2
    want_hidden = moe.moe_gemm_plain(rows, gate_up, offsets, swiglu=True)
    want_out = moe.moe_gemm_plain(want_hidden, down, offsets, row_weight=rw)
    for got, want in ((hidden, want_hidden), (out, want_out)):
        gap = (got.float() - want.float()).abs().max()
        assert gap <= 2.0 ** -6 * want.float().abs().max(), float(gap)
        assert torch.isfinite(got.float()).all()


# ---------------------------------------------------------------- the tool

def test_compose_declarations_batched_writes_and_resumes(pair, tmp_path):
    """The batched driver writes the JSON ``compose_declarations`` writes
    with the same composer (a word-piece tokenizer over a synthetic
    vocabulary, the tiny model on the CPU), and a run that finds half of
    the file done composes only the rest."""
    from bridgeqa_tpu_torch.data.sources import synthetic_records, synthetic_tokenizer
    from bridgeqa_tpu_torch.tools.compose_decl import compose_declarations
    from bridgeqa_tpu_torch.tools.compose_llm import (
        LocalLMComposer,
        WordPieceIds,
        compose_declarations_batched,
    )

    cfg, port, _ = pair
    records = synthetic_records(6)
    composer = LocalLMComposer(port, WordPieceIds(synthetic_tokenizer()), batch_size=4,
                               max_new_tokens=5)
    one = compose_declarations(records, str(tmp_path / "one.json"), composer=composer)
    batched = compose_declarations_batched(records, str(tmp_path / "batched.json"), composer,
                                           batch_size=4)
    assert batched == one
    assert json.loads((tmp_path / "batched.json").read_text()) == json.loads(
        (tmp_path / "one.json").read_text())
    half = {k: one[k] for k in list(one)[:3]}
    (tmp_path / "resumed.json").write_text(json.dumps(half))
    calls = []

    class Counting(LocalLMComposer):
        def compose_batch(self, pairs):
            calls.append(len(pairs))
            return super().compose_batch(pairs)

    counting = Counting(port, WordPieceIds(synthetic_tokenizer()), batch_size=4, max_new_tokens=5)
    resumed = compose_declarations_batched(records, str(tmp_path / "resumed.json"), counting,
                                           batch_size=4)
    assert resumed == one and calls == [3]


@pytest.mark.cuda
def test_decode_graphs_replay_the_eager_step():
    """On the card the decode steps replay CUDA graphs after one eager step:
    the same tokens and the same logits, bit for bit, as every step run
    eagerly (inside ``recording()``, where no step is captured); and the
    counters count each replay's launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from bridgeqa_tpu_torch.utils import profiling

    card = torch.device("cuda", 0)
    cfg = tiny_config()
    tensors = draw(cfg)
    port = ds.DeepseekV2ForCausalLM(cfg, device=card)
    port.load_published(lambda name: tensors[name].to(card, torch.bfloat16))
    lens, new = [5, 9, 2, 30], [6, 3, 8, 12]
    ids = prompts(lens, cfg.vocab_size, seed=4).to(card)
    rows = torch.arange(len(lens), device=card)
    runs = {}
    for mode in ("eager", "graphs", "graphs"):
        before = profiling.counts()
        with profiling.recording() if mode == "eager" else contextlib.nullcontext():
            out = port.generate_greedy(ids, lens, new, eos=-1, logit_rows=rows)
        runs.setdefault(mode, []).append((out, profiling.counts() - before))
        if mode == "eager":
            assert port._steps[(4, 64, card)].graphs is None
    eager, eager_counts = runs["eager"][0]
    assert port._steps[(4, 64, card)].graphs is not None
    for out, launched in runs["graphs"]:
        assert torch.equal(out.ids, eager.ids)
        assert torch.equal(out.logits, eager.logits)
        assert launched == eager_counts


def test_view_select_composer_flag(tmp_path):
    """``--composer deepseek-v2-lite`` composes with the tiny model under
    ``--synthetic`` and refuses without it: the published weights are not in
    the repository."""
    from bridgeqa_tpu_torch.scripts import view_select

    out = tmp_path / "i2t.json"
    view_select.main(["--synthetic", "--tiny", "--device", "cpu", "--composer",
                      "deepseek-v2-lite", "--out", str(out)])
    decl = json.loads((tmp_path / "i2t.json.decl.json").read_text())
    assert len(decl) == 8 and out.exists()
    with pytest.raises(SystemExit, match="not in the repository"):
        view_select.main(["--tiny", "--device", "cpu", "--composer", "deepseek-v2-lite",
                          "--out", str(tmp_path / "refused.json")])
