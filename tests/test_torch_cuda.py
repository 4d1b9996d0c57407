"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA card and ``nvcc`` and skip without them. On the card:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine does not have; this file imports none.) On the edge cases
``chip_smoke.py`` does not draw:

- the point kernels must agree with their plain versions bitwise: NaN
  coordinates, an all-padding cloud, 4 feature channels, both stripe plans,
  clouds shorter than one stripe quantum;
- the scoring kernels (GEMM, both attentions, LayerNorm, vocabulary
  reductions) must agree with theirs within a tolerance, in f32 and bf16:
  rows and vocabularies that are no tile multiple, 7, 80 and 130 question
  keys, all but one key masked, and attention shapes that take the
  tensor-core kernel (bf16, head width 64) and the CUDA-core one;
- the ViT kernels likewise: the GEMM's residual epilogue, LayerNorm without
  a residual and keeping the sum, the attention over 1, 17, 64, 65, 833, 901
  and 1025 tokens (65, 833 and 1025 leave one valid key in the last tile),
  and a whole block;
- the bf16 GEMM's TMA edges: M, N and K that are no multiple of the tile or
  of the 64-wide box, with GELU and with the residual; its GELU against the
  erf GELU at every |x| up to 6, within two f32 ulp or one bf16 rounding;
- the bf16 GEMM and ViT attention launched from several host threads at
  once (ctypes releases the GIL), bit for bit as from one;
- the row gather must copy bit for bit, with rows that fill no block and
  1, 3, 4 and 131 channels, and refuse indices out of range.
f32: 1e-3 absolute (both sides accumulate in f32, in another order). bf16
outputs: 2^-6 of the largest output, about two steps of bf16 (both round
once from f32, and a sum taken in another order can flip a rounding, or the
rounding of an exp or a softmax weight before the product with V).
"""

import threading

import numpy as np
import pytest
import torch

from bridgeqa_tpu_torch.ops import gather, grouping, sampling, scoring_layer, vit_block, vocab_loss

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    return torch.device("cuda", 0)


def _cloud(rng, b, n, scale=2.0):
    return ((rng.rand(b, n, 3) - 0.5) * scale).astype(np.float32)


@pytest.mark.parametrize("n,npoint", [(300, 64), (5000, 700), (70000, 16)])
def test_fps_kernel_matches_plain(card, n, npoint):
    """n = 70000 does not fit the distance buffer in shared memory and takes
    the global-memory path."""
    rng = np.random.RandomState(n)
    xyz = _cloud(rng, 4, n)
    xyz[0, n - n // 5:] = 0.0  # trailing padding
    xyz[1, 10:40] = xyz[1, 40:70]  # ties
    xyz[1, 5] = [np.nan, 0.3, 0.1]  # NaN: padding, scrubbed
    xyz[2, 0] = [0.2, np.nan, 0.0]  # NaN in the first pick
    xyz[3] = 0.0  # all padding
    t = torch.from_numpy(xyz).to(card)
    before = sampling.launches
    idx, coords = sampling.furthest_point_sample_with_xyz(t, npoint)
    assert sampling.launches == before + 1
    pidx, pcoords = sampling.fps_plain(t, npoint)
    torch.cuda.synchronize()
    assert torch.equal(idx, pidx)
    assert torch.equal(coords, pcoords)
    assert (idx[3] == 0).all()


@pytest.mark.parametrize("n,nsample,nf", [(1024, 8, 0), (900, 8, 4), (600, 16, 1), (100, 16, 2),
                                           (40000, 64, 1)])
def test_ball_query_kernel_matches_plain(card, n, nsample, nf):
    rng = np.random.RandomState(n + nf)
    xyz = _cloud(rng, 3, n)
    xyz[0, : n // 3] = xyz[0, n // 3: 2 * (n // 3)]  # duplicates
    ctr = _cloud(rng, 3, 48)
    ctr[:, :4] += 10.0  # empty balls
    feats = torch.from_numpy(rng.randn(3, n, nf).astype(np.float32)).to(card) if nf else None
    args = (0.35, nsample, torch.from_numpy(xyz).to(card), torch.from_numpy(ctr).to(card), feats)
    before = grouping.launches
    out = grouping.ball_query_stripes(*args)
    assert grouping.launches == before + 1
    ref = grouping.ball_query_stripes_plain(*args)
    torch.cuda.synchronize()
    for got, want in zip(out, ref):
        assert (got is None and want is None) or torch.equal(got, want)
    assert (out[0][:, :4] == 0).all()


def test_wrappers_refuse_bad_inputs(card):
    xyz = torch.zeros(2, 64, 3, device=card)
    with pytest.raises(ValueError):
        grouping.ball_query_stripes(0.2, 8, xyz, xyz, torch.zeros(2, 64, 5, device=card))
    with pytest.raises(ValueError):
        grouping.ball_query_stripes(0.2, 8, xyz, xyz.cpu())
    with pytest.raises(ValueError):
        sampling.furthest_point_sample_with_xyz(xyz[..., :2], 4)


DTYPES = [torch.float32, torch.bfloat16]


def _randn(rng, *shape, scale=1.0, dtype=torch.float32, device="cpu"):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(device, dtype)


def _assert_close(got, want, what):
    err = float((got.float() - want.float()).abs().max())
    if got.dtype == torch.bfloat16:
        tol = 2.0**-6 * float(want.float().abs().max())
    else:
        tol = 1e-3
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


def _counted(name, fn):
    before = dict(scoring_layer.launches)
    out = fn()
    assert scoring_layer.launches[name] == before[name] + 1
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,k,gelu", [(300, 200, 72, False), (257, 136, 768, True),
                                        (1000, 768, 3072, False), (5, 8, 8, True)])
def test_scoring_gemm_matches_plain(card, dtype, m, n, k, gelu):
    rng = np.random.RandomState(m + n + k)
    x = _randn(rng, m, k, dtype=dtype, device=card)
    w = _randn(rng, n, k, scale=0.05, dtype=dtype, device=card)
    b = _randn(rng, n, scale=0.1, device=card)
    got = _counted("scoring_gemm", lambda: scoring_layer.scoring_gemm(x, w, b, gelu))
    _assert_close(got, scoring_layer.scoring_gemm_plain(x, w, b, gelu), "gemm")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("la,seqs,heads,hd", [(12, 37, 12, 64), (5, 3, 2, 64), (1, 9, 2, 16),
                                              (128, 2, 2, 64), (12, 11, 3, 34)])
def test_self_attention_matches_plain(card, dtype, la, seqs, heads, hd):
    rng = np.random.RandomState(la * seqs)
    qkv = _randn(rng, la * seqs, 3 * heads * hd, dtype=dtype, device=card)
    got = _counted("scoring_attention",
                   lambda: scoring_layer.self_attention(qkv, la=la, heads=heads))
    _assert_close(got, scoring_layer.self_attention_plain(qkv, la=la, heads=heads), "self")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lk", [7, 80, 130])
def test_cross_attention_matches_plain(card, dtype, lk):
    """Three questions of 240 rows each (no multiple of the 128-row tile):
    all keys valid, all but one masked, half masked."""
    rng = np.random.RandomState(lk)
    nq, rows_per_q, heads, hd = 3, 240, 12, 64
    h = heads * hd
    qc = _randn(rng, nq * rows_per_q, h, dtype=dtype, device=card)
    ck = _randn(rng, nq, lk, h, dtype=dtype, device=card)
    cv = _randn(rng, nq, lk, h, dtype=dtype, device=card)
    mask = np.ones((nq, lk), bool)
    mask[1, 1:] = False
    mask[2, lk // 2:] = False
    cbias = torch.from_numpy(np.where(mask, 0.0, scoring_layer.NEG).astype(np.float32)).to(card)
    got = _counted("scoring_attention",
                   lambda: scoring_layer.cross_attention(qc, ck, cv, cbias, heads=heads))
    want = scoring_layer.cross_attention_plain(qc, ck, cv, cbias, heads=heads)
    _assert_close(got, want, f"cross, lk {lk}")
    # the question with one valid key copies that key's value
    _assert_close(got[rows_per_q:2 * rows_per_q], cv[1, :1].expand(rows_per_q, h), "one key")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,cols", [(1001, 768), (3, 130)])
def test_add_layernorm_matches_plain(card, dtype, rows, cols):
    rng = np.random.RandomState(rows + cols)
    a = _randn(rng, rows, cols, dtype=dtype, device=card)
    r = _randn(rng, rows, cols, scale=2.0, dtype=dtype, device=card)
    scale = _randn(rng, cols, device=card) + 1.0
    bias = _randn(rng, cols, scale=0.1, device=card)
    got = _counted("scoring_layernorm",
                   lambda: scoring_layer.add_layernorm(a, r, scale, bias, 1e-12))
    _assert_close(got, scoring_layer.add_layernorm_plain(a, r, scale, bias, 1e-12), "layernorm")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,vocab,hdim", [(1000, 203, 64), (300, 30524, 768), (7, 5, 8)])
def test_vocab_reductions_match_plain(card, dtype, rows, vocab, hdim):
    rng = np.random.RandomState(rows + vocab)
    h = _randn(rng, rows, hdim, dtype=dtype, device=card)
    table = _randn(rng, vocab, hdim, scale=0.05, dtype=dtype, device=card)
    bias = _randn(rng, vocab, scale=0.1, device=card)
    labels = torch.from_numpy(rng.randint(0, vocab, rows).astype(np.int32)).to(card)
    before = vocab_loss.launches
    got = vocab_loss.lm_vocab_reductions(h, table, bias, labels)
    assert vocab_loss.launches == before + 1
    want = vocab_loss.lm_vocab_reductions_plain(h, table, bias, labels)
    for name, a, b in zip(("lse", "sum_logits", "target_logit"), got, want):
        err = float((a - b).abs().max())
        assert err <= 1e-3 * max(1.0, float(b.abs().max())), f"{name}: {err}"


def test_scoring_wrappers_refuse_bad_inputs(card):
    x = torch.zeros(16, 64, device=card)
    w = torch.zeros(32, 64, device=card)
    b = torch.zeros(32, device=card)
    with pytest.raises(ValueError):  # mixed devices
        scoring_layer.scoring_gemm(x, w.cpu(), b)
    with pytest.raises(ValueError):  # not contiguous
        scoring_layer.scoring_gemm(x, torch.zeros(64, 32, device=card).T, b)
    with pytest.raises(ValueError):  # no kernel for float16
        scoring_layer.scoring_gemm(x.half(), w.half(), b)
    with pytest.raises(ValueError):  # bf16 needs widths that are multiples of 8
        scoring_layer.scoring_gemm(x[:, :60].bfloat16().contiguous(),
                                   w[:, :60].bfloat16().contiguous(), b)
    with pytest.raises(ValueError):
        scoring_layer.self_attention(torch.zeros(3 * 64, 12, device=card).T, la=12, heads=2)
    with pytest.raises(ValueError):
        scoring_layer.cross_attention(torch.zeros(8, 64, device=card), torch.zeros(2, 5, 64),
                                      torch.zeros(2, 5, 64), torch.zeros(2, 5), heads=2)
    with pytest.raises(ValueError):
        scoring_layer.add_layernorm(x, x, torch.ones(64, device=card).bfloat16(),
                                    torch.zeros(64, device=card), 1e-12)
    with pytest.raises(ValueError):
        vocab_loss.lm_vocab_reductions(x, w, b, torch.zeros(16, dtype=torch.int64, device=card))


# ------------------------------------------------------------ the ViT block

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,k,gelu", [(7208, 768, 3072, False), (37, 136, 72, True)])
def test_scoring_gemm_residual_matches_plain(card, dtype, m, n, k, gelu):
    rng = np.random.RandomState(m + k)
    x = _randn(rng, m, k, dtype=dtype, device=card)
    w = _randn(rng, n, k, scale=0.05, dtype=dtype, device=card)
    b = _randn(rng, n, scale=0.5, device=card)
    res = _randn(rng, m, n, scale=2.0, dtype=dtype, device=card)
    got = _counted("scoring_gemm", lambda: scoring_layer.scoring_gemm(x, w, b, gelu, res))
    want = scoring_layer.scoring_gemm_plain(x, w, b, gelu, res)
    _assert_close(got, want, "gemm + residual")
    _assert_close(got - res, scoring_layer.scoring_gemm_plain(x, w, b, gelu), "residual dropped")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("epilogue", ["gelu", "residual"])
@pytest.mark.parametrize("m,n,k", [(7208, 136, 8), (1000, 8, 776), (5, 200, 72),
                                   (7208, 2304, 776), (1000, 3072, 72)])
def test_scoring_gemm_tma_edges(card, dtype, epilogue, m, n, k):
    """The bf16 kernel's TMA boxes past the edges: M no multiple of the
    128-row tile, N no multiple of 256 (or of the 128-wide tile, or of the
    64-wide store box), K no multiple of the 64-wide load box."""
    rng = np.random.RandomState(m + 3 * n + 7 * k)
    x = _randn(rng, m, k, dtype=dtype, device=card)
    w = _randn(rng, n, k, scale=0.05, dtype=dtype, device=card)
    b = _randn(rng, n, scale=0.5, device=card)
    gelu = epilogue == "gelu"
    res = None if gelu else _randn(rng, m, n, scale=2.0, dtype=dtype, device=card)
    got = _counted("scoring_gemm", lambda: scoring_layer.scoring_gemm(x, w, b, gelu, res))
    _assert_close(got, scoring_layer.scoring_gemm_plain(x, w, b, gelu, res), f"gemm, {epilogue}")
    if res is not None:
        _assert_close(got - res, scoring_layer.scoring_gemm_plain(x, w, b), "residual dropped")


@pytest.mark.parametrize("dtype", DTYPES)
def test_scoring_gemm_gelu_is_exact(card, dtype):
    """The epilogue's GELU (a branch-free erf) at every |x| up to 6, taken
    through an identity product so that the sum is exact: within 2 f32 ulp
    of the erf GELU in f32 (erf's error times |x| / 2 where erf nears -1),
    within one bf16 rounding in bf16."""
    x = torch.linspace(-6.0, 6.0, 4096 * 8, dtype=torch.float64).reshape(4096, 8).to(dtype)
    w = torch.eye(8, dtype=dtype)
    b = torch.zeros(8)
    got = _counted("scoring_gemm", lambda: scoring_layer.scoring_gemm(
        x.to(card), w.to(card), b.to(card), True)).cpu().double()
    xd = x.double()
    want = 0.5 * xd * (1.0 + torch.erf(xd / 2.0**0.5))
    ulp = 2.0**-23 if dtype == torch.float32 else 2.0**-8
    tol = 2 * ulp * want.abs() + 2.0**-23 * xd.abs()
    assert ((got - want).abs() <= tol).all(), float(((got - want).abs() - tol).max())


def test_kernels_from_threads(card):
    """The C entries are called through ctypes, which releases the GIL, so
    host threads launching at once share the GEMM's tensor-map cache and the
    per-device shared-memory attribute record. Every thread's results equal,
    bit for bit, those of the same calls made from one thread."""
    rng = np.random.RandomState(5)
    calls = []
    for m, n, k in [(300, 200, 72), (1000, 768, 776), (5, 136, 8)]:
        x = _randn(rng, m, k, dtype=torch.bfloat16, device=card)
        w = _randn(rng, n, k, scale=0.05, dtype=torch.bfloat16, device=card)
        b = _randn(rng, n, scale=0.1, device=card)
        calls.append(lambda x=x, w=w, b=b: scoring_layer.scoring_gemm(x, w, b, True))
    qkv = _randn(rng, 2, 65, 3 * 3 * vit_block.HEAD_DIM, dtype=torch.bfloat16, device=card)
    calls.append(lambda: vit_block.vit_attention(qkv, heads=3))
    want = [fn() for fn in calls]
    got = [[] for _ in calls]

    def run(i):
        for _ in range(50):
            got[i].append(calls[i]())

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(calls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    for i, (ref, outs) in enumerate(zip(want, got)):
        assert len(outs) == 50, f"call {i}: a thread raised"
        assert all(torch.equal(o, ref) for o in outs), f"call {i}"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,cols,mode", [(1001, 768, "plain"), (3, 130, "plain"),
                                            (1001, 768, "sum"), (3, 130, "sum")])
def test_layernorm_vit_modes_match_plain(card, dtype, rows, cols, mode):
    """LayerNorm with no residual, and LayerNorm(a + r) keeping the sum."""
    rng = np.random.RandomState(rows * cols)
    a = _randn(rng, rows, cols, dtype=dtype, device=card)
    r = _randn(rng, rows, cols, scale=2.0, dtype=dtype, device=card) if mode == "sum" else None
    scale = _randn(rng, cols, scale=0.5, device=card) + 1.0
    bias = _randn(rng, cols, scale=0.5, device=card)
    keep = mode == "sum"
    got = _counted("scoring_layernorm",
                   lambda: scoring_layer.add_layernorm(a, r, scale, bias, 1e-6, keep_sum=keep))
    want = scoring_layer.add_layernorm_plain(a, r, scale, bias, 1e-6, keep_sum=keep)
    if keep:
        assert torch.equal(got[0], want[0])  # the sum is rounded once on both sides
        got, want = got[1], want[1]
    _assert_close(got, want, f"layernorm, {mode}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 17, 64, 65, 833, 901, 1025])
def test_vit_attention_matches_plain(card, dtype, n):
    rng = np.random.RandomState(n)
    b, heads = 2, 3
    qkv = _randn(rng, b, n, 3 * heads * vit_block.HEAD_DIM, dtype=dtype, device=card)
    before = vit_block.launches
    got = vit_block.vit_attention(qkv, heads=heads)
    assert vit_block.launches == before + 1
    _assert_close(got, vit_block.vit_attention_plain(qkv, heads=heads), f"vit attention, n {n}")
    if n == 1:  # one key: the context is its value
        assert torch.equal(got, qkv[..., 2 * heads * vit_block.HEAD_DIM:])


@pytest.mark.parametrize("dtype", DTYPES)
def test_vit_block_matches_plain(card, dtype):
    """A whole block at embed 128, 2 heads, 37 tokens; biases and LayerNorm
    parameters away from 0 and (1, 0)."""
    rng = np.random.RandomState(11)
    h, mlp = 128, 512
    x = _randn(rng, 3, 37, h, dtype=dtype, device=card)
    ws = [_randn(rng, *shape, scale=0.05, dtype=dtype, device=card)
          for shape in ((3 * h, h), (h, h), (mlp, h), (h, mlp))]
    bs = [_randn(rng, w.shape[0], scale=0.5, device=card) for w in ws]
    lns = [_randn(rng, h, scale=0.5, device=card) + shift for shift in (1.0, 0.0, 1.0, 0.0)]
    args = (x, ws[0], bs[0], ws[1], bs[1], lns[0], lns[1], ws[2], bs[2], ws[3], bs[3], lns[2],
            lns[3])
    got = vit_block.vit_block(*args, heads=2, eps=1e-6)
    _assert_close(got, vit_block.vit_block_plain(*args, heads=2, eps=1e-6), "vit block")


def test_vit_wrappers_refuse_bad_inputs(card):
    qkv = torch.zeros(2, 10, 3 * 128, device=card)
    with pytest.raises(ValueError):  # not contiguous
        vit_block.vit_attention(torch.zeros(2, 3 * 128, 10, device=card).transpose(1, 2), heads=2)
    with pytest.raises(ValueError):  # no kernel for float16
        vit_block.vit_attention(qkv.half(), heads=2)
    with pytest.raises(ValueError):  # head width 32
        vit_block.vit_attention(qkv, heads=4)
    with pytest.raises(ValueError):  # a residual of another shape
        scoring_layer.scoring_gemm(torch.zeros(4, 8, device=card), torch.zeros(8, 8, device=card),
                                   torch.zeros(8, device=card),
                                   residual=torch.zeros(4, 16, device=card))


# ------------------------------------------------------------ the gather

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,c,r", [(1000, 1, 3001), (40000, 3, 5003), (2048, 4, 777),
                                   (2048, 131, 1037)])
def test_gather_rows_matches_torch_gather(card, dtype, n, c, r):
    rng = np.random.RandomState(n + c)
    table = _randn(rng, 3, n, c, dtype=dtype, device=card)
    idx = torch.from_numpy(rng.randint(0, n, (3, r)).astype(np.int32)).to(card)
    before = gather.launches
    got = gather.gather_rows(table, idx)
    assert gather.launches == before + 1
    assert torch.equal(got, gather.gather_rows_plain(table, idx))
    one = gather.gather_rows(table[1], idx[1].long())
    assert torch.equal(one, table[1][idx[1].long()])


def test_gather_rows_refuses_bad_inputs(card):
    table = torch.zeros(2, 50, 4, device=card)
    idx = torch.zeros(2, 7, dtype=torch.int32, device=card)
    with pytest.raises(IndexError):
        gather.gather_rows(table, idx + 50)
    with pytest.raises(IndexError):
        gather.gather_rows(table, idx - 1)
    with pytest.raises(ValueError):  # float indices
        gather.gather_rows(table, idx.float())
    with pytest.raises(ValueError):  # no kernel for float16
        gather.gather_rows(table.half(), idx)
    with pytest.raises(ValueError):  # not contiguous
        gather.gather_rows(torch.zeros(2, 4, 50, device=card).transpose(1, 2), idx)
    with pytest.raises(ValueError):  # mixed devices
        gather.gather_rows(table, idx.cpu())
