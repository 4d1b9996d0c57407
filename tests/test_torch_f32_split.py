"""The 3xTF32 route of the port's f32 kernels (the products, the ViT and
scoring attentions, the vocabulary pass), emulated on the CPU
(``csrc/tile_gemm.cuh``: ``to_tf32``, ``split_tf32``, ``split3_tf32``, the
order of ``tf32_mainloop``; ``csrc/attention_f32.cuh``).

An f32 operand x is split into hi = tf32(x) and lo = tf32(x - hi), TF32 being
10 mantissa bits rounded to nearest with ties away from zero
(``cvt.rna.tf32.f32``'s rounding, which the kernels compute with the same
integer add and mask as ``to_tf32`` here); a product is lo_a * hi_b +
hi_a * lo_b + hi_a * hi_b, each partial product exact in an f32
accumulator. The products' and vocabulary pass's wgmma loop splits each
32-deep stage once and adds each 8-deep step's three passes, taken into a
fresh accumulator, to the f32 sum. These tests hold that sum
at the ViT's two depths (K = 768 and 3072) to the f64 product within 1e-5 of
the largest output, where the card's gate for the f32 kernels allows 1e-3,
and show that one TF32 pass (hi_a * hi_b alone) misses that 1e-5: the reason
the one-pass route is refused. The attention's P V splits V three ways, so
that a single key's context is exactly its value. The vocabulary pass's
reductions and the scoring attentions' two masks (causal inside an answer; a
-1e9 bias on question padding) keep that accuracy on the route's products.
"""

import numpy as np
import pytest
import torch

SPLIT_TOL = 1e-5  # of the largest output, against the f64 product


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: add half
    of the 13 dropped bits' weight to the magnitude and clear them (the sign
    is its own bit, so ties go away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = to_tf32(x)
    return hi, to_tf32(x - hi)


def three_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) times b (N, K)^T, 3xTF32, accumulated in f32."""
    (ah, al), (bh, bl) = split(a), split(b)
    return al @ bh.T + ah @ bl.T + ah @ bh.T


def wgmma_loop_products(a: torch.Tensor, b: torch.Tensor, bk: int = 32) -> torch.Tensor:
    """a (M, K) times b (N, K)^T in ``tf32_mainloop``'s order: K in stages
    of ``bk`` (zero-filled past K, as TMA fills them), each stage's tiles
    split once; each 8-deep step's passes lo_a hi_b, hi_a lo_b, hi_a hi_b
    into a fresh accumulator; two step accumulators that alternate, each
    added to the f32 sum while the next step runs (the first step adds the
    second accumulator's zeros), the last one after the loop."""
    k = a.shape[1]
    pad = -k % bk
    a, b = torch.nn.functional.pad(a, (0, pad)), torch.nn.functional.pad(b, (0, pad))
    total = torch.zeros(a.shape[0], b.shape[0])
    acc = [None, torch.zeros_like(total)]
    for s0 in range(0, k + pad, bk):
        (ah, al), (bh, bl) = split(a[:, s0:s0 + bk]), split(b[:, s0:s0 + bk])
        for ks in range(bk // 8):
            cur, sl = ks % 2, slice(8 * ks, 8 * ks + 8)
            step = al[:, sl] @ bh[:, sl].T
            step = step + ah[:, sl] @ bl[:, sl].T
            acc[cur] = step + ah[:, sl] @ bh[:, sl].T
            total = total + acc[1 - cur]
    return total + acc[1]


def _low_bits_clear(x: torch.Tensor) -> bool:
    return bool(((x.view(torch.int32) & 0x1FFF) == 0).all())


def test_tf32_rounding_is_cvt_rna():
    one = 1.0
    cases = {
        one + 2.0**-11: one + 2.0**-10,  # a tie: away from zero
        -(one + 2.0**-11): -(one + 2.0**-10),
        one + 2.0**-11 - 2.0**-23: one,  # below the tie
        one + 3 * 2.0**-11: one + 2 * 2.0**-10,  # a tie with an odd last bit: still away
        2.0**-10 + 1.0: 2.0**-10 + 1.0,  # already TF32
        0.0: 0.0,
    }
    x = torch.tensor(list(cases), dtype=torch.float32)
    want = torch.tensor(list(cases.values()), dtype=torch.float32)
    assert torch.equal(to_tf32(x), want)
    rng = np.random.RandomState(0)
    y = torch.from_numpy(rng.randn(10000).astype(np.float32))
    r = to_tf32(y)
    assert _low_bits_clear(r)
    assert float(((r - y).abs() / y.abs()).max()) <= 2.0**-11


def test_three_way_split_is_exact():
    """x = hi + lo + lo2 with lo2 = x - hi - lo exact in f32 and a TF32 value
    as it stands (``split3_tf32``)."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy((rng.randn(100000) * 10.0 ** rng.uniform(-6, 6, 100000))
                         .astype(np.float32))
    hi, lo = split(x)
    lo2 = (x - hi) - lo
    assert _low_bits_clear(hi) and _low_bits_clear(lo) and _low_bits_clear(lo2)
    assert torch.equal(x.double(), hi.double() + lo.double() + lo2.double())
    # the two-way split alone can miss x by up to two of its bits
    assert not torch.equal(x, hi + lo)


@pytest.mark.parametrize("k", [768, 3072])
def test_three_products_keep_f32_accuracy(k):
    rng = np.random.RandomState(k)
    a = torch.from_numpy(rng.randn(64, k).astype(np.float32))
    b = torch.from_numpy(rng.randn(96, k).astype(np.float32))
    exact = a.double() @ b.double().T
    largest = float(exact.abs().max())
    err3 = float((three_products(a, b).double() - exact).abs().max()) / largest
    err1 = float((to_tf32(a) @ to_tf32(b).T).double().sub(exact).abs().max()) / largest
    assert err3 <= SPLIT_TOL, err3
    # one TF32 pass keeps ~3 decimal digits a product
    assert err1 > SPLIT_TOL, err1
    assert err1 > 10 * err3


@pytest.mark.parametrize("k", [768, 3072, 776])
def test_wgmma_loop_order_keeps_f32_accuracy(k):
    """The products' and vocabulary pass's wgmma loop order at the ViT's and
    decoders' two depths, and at a depth whose last stage TMA zero-fills:
    within 1e-5 of the largest output against f64, and its stage split
    matches splitting the whole operands (the split is elementwise)."""
    rng = np.random.RandomState(k + 7)
    a = torch.from_numpy(rng.randn(48, k).astype(np.float32))
    b = torch.from_numpy((rng.randn(80, k) * 0.02).astype(np.float32))
    exact = a.double() @ b.double().T
    got = wgmma_loop_products(a, b)
    assert float((got.double() - exact).abs().max()) <= SPLIT_TOL * float(exact.abs().max())
    (ah, al), (bh, bl) = split(a), split(b)
    whole = sum((al[:, s:s + 8] @ bh[:, s:s + 8].T + ah[:, s:s + 8] @ bl[:, s:s + 8].T)
                + ah[:, s:s + 8] @ bh[:, s:s + 8].T for s in range(0, k, 8))
    assert float((got - whole).abs().max()) <= 1e-6 * float(exact.abs().max())


def test_one_key_context_is_its_value():
    """The ViT attention's P V at a single key: e = 1 (hi 1, lo 0) against V
    split three ways, summed in the kernel's order (lo2 * e_hi, e_lo * v_hi,
    lo * e_hi, hi * e_hi) in f32: exactly v. Two ways would miss it."""
    rng = np.random.RandomState(2)
    v = torch.from_numpy(rng.randn(4096).astype(np.float32))
    eh, el = split(torch.ones_like(v))
    vh, vl = split(v)
    vr = (v - vh) - vl
    acc = torch.zeros_like(v)
    for term in (vr * eh, el * vh, vl * eh, vh * eh):
        acc = acc + term
    assert torch.equal(acc, v)
    assert not torch.equal(el * vh + vl * eh + vh * eh, v)


def _emulated_attention(q, k, v, bias):
    """softmax(q k^T / 8 + bias) v on the kernels' route: q, k (B, M or N,
    64) and v (B, N, 64) f32, bias (B, M, N); S in 3xTF32, e = exp(s - max),
    P V with e split two ways and V three ways, summed in the kernels' order,
    then divided by the f32 sum."""
    (qh, ql), (kh, kl) = split(q), split(k)
    s = (ql @ kh.transpose(1, 2) + qh @ kl.transpose(1, 2) + qh @ kh.transpose(1, 2)) * 0.125
    s = s + bias
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    (eh, el), (vh, vl) = split(e), split(v)
    vr = (v - vh) - vl
    o = ((eh @ vr + el @ vh) + eh @ vl) + eh @ vh
    return o / e.sum(dim=-1, keepdim=True)


def _f64_attention(q, k, v, bias):
    s = q.double() @ k.double().transpose(1, 2) * 0.125 + bias.double()
    return torch.softmax(s, dim=-1) @ v.double()


@pytest.mark.parametrize("mode", ["self", "cross"])
def test_attention_masks_keep_f32_accuracy(mode):
    """Self: 64 answers of 12 under the causal mask; cross: 96 rows against
    80 question keys of which the last 30 carry -1e9. Within 1e-5 of the
    largest output against f64."""
    rng = np.random.RandomState(3 if mode == "self" else 4)
    b, m, n = (64, 12, 12) if mode == "self" else (2, 96, 80)
    q, k, v = (torch.from_numpy(rng.randn(b, r, 64).astype(np.float32)) for r in (m, n, n))
    if mode == "self":
        bias = torch.where(torch.tril(torch.ones(m, n, dtype=torch.bool)), 0.0, -1e9)
    else:
        bias = torch.where(torch.arange(n) < 50, 0.0, -1e9)[None, :].expand(m, n)
    bias = bias.expand(b, m, n).float()
    exact = _f64_attention(q, k, v, bias)
    err = float((_emulated_attention(q, k, v, bias).double() - exact).abs().max())
    assert err <= SPLIT_TOL * float(exact.abs().max()), err


def test_single_visible_key_context_is_its_value():
    """A question with one valid key and -1e9 on the others: every row's
    weights are exactly (1, 0, ...), so its context is that key's value bit
    for bit."""
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(1, r, 64).astype(np.float32)) for r in (40, 80, 80))
    bias = torch.where(torch.arange(80) < 1, 0.0, -1e9)[None, None, :].expand(1, 40, 80).float()
    assert torch.equal(_emulated_attention(q, k, v, bias), v[:, :1].expand(1, 40, 64))


def test_vocab_reductions_keep_f32_accuracy():
    """The vocabulary pass's (lse, sum of logits, target logit) of 3xTF32
    logits (64 rows x 4096 words x 768, plus an f32 bias) against f64: lse
    and the target logit within 1e-5 of their largest value, each row's sum
    of logits within 1e-5 of its sum of |logit|."""
    rng = np.random.RandomState(6)
    h = torch.from_numpy(rng.randn(64, 768).astype(np.float32))
    table = torch.from_numpy((rng.randn(4096, 768) * 0.05).astype(np.float32))
    bias = torch.from_numpy((rng.randn(4096) * 0.5).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 4096, 64))
    logits = three_products(h, table) + bias
    exact = h.double() @ table.double().T + bias.double()
    for got, want in ((torch.logsumexp(logits, dim=-1), torch.logsumexp(exact, dim=-1)),
                      (logits.gather(1, labels[:, None]), exact.gather(1, labels[:, None]))):
        assert float((got.double() - want).abs().max()) <= SPLIT_TOL * float(want.abs().max())
    rel = (logits.sum(dim=-1).double() - exact.sum(dim=-1)).abs() / exact.abs().sum(dim=-1)
    assert float(rel.max()) <= SPLIT_TOL
