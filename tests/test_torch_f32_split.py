"""The 3xTF32 route of the port's f32 products and f32 ViT attention,
emulated on the CPU (``csrc/tile_gemm.cuh``: ``to_tf32``, ``split_tf32``,
``split3_tf32``).

An f32 operand x is split into hi = tf32(x) and lo = tf32(x - hi), TF32 being
10 mantissa bits rounded to nearest with ties away from zero
(``cvt.rna.tf32.f32``'s rounding, which the kernels compute with the same
integer add and mask as ``to_tf32`` here); a product is lo_a * hi_b +
hi_a * lo_b + hi_a * hi_b, each partial product exact in an f32
accumulator. These tests hold that sum
at the ViT's two depths (K = 768 and 3072) to the f64 product within 1e-5 of
the largest output, where the card's gate for the f32 kernels allows 1e-3,
and show that one TF32 pass (hi_a * hi_b alone) misses that 1e-5: the reason
the one-pass route is refused. The attention's P V splits V three ways, so
that a single key's context is exactly its value.
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
