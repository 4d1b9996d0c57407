"""The operation and byte counts against a count by hand at tiny shapes, and
against ``bench.py``'s arithmetic (``scoring_pass_flops_bytes``,
``vit_flops``), worked out by hand at its full shapes: batch 32, k_test 256,
answers of 12 tokens, questions of 80, hidden 768, FFN 3072, 12 layers,
vocabulary 30524, 901 ViT tokens."""

from qa_bench import flops
from qa_bench.tests import tiny

H, FF, LAYERS, VOCAB = 768, 3072, 12, 30524
B, K, LA, LQ = 32, 256, 12, 80
# bench.py: LAYERS * per_layer of scoring_pass_flops_bytes, one decoder
BENCH_SCORING_LAYERS = 19815368491008
# bench.py: head_rows * H * VOCAB * 2, head_rows = B * K * (LA - 1)
BENCH_VOCAB = 4224888864768
# bench.py: vit_flops(), BATCH * LAYERS * per_layer (no patch embedding)
BENCH_VIT = 5855311429632


def test_vit_by_hand():
    # 2 images of 32 px: 4 patches, 5 tokens, 10 rows. Patch embedding
    # 2*8*768*8 = 98304; a block: QKV 2*10*8*24 = 3840, output 1280, MLP
    # 2560 + 2560, attention 2*2*10*5*8 = 1600
    assert flops.vit_flops(2, 32, 8, 16, 1) == 98304 + 3840 + 1280 + 2560 + 2560 + 1600


def test_bert_layer_by_hand():
    # 6 rows of 3-token sequences, width 4, FFN 8, 5 cross keys from 10 rows:
    # QKV 2*6*4*12 = 576, scores and context 2*2*6*3*4 = 288, output 192; cross query 192, K and V
    # 640, scores and context 480, output 192; FFN 384 + 384
    assert flops.bert_layer(6, 3, 4, 8, 5, 10) == 576 + 288 + 192 + 192 + 640 + 480 + 192 + 768
    assert flops.bert_layer(6, 3, 4, 8) == 576 + 288 + 192 + 768


def test_gemm_call_by_hand():
    # x 3x4, w 5x4, out 3x5 and a residual 3x5 in f32, bias 5 f32
    assert flops.gemm_call(3, 4, 5, 4, residual=True) == (120, (12 + 20 + 30) * 4 + 20)
    assert flops.gemm_call(3, 4, 5, 2) == (120, (12 + 20 + 15) * 2 + 20)


def test_scoring_pass_matches_bench():
    cfg = tiny.load("configs/bridgeqa-scanqa.json")
    gemm = sum(f for f, _ in flops.scoring_gemm_calls(cfg, B, K, LA, 2)) // 2
    rows = B * K * LA
    attention = LAYERS * (flops.attention(rows, LA, H) + flops.attention(rows, LQ, H))
    assert gemm + attention == BENCH_SCORING_LAYERS
    vocab = flops.vocab_calls(cfg, B, K, LA, 2)
    assert len(vocab) == 2 and vocab[0][0] == BENCH_VOCAB


def test_vit_matches_bench():
    patch = flops.dense(B * 900, 3 * 16 * 16, H)
    assert flops.vit_flops(B, 480, H, FF, LAYERS) - patch == BENCH_VIT


def test_rank_forward_total():
    """Every product of the rank forward at batch 8: the scoring passes and
    the vocabulary carry about 13 of its 13.7 TFLOP, and the total bounds
    the ViT, the decoders and the vocabulary products from above."""
    cfg = tiny.load("configs/bridgeqa-scanqa.json")
    total = flops.rank_flops(cfg, 8, 256, LQ, LA)
    parts = (flops.vit_flops(8, 480, H, FF, LAYERS)
             + 2 * (BENCH_SCORING_LAYERS + BENCH_VOCAB) // 4)
    assert parts < total < parts * 1.1
    assert 13.0e12 < total < 14.5e12


def test_itm_counts():
    cfg = tiny.load("configs/blip-itm-base.json")
    assert flops.itm_image_flops(cfg, 64) == (flops.vit_flops(64, 384, H, FF, LAYERS)
                                              + flops.dense(64, H, 256))
    text = LAYERS * flops.bert_layer(64 * 40, 40, H, FF) + flops.dense(64, H, 256)
    assert flops.itm_text_flops(cfg, 64, 40) == text
