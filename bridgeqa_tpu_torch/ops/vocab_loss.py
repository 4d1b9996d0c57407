"""Streaming label-smoothed LM vocabulary loss.

Counterpart of ``bridgeqa_tpu/ops/vocab_loss.py``. The answer-scoring head
projects every answer token onto the 30524-word tied table and reduces the
logits straight into a label-smoothed cross entropy. On a CUDA tensor
``lm_vocab_reductions`` launches the hand-written kernel in
``csrc/vocab_loss.cu``, which streams vocabulary tiles past panels of rows
(bf16 on the wgmma main loop of ``csrc/wgmma_gemm.cuh``, f32 on a 3xTF32
main loop of ``csrc/tile_gemm.cuh``) and never writes a logit; on a CPU
tensor it runs
``lm_vocab_reductions_plain``. Logits are ``h @ table.T`` accumulated in f32
plus the f32 bias, never rounded to the working type.

Loss combine (``label_smoothed_loss_streaming``, O(rows), plain torch):
    nll    = lse - logit_target
    smooth = lse - sum_logits / V
    loss   = (1 - eps) * nll + eps * smooth    [0 where label == -100]
"""

import torch

from bridgeqa_tpu_torch.ops import cuda_lib
from bridgeqa_tpu_torch.utils.profiling import count

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# vocabulary words (and rows) per tile of the kernel, in either type
_TILE = 128
# f32: a run this much busier than the least busy one still counts as level
# (a unit's start, the ring's fill and its partials, costs more: one tile a
# run measured 4% slower than 80, f32_variants.py)
_F32_LEVEL = 1.01
# rows per block of the plain version
_PLAIN_ROWS = 2048


def _splits(rows: int, vocab: int, dtype: torch.dtype, device: torch.device) -> tuple[int, int]:
    """(runs, tiles per run) of the vocabulary tiles.

    A unit of the kernel is (128-row panel, run), and the card holds one
    block an SM in either type. bf16: a persistent grid walks the units,
    and a run is an even number of tiles (the two consumers alternate over
    them); f32: a persistent grid too on the TMA route (both consumers share
    each tile), one block a unit on the mma.sync route. The run is the
    longest that makes the busiest SM's tiles fewest (fewer partials), in
    f32 within ``_F32_LEVEL`` of the fewest."""
    vtiles = -(-vocab // _TILE)
    panels = -(-rows // _TILE)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    bf16 = dtype == torch.bfloat16

    def busiest(per):
        units = panels * -(-vtiles // per)
        return -(-units // min(units, sms)) * per

    runs = range(2, vtiles + 2, 2) if bf16 else range(1, vtiles + 1)
    least = min(busiest(p) for p in runs)
    per = max(p for p in runs if busiest(p) <= (1.0 if bf16 else _F32_LEVEL) * least)
    return -(-vtiles // per), per


def lm_vocab_reductions(h: torch.Tensor, table: torch.Tensor, bias: torch.Tensor,
                        labels: torch.Tensor, *, split: tuple[int, int] | None = None):
    """Per-row (lse, sum_logits, target_logit) of ``h @ table.T + bias``.

    h: (R, H) transformed hidden states; table: (V, H) tied embedding, the
    same dtype; bias: (V,) f32; labels: (R,) int32 in [0, V). Returns three
    (R,) f32 tensors. ``split`` = (runs, tiles per run, even for bf16) sets
    how the kernel cuts the vocabulary instead of ``_splits``, for the card
    tests (a run may lie wholly past the vocabulary)."""
    r, hdim = h.shape
    v = table.shape[0]
    if table.shape != (v, hdim) or bias.shape != (v,) or labels.shape != (r,):
        raise ValueError(f"lm_vocab_reductions: shapes {tuple(h.shape)}, {tuple(table.shape)}, "
                         f"{tuple(bias.shape)}, {tuple(labels.shape)}")
    if h.device.type == "cpu":
        return lm_vocab_reductions_plain(h, table, bias, labels)
    if h.device.type != "cuda":
        raise ValueError(f"lm_vocab_reductions: unsupported device {h.device}")
    for t in (table, bias, labels):
        if t.device != h.device:
            raise ValueError(f"lm_vocab_reductions: tensors on {t.device} and {h.device}")
    cuda_lib.refuse_grad("lm_vocab_reductions", h, table, bias)
    if not all(t.is_contiguous() for t in (h, table, bias, labels)):
        raise ValueError("lm_vocab_reductions: the kernel needs contiguous tensors")
    if h.dtype not in _DTYPE_CODES or table.dtype != h.dtype:
        raise ValueError(f"lm_vocab_reductions: h and table must both be float32 or bfloat16, "
                         f"got {h.dtype}, {table.dtype}")
    if bias.dtype != torch.float32 or labels.dtype != torch.int32:
        raise ValueError(f"lm_vocab_reductions: bias must be float32 and labels int32, got "
                         f"{bias.dtype}, {labels.dtype}")
    if h.dtype == torch.bfloat16 and (hdim % 8 or h.data_ptr() % 16 or table.data_ptr() % 16):
        raise ValueError(f"lm_vocab_reductions: bf16 needs a width that is a multiple of 8 and "
                         f"16-byte aligned h and table, got {hdim}")
    splits, per = split or _splits(r, v, h.dtype, h.device)
    if h.dtype == torch.bfloat16 and per % 2:
        raise ValueError(f"lm_vocab_reductions: bf16 runs of an even number of tiles, got {per}")
    parts = 2 * splits if h.dtype == torch.bfloat16 else splits  # bf16: one per consumer
    partial = torch.empty((parts, r, 4), dtype=torch.float32, device=h.device)
    lse, sumlog, tgt = (torch.empty(r, dtype=torch.float32, device=h.device) for _ in range(3))
    rc = cuda_lib.lib().bq_vocab_reductions(
        h.data_ptr(), table.data_ptr(), bias.data_ptr(), labels.data_ptr(), partial.data_ptr(),
        lse.data_ptr(), sumlog.data_ptr(), tgt.data_ptr(), r, v, hdim, splits, per,
        _DTYPE_CODES[h.dtype], cuda_lib.stream_handle(h.device))
    cuda_lib.check(rc, "bq_vocab_reductions")
    count("kernel/vocab_loss")
    if h.dtype == torch.float32:
        count("kernel/f32_vocab_wgmma" if cuda_lib.f32_tma_route(hdim, h, table)
              else "kernel/f32_vocab_mma")
    return lse, sumlog, tgt


def lm_vocab_reductions_plain(h, table, bias, labels):
    """Plain PyTorch ``lm_vocab_reductions`` on any device: f32 logits of
    the up-cast inputs, ``_PLAIN_ROWS`` rows at a time."""
    table32 = table.float()
    bias32 = bias.float()
    out = []
    for s in range(0, h.shape[0], _PLAIN_ROWS):
        logits = h[s:s + _PLAIN_ROWS].float() @ table32.T + bias32
        lab = labels[s:s + _PLAIN_ROWS].long()
        out.append((torch.logsumexp(logits, dim=-1), logits.sum(dim=-1),
                    logits.gather(1, lab[:, None])[:, 0]))
    return tuple(torch.cat(parts) for parts in zip(*out))


def label_smoothed_loss_streaming(h_shifted, labels_shifted, table, bias, epsilon: float = 0.1,
                                  reductions=lm_vocab_reductions):
    """Label-smoothed per-sequence LM loss through ``reductions``
    (``lm_vocab_reductions`` or its plain version).

    h_shifted: (B, L-1, H) transformed hidden states (positions 0..L-2);
    labels_shifted: (B, L-1) target ids, -100 = ignore. Returns (B,) f32."""
    b, lm1, hdim = h_shifted.shape
    v = table.shape[0]
    flat_lab = labels_shifted.reshape(b * lm1)
    valid = flat_lab != -100
    safe = torch.where(valid, flat_lab, 0).to(torch.int32)
    lse, sumlog, tgt = reductions(h_shifted.reshape(b * lm1, hdim).contiguous(),
                                  table.contiguous(), bias.float().contiguous(), safe)
    per_token = (1.0 - epsilon) * (lse - tgt) + epsilon * (lse - sumlog / v)
    return torch.where(valid, per_token, 0.0).reshape(b, lm1).sum(dim=-1)
