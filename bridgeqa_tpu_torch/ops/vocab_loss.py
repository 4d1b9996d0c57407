"""Streaming label-smoothed LM vocabulary loss.

Counterpart of ``bridgeqa_tpu/ops/vocab_loss.py``. The answer-scoring head
projects every answer token onto the 30524-word tied table and reduces the
logits straight into a label-smoothed cross entropy. On a CUDA tensor
``lm_vocab_reductions`` launches the hand-written kernel in
``csrc/vocab_loss.cu``, which streams vocabulary tiles past blocks of rows
and never writes a logit; on a CPU tensor it runs
``lm_vocab_reductions_plain``. Logits are ``h @ table.T`` accumulated in f32
plus the f32 bias, never rounded to the working type.

Loss combine (``label_smoothed_loss_streaming``, O(rows), plain torch):
    nll    = lse - logit_target
    smooth = lse - sum_logits / V
    loss   = (1 - eps) * nll + eps * smooth    [0 where label == -100]
"""

import torch

from bridgeqa_tpu_torch.ops import cuda_lib

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# vocabulary words per tile of the kernel: bf16 tensor-core tiles, f32 tiles
_TILE = {torch.bfloat16: 128, torch.float32: 64}
# rows per block of the plain version
_PLAIN_ROWS = 2048

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0


def _splits(rows: int, vocab: int, dtype: torch.dtype, device: torch.device) -> tuple[int, int]:
    """(splits, tiles per split): cut the vocabulary into runs so that the
    row blocks times the runs fill the card about four blocks deep."""
    tile = _TILE[dtype]
    vtiles = -(-vocab // tile)
    row_blocks = -(-rows // tile)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = min(vtiles, max(1, -(-4 * sms // row_blocks)))
    per = -(-vtiles // want)
    return -(-vtiles // per), per


def lm_vocab_reductions(h: torch.Tensor, table: torch.Tensor, bias: torch.Tensor,
                        labels: torch.Tensor):
    """Per-row (lse, sum_logits, target_logit) of ``h @ table.T + bias``.

    h: (R, H) transformed hidden states; table: (V, H) tied embedding, the
    same dtype; bias: (V,) f32; labels: (R,) int32 in [0, V). Returns three
    (R,) f32 tensors."""
    global launches
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
    splits, per = _splits(r, v, h.dtype, h.device)
    partial = torch.empty((splits, r, 4), dtype=torch.float32, device=h.device)
    lse, sumlog, tgt = (torch.empty(r, dtype=torch.float32, device=h.device) for _ in range(3))
    rc = cuda_lib.lib().bq_vocab_reductions(
        h.data_ptr(), table.data_ptr(), bias.data_ptr(), labels.data_ptr(), partial.data_ptr(),
        lse.data_ptr(), sumlog.data_ptr(), tgt.data_ptr(), r, v, hdim, splits, per,
        _DTYPE_CODES[h.dtype], cuda_lib.stream_handle(h.device))
    cuda_lib.check(rc, "bq_vocab_reductions")
    launches += 1
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
