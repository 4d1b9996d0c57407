#!/usr/bin/env python3
"""Time the port's main-path forward in two configurations, in turns, in one
process on one CUDA card.

    python3 main_path_variants.py

- "fused": the ViT blocks through the fused kernels, and each ``Dense`` bias
  an f32 parameter with a bf16 copy for the module path (the default).
- "module": the ViT as a module loop (``vit_block.FUSED_MODE = "off"``), and
  each ``Dense`` and ``PatchEmbed`` bias a bf16 parameter (the layout
  ``set_compute_dtype`` made before the fused paths read f32 biases).

Both run the same model and inputs as ``chip_smoke.py`` phase 5 (batch 8,
bf16). For each, in each of 4 rounds (the order alternating): the median
wall time of 5 forwards, then the card's and the host's time per stage
(``chip_smoke.stage_times``).
Comparing the two in one process takes the host's drift between processes
out of the comparison. Prints one JSON line per round and configuration,
and fails without a card.
"""

import json
import statistics
import time

import torch

import chip_smoke as cs

ROUNDS = 4


def set_layout(model, vb, layout: str, f32_bias: dict) -> None:
    """Switch the ViT path and the bias layout of ``model``; ``f32_bias``
    holds each module's f32 bias to switch back to."""
    from bridgeqa_tpu_torch.models.layers import Dense, PatchEmbed

    vb.FUSED_MODE = "auto" if layout == "fused" else "off"
    for m in model.modules():
        if isinstance(m, (Dense, PatchEmbed)) and m in f32_bias:
            if layout == "fused":
                m.bias.data = f32_bias[m]
                m.bias_cast = f32_bias[m].to(torch.bfloat16)
            else:
                m.bias.data = f32_bias[m].to(torch.bfloat16)
                m.bias_cast = None


def main() -> int:
    device = cs.phase_device()
    cs.phase_build()
    from bridgeqa_tpu_torch.models.layers import Dense, PatchEmbed, set_compute_dtype
    from bridgeqa_tpu_torch.ops import vit_block as vb

    cfg = cs.main_config()
    model = set_compute_dtype(cs.build_model(cfg, device), torch.bfloat16)
    batch = cs.make_batch(cfg, cs.BATCH, cs.NUM_POINTS, cs.IMAGE_SIZE, cs.QUESTION_LEN,
                          cs.ANSWER_LEN, device)
    f32_bias = {m: m.bias.data for m in model.modules()
                if isinstance(m, (Dense, PatchEmbed)) and m.bias is not None}

    def forward():
        return model(batch, inference="rank", k_test=cs.K_TEST)

    with torch.inference_mode():
        for r in range(ROUNDS):
            for layout in ("fused", "module") if r % 2 == 0 else ("module", "fused"):
                set_layout(model, vb, layout, f32_bias)
                forward()
                walls = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    forward()
                    torch.cuda.synchronize()
                    walls.append(round((time.perf_counter() - t0) * 1e3, 1))
                card, host = cs.stage_times(model, forward)
                print(json.dumps({"round": r, "layout": layout,
                                  "wall_ms": statistics.median(walls), "walls": walls,
                                  "card_ms": {k: round(v, 2) for k, v in card.items()},
                                  "host_ms": {k: round(v, 2) for k, v in host.items()}}),
                      flush=True)
    set_layout(model, vb, "fused", f32_bias)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
