"""Run a tiny compose cell through the harness and print its result line;
with a fault, the timed path is broken underneath.

    python3 -m qa_bench.tests.tiny_compose [--trace] [--device cpu|cuda]
        [--fault expert|cache|prompt] [--full]

The harness's look for a card is skipped: everything after it runs as in a
run on the card. ``--full`` runs the cell's own configuration and traffic
instead (DeepSeek-V2-Lite whole, bf16, batches of 256: on the card), so
that a fault is read at the cell's size. The last line of standard error names the loaded modules
of JAX or the JAX package (none, when the run is sound)."""

import argparse
import copy
import json
import sys
import time

START = time.perf_counter()

import torch  # noqa: E402

from qa_bench import harness  # noqa: E402
from qa_bench.tests.tiny import load  # noqa: E402

CELL = "compose-bf16-b256"


def config() -> dict:
    c = copy.deepcopy(load("configs/deepseek-v2-lite.json"))
    # at this width a std of 0.02 leaves the branches' outputs a tenth of the
    # full model's against the residual; 0.1 gives them the full model's scale
    c.update(vocab_size=512, hidden_size=64, intermediate_size=128, moe_intermediate_size=64,
             num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=4,
             n_shared_experts=1, n_routed_experts=8, num_experts_per_tok=2, kv_lora_rank=32,
             qk_rope_head_dim=16, qk_nope_head_dim=16, v_head_dim=16, bos_token_id=500,
             eos_token_id=501, initializer_range=0.1)
    c["rope_scaling"] = {**c["rope_scaling"], "original_max_position_embeddings": 64}
    return c


def traffic(dtype: str) -> dict:
    t = copy.deepcopy(load("workloads/compose-bf16-b256.json"))
    t.update(dtype=dtype, batch=4, pool_batches=2, template_tokens=6, question_words=[2, 5],
             answer_words=[1, 2], new_tokens=[4, 8], check_rows=4, warmup=1)
    return t


def break_program(fault: str) -> None:
    from bridgeqa_tpu_torch.models import deepseek_v2
    from bridgeqa_tpu_torch.ops import moe

    if fault == "expert":  # one routed expert's output dropped in the combine
        ffn = moe.moe_ffn

        def dropped(x, weights, ids, gate_up, down):
            return ffn(x, torch.where(ids == 0, 0.0, weights), ids, gate_up, down)

        deepseek_v2.moe.moe_ffn = dropped
    elif fault == "cache":  # one token's row of the latent cache corrupted after prefill
        prefill = deepseek_v2.DeepseekV2ForCausalLM.prefill

        def corrupted(self, ids, lens, extra=0):
            cache, logits = prefill(self, ids, lens, extra)
            cache.kv[1][:, 1] += 1.0
            return cache, logits

        deepseek_v2.DeepseekV2ForCausalLM.prefill = corrupted
    elif fault == "prompt":  # a checked row's prompt shortened by its last token
        generate = deepseek_v2.DeepseekV2ForCausalLM.generate_greedy

        def shortened(self, ids, lens, new, eos=None, logit_rows=None):
            if logit_rows is not None:
                lens = list(lens)
                lens[int(logit_rows[0])] -= 1
            return generate(self, ids, lens, new, eos, logit_rows)

        deepseek_v2.DeepseekV2ForCausalLM.generate_greedy = shortened


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--trace", action="store_true")
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--fault", choices=("expert", "cache", "prompt"))
    parser.add_argument("--seed", type=int, default=2**31 + 11)
    parser.add_argument("--full", action="store_true")
    args = parser.parse_args(argv)
    torch.set_num_threads(2)
    if args.fault:
        break_program(args.fault)
    device = torch.device(args.device)
    bench, cell, cfg, t = harness.find_cell(CELL)
    # float32 on the CPU: the limits, set for bf16 at full size, then hold
    # the program to the reference with room, and each fault breaks them
    dtype = "bfloat16" if device.type == "cuda" else "float32"
    if not args.full:
        cfg, t = config(), traffic(dtype)
    result = harness.run(bench, cell, cfg, t, args.seed, 1.0, args.trace, device, START)
    print(json.dumps(result), flush=True)
    print(f"forbidden modules: {harness.forbidden_modules()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
