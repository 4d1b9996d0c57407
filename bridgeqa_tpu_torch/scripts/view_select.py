"""Produce the question -> best-view mapping (i2tfile) with BLIP-ITM
(counterpart of ``scripts/view_select.py``, the reference's
``eval_scene_best_views.py``).

Compose declarative rewrites of the questions (``tools/compose_decl.py``),
encode every frame of a scene and each declaration with BLIP-ITM (itc
mode), rank the frames per question by cosine similarity, and save the
mapping the data pipeline reads (``--i2tfile`` of the ``train`` driver).

The JAX driver's flags, plus ``--composer`` (``rules``, the default: the
rule-based rewrite; ``deepseek-v2-lite``: ``tools/compose_llm.py``'s
``LocalLMComposer`` on the card, which needs the published weights and
tokenizer, not in the repository, so it refuses unless ``--synthetic``
runs a tiny configuration of it on random weights), ``--device`` (the card
by default; without one it raises, nothing falls back to the CPU) and ``--seed`` (the random weights
where no ``--itm_ckpt`` is given). ``--itm_ckpt`` goes through the port's
copies of the converters (``utils/blip_checkpoint.py``) over the seeded
model's own tree. The synthetic frames of a scene are seeded from
``zlib.crc32`` of its id (``data/sources.stable_seed``), the same in every
process; the JAX driver seeds them from Python's salted ``hash``. Real frames
are read with PIL (``data/views.py``).

Demo: ``python -m bridgeqa_tpu_torch.scripts.view_select --synthetic --tiny --device cpu
--out /tmp/i2t.json``
"""

import argparse
import json
import os

import numpy as np
import torch

from bridgeqa_tpu_torch.convert import export_jax_variables, load_jax_variables
from bridgeqa_tpu_torch.data.sources import stable_seed
from bridgeqa_tpu_torch.models.blip_itm import BLIPITM, BlipITMConfig
from bridgeqa_tpu_torch.models.layers import init_weights
from bridgeqa_tpu_torch.models.med import MedConfig
from bridgeqa_tpu_torch.scripts import common
from bridgeqa_tpu_torch.tools.compose_decl import RuleBasedComposer, compose_declarations
from bridgeqa_tpu_torch.tools.compose_llm import compose_declarations_batched
from bridgeqa_tpu_torch.tools.view_select import save_i2tfile, select_best_views


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--split", type=str, nargs="+", default=["train", "val"])
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--image_size", type=int, default=384)
    p.add_argument("--image_batch", type=int, default=64)
    p.add_argument("--decl_file", type=str, default=None,
                   help="question_id->declaration json (LLM rewrites); "
                        "defaults to the rule-based composer")
    p.add_argument("--composer", choices=("rules", "deepseek-v2-lite"), default="rules",
                   help="who rewrites the questions where no --decl_file is given")
    p.add_argument("--itm_ckpt", type=str, default=None,
                   help="torch BLIP-ITM .pth to convert and load")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def build_model(args, device):
    if args.tiny:
        med = MedConfig(vocab_size=200, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=128,
                        max_position_embeddings=64, encoder_width=64)
        cfg = BlipITMConfig(med=med, image_size=32, vit="custom", embed_dim=32,
                            vit_custom_embed_dim=64, vit_custom_depth=2, vit_custom_heads=4)
    else:
        cfg = BlipITMConfig(image_size=args.image_size, vit="large"
                            if args.itm_ckpt and "large" in args.itm_ckpt else "base")
    model = BLIPITM(cfg, device=device)
    init_weights(model, torch.Generator(device=device).manual_seed(args.seed))

    if args.itm_ckpt:
        from bridgeqa_tpu_torch.utils.blip_checkpoint import (
            _bert_embeddings,
            _linear,
            convert_bert_encoder,
            convert_vit,
            load_torch_checkpoint,
            merge_pretrained,
        )

        sd = load_torch_checkpoint(args.itm_ckpt)
        num_patches = (cfg.image_size // 16) ** 2
        converted = {
            "visual_encoder": convert_vit(sd, "visual_encoder", num_patches),
            "text_encoder": {
                "embeddings": _bert_embeddings(sd, "text_encoder.bert.embeddings"
                                               if "text_encoder.bert.embeddings.word_embeddings.weight" in sd
                                               else "text_encoder.embeddings", cfg.med.vocab_size),
                "encoder": convert_bert_encoder(sd, "text_encoder.bert.encoder"
                                                if "text_encoder.bert.encoder.layer.0.attention.self.query.weight" in sd
                                                else "text_encoder.encoder", twin=False),
            },
            "vision_proj": _linear(sd, "vision_proj"),
            "text_proj": _linear(sd, "text_proj"),
            "itm_head": _linear(sd, "itm_head"),
        }
        params, loaded, skipped = merge_pretrained(export_jax_variables(model)["params"],
                                                   converted)
        print(f"loaded {len(loaded)} tensors, skipped {len(skipped)}")
        load_jax_variables(model, {"params": params})
    return model


# the tiny configuration ``--composer deepseek-v2-lite --synthetic`` runs
TINY_LM = dict(vocab_size=512, hidden_size=64, intermediate_size=128, moe_intermediate_size=64,
               num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
               n_shared_experts=1, n_routed_experts=8, num_experts_per_tok=2, kv_lora_rank=32,
               qk_rope_head_dim=16, qk_nope_head_dim=16, v_head_dim=16, bos_token_id=510,
               eos_token_id=511)


def build_lm_composer(args, device, tokenizer):
    """``LocalLMComposer`` over DeepSeek-V2-Lite: with ``--synthetic`` a tiny
    configuration on random weights and the run's word-piece tokenizer;
    otherwise a refusal, since the published weights and tokenizer are not
    in the repository."""
    from bridgeqa_tpu_torch.models.deepseek_v2 import DeepseekV2Config, DeepseekV2ForCausalLM
    from bridgeqa_tpu_torch.tools.compose_llm import LocalLMComposer, WordPieceIds

    if not args.synthetic:
        raise SystemExit("--composer deepseek-v2-lite: the published DeepSeek-V2-Lite weights "
                         "(safetensors) and tokenizer.json are not in the repository; "
                         "--synthetic runs a tiny configuration on random weights")
    model = DeepseekV2ForCausalLM(DeepseekV2Config(**TINY_LM), device=device,
                                  dtype=torch.float32 if device.type == "cpu" else torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(1.0 if p.dim() == 1 else 0.0, 0.1 if p.dim() == 1 else 0.02, generator=gen)
    return LocalLMComposer(model, WordPieceIds(tokenizer), max_new_tokens=8)


class SyntheticFrames:
    """``num_frames`` random frames a scene (six, as the JAX driver's),
    seeded from ``zlib.crc32`` of its id."""

    def __init__(self, image_size: int, num_frames: int = 6):
        self.image_size, self.num_frames = image_size, num_frames

    def __call__(self, scene_id):
        rng = np.random.RandomState(stable_seed(scene_id))
        names = [f"{i * 20}.jpg" for i in range(self.num_frames)]
        size = self.image_size
        return names, rng.rand(self.num_frames, size, size, 3).astype(np.float32)


def real_frames(data_root, image_size):
    from bridgeqa_tpu_torch.data.views import SceneViewsPool, preprocess_vqa

    pool = SceneViewsPool(os.path.join(data_root, "frames_square"), image_size)

    def load(scene_id):
        from PIL import Image

        names = pool.get_all_views(scene_id)
        images = []
        for name in names:
            color_p, _, _ = pool._paths(scene_id, name)
            images.append(preprocess_vqa(Image.open(color_p), image_size))
        return names, np.stack(images)

    return load


def main(argv=None):
    args = parse_args(argv)
    device = common.resolve_device(args.device)
    if args.synthetic or not args.data_root:
        records = common.synthetic_records(8)
        tokenizer = common.synthetic_tokenizer()
        loader = SyntheticFrames(32 if args.tiny else args.image_size)
    else:
        records = []
        for s in args.split:
            records += common.load_scanqa_records(args.data_root, s, getattr(args, "dataset", "scanqa"))
        from bridgeqa_tpu_torch.data.tokenization import WordPieceTokenizer

        tokenizer = WordPieceTokenizer.from_vocab_file(os.path.join(args.data_root, "vocab.txt"))
        loader = real_frames(args.data_root, args.image_size)

    if args.decl_file and os.path.exists(args.decl_file):
        with open(args.decl_file) as f:
            decl_map = json.load(f)
    elif args.composer == "rules":
        decl_map = compose_declarations(records, args.out + ".decl.json",
                                        composer=RuleBasedComposer())
    else:
        decl_map = compose_declarations_batched(records, args.out + ".decl.json",
                                                build_lm_composer(args, device, tokenizer))

    model = build_model(args, device)
    i2t = select_best_views(model, records, tokenizer, loader, decl_map=decl_map,
                            image_batch=args.image_batch)
    save_i2tfile(i2t, args.out)
    print(f"wrote view rankings for {len(i2t['view'])} questions -> {args.out}")
    return i2t


if __name__ == "__main__":
    main()
