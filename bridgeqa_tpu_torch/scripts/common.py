"""Shared CLI plumbing: config construction, dataset/record loading,
synthetic demo data (so every driver runs without a ScanNet download)
(counterpart of ``scripts/common.py``).

Mirrors the argparse surface of the reference drivers (``scripts/train.py``
flags 40-179) mapped onto the port's config dataclasses, plus ``--device``
(the card by default; a run that asks for the card fails without one, it
never falls back to the CPU) and ``--synthetic_val_records``. The model is
built on the device (``BridgeQA(cfg, device=...)``) with its weights drawn
from ``--seed`` (``layers.init_weights``), computing in bf16 under
``--bf16`` (``set_compute_dtype``).

The scene loader, the view and multiview lookups and the synthetic data
live in ``data/sources.py`` (numpy only, and picklable: the feed's worker
processes receive the dataset that holds them).
"""

import argparse
import json
import os

import torch

from bridgeqa_tpu_torch.data.answers import build_answer_vocab
from bridgeqa_tpu_torch.data.pipeline import BatchIterator, ScanQADataset
from bridgeqa_tpu_torch.data.scannet_config import ScannetDatasetConfig
from bridgeqa_tpu_torch.data.sources import (
    MultiviewFiles,
    SyntheticMultiview,
    make_scene_loader,
    synthetic_records,
    synthetic_scene_data,
    synthetic_tokenizer,
    synthetic_view_lookup,
)
from bridgeqa_tpu_torch.data.tokenization import WordPieceTokenizer
from bridgeqa_tpu_torch.models.blip_vqa3d import BlipVQA3DConfig
from bridgeqa_tpu_torch.models.bridgeqa import BridgeQA, BridgeQAConfig
from bridgeqa_tpu_torch.models.layers import init_weights, set_compute_dtype
from bridgeqa_tpu_torch.models.med import MedConfig


def add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--num_points", type=int, default=40000)
    p.add_argument("--num_proposal", type=int, default=256)
    p.add_argument("--seed_feat_dim", type=int, default=256)
    p.add_argument("--proposal_size", type=int, default=128)
    p.add_argument("--hidden_size", type=int, default=128)
    p.add_argument("--image_size", type=int, default=480)
    p.add_argument("--use_color", action="store_true")
    p.add_argument("--use_height", action="store_true", default=True)
    p.add_argument("--use_normal", action="store_true")
    p.add_argument("--use_multiview", action="store_true")
    p.add_argument("--no_reference", action="store_true")
    p.add_argument("--no_lang_cls", action="store_true")
    p.add_argument("--no_answer", action="store_true")
    p.add_argument("--no_blip", action="store_true", help="MCAN 3D-only path")
    p.add_argument("--stage", type=str, default="VQA", choices=["DET", "VQA"])
    p.add_argument("--share_decoder", action="store_true")
    p.add_argument("--scene_feature_position", type=str, default="paralleltwin",
                   choices=["paralleltwin", "parallelshare"],
                   help="3D-stream decoder: separate twin decoder (paper main "
                        "path) or one shared decoder with per-stream FFN "
                        "LayerNorms (reference train.py:148)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 activations")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize ViT/BERT layers (bigger train batches)")
    p.add_argument("--remat_mode", type=str, default="block", choices=["block", "attn"],
                   help="block: recompute whole layers in the backward (reference's "
                        "fairscale checkpoint_wrapper behavior; fits batch 16 on 16G); "
                        "attn: recompute only attention matrices (~5%% recompute, but "
                        "saves ~6x more activations — smaller batches only)")
    p.add_argument("--tiny", action="store_true", help="tiny dims (CI/demo)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model runs: a CUDA card (default; fails without one) "
                        "or 'cpu' (the kernels' plain versions)")


def add_data_args(p: argparse.ArgumentParser):
    p.add_argument("--data_root", type=str, default=None,
                   help="root with ScanQA jsons + scannet_data npys + frames")
    p.add_argument("--dataset", type=str, default="scanqa", choices=["scanqa", "sqa"],
                   help="QA benchmark: ScanQA or SQA3D (reference blip_utils.py:11-14)")
    p.add_argument("--i2tfile", type=str, default=None, help="question->view mapping")
    p.add_argument("--multiview_root", type=str, default=None,
                   help="per-scene projected ENet features "
                        "(project_multiview_features.py output) for --use_multiview")
    p.add_argument("--synthetic", action="store_true",
                   help="run on generated scenes (no ScanNet needed)")
    p.add_argument("--synthetic_records", type=int, default=32,
                   help="synthetic train-split size (loader profiling wants "
                        "epochs long enough to measure steady state)")
    p.add_argument("--synthetic_val_records", type=int, default=8,
                   help="synthetic size of every other split (the loaders drop a "
                        "last partial batch, so validation needs at least one batch)")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--answer_max_size", type=int, default=-1)
    p.add_argument("--answer_min_freq", type=int, default=1)
    p.add_argument("--question_len", type=int, default=80)
    p.add_argument("--answer_len", type=int, default=16)
    p.add_argument("--use_unanswerable", action="store_true")
    p.add_argument("--num_workers", type=int, default=4,
                   help="worker processes per loader (>1 switches the dataset "
                        "to per-sample rng, the torch DataLoader worker idiom)")


def resolve_device(name: str) -> torch.device:
    """The device a driver runs on; a CUDA device needs a card."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA card here (pass --device cpu to run on "
                           "the CPU)")
    return device


def input_feature_dim(args) -> int:
    return (3 * args.use_color + 1 * args.use_height + 3 * args.use_normal
            + 128 * args.use_multiview)


def build_model_config(args, num_answers: int) -> BridgeQAConfig:
    if getattr(args, "tiny", False):
        med = MedConfig(vocab_size=200, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=128,
                        max_position_embeddings=128, encoder_width=64)
        blip = BlipVQA3DConfig(med=med, image_size=64, num_answers=num_answers,
                               vit="custom", vit_custom_embed_dim=64, vit_custom_depth=2,
                               vit_custom_heads=4, vit_drop_path_rate=0.0,
                               bos_token_id=110, share_decoder=args.share_decoder,
                               scene_feature_position=args.scene_feature_position)
        return BridgeQAConfig(
            num_answers=num_answers, num_proposal=32, hidden_size=32, blip=blip,
            mcan_num_layers=1, mcan_flat_out_size=64, mcan_flat_mlp_size=32,
            input_feature_dim=input_feature_dim(args),
            use_reference=not args.no_reference, use_lang_cls=not args.no_lang_cls,
            use_answer=not args.no_answer, use_blip=not args.no_blip, stage=args.stage,
        )
    blip = BlipVQA3DConfig(image_size=args.image_size, num_answers=num_answers,
                           share_decoder=args.share_decoder,
                           scene_feature_position=args.scene_feature_position,
                           remat=getattr(args, "remat", False),
                           remat_mode=getattr(args, "remat_mode", "block"))
    return BridgeQAConfig(
        num_answers=num_answers,
        num_proposal=args.num_proposal,
        seed_feat_dim=args.seed_feat_dim,
        proposal_size=args.proposal_size,
        hidden_size=args.hidden_size,
        input_feature_dim=input_feature_dim(args),
        use_reference=not args.no_reference,
        use_lang_cls=not args.no_lang_cls,
        use_answer=not args.no_answer,
        use_blip=not args.no_blip,
        stage=args.stage,
        blip=blip,
    )


def build_model(args, num_answers: int, device: torch.device, *, seed: int | None = None):
    """(model, cfg, dataset config): ``BridgeQA`` on ``device`` in eval
    mode, its weights drawn from ``seed`` (left as built when None: the
    caller loads them), computing in bf16 under ``--bf16``."""
    if args.no_blip and args.stage != "DET":
        # the MCAN model reads lang_feat (GloVe vectors of the question's
        # words, ``ScanQADataset(glove=...)``); the JAX drivers pass the
        # dataset no such table either, and their run fails at its first
        # batch (ROADMAP C3)
        raise ValueError("--no_blip at the VQA stage builds the MCAN model, which reads "
                         "lang_feat (GloVe vectors of the question words): the drivers have no "
                         "lang_feat source (no GloVe table reaches the dataset)")
    dc = ScannetDatasetConfig()
    cfg = build_model_config(args, num_answers)
    model = BridgeQA(cfg, mean_size_arr=dc.mean_size_arr, device=device)
    if seed is not None:
        init_weights(model, torch.Generator(device=device).manual_seed(seed))
    if getattr(args, "bf16", False):
        set_compute_dtype(model, torch.bfloat16)
    return model, cfg, dc


# --- record loading -----------------------------------------------------

def load_scanqa_records(data_root: str, split: str, dataset: str = "scanqa"):
    """QA record loading. ScanQA: ``ScanQA_v1.0_<split>.json``; SQA3D uses
    the ScanQA-converted jsons (``SQA_train_scanqa.json`` / ``SQA_val.json``
    / ``SQA_test.json``, reference ``utils/blip_utils.py:11-14``). SQA
    records carrying a separate ``situation`` field get it prepended to the
    question (the converted files ship them pre-merged)."""
    if dataset == "sqa":
        name = "SQA_train_scanqa.json" if split == "train" else f"SQA_{split}.json"
    else:
        name = f"ScanQA_v1.0_{split}.json"
    with open(os.path.join(data_root, "qa", name)) as f:
        records = json.load(f)
    for rec in records:
        if rec.get("situation") and rec["situation"] not in rec["question"]:
            rec["question"] = f"{rec['situation']} {rec['question']}"
    return records


def build_datasets(args, *, splits=("train", "val")):
    """Returns (datasets dict, tokenizer, answer_cands, answer_counter)."""
    if args.synthetic or not args.data_root:
        tokenizer = synthetic_tokenizer()
        num_scenes = 4
        scene_data = synthetic_scene_data(num_scenes, num_points=max(args.num_points, 2048))
        records = {s: synthetic_records(
            getattr(args, "synthetic_records", 32) if s == "train"
            else getattr(args, "synthetic_val_records", 8), num_scenes)
            for s in splits}
    else:
        tokenizer = WordPieceTokenizer.from_vocab_file(os.path.join(args.data_root, "vocab.txt"))
        scene_data = make_scene_loader(args.data_root)
        records = {s: load_scanqa_records(args.data_root, s, getattr(args, "dataset", "scanqa")) for s in splits}

    train_recs = records.get("train", [])
    val_recs = records.get("val", records.get(splits[0], []))
    answer_cands, answer_counter = build_answer_vocab(
        train_recs, val_recs, args.answer_max_size, args.answer_min_freq)

    view_lookup = None
    if not args.no_blip:
        if args.synthetic or not args.data_root:
            img_size = 64 if getattr(args, "tiny", False) else args.image_size
            view_lookup = synthetic_view_lookup(img_size)
        elif args.i2tfile:
            from bridgeqa_tpu_torch.data.views import SceneViewsPool, load_scene_view_map, make_view_lookup

            pool = SceneViewsPool(os.path.join(args.data_root, "frames_square"),
                                  image_size=args.image_size)
            view_lookup = make_view_lookup(pool, load_scene_view_map(args.i2tfile))

    multiview_lookup = None
    if args.use_multiview:
        if getattr(args, "multiview_root", None):
            multiview_lookup = MultiviewFiles(args.multiview_root)
        else:  # synthetic: random 128-d per-point features
            sizes = {} if callable(scene_data) else {
                k: v["mesh_vertices"].shape[0] for k, v in scene_data.items()}
            multiview_lookup = SyntheticMultiview(sizes)

    datasets = {}
    for s in splits:
        datasets[s] = ScanQADataset(
            records[s], scene_data,
            answer_cands=answer_cands, answer_counter=answer_counter,
            split=s, num_points=args.num_points,
            use_color=args.use_color, use_height=args.use_height,
            use_normal=args.use_normal, use_multiview=args.use_multiview,
            multiview_lookup=multiview_lookup,
            augment=(s == "train"), use_unanswerable=args.use_unanswerable or s != "train",
            tokenizer=tokenizer, question_len=args.question_len, answer_len=args.answer_len,
            view_lookup=view_lookup,
            rng_mode="per_sample" if getattr(args, "num_workers", 1) > 1 else "stream",
        )
    return datasets, tokenizer, answer_cands, answer_counter


def make_loader(dataset, args, *, shuffle, seed=0, num_shards=1, shard_index=0):
    return BatchIterator(dataset, args.batch_size, shuffle=shuffle, seed=seed,
                         num_shards=num_shards, shard_index=shard_index,
                         num_workers=getattr(args, "num_workers", 1))


def args_to_dict(args):
    return {k: v for k, v in vars(args).items() if not k.startswith("_")}
