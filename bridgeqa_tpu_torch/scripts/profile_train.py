"""Train-step phase profiler: where the training milliseconds go
(counterpart of ``scripts/profile_train.py``).

The reference's training loop (``lib/solver.py:398-411``) is forward ->
loss -> backward -> optimizer on one CUDA stream; its published profile is
the per-phase ``fetch/forward/backward/eval`` means it logs every
``verbose`` iterations (``lib/solver.py:466-503``). Here each phase of the
train step runs on its own, ``REPS`` times over inputs that differ per rep
(the points, images or states shifted by 1e-3 a rep, as the JAX script's
perturbed scans), between two CUDA events after one warm-up rep; plus the
analytic MFU of the product-bound phases against the card's bf16 peak (989
TFLOP/s, NVIDIA's H100 SXM data sheet), from the JAX script's FLOP formulas.
The model computes in bf16 over f32 parameters with remat, as training runs.

On the card:      python -m bridgeqa_tpu_torch.scripts.profile_train [--batch 16]
CPU plumbing:     python -m bridgeqa_tpu_torch.scripts.profile_train --smoke --device cpu

On the CPU the times are the host clock's and no MFU is given (the card's
peak does not apply). Prints one JSON object per line (phase, ms, mfu where
it applies), then a summary line. Phases:

  full        the whole train step (forward, every loss, backward, grouped AdamW)
  fwd         forward and losses only (no grad); backward = full - fwd - opt
  detector    d(sum of the detector's outputs)/d(params) at 40k points
  vit         d(sum of the ViT-B/480 embeddings)/d(params)
  twin        d(sum of the twin question encoding)/d(params), fixed image embeddings
  decoders    d(2D + 3D LM loss)/d(params), fixed question states
  opt         the grouped AdamW update alone, on prebuilt gradients
"""

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

REPS = 4

# H100 SXM dense bf16 peak (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
PHASES = ("full", "fwd", "detector", "vit", "twin", "decoders", "opt")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=16,
                    help="train batch (reference scripts/train.py:47 default 16)")
    ap.add_argument("--smoke", action="store_true", help="tiny plumbing check")
    ap.add_argument("--num_points", type=int, default=40000)
    ap.add_argument("--image_size", type=int, default=480)
    ap.add_argument("--device", type=str, default="cuda")
    return ap.parse_args(argv)


def timed(device, run, xs) -> float:
    """Seconds per rep of ``run(x)`` over the reps' inputs ``xs``, after one
    warm-up rep: CUDA events on the card, the host clock on the CPU."""
    run(xs[0])
    if device.type != "cuda":
        t0 = time.perf_counter()
        for x in xs:
            run(x)
        return (time.perf_counter() - t0) / len(xs)
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for x in xs:
        run(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / len(xs)


def main(argv=None):
    args = parse_args(argv)

    from bridgeqa_tpu_torch.data.scannet_config import ScannetDatasetConfig
    from bridgeqa_tpu_torch.losses import get_loss
    from bridgeqa_tpu_torch.models.blip_vqa3d import BlipVQA3DConfig
    from bridgeqa_tpu_torch.models.bridgeqa import BridgeQA, BridgeQAConfig
    from bridgeqa_tpu_torch.models.layers import init_weights, set_compute_dtype
    from bridgeqa_tpu_torch.models.med import IGNORE_INDEX, MedConfig
    from bridgeqa_tpu_torch.scripts import common
    from bridgeqa_tpu_torch.train.optim import OptimConfig, build_optimizer
    from bridgeqa_tpu_torch.train.step import train_step

    device = common.resolve_device(args.device)
    B = args.batch
    NUM_POINTS, IMAGE_SIZE = args.num_points, args.image_size
    QUESTION_LEN, ANSWER_LEN = 80, 12
    NUM_ANSWERS = 4500
    H, FF, LAYERS, VOCAB = 768, 3072, 12, 30524

    dc = ScannetDatasetConfig()
    if args.smoke:
        B, NUM_POINTS, IMAGE_SIZE = 2, 1024, 64
        QUESTION_LEN, ANSWER_LEN, NUM_ANSWERS = 20, 6, 30
        H, FF, LAYERS, VOCAB = 64, 128, 2, 200
        med = MedConfig(vocab_size=VOCAB, hidden_size=H, num_hidden_layers=LAYERS,
                        num_attention_heads=4, intermediate_size=FF,
                        max_position_embeddings=128, encoder_width=H)
        blip = BlipVQA3DConfig(med=med, image_size=IMAGE_SIZE, num_answers=NUM_ANSWERS,
                               vit="custom", vit_custom_embed_dim=H, vit_custom_depth=2,
                               vit_custom_heads=4, vit_drop_path_rate=0.0, bos_token_id=110)
        # and a scaled-down backbone (verify_parity's --tiny_backbone): the
        # plumbing check's CPU time is the full-width detector's
        cfg = BridgeQAConfig(num_answers=NUM_ANSWERS, num_proposal=32, hidden_size=32,
                             blip=blip, mcan_num_layers=1, mcan_flat_out_size=64,
                             mcan_flat_mlp_size=32, input_feature_dim=1,
                             backbone_sa_npoints=(128, 64, 32, 16),
                             backbone_sa_nsamples=(8, 8, 8, 8))
        vit_depth, vit_width, vit_tokens = 2, H, (IMAGE_SIZE // 16) ** 2 + 1
    else:
        cfg = BridgeQAConfig(num_answers=NUM_ANSWERS, input_feature_dim=1)
        vit_depth, vit_width, vit_tokens = 12, 768, (IMAGE_SIZE // 16) ** 2 + 1

    # production training runs under remat, as the reference (fairscale
    # checkpoint_wrapper around the ViT blocks, models/vit.py:103-105); the
    # fused ViT and scoring kernels run only without grad, so every grad
    # phase takes the module path, as the train step does
    cfg = dataclasses.replace(cfg, blip=dataclasses.replace(cfg.blip, remat=True))
    model = BridgeQA(cfg, mean_size_arr=dc.mean_size_arr, device=device)
    init_weights(model, torch.Generator(device=device).manual_seed(0))
    set_compute_dtype(model, torch.bfloat16)
    blip_model = model.blip_model
    vmax = min(30000, cfg.blip.med.vocab_size - 2)

    rng = np.random.RandomState(0)
    pc = (rng.rand(B, NUM_POINTS, 3) - 0.5) * 6.0
    height = pc[..., 2:3] - pc[..., 2:3].min(axis=1, keepdims=True)
    max_obj = 8
    f, i = np.float32, np.int32
    arrays = dict(
        point_clouds=np.concatenate([pc, height], axis=-1).astype(f),
        images=rng.rand(B, IMAGE_SIZE, IMAGE_SIZE, 3).astype(f),
        question_ids=rng.randint(1, vmax, (B, QUESTION_LEN)).astype(i),
        question_mask=np.ones((B, QUESTION_LEN), i),
        answer_ids=rng.randint(1, vmax, (B, ANSWER_LEN)).astype(i),
        answer_mask=np.ones((B, ANSWER_LEN), i),
        answer_cat=rng.randint(0, NUM_ANSWERS, (B,)).astype(i),
        answer_cat_scores=rng.rand(B, NUM_ANSWERS).astype(f),
        vote_label=(rng.randn(B, NUM_POINTS, 9) * 0.1).astype(f),
        vote_label_mask=rng.randint(0, 2, (B, NUM_POINTS)).astype(f),
        center_label=rng.randn(B, max_obj, 3).astype(f),
        box_label_mask=np.ones((B, max_obj), f),
        sem_cls_label=rng.randint(0, 18, (B, max_obj)).astype(i),
        size_class_label=rng.randint(0, 18, (B, max_obj)).astype(i),
        size_residual_label=(rng.randn(B, max_obj, 3) * 0.1).astype(f),
        heading_class_label=np.zeros((B, max_obj), i),
        heading_residual_label=np.zeros((B, max_obj), f),
        ref_center_label=rng.randn(B, 3).astype(f),
        ref_heading_class_label=np.zeros((B,), i),
        ref_heading_residual_label=np.zeros((B,), f),
        ref_size_class_label=rng.randint(0, 18, (B,)).astype(i),
        ref_size_residual_label=(rng.randn(B, 3) * 0.1).astype(f),
        ref_obj_mask=np.ones((B,), i),
        object_cat=rng.randint(0, 18, (B,)).astype(i),
    )
    batch = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    optimizer = build_optimizer(model, OptimConfig())
    gen = torch.Generator(device=device).manual_seed(1)

    # the reps' inputs, each shifted by 1e-3 a rep
    pcs = [batch["point_clouds"] + 1e-3 * (k + 1) for k in range(REPS)]
    imgs = [batch["images"] + 1e-3 * (k + 1) for k in range(REPS)]
    results = {}

    def step(pc_k):
        train_step(model, optimizer, dict(batch, point_clouds=pc_k), bn_momentum=0.1,
                   generator=gen)

    results["full"] = timed(device, step, pcs)

    def fwd_only(pc_k):
        model.train()
        b = dict(batch, point_clouds=pc_k)
        with torch.no_grad():
            out = model(b, inference="loss", bn_momentum=0.1, generator=gen)
            ep = dict(b)
            ep.update(out)
            get_loss(ep, dc, detection=True, use_reference=True, use_lang_classifier=True,
                     use_answer=True)

    results["fwd"] = timed(device, fwd_only, pcs)
    model.eval()

    def grad_of(fn):
        """Run ``fn``'s scalar backward into every parameter it reaches."""
        def run(x):
            model.zero_grad(set_to_none=True)
            fn(x).backward()
        return run

    def detector_sum(pc_k):
        out = model.detector(pc_k)
        return sum(v.float().sum() for v in out.values()
                   if torch.is_tensor(v) and v.is_floating_point())

    results["detector"] = timed(device, grad_of(detector_sum), pcs)
    results["vit"] = timed(device, grad_of(lambda im: blip_model.encode_image(im).float().sum()),
                           imgs)

    n_obj = cfg.num_proposal
    img_embeds = torch.from_numpy(rng.randn(B, vit_tokens, vit_width).astype(f) * 0.3).to(device)
    # detector-width object features; encode_question's scene-object adapter
    # (linear_scene_object) maps cfg.hidden_size -> the BERT width itself
    obj_embeds = torch.from_numpy(rng.randn(B, n_obj, cfg.hidden_size).astype(f) * 0.3).to(device)
    obj_mask = torch.ones((B, n_obj), dtype=torch.int32, device=device)
    ie_stack = [(img_embeds + 1e-3 * k).to(torch.bfloat16) for k in range(REPS)]

    def twin_sum(ie):
        h2d, h3d = blip_model.encode_question(ie, batch["question_ids"], batch["question_mask"],
                                              obj_embeds, obj_mask)
        return h2d.float().sum() + h3d.float().sum()

    results["twin"] = timed(device, grad_of(twin_sum), ie_stack)

    h_model = cfg.blip.med.hidden_size
    qs_stack = [torch.from_numpy(rng.randn(B, QUESTION_LEN, h_model).astype(f) * 0.5).to(device)
                for _ in range(REPS)]
    targets = torch.where(batch["answer_ids"] == cfg.blip.pad_token_id, IGNORE_INDEX,
                          batch["answer_ids"])

    def decoders_loss(qs):
        _, l2 = blip_model.text_decoder(batch["answer_ids"], batch["answer_mask"], qs,
                                        batch["question_mask"], labels=targets)
        _, l3 = blip_model._decoder_scene()(batch["answer_ids"], batch["answer_mask"], qs,
                                            batch["question_mask"], labels=targets,
                                            layernorm_idx=blip_model._scene_layernorm_idx())
        return (l2.sum() + l3.sum()).float() / B

    results["decoders"] = timed(device, grad_of(decoders_loss), qs_stack)

    # the optimizer alone: one gradient a parameter, scaled per rep
    grads = {p: torch.full_like(p, 1e-4) for p in model.parameters()}

    def opt_step(scale):
        for p, g in grads.items():
            p.grad = g * scale
        optimizer.step()

    results["opt"] = timed(device, opt_step, [1 + 0.1 * k for k in range(REPS)])

    # ---- analytic MFU of the product phases (fwd + bwd = 3x fwd FLOPs) ----
    t = vit_tokens
    vit_fwd_flops = B * vit_depth * (t * (4 * vit_width**2 + 2 * vit_width * (4 * vit_width)) * 2
                                     + 2 * t * t * vit_width * 2)
    twin_keys_2d, twin_keys_3d = vit_tokens, n_obj
    twin_fwd_flops = B * LAYERS * QUESTION_LEN * 2 * (
        # two streams: self QKV+out + cross q+out + FFN pair
        2 * (4 * H * H + 2 * H * H + 2 * H * FF)
    ) + B * LAYERS * 2 * 2 * (
        # cross K/V projections over [keys] + attention scores/ctx
        (twin_keys_2d + twin_keys_3d) * 2 * H * H
        + QUESTION_LEN * (twin_keys_2d + twin_keys_3d) * H * 2
        + QUESTION_LEN * QUESTION_LEN * H * 2
    )
    dec_rows = B * ANSWER_LEN
    dec_fwd_flops = 2 * (LAYERS * dec_rows * (
        4 * H * H * 2 + 2 * H * H * 2 + 2 * H * FF * 2
        + 2 * ANSWER_LEN * H * 2 + 2 * QUESTION_LEN * H * 2)
        + B * LAYERS * QUESTION_LEN * 2 * H * H * 2  # cross K/V over question
        + dec_rows * (H * H + H * VOCAB) * 2)
    fwd_flops = {"vit": vit_fwd_flops, "twin": twin_fwd_flops, "decoders": dec_fwd_flops}

    for phase in PHASES:
        row = {"phase": phase, "ms": results[phase] * 1e3}
        if phase in fwd_flops:
            row["mfu"] = (3 * fwd_flops[phase] / results[phase] / PEAK_BF16_FLOPS
                          if device.type == "cuda" else None)
        print(json.dumps(row))

    bwd_glue = results["full"] - results["fwd"] - results["opt"]
    component_sum = (results["detector"] + results["vit"] + results["twin"]
                     + results["decoders"] + results["opt"])
    summary = {
        "batch": B,
        "train_samples_per_sec": B / results["full"],
        "bwd_plus_glue_ms": bwd_glue * 1e3,
        "component_grad_sum_ms": component_sum * 1e3,
        "full_ms": results["full"] * 1e3,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
        "note": "component grads each re-run their own forward, so their sum overcounts vs "
                "full (which shares one forward); mfu = 3x analytic fwd GEMM FLOPs / time vs "
                "989 TFLOP/s bf16 peak; on the CPU host-clock times and no mfu",
    }
    print(json.dumps({"summary": summary, "smoke": bool(args.smoke) or None}))
    return results


if __name__ == "__main__":
    main()
