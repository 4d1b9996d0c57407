#!/usr/bin/env python3
"""Drive the PyTorch port (``bridgeqa_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before a
result is printed):

1. device: a CUDA card is required (there is no CPU path); print its name
   and ``nvidia-smi``'s name and power limit; the port imports no JAX.
2. build: compile every ``bridgeqa_tpu_torch/csrc/*.cu`` for sm_90a.
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at every shape the main path gives it, batch 8, with padding
   points, duplicate points, empty balls and clouds whose length is no
   multiple of the stripe quantum. Both must agree bitwise; median times of
   both are printed.
4. reference: a tiny rank forward on the card (kernels, f32) against the
   same weights on the CPU (plain versions, f32).
5. main path: full-width rank inference (``BridgeQAConfig(num_answers=4500,
   input_feature_dim=1)``: 40k-point scenes, ViT-B/16 at 480 px, 12-layer
   twin encoder and decoders, k_test 256) at batch 8 in bf16, random
   weights from a seed. Launch counts are zeroed just before the forward
   and read just after; outputs must be finite and well formed.

Matrix products run in full f32 where f32 is used: TF32 is switched off
for both cuBLAS and cuDNN, and the patch embedding is a matrix product.
The last two lines are a ``{"kernels": [...]}`` JSON object and
``{"ok": true, "device": {...}}``.
"""

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 8
NUM_POINTS = 40000
IMAGE_SIZE = 480
QUESTION_LEN = 80
ANSWER_LEN = 12
NUM_ANSWERS = 4500
K_TEST = 256

# (name, points in, points out) for each FPS call of the main path
FPS_SHAPES = [("sa1", NUM_POINTS, 2048), ("sa2", 2048, 1024), ("sa3", 1024, 512),
              ("sa4", 512, 256), ("votes", 1024, 256)]
# (name, points, centres, nsample, radius, feature channels) for each ball query
BQ_SHAPES = [("sa1", NUM_POINTS, 2048, 64, 0.2, 1), ("sa2", 2048, 1024, 32, 0.4, 0),
             ("sa3", 1024, 512, 16, 0.8, 0), ("sa4", 512, 256, 16, 1.2, 0),
             ("votes", 1024, 256, 16, 0.3, 0)]


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs after one warm-up,
    each run between two CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def make_cloud(rng: np.random.RandomState, b: int, n: int) -> np.ndarray:
    """Scene-sized cloud (6 m cube) with padding points and duplicates."""
    xyz = ((rng.rand(b, n, 3) - 0.5) * 6.0).astype(np.float32)
    xyz[:, n - n // 50:] = 0.0  # trailing padding, |p|^2 <= 1e-3
    xyz[:, 7:n // 40:3] = 0.0  # scattered padding
    dup = n // 20
    xyz[:, dup:2 * dup] = xyz[:, :dup]  # exact duplicates
    return xyz


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels run only on the card")
    import bridgeqa_tpu_torch.models.bridgeqa  # noqa: F401  (fails outside the repository)

    if "jax" in sys.modules:
        raise RuntimeError("the port imported jax")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(smi.splitlines()[0])
    return torch.device("cuda", 0)


def phase_build():
    from bridgeqa_tpu_torch.ops import cuda_lib

    cuda_lib.lib()
    log(f"build: {cuda_lib.build_seconds:.1f} s")
    for line in cuda_lib.build_log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            log(f"  {line.strip()}")


def phase_kernels(device, batch: int = BATCH, fps_shapes=FPS_SHAPES, bq_shapes=BQ_SHAPES,
                  reps: int = 5):
    """Each kernel against its plain version; returns the per-kernel
    records of the kernels line (without launch counts)."""
    from bridgeqa_tpu_torch.ops import grouping, sampling

    rng = np.random.RandomState(1)
    fps_rows, bq_rows = [], []
    for name, n, npoint in fps_shapes:
        xyz = torch.from_numpy(make_cloud(rng, batch, n)).to(device)
        idx, coords = sampling.furthest_point_sample_with_xyz(xyz, npoint)
        pidx, pcoords = sampling.fps_plain(xyz, npoint)
        torch.cuda.synchronize()
        same = torch.equal(idx, pidx) and torch.equal(coords, pcoords)
        err = float((coords - pcoords).abs().max())
        ms = time_ms(lambda: sampling.furthest_point_sample_with_xyz(xyz, npoint), reps)
        plain_ms = time_ms(lambda: sampling.fps_plain(xyz, npoint), max(1, reps // 2))
        fps_rows.append(dict(shape=f"{name}: ({batch}, {n}, 3) -> {npoint}", bitwise=same,
                             max_abs_err=err, ms=ms, plain_ms=plain_ms))
        log(f"fps {name}: ({batch}, {n}) -> {npoint}: bitwise {same}, kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms")
    for name, n, m, ns, radius, nf in bq_shapes:
        xyz_np = make_cloud(rng, batch, n)
        centres = xyz_np[:, rng.permutation(n)[:m]].copy()
        centres[:, :4] += 100.0  # empty balls
        xyz = torch.from_numpy(xyz_np).to(device)
        ctr = torch.from_numpy(centres).to(device)
        feats = torch.from_numpy(rng.rand(batch, n, nf).astype(np.float32)).to(device) if nf else None
        out = grouping.ball_query_stripes(radius, ns, xyz, ctr, feats)
        ref = grouping.ball_query_stripes_plain(radius, ns, xyz, ctr, feats)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) if a is not None else b is None for a, b in zip(out, ref))
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(out, ref) if a is not None)
        empty = bool((out[0][:, :4] == 0).all())
        ms = time_ms(lambda: grouping.ball_query_stripes(radius, ns, xyz, ctr, feats), reps)
        plain_ms = time_ms(lambda: grouping.ball_query_stripes_plain(radius, ns, xyz, ctr, feats),
                           max(1, reps // 2))
        picks, np_padded = grouping.stripe_plan(n, ns)
        bq_rows.append(dict(shape=f"{name}: N={n} padded to {np_padded}, {picks} pick(s), "
                                  f"M={m}, nsample={ns}, r={radius}, nf={nf}, batch {batch}",
                            bitwise=same and empty, max_abs_err=err, ms=ms, plain_ms=plain_ms))
        log(f"ball query {name}: N={n} (padded {np_padded}, {picks} pick(s)), M={m}, ns={ns}, "
            f"r={radius}, nf={nf}: bitwise {same}, empty balls {empty}, kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms")
    bad = [r for r in fps_rows + bq_rows if not r["bitwise"]]
    if bad:
        raise AssertionError(f"kernel and plain version disagree: {bad}")
    return [
        dict(name="fps", route="cuda", source="bridgeqa_tpu_torch/csrc/fps.cu",
             replaces="bridgeqa_tpu/ops/sampling.py:70", rows=fps_rows),
        dict(name="ball_query_stripes", route="cuda",
             source="bridgeqa_tpu_torch/csrc/ball_query_stripes.cu",
             replaces="bridgeqa_tpu/ops/grouping.py:194", rows=bq_rows),
    ]


def make_batch(cfg, batch: int, num_points: int, image_size: int, question_len: int,
               answer_len: int, device, seed: int = 0):
    """Synthetic inputs as ``bench.py`` builds them: a uniform 6 m scene
    with a height channel, a random image, random question tokens and an
    answer table of bos + random tokens."""
    rng = np.random.RandomState(seed)
    bos = cfg.blip.bos_token_id
    vmax = min(30000, cfg.blip.med.vocab_size - 2)
    num_answers = cfg.num_answers
    pc = (rng.rand(batch, num_points, 3) - 0.5) * 6.0
    height = pc[..., 2:3] - pc[..., 2:3].min(axis=1, keepdims=True)
    answers = np.concatenate([np.full((num_answers, 1), bos),
                              rng.randint(1, vmax, (num_answers, answer_len - 1))], axis=1)
    arrays = dict(
        point_clouds=np.concatenate([pc, height], axis=-1).astype(np.float32),
        images=rng.rand(batch, image_size, image_size, 3).astype(np.float32),
        question_ids=rng.randint(1, vmax, (batch, question_len)),
        question_mask=np.ones((batch, question_len), np.int32),
        answer_list_ids=answers,
        answer_list_mask=np.ones((num_answers, answer_len), np.int32),
    )
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def build_model(cfg, device, seed: int = 0):
    from bridgeqa_tpu_torch.models.bridgeqa import BridgeQA
    from bridgeqa_tpu_torch.models.layers import init_weights

    with torch.device(device):
        model = BridgeQA(cfg)  # ScanNet's size clusters
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_weights(model, gen).eval()


def tiny_config():
    from bridgeqa_tpu_torch.models.blip_vqa3d import BlipVQA3DConfig
    from bridgeqa_tpu_torch.models.bridgeqa import BridgeQAConfig
    from bridgeqa_tpu_torch.models.med import MedConfig

    med = MedConfig(vocab_size=200, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                    intermediate_size=128, max_position_embeddings=128, encoder_width=64)
    blip = BlipVQA3DConfig(med=med, image_size=64, num_answers=30, vit="custom",
                           vit_custom_embed_dim=64, vit_custom_depth=2, vit_custom_heads=4,
                           bos_token_id=110)
    return BridgeQAConfig(num_answers=30, num_proposal=32, hidden_size=32, blip=blip,
                          mcan_num_layers=1, input_feature_dim=1)


def phase_reference(device):
    """A tiny rank forward through the kernels on the card against the
    plain versions on the CPU, same weights, f32. Every answer is scored
    (k_test = the list length), so no top-k tie can split the two runs.
    Tolerance 1e-3: the two devices sum matrix products in another order."""
    cfg = tiny_config()
    cpu_model = build_model(cfg, torch.device("cpu"), seed=3)
    card_model = copy.deepcopy(cpu_model).to(device)
    batch = make_batch(cfg, 2, 4096, 64, 20, 6, torch.device("cpu"), seed=4)
    with torch.inference_mode():
        want = cpu_model(batch, k_test=cfg.num_answers)
        got = card_model({k: v.to(device) for k, v in batch.items()}, k_test=cfg.num_answers)
    for key in ("sa1_inds", "sa2_inds", "fp2_inds"):
        if not torch.equal(got[key].cpu(), want[key]):
            raise AssertionError(f"reference: {key} differs between the card and the CPU")
    worst = {}
    for key in ("answer_scores_2d", "answer_scores_scene", "lang_scores", "cluster_ref",
                "aggregated_vote_xyz", "center"):
        err = float((got[key].cpu().float() - want[key].float()).abs().max())
        worst[key] = err
        if not err <= 1e-3:
            raise AssertionError(f"reference: {key} differs by {err}")
    log(f"reference (tiny config, f32, card vs CPU): max abs err {json.dumps(worst)}")


def phase_main_path(device, reps: int = 3):
    from bridgeqa_tpu_torch.models.bridgeqa import BridgeQAConfig
    from bridgeqa_tpu_torch.models.layers import set_compute_dtype
    from bridgeqa_tpu_torch.ops import grouping, sampling

    cfg = BridgeQAConfig(num_answers=NUM_ANSWERS, input_feature_dim=1)
    t0 = time.perf_counter()
    model = set_compute_dtype(build_model(cfg, device), torch.bfloat16)
    batch = make_batch(cfg, BATCH, NUM_POINTS, IMAGE_SIZE, QUESTION_LEN, ANSWER_LEN, device)
    torch.cuda.synchronize()
    log(f"main path: model built and weights drawn in {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters")

    with torch.inference_mode():
        sampling.launches = 0
        grouping.launches = 0
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        out = model(batch, inference="rank", k_test=K_TEST)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = {"fps": sampling.launches, "ball_query_stripes": grouping.launches}
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9

        scores = out["answer_scores"]
        checks = {
            "answer_scores shape": tuple(scores.shape) == (BATCH, NUM_ANSWERS),
            "cluster_ref shape": tuple(out["cluster_ref"].shape) == (BATCH, cfg.num_proposal),
            "lang_scores shape": tuple(out["lang_scores"].shape) == (BATCH, cfg.num_object_class),
            "finite": all(bool(torch.isfinite(out[k].float()).all())
                          for k in ("answer_scores", "answer_scores_2d", "answer_scores_scene",
                                    "cluster_ref", "lang_scores", "bbox_corner")),
            "k_test answers scored per row": all(
                bool(((out[k] != -1e4).sum(dim=1) == K_TEST).all())
                for k in ("answer_scores_2d", "answer_scores_scene")),
            "log-prob sums < 0": all(bool((out[k][out[k] != -1e4] < 0).all())
                                     for k in ("answer_scores_2d", "answer_scores_scene")),
            "5 FPS launches": launches["fps"] == 5,
            "5 ball-query launches": launches["ball_query_stripes"] == 5,
        }
        log(f"main path: first forward {first_s:.3f} s, peak memory {peak_gb:.2f} GB, "
            f"launches {json.dumps(launches)}")
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"main path checks failed: {failed}")

        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(batch, inference="rank", k_test=K_TEST)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    latency = statistics.median(times)
    log(f"main path: rank forward at batch {BATCH}, bf16: median {latency * 1e3:.1f} ms over "
        f"{reps} runs ({', '.join(f'{t * 1e3:.1f}' for t in times)}), "
        f"{BATCH / latency:.2f} QA pairs/s")
    return launches


def main() -> int:
    device = phase_device()
    phase_build()
    kernels = phase_kernels(device)
    phase_reference(device)
    launches = phase_main_path(device)
    records = []
    for k in kernels:
        rows = k.pop("rows")
        records.append(dict(k, launches=launches[k["name"]],
                            max_abs_err=max(r["max_abs_err"] for r in rows),
                            bitwise=all(r["bitwise"] for r in rows),
                            ms=sum(r["ms"] for r in rows), plain_ms=sum(r["plain_ms"] for r in rows),
                            shapes=rows))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
