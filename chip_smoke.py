#!/usr/bin/env python3
"""Drive the PyTorch port (``bridgeqa_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before a
result is printed):

1. device: a CUDA card is required (there is no CPU path); print its name
   and ``nvidia-smi``'s name and power limit; the port imports nothing of
   JAX and nothing of the JAX package (``bridgeqa_tpu``).
2. build: compile every ``bridgeqa_tpu_torch/csrc/*.cu`` for sm_90a; print
   ptxas's register, spill and shared-memory lines for the redesigned
   kernels (the bf16 GEMM, the ViT attention, FPS's cluster kernel, the
   vocabulary pass, the scoring attentions' pipeline, the ball query and its
   backward);
   disassemble the library (``cuobjdump -sass``) and fail unless every
   instantiation of the bf16 GEMM and the vocabulary pass's bf16 kernel
   hold ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA loads), and every
   instantiation of the scoring attentions' pipeline ``UTMALDG``.
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at every shape the main path gives it, batch 8.
   - FPS and the stripe ball query, with padding points, duplicate points,
     empty balls and clouds whose length is no multiple of the stripe
     quantum: both must agree bitwise. FPS's rows also give the cluster size
     its launch took, the clusters of that size the card holds at once, the
     us per selection, the kernel's time at every cluster size, and loops of
     bare cluster barriers at SA1's clusters of every size (the floor of one
     selection).
   - The scoring kernels (GEMM at the layer's six shapes, self and cross
     attention, residual + LayerNorm, the vocabulary reductions at
     22528 x 30524) in bf16, and their f32 instantiations. f32: max abs
     error <= 1e-3 (both sides accumulate in f32, in another order). bf16
     outputs: <= 2^-6 of the largest output, about two steps of bf16 (both
     round once from f32, and a sum in another order can flip a rounding).
     Biases and LayerNorm scale and shift are drawn well away from 0 and
     (1, 0), so a kernel that drops one fails. The vocabulary reductions
     come out in f32 from exact products: each output (lse, sum of logits,
     target logit) within 1e-3 of its own largest value, and its TFLOP/s;
     also at 1000 rows and a 203-word vocabulary, mostly padding in its last
     tile. Then a
     whole 12-layer decoder pass and its loss, kernels against plain
     versions in bf16, every bias and LayerNorm parameter perturbed:
     per-sequence losses within 1% relative (rounding points match,
     summation order does not).
   - The ViT block's kernels at its shapes (8 images of 901 tokens): the
     GEMM's four products (the last with its residual epilogue), the
     attention over 901 tokens (``csrc/vit_attention.cu``), LayerNorm without
     a residual and keeping the sum (whose sum must be bitwise), with the
     tolerances above; the attention also within 1% relative L2 error for
     each image and head, and again at 833 tokens, whose last key tile is
     mostly padding. Then a whole 12-block ViT-B/16 with its final norm,
     kernels against plain versions in bf16, every bias and LayerNorm
     parameter perturbed: each image's relative L2 error within 1%.
   - The row gather (no path calls it), bitwise against ``torch.gather`` at
     the SA1 and SA2 grouping shapes, f32 and bf16.
   Kernel, plain version and, where one PyTorch call computes the same
   function, that call (``library_ms``; the port never calls it) are timed
   as loops of back-to-back calls between two CUDA events (ms per call,
   median of three loops), so the wrappers' host time overlaps the card's
   work instead of adding to it; each is printed with its bound (below).
   The LayerNorms, the smaller products, the scoring attentions and the
   ball query take the card about as long as, or less time than, their
   wrappers take the host, so the LayerNorm, GEMM, scoring-attention and
   ball-query rows' times, the library calls beside them included, are the
   card time of such a loop, read from ``torch.profiler`` (``device_ms``,
   which takes a trace again if it lacks a card record of some launch and
   counts such traces). The scoring-attention and ball-query rows carry
   the launch their C entry reports having made (kernel, grid, and the
   ring's depth and shared memory, or the centres a warp); the main path's
   attentions must have run the tensor-core pipeline. The ball query's log
   lines also give its bound in unfused f32 instructions (its source builds
   with ``-fmad=false``).
   The gather's wrapper waits for the card in its index check; its loop
   time is printed beside its card time. Then each GEMM
   shape's time over ``F.linear``'s and the per-forward sums, the ViT
   attention's and the scoring attentions' over SDPA's, and the host time
   per call of the GEMM's and the ViT attention's wrappers.
4. reference: a tiny rank forward on the card (kernels, f32) against the
   same weights on the CPU (plain versions, f32), hidden 128 and 2 heads so
   that the fused scoring path and the fused ViT run (``fused_scoring=
   "force"`` on both sides; ``vit_block.FUSED_MODE`` "force" on the CPU and
   "auto" on the card); the scoring and ViT kernels must launch on the card.
5. main path: full-width rank inference (``BridgeQAConfig(num_answers=4500,
   input_feature_dim=1)``: 40k-point scenes, ViT-B/16 at 480 px, 12-layer
   twin encoder and decoders, k_test 256) at batch 8 in bf16, random
   weights from a seed, ``fused_scoring="auto"`` and ``vit_block.FUSED_MODE
   = "auto"``. Launch counts are zeroed just before the forward and read
   just after, and must equal the counts derived from the config (the ViT's
   included); outputs must be finite and well formed. Stage times (CUDA
   events around each stage's modules, the ViT's among them, and the host's
   time to issue each stage) follow, then
   one forward under ``torch.profiler``: the card's busy share, the casts'
   launches and time (``aten::copy_``), and the table by kernel in
   ``build/profile_main_path.txt``.
6. generate: open-ended answers by KV-cached beam search,
   ``BridgeQA.forward(batch, inference="generate")``, 2 x 5 beams a
   question, answers of up to 20 tokens, the 2D decoder sharpened
   (``sharpen_decoder``: the LM head bias plus ``RandomState(1).randn(V) *
   4``, the attention's value and output kernels x10).
   - Tiny, card against CPU (``phase_generate_reference``): the tiny config
     in f32, the kernels on the card, the plain versions on the CPU: the ids
     equal; lang_scores, cluster_ref and the best beams' scores (from
     ``beam_search_cached`` called directly) within 1e-3; the detector and
     ViT kernels launched on the card, the scoring attentions and the
     vocabulary pass not.
   - Full width (``phase_generate``): the main path's config and inputs at
     batch 8 in bf16. Launch counts zeroed just before the forward and read
     just after must equal those derived from the config (FPS 5, ball query
     5, GEMM 48, ViT attention 12, LayerNorm 25, none of the scoring
     attentions or the vocabulary pass); the ids (8, 20), bos first, only
     pad after the first [SEP]; lang_scores and cluster_ref finite. KV-cache
     consistency: ``beam_search_cached`` called directly on the forward's
     encoded states gives the forward's ids as its best beams, and each of
     its 80 beams' score equals a teacher-forced full-prefix pass of the 2D
     decoder against its question's 2D states, summed up to and including
     the first [SEP], within 2% relative per row (derived in
     ``phase_generate``'s docstring).
   - Times: the forward's wall (median of 5) and its QA pairs/s, the stages
     by CUDA events and on the host (detector, ViT, twin encoder, cache
     init, the decode loop, its decoder passes, per step, the heads), one
     profiled forward (device time, busy share, casts; the table by kernel
     in ``build/profile_generate.txt``), one profiled decode loop alone
     (card records, device time, the cache reorder's;
     ``build/profile_generate_loop.txt``) and peak memory.

7. train: ``train_step`` (``BridgeQA.forward(batch, inference="loss")`` in
   train mode, ``get_loss``, the backward, the 3-group AdamW of
   ``train.optim.build_optimizer``).
   - The stripe ball query's backward kernel (``csrc/ball_query_backward.cu``)
     against its plain version at the vote aggregation's shape (batch 16,
     1024 votes, 256 centres, 16 slots) and SA1's (40000 points, 2048
     centres, 64 slots, one feature channel), with duplicate points,
     all-empty balls and stripes filled by the ball's first qualifier: g_xyz,
     g_center and g_feats each within 1e-5 of their largest value (f32
     atomics add in another order); card times beside the bound and one
     ``index_add_``.
   - Tiny, card against CPU (``phase_train_reference``): one step of the
     tiny config in f64 (the point kernels in f32, as always; in f32 the
     detector's BatchNorm gradients carry more than 1e-3 of rounding on
     either device, and the f32 step's distance from it is printed), dropout
     0, BatchNorm in train mode: losses within 1e-4
     relative, gradients within 1e-3 relative L2 (those 0 by construction
     within 1e-5 of the largest), running statistics within 1e-5; FPS, the
     ball query and its backward launched on the card, the fused scoring and
     ViT kernels not.
   - Full width (``phase_train``): the main path's config at batch 16 with
     remat "block", bf16 compute over f32 parameters, the config's dropout
     from a seeded generator, ``OptimConfig()``, BN momentum 0.1: one
     warm-up step and 5 steps with finite losses and gradients, each
     step's launch counts equal to ``expected_train_launches`` (FPS 5, ball
     query 5, its backward 1, every fused kernel 0), every parameter group
     changed; the step's wall and samples/s, forward, backward and optimizer
     by CUDA events, one profiled step (``build/profile_train_step.txt``),
     and peak memory with remat and without it.

Bounds: the least time the card could take for a kernel's work, the larger
of the bytes it must move (each input read once, each output written once)
over 3.35 TB/s and its operations over the peak rate for their type
(989 TFLOP/s bf16 tensor-core, 67 TFLOP/s f32), NVIDIA's H100 SXM data
sheet. Work that depends on the data (the ball query's scan, masked keys,
causal prefixes) is counted for this run's data.

Matrix products run in full f32 where f32 is used: TF32 is switched off
for both cuBLAS and cuDNN, and the patch embedding is a matrix product.
The last two lines are a ``{"kernels": [...]}`` JSON object (each
kernel's ``launches`` from the path it serves, named by ``launches_path``:
the rank forward, or the train step for the backward kernel;
``launches_by_path`` from the rank forward, the generate forward and a train
step) and ``{"ok": true, "device": {...}}``.
"""

import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

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
# the cluster sizes the FPS kernel takes
FPS_CLUSTER_SIZES = (2, 4, 8, 16)
# (name, points, centres, nsample, radius, feature channels) for each ball query
BQ_SHAPES = [("sa1", NUM_POINTS, 2048, 64, 0.2, 1), ("sa2", 2048, 1024, 32, 0.4, 0),
             ("sa3", 1024, 512, 16, 0.8, 0), ("sa4", 512, 256, 16, 1.2, 0),
             ("votes", 1024, 256, 16, 0.3, 0)]
# the scoring decoders: hidden 768, 12 heads, FFN 3072, vocabulary 30524
HIDDEN, HEADS, FFN, VOCAB = 768, 12, 3072, 30524
DECODER_ROWS = BATCH * K_TEST * ANSWER_LEN  # answer tokens a scoring pass runs
VOCAB_ROWS = BATCH * K_TEST * (ANSWER_LEN - 1)  # tokens whose next token is scored
# (name, K, N, GELU) of the six products of one decoder layer
GEMM_SHAPES = [("qkv", HIDDEN, 3 * HIDDEN, False), ("attention out", HIDDEN, HIDDEN, False),
               ("cross query", HIDDEN, HIDDEN, False), ("cross out", HIDDEN, HIDDEN, False),
               ("ffn in", HIDDEN, FFN, True), ("ffn out", FFN, HIDDEN, False)]
SCORING_PASSES = 2  # the 2D and the 3D decoder
# the ViT-B/16 at 480 px: 901 tokens of 8 images, 12 heads of 64, MLP 3072
VIT_TOKENS = (IMAGE_SIZE // 16) ** 2 + 1
VIT_ROWS = BATCH * VIT_TOKENS
VIT_HEADS = 12
# (name, K, N, GELU, residual) of the four products of one ViT block
VIT_GEMM_SHAPES = [("vit qkv", HIDDEN, 3 * HIDDEN, False, False),
                   ("vit attention out", HIDDEN, HIDDEN, False, False),
                   ("vit mlp in", HIDDEN, FFN, True, False),
                   ("vit mlp out", FFN, HIDDEN, False, True)]
# (name, table rows, channels, gathered rows) of the gather's checks: the
# shapes of the SA1 and SA2 groupings, batch 8
GATHER_SHAPES = [("sa1-like", NUM_POINTS, 4, 2048 * 64), ("sa2-like", 2048, 131, 1024 * 32)]

# H100 SXM peaks (NVIDIA's data sheet, dense) for the bounds
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12
OUT_DIR = Path(__file__).resolve().parent / "build"  # listed in .gitignore


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, loops: int = 3) -> float:
    """ms per call of ``fn``: after one warm-up call, ``loops`` loops of
    ``reps`` back-to-back calls, each loop between two CUDA events; the
    median of the loops. Back to back, the host enqueues a call while the
    card runs the one before, so the wrapper's host time stays out of the
    reading wherever a call takes the card longer than the host."""
    fn()
    times = []
    for _ in range(loops):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


# the host's calls that put work on the card, as the profiler names them
_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")
# traces of a device_ms that lacked some of their launches' work, since the
# process began: (reps, launch calls, card records) of each
dropped_traces = []


def device_ms(fn, reps: int) -> float:
    """ms of card time per call of ``fn``: the durations of every kernel
    (and copy) that a loop of ``reps`` back-to-back calls runs, read from
    ``torch.profiler``'s records of the card, over ``reps``. For kernels that
    take the card less time than their wrapper takes the host, where
    ``time_ms`` reads the host. One more call runs first inside the trace, and
    only the loop's records count (the last ones by start time, as many as
    the loop launched). A trace is used only if it holds a card record for
    every launch of the loop; one that lost some (``dropped_traces``) is
    taken again, up to five times, with the names of what it held and what
    was launched printed, and then the reading fails."""
    from collections import Counter

    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.profiler.kineto_results.events()
        work = sorted((e for e in events if e.device_type() == DeviceType.CUDA),
                      key=lambda e: e.start_ns())
        launched = [e.name() for e in events if e.device_type() == DeviceType.CPU
                    and e.name().startswith(_LAUNCH_CALLS)]
        # the loop's launches, when every call launches alike; else all of them
        loop = (len(launched) // (reps + 1) * reps if len(launched) % (reps + 1) == 0
                else len(launched))
        if work and len(work) >= loop:
            return sum(e.duration_ns() for e in work[len(work) - loop:]) / 1e6 / reps
        dropped_traces.append((reps, loop, len(work)))
        log(f"device_ms: a trace of {reps} calls held {len(work)} card records for {loop} "
            f"launches of the loop; taken again. Records "
            f"{dict(Counter(e.name()[:40] for e in work))}, launches {dict(Counter(launched))}")
    raise RuntimeError("device_ms: torch.profiler lost the card's records five times in a row")


def queued_ms(fn, reps: int, loops: int = 3) -> float:
    """ms of card time per call of ``fn``, by CUDA events and no profiler:
    each loop of ``reps`` calls is queued behind a spin kernel
    (``torch.cuda._sleep``) that holds the card until the host has queued
    the whole loop, so the events read the card running the calls back to
    back (the gaps between its kernels included), not the host issuing
    them. A loop counts only if the host queued it within the spin's card
    time; else the spin is doubled and the loop taken again, up to five
    times, and then the reading fails. The median of ``loops`` loops. For
    the backward kernel's rows: late in a long run ``torch.profiler`` has
    been seen to lose a few of their short kernels' records in every trace,
    so ``device_ms`` cannot read them."""
    fn()
    torch.cuda.synchronize()
    cycles, times = 1 << 20, []
    while len(times) < loops:
        for _ in range(5):
            spun, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
            spun_from = time.perf_counter()
            spun.record()
            torch.cuda._sleep(cycles)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            queued_s = time.perf_counter() - spun_from
            end.synchronize()
            if queued_s * 1e3 < spun.elapsed_time(start):
                times.append(start.elapsed_time(end) / reps)
                break
            cycles *= 2
        else:
            raise RuntimeError(f"queued_ms: the host took longer to queue {reps} calls than a "
                               f"spin of {cycles} cycles held the card")
    return statistics.median(times)


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the least time for ``flops`` at
    ``peak`` and ``nbytes`` at the HBM rate, and which of the two it is."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


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

    foreign = sorted(m for m in sys.modules if m in ("jax", "bridgeqa_tpu")
                     or m.startswith(("jax.", "bridgeqa_tpu.")))
    if foreign:
        raise RuntimeError(f"the port imported {foreign[:5]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(card_name_and_power())
    return torch.device("cuda", 0)


def card_name_and_power() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return smi.splitlines()[0]


# the redesigned kernels whose ptxas lines phase 2 prints (parts of their
# mangled names)
PTXAS_KERNELS = ("gemm_kernel", "vit_attention_bf16_kernel", "fps_cluster_kernel",
                 "vocab_wgmma_kernel", "attention_pipe_kernel", "ball_query_stripes_kernel",
                 "ball_query_backward_kernel")
# kernels whose SASS must hold Hopper instructions (parts of their mangled
# names: wg::gemm_kernel<...>, the vocabulary pass, the scoring attentions'
# pipeline), and which: the wgmma product (HGMMA) and the TMA tile load
# (UTMALDG)
SASS_KERNELS = {"wg11gemm_kernel": ("HGMMA", "UTMALDG"), "vocab_wgmma_kernel": ("HGMMA", "UTMALDG"),
                "attention_pipe_kernel": ("UTMALDG",)}


def ptxas_lines(build_log: str) -> list[str]:
    """The ptxas lines (registers, spills, barriers, warnings) of the
    entry functions whose names contain one of ``PTXAS_KERNELS``."""
    out, current = [], None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1] if "'" in line else line
            if any(k in current for k in PTXAS_KERNELS):
                out.append(f"{current}:")
            continue
        if current and any(k in current for k in PTXAS_KERNELS) and (
                "registers" in line or "spill" in line or "smem" in line or "arning" in line):
            out.append(f"    {line.strip()}")
    return out


def sass_check(library) -> dict:
    """Disassemble the kernel library with ``cuobjdump -sass`` and count, in
    each kernel of ``SASS_KERNELS`` (every instantiation), the instructions
    it must hold; raise unless every one holds them all, and every entry of
    ``SASS_KERNELS`` is among the kernels."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            ops = next((o for k, o in SASS_KERNELS.items() if k in name), None)
            if ops:
                counts[name] = dict.fromkeys(ops, 0)
            else:
                name = None
        elif name:
            for op in counts[name]:
                if op in line:
                    counts[name][op] += 1
    if (not all(any(k in name for name in counts) for k in SASS_KERNELS)
            or any(n == 0 for c in counts.values() for n in c.values())):
        raise AssertionError(f"the Hopper kernels' SASS lacks {SASS_KERNELS}: {counts}")
    return counts


def phase_build():
    from bridgeqa_tpu_torch.ops import cuda_lib

    cuda_lib.lib()
    log(f"build: {cuda_lib.build_seconds:.1f} s")
    for line in cuda_lib.build_log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            log(f"  {line.strip()}")
    log("ptxas, the redesigned kernels (bf16 GEMM, ViT attention, FPS, vocabulary pass, scoring "
        "attentions, ball query):")
    for line in ptxas_lines(cuda_lib.build_log) or ["(library reused: no build log)"]:
        log(f"  {line}")
    for fn, c in sass_check(cuda_lib.library_path).items():
        log(f"SASS {fn}: " + ", ".join(f"{op} x{n}" for op, n in c.items()))


def wrapper_host_us(device, loops: int = 3, reps: int = 200) -> dict:
    """Host time per call of the two redesigned kernels' wrappers, in us:
    loops of ``reps`` calls at small shapes (the card finishes each call
    before the host issues the next), median of the loops, host clock
    around the enqueue only."""
    from bridgeqa_tpu_torch.ops import scoring_layer as sl
    from bridgeqa_tpu_torch.ops import vit_block as vb

    gen = torch.Generator(device=device).manual_seed(12)
    x = torch.randn(256, HIDDEN, generator=gen, device=device).bfloat16()
    w = torch.randn(HIDDEN, HIDDEN, generator=gen, device=device).bfloat16()
    b = torch.randn(HIDDEN, generator=gen, device=device)
    qkv = torch.randn(1, 64, 3 * HIDDEN, generator=gen, device=device).bfloat16()
    calls = {"scoring_gemm": lambda: sl.scoring_gemm(x, w, b),
             "vit_attention": lambda: vb.vit_attention(qkv, heads=VIT_HEADS)}
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(loops):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            times.append((time.perf_counter() - t0) / reps * 1e6)
            torch.cuda.synchronize()
        out[name] = statistics.median(times)
    log("wrapper host time per call (us, median of 3 loops of 200 calls): "
        + json.dumps({k: round(v, 2) for k, v in out.items()}))
    return out


def stripe_scan_tests(radius: float, nsample: int, xyz, ctr) -> int:
    """Distance tests the stripe scan needs on these inputs: in each
    (centre, stripe), the points up to its first qualifier, or all of the
    stripe's real points when none qualifies; with two picks, also the
    points from the stripe's end back to its last qualifier."""
    from bridgeqa_tpu_torch.ops import grouping

    b, n, _ = xyz.shape
    picks, np_padded = grouping.stripe_plan(n, nsample)
    stripes = nsample // picks
    w = np_padded // stripes
    xyz_p = torch.cat([xyz, xyz.new_full((b, np_padded - n, 3), 1e9)], dim=1)
    r2 = float(np.float32(radius * radius))
    lidx = torch.arange(w, device=xyz.device)
    real = (n - torch.arange(stripes, device=xyz.device) * w).clamp(0, w)
    total = 0
    for s in range(0, ctr.shape[1], 256):
        mask = (grouping.pairwise_sqdist(ctr[:, s:s + 256], xyz_p) < r2).reshape(b, -1, stripes, w)
        found = mask.any(-1)
        tests = torch.where(found, torch.where(mask, lidx, w).amin(-1) + 1, real)
        if picks == 2:
            tests = tests + torch.where(found, real - torch.where(mask, lidx, -1).amax(-1), 0)
        total += int(tests.sum())
    return total


def phase_kernels(device, batch: int = BATCH, fps_shapes=FPS_SHAPES, bq_shapes=BQ_SHAPES,
                  reps: int = 5):
    """FPS and the ball query against their plain versions; returns their
    records of the kernels line (without launch counts). No single PyTorch
    call computes either, so neither has a ``library_ms``."""
    from bridgeqa_tpu_torch.ops import cuda_lib, grouping, sampling

    rng = np.random.RandomState(1)
    fps_rows, bq_rows = [], []
    for name, n, npoint in fps_shapes:
        xyz = torch.from_numpy(make_cloud(rng, batch, n)).to(device)
        idx, coords = sampling.furthest_point_sample_with_xyz(xyz, npoint)
        size, coresident = sampling.last_cluster
        pidx, pcoords = sampling.fps_plain(xyz, npoint)
        torch.cuda.synchronize()
        same = torch.equal(idx, pidx) and torch.equal(coords, pcoords)
        err = float((coords - pcoords).abs().max())
        ms = time_ms(lambda: sampling.furthest_point_sample_with_xyz(xyz, npoint), reps)
        plain_ms = time_ms(lambda: sampling.fps_plain(xyz, npoint), max(1, reps // 2))
        # each pick updates every point: 3 sub, 3 mul, 2 add, a min and an argmax compare
        bound_ms, bound_by = bound(batch * (npoint - 1) * n * 10.0,
                                   batch * (n * 12 + npoint * 16), PEAK_F32)
        us_per_pick = ms * 1e3 / (npoint - 1)
        # the kernel at every cluster size, against which the size picked is
        # read (these launches are not the main path's)
        by_size = {s: time_ms(lambda s=s: sampling.furthest_point_sample_with_xyz(
            xyz, npoint, cluster_size=s), reps) for s in FPS_CLUSTER_SIZES}
        fps_rows.append(dict(shape=f"{name}: ({batch}, {n}, 3) -> {npoint}", calls=1,
                             bitwise=same, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                             cluster_size=size, coresident_clusters=coresident,
                             us_per_selection=us_per_pick, ms_by_cluster_size=by_size))
        log(f"fps {name}: ({batch}, {n}) -> {npoint}: bitwise {same}, kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}); clusters of "
            f"{size} ({coresident} co-resident), {us_per_pick:.3f} us per selection; ms at "
            f"each cluster size {json.dumps({k: round(v, 4) for k, v in by_size.items()})}")
    # the floor of one selection: bare cluster barriers, SA1's clusters, at
    # each cluster size
    name, _, npoint = fps_shapes[0]
    lib = cuda_lib.lib()

    def barriers(size):
        cuda_lib.check(lib.bq_cluster_barrier_loop(batch, size, npoint - 1,
                                                   cuda_lib.stream_handle(device)),
                       "bq_cluster_barrier_loop")

    barrier_us = {s: time_ms(lambda s=s: barriers(s), reps) * 1e3 / (npoint - 1)
                  for s in FPS_CLUSTER_SIZES}
    fps_rows[0]["us_per_bare_cluster_barrier"] = barrier_us
    log(f"fps {name}: loops of {npoint - 1} bare cluster barriers, {batch} clusters, us per "
        f"barrier at each cluster size {json.dumps({k: round(v, 3) for k, v in barrier_us.items()})}"
        f", against {fps_rows[0]['us_per_selection']:.3f} us per selection at "
        f"{fps_rows[0]['cluster_size']}")
    for name, n, m, ns, radius, nf in bq_shapes:
        xyz_np = make_cloud(rng, batch, n)
        centres = xyz_np[:, rng.permutation(n)[:m]].copy()
        centres[:, :4] += 100.0  # empty balls
        xyz = torch.from_numpy(xyz_np).to(device)
        ctr = torch.from_numpy(centres).to(device)
        feats = torch.from_numpy(rng.rand(batch, n, nf).astype(np.float32)).to(device) if nf else None
        out = grouping.ball_query_stripes(radius, ns, xyz, ctr, feats)
        launch = dict(grouping.last_launch)
        ref = grouping.ball_query_stripes_plain(radius, ns, xyz, ctr, feats)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) if a is not None else b is None for a, b in zip(out, ref))
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(out, ref) if a is not None)
        empty = bool((out[0][:, :4] == 0).all())
        # card time: at the small shapes a call takes the card less time than
        # its wrapper takes the host
        ms = device_ms(lambda: grouping.ball_query_stripes(radius, ns, xyz, ctr, feats), reps)
        plain_ms = device_ms(lambda: grouping.ball_query_stripes_plain(radius, ns, xyz, ctr, feats),
                             max(1, reps // 2))
        picks, np_padded = grouping.stripe_plan(n, ns)
        # a distance test: 3 sub, 3 mul, 2 add, a compare
        tests = stripe_scan_tests(radius, ns, xyz, ctr)
        bound_ms, bound_by = bound(tests * 9.0, batch * (n * (12 + 4 * nf) + m * 12
                                                         + m * ns * (4 + 12 + 4 * nf)), PEAK_F32)
        # the same tests as unfused instructions (the source builds with
        # -fmad=false): one a lane and cycle, 33.5e12 a second
        unfused_ms = tests * 9.0 / (PEAK_F32 / 2) * 1e3
        bq_rows.append(dict(shape=f"{name}: N={n} padded to {np_padded}, {picks} pick(s), "
                                  f"M={m}, nsample={ns}, r={radius}, nf={nf}, batch {batch}",
                            calls=1, bitwise=same and empty, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                            bound_by=bound_by, distance_tests=tests, launch=launch))
        log(f"ball query {name}: N={n} (padded {np_padded}, {picks} pick(s)), M={m}, ns={ns}, "
            f"r={radius}, nf={nf}: bitwise {same}, empty balls {empty}, kernel {ms:.4f} ms card "
            f"time, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}, {tests} tests), "
            f"in unfused instructions {unfused_ms:.4f} ms ({ms / unfused_ms:.2f}x); launch "
            f"{json.dumps(launch)}")
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


def attention_launch(mode: str):
    """The record of the last attention launch (the C entry's report); the
    main path's bf16 shapes must have run the tensor-core pipeline."""
    from bridgeqa_tpu_torch.ops import scoring_layer as sl

    launch = dict(sl.last_attention_launch)
    if launch["pipeline"] != 1:
        raise AssertionError(f"the {mode} attention at the main path's shape did not run the "
                             f"tensor-core pipeline: {launch}")
    return launch


def _bf16_tol(want) -> float:
    return 2.0**-6 * float(want.float().abs().max())


def check_row(rows, failures, name, shape, checks, ms, plain_ms, library_ms, flops, nbytes, peak,
              calls, note="", launch=None):
    """Append one shape's row to ``rows`` and log it. ``checks``: {output:
    (bf16 error, its tolerance, f32 error, its tolerance)}, one entry for
    each output the kernel writes; a check outside its tolerance is added to
    ``failures``."""
    bound_ms, bound_by = bound(flops, nbytes, peak)
    checks = {k: dict(zip(("max_abs_err", "tolerance", "f32_max_abs_err", "f32_tolerance"), v))
              for k, v in checks.items()}
    for out, c in checks.items():
        if not (c["max_abs_err"] <= c["tolerance"] and c["f32_max_abs_err"] <= c["f32_tolerance"]):
            failures.append(f"{name} {shape} {out}: {c}")
    rows.append(dict(shape=shape, calls=calls,
                     max_abs_err=max(c["max_abs_err"] for c in checks.values()), checks=checks,
                     ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                     bound_by=bound_by, note=note))
    if launch is not None:
        rows[-1]["launch"] = launch
    lib = "none" if library_ms is None else f"{library_ms:.3f} ms"
    errs = "; ".join(f"{out} err {c['max_abs_err']:.3g} (tol {c['tolerance']:.3g}), f32 err "
                     f"{c['f32_max_abs_err']:.3g} (tol {c['f32_tolerance']:.3g})"
                     for out, c in checks.items())
    log(f"{name} {shape}: {errs}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, library {lib}, "
        f"bound {bound_ms:.4f} ms ({bound_by}); {note}"
        + ("" if launch is None else f"; launch {json.dumps(launch)}"))


def one_output(err, want, f32_err):
    """The checks of a kernel with one output: bf16 within 2^-6 of the
    largest output, f32 within 1e-3."""
    return {"out": (err, _bf16_tol(want), f32_err, 1e-3)}


def phase_scoring_kernels(device, layers: int, reps: int = 10):
    """The scoring kernels against their plain versions at the main-path
    shapes, bf16, and their f32 instantiations; returns their records of the
    kernels line. ``calls`` is how often one forward makes each call:
    ``layers`` decoder layers in each of the two scoring passes."""
    from bridgeqa_tpu_torch.ops import scoring_layer as sl
    from bridgeqa_tpu_torch.ops import vocab_loss as vl

    gen = torch.Generator(device=device).manual_seed(5)
    bf16 = torch.bfloat16
    per_layer = layers * SCORING_PASSES
    failures = []

    def randn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(dtype)

    rows_n, h, hd, la = DECODER_ROWS, HIDDEN, HIDDEN // HEADS, ANSWER_LEN
    gemm_rows = []
    for name, k, n, gelu in GEMM_SHAPES:
        x = randn(rows_n, k)
        w = randn(n, k, scale=0.02)
        # biases as large as the products (std ~0.55), so a dropped bias
        # exceeds the bf16 tolerance
        b = randn(n, scale=0.5, dtype=torch.float32)
        got, want = sl.scoring_gemm(x, w, b, gelu), sl.scoring_gemm_plain(x, w, b, gelu)
        x32, w32 = x.float(), w.float()
        f32_err = max_err(sl.scoring_gemm(x32, w32, b, gelu),
                          sl.scoring_gemm_plain(x32, w32, b, gelu))
        b16 = b.to(bf16)
        check_row(gemm_rows, failures, "scoring_gemm", f"{name}: ({rows_n}, {k}) x ({n}, {k})^T"
                  + (" + GELU" if gelu else ""), one_output(max_err(got, want), want, f32_err),
                  device_ms(lambda: sl.scoring_gemm(x, w, b, gelu), reps),
                  device_ms(lambda: sl.scoring_gemm_plain(x, w, b, gelu), 3),
                  device_ms(lambda: F.linear(x, w, b16), reps), 2.0 * rows_n * n * k,
                  2 * (rows_n * k + n * k + rows_n * n) + 4 * n, PEAK_BF16, per_layer,
                  "library: F.linear, without the GELU" if gelu else "library: F.linear")
        del x, w, got, want, x32, w32

    attn_rows = []
    qkv = randn(rows_n, 3 * h)
    seqs = rows_n // la
    got = sl.self_attention(qkv, la=la, heads=HEADS)
    launch = attention_launch("self")
    want = sl.self_attention_plain(qkv, la=la, heads=HEADS)
    qkv32 = qkv.float()
    f32_err = max_err(sl.self_attention(qkv32, la=la, heads=HEADS),
                      sl.self_attention_plain(qkv32, la=la, heads=HEADS))
    q, k, v = qkv.view(seqs, la, 3, HEADS, hd).permute(2, 0, 3, 1, 4)
    check_row(attn_rows, failures, "scoring_attention",
              f"self: ({rows_n}, {3 * h}), {seqs} answers of {la}",
              one_output(max_err(got, want), want, f32_err),
              device_ms(lambda: sl.self_attention(qkv, la=la, heads=HEADS), reps),
              device_ms(lambda: sl.self_attention_plain(qkv, la=la, heads=HEADS), 3),
              device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), reps),
              4.0 * HEADS * seqs * (la * (la + 1) // 2) * hd, 2 * (rows_n * 3 * h + rows_n * h),
              PEAK_BF16, per_layer, "library: scaled_dot_product_attention, causal", launch)
    del qkv, qkv32, q, k, v, got, want

    rows_q = rows_n // BATCH
    qc = randn(rows_n, h)
    ck, cv = randn(BATCH, QUESTION_LEN, h), randn(BATCH, QUESTION_LEN, h)
    valid = QUESTION_LEN - 4 * torch.arange(BATCH, device=device)  # padded questions
    keep = torch.arange(QUESTION_LEN, device=device)[None, :] < valid[:, None]
    cbias = torch.where(keep, 0.0, sl.NEG).float()
    got = sl.cross_attention(qc, ck, cv, cbias, heads=HEADS)
    launch = attention_launch("cross")
    want = sl.cross_attention_plain(qc, ck, cv, cbias, heads=HEADS)
    f32_err = max_err(sl.cross_attention(qc.float(), ck.float(), cv.float(), cbias, heads=HEADS),
                      sl.cross_attention_plain(qc.float(), ck.float(), cv.float(), cbias,
                                               heads=HEADS))
    qh = qc.view(BATCH, rows_q, HEADS, hd).transpose(1, 2)
    kh = ck.view(BATCH, QUESTION_LEN, HEADS, hd).transpose(1, 2)
    vh = cv.view(BATCH, QUESTION_LEN, HEADS, hd).transpose(1, 2)
    mask16 = cbias[:, None, None, :].to(bf16)
    check_row(attn_rows, failures, "scoring_attention",
              f"cross: ({rows_n}, {h}) against ({BATCH}, {QUESTION_LEN}, {h}), "
              f"{int(valid.sum())} valid keys", one_output(max_err(got, want), want, f32_err),
              device_ms(lambda: sl.cross_attention(qc, ck, cv, cbias, heads=HEADS), reps),
              device_ms(lambda: sl.cross_attention_plain(qc, ck, cv, cbias, heads=HEADS), 3),
              device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask16), reps),
              4.0 * rows_q * h * float(valid.sum()),
              2 * (2 * rows_n * h + 2 * BATCH * QUESTION_LEN * h) + 4 * BATCH * QUESTION_LEN,
              PEAK_BF16, per_layer, "library: scaled_dot_product_attention, additive mask", launch)
    del qc, ck, cv, qh, kh, vh, got, want

    ln_rows = []
    a, r = randn(rows_n, h), randn(rows_n, h)
    # scale and shift well away from (1, 0), so a dropped affine exceeds
    # the bf16 tolerance
    scale = randn(h, scale=0.5, dtype=torch.float32) + 1.0
    shift = randn(h, scale=0.5, dtype=torch.float32)
    eps = 1e-12
    got = sl.add_layernorm(a, r, scale, shift, eps)
    want = sl.add_layernorm_plain(a, r, scale, shift, eps)
    f32_err = max_err(sl.add_layernorm(a.float(), r.float(), scale, shift, eps),
                      sl.add_layernorm_plain(a.float(), r.float(), scale, shift, eps))
    s16, b16 = scale.to(bf16), shift.to(bf16)
    check_row(ln_rows, failures, "scoring_layernorm", f"({rows_n}, {h}) + ({rows_n}, {h})",
              one_output(max_err(got, want), want, f32_err),
              device_ms(lambda: sl.add_layernorm(a, r, scale, shift, eps), reps),
              device_ms(lambda: sl.add_layernorm_plain(a, r, scale, shift, eps), 3),
              device_ms(lambda: F.layer_norm(a + r, (h,), s16, b16, eps), reps),
              10.0 * rows_n * h, 2 * 3 * rows_n * h + 8 * h, PEAK_F32, 3 * per_layer,
              "library: F.layer_norm after the add (two calls)")
    del a, r, got, want

    vocab_rows = []
    # the main path's pass, then a check only (no calls on the main path):
    # rows that fill no block and a vocabulary whose last tile is mostly
    # padding, so padded columns that leak into a sum show
    for rows_v, vocab, calls in ((VOCAB_ROWS, VOCAB, SCORING_PASSES), (1000, 203, 0)):
        hv = randn(rows_v, h)
        table = randn(vocab, h, scale=0.02)
        vbias = randn(vocab, scale=0.5, dtype=torch.float32)  # a dropped bias shows
        labels = torch.randint(0, vocab, (rows_v,), generator=gen, device=device,
                               dtype=torch.int32)
        got = vl.lm_vocab_reductions(hv, table, vbias, labels)
        want = vl.lm_vocab_reductions_plain(hv, table, vbias, labels)
        got32 = vl.lm_vocab_reductions(hv.float(), table.float(), vbias, labels)
        # each output is f32 from exact products, summed in another order on
        # each side: <= 1e-3 of that output's largest value; the f32
        # instantiation <= 1e-3, as every f32 instantiation
        checks = {out: (max_err(a_, b_), 1e-3 * max(1.0, float(b_.abs().max())),
                        max_err(a32, b_), 1e-3)
                  for out, a_, a32, b_ in zip(("lse", "sum_logits", "target_logit"), got, got32,
                                               want)}
        check_row(vocab_rows, failures, "vocab_loss", f"({rows_v}, {h}) x ({vocab}, {h})^T", checks,
                  time_ms(lambda: vl.lm_vocab_reductions(hv, table, vbias, labels), reps),
                  time_ms(lambda: vl.lm_vocab_reductions_plain(hv, table, vbias, labels), 3), None,
                  2.0 * rows_v * vocab * h, 2 * (rows_v * h + vocab * h) + 4 * vocab
                  + 4 * rows_v + 12 * rows_v, PEAK_BF16, calls,
                  "no single PyTorch call: it takes a product and a logsumexp")
        row = vocab_rows[-1]
        row["tflops"] = 2.0 * rows_v * vocab * h / (row["ms"] * 1e-3) / 1e12
        log(f"vocab_loss ({rows_v}, {h}) x ({vocab}, {h})^T: {row['tflops']:.1f} TFLOP/s")
        del hv, table, got, want, got32

    if failures:
        raise AssertionError(f"scoring kernels and plain versions disagree: {failures}")
    src = "bridgeqa_tpu_torch/csrc/"
    layer_kernel = "bridgeqa_tpu/ops/scoring_layer.py:67"
    return [
        dict(name="scoring_gemm", route="cuda", source=src + "scoring_gemm.cu",
             replaces=layer_kernel, rows=gemm_rows),
        dict(name="scoring_attention", route="cuda", source=src + "scoring_attention.cu",
             replaces=layer_kernel, rows=attn_rows),
        dict(name="scoring_layernorm", route="cuda", source=src + "scoring_layernorm.cu",
             replaces=layer_kernel, rows=ln_rows),
        dict(name="vocab_loss", route="cuda", source=src + "vocab_loss.cu",
             replaces="bridgeqa_tpu/ops/vocab_loss.py:37", rows=vocab_rows),
    ]


def phase_vit_kernels(device, kernels: dict, depth: int, reps: int = 10):
    """The ViT block's kernels against their plain versions at the main-path
    shapes (8 images of 901 tokens), bf16 and f32, and the row gather.
    The products and LayerNorms are the scoring kernels': their rows join
    those records in ``kernels`` (``calls``: ``depth`` blocks, and the final
    LayerNorm). Returns the records of the ViT attention and the gather."""
    from bridgeqa_tpu_torch.ops import gather
    from bridgeqa_tpu_torch.ops import scoring_layer as sl
    from bridgeqa_tpu_torch.ops import vit_block as vb

    gen = torch.Generator(device=device).manual_seed(8)
    bf16 = torch.bfloat16
    failures = []
    vit_kernel = "bridgeqa_tpu/ops/vit_block.py:39"

    def randn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(dtype)

    rows_n, h, hd = VIT_ROWS, HIDDEN, HIDDEN // VIT_HEADS
    gemm_rows = kernels["scoring_gemm"]["rows"]
    for name, k, n, gelu, with_res in VIT_GEMM_SHAPES:
        x = randn(rows_n, k)
        w = randn(n, k, scale=0.02)
        b = randn(n, scale=0.5, dtype=torch.float32)  # a dropped bias shows
        res = randn(rows_n, n, scale=2.0) if with_res else None
        got, want = sl.scoring_gemm(x, w, b, gelu, res), sl.scoring_gemm_plain(x, w, b, gelu, res)
        x32, w32 = x.float(), w.float()
        res32 = None if res is None else res.float()
        f32_err = max_err(sl.scoring_gemm(x32, w32, b, gelu, res32),
                          sl.scoring_gemm_plain(x32, w32, b, gelu, res32))
        b16 = b.to(bf16)
        check_row(gemm_rows, failures, "scoring_gemm",
                  f"{name}: ({rows_n}, {k}) x ({n}, {k})^T" + (" + GELU" if gelu else "")
                  + (" + residual" if with_res else ""),
                  one_output(max_err(got, want), want, f32_err),
                  device_ms(lambda: sl.scoring_gemm(x, w, b, gelu, res), reps),
                  device_ms(lambda: sl.scoring_gemm_plain(x, w, b, gelu, res), 3),
                  device_ms(lambda: F.linear(x, w, b16), reps), 2.0 * rows_n * n * k,
                  2 * (rows_n * k + n * k + rows_n * n * (2 if with_res else 1)) + 4 * n,
                  PEAK_BF16, depth,
                  "library: F.linear" + (", without the GELU" if gelu else "")
                  + (", without the residual" if with_res else ""))
        del x, w, got, want, x32, w32, res, res32

    attn_rows = []
    # the main path's 901 tokens (the last 64-key tile holds 5 keys), then a
    # check only: 833 tokens, one key in the last tile and 63 of padding.
    # A padded key that leaked into a row's sum would add exp(0 - max) to it
    # and shrink the whole row: some percent over 59 or 63 keys, which the
    # relative L2 error of each (image, head) shows
    for tokens, calls in ((VIT_TOKENS, depth), (833, 0)):
        qkv = randn(BATCH, tokens, 3 * h)
        got = vb.vit_attention(qkv, heads=VIT_HEADS)
        want = vb.vit_attention_plain(qkv, heads=VIT_HEADS)
        qkv32 = qkv.float()
        f32_err = max_err(vb.vit_attention(qkv32, heads=VIT_HEADS),
                          vb.vit_attention_plain(qkv32, heads=VIT_HEADS))
        q, k, v = qkv.view(BATCH, tokens, 3, VIT_HEADS, hd).permute(2, 0, 3, 1, 4)
        check_row(attn_rows, failures, "vit_attention",
                  f"({BATCH}, {tokens}, {3 * h}), {VIT_HEADS} heads of {hd}",
                  one_output(max_err(got, want), want, f32_err),
                  time_ms(lambda: vb.vit_attention(qkv, heads=VIT_HEADS), reps),
                  time_ms(lambda: vb.vit_attention_plain(qkv, heads=VIT_HEADS), 3),
                  time_ms(lambda: F.scaled_dot_product_attention(q, k, v), reps),
                  4.0 * BATCH * VIT_HEADS * tokens * tokens * hd,
                  2 * BATCH * tokens * 4 * h, PEAK_BF16, calls,
                  f"library: scaled_dot_product_attention on ({BATCH}, {VIT_HEADS}, {tokens}, "
                  f"{hd}) views")
        # and the relative L2 error of each (image, head): within 1%
        rel = head_rel_l2(got, want, VIT_HEADS)
        attn_rows[-1]["rel_l2_per_image_head"] = rel
        log(f"vit_attention ({BATCH}, {tokens}): max relative L2 error per image and head "
            f"{rel:.3g} (tol 0.01)")
        if not rel <= 0.01:
            failures.append(f"vit_attention {tokens} tokens: relative L2 error {rel} per head")
        del qkv, qkv32, q, k, v, got, want

    ln_rows = kernels["scoring_layernorm"]["rows"]
    a, r = randn(rows_n, h), randn(rows_n, h, scale=2.0)
    scale = randn(h, scale=0.5, dtype=torch.float32) + 1.0
    shift = randn(h, scale=0.5, dtype=torch.float32)
    s16, b16 = scale.to(bf16), shift.to(bf16)
    eps = 1e-6
    # LN1 of every block and the final norm: no residual
    got = sl.add_layernorm(a, None, scale, shift, eps)
    want = sl.add_layernorm_plain(a, None, scale, shift, eps)
    f32_err = max_err(sl.add_layernorm(a.float(), None, scale, shift, eps),
                      sl.add_layernorm_plain(a.float(), None, scale, shift, eps))
    check_row(ln_rows, failures, "scoring_layernorm", f"vit LN1 and final norm: ({rows_n}, {h})",
              one_output(max_err(got, want), want, f32_err),
              device_ms(lambda: sl.add_layernorm(a, None, scale, shift, eps), reps),
              device_ms(lambda: sl.add_layernorm_plain(a, None, scale, shift, eps), 3),
              device_ms(lambda: F.layer_norm(a, (h,), s16, b16, eps), reps),
              8.0 * rows_n * h, 2 * 2 * rows_n * h + 8 * h, PEAK_F32, depth + 1,
              "library: F.layer_norm")
    # LN2 after the attention's residual, keeping the sum
    (gsum, got), (wsum, want) = (sl.add_layernorm(a, r, scale, shift, eps, keep_sum=True),
                                 sl.add_layernorm_plain(a, r, scale, shift, eps, keep_sum=True))
    f32_got = sl.add_layernorm(a.float(), r.float(), scale, shift, eps, keep_sum=True)
    f32_want = sl.add_layernorm_plain(a.float(), r.float(), scale, shift, eps, keep_sum=True)
    checks = {"out": (max_err(got, want), _bf16_tol(want), max_err(f32_got[1], f32_want[1]),
                      1e-3),
              # the sum is one rounding of a + r on both sides: bitwise
              "sum": (max_err(gsum, wsum), 0.0, max_err(f32_got[0], f32_want[0]), 0.0)}
    check_row(ln_rows, failures, "scoring_layernorm",
              f"vit LN2 keeping the sum: ({rows_n}, {h}) + ({rows_n}, {h})", checks,
              device_ms(lambda: sl.add_layernorm(a, r, scale, shift, eps, keep_sum=True), reps),
              device_ms(lambda: sl.add_layernorm_plain(a, r, scale, shift, eps, keep_sum=True), 3),
              device_ms(lambda: F.layer_norm(a + r, (h,), s16, b16, eps), reps),
              10.0 * rows_n * h, 2 * 4 * rows_n * h + 8 * h, PEAK_F32, depth,
              "library: F.layer_norm after the add (two calls)")
    del a, r, got, want, gsum, wsum, f32_got, f32_want
    for name in ("scoring_gemm", "scoring_layernorm"):
        kernels[name]["replaces"] += ", " + vit_kernel

    # the gather: bitwise against torch.gather (also the library call); not
    # on the main path, so one call of each shape
    gather_rows = []
    rng = np.random.RandomState(9)
    for name, n, c, r in GATHER_SHAPES:
        idx = torch.from_numpy(rng.randint(0, n, (BATCH, r)).astype(np.int32)).to(device)
        # rows the indices pick: each read once
        picked = sum(int(torch.unique(idx[i]).numel()) for i in range(BATCH))
        for dtype in (torch.float32, bf16):
            table = randn(BATCH, n, c, dtype=dtype)
            got, want = gather.gather_rows(table, idx), gather.gather_rows_plain(table, idx)
            same = torch.equal(got, want)
            if not same:
                failures.append(f"gather_rows {name} {dtype}: not bitwise equal")
            es = table.element_size()
            # the wrapper, whose host-side index check waits for the card
            # every call; and the card time of a call (the check's
            # reduction and the copy)
            ms = time_ms(lambda: gather.gather_rows(table, idx), reps)
            card_ms = device_ms(lambda: gather.gather_rows(table, idx), reps)
            plain_ms = time_ms(lambda: gather.gather_rows_plain(table, idx), reps)
            bound_ms, bound_by = bound(0.0, BATCH * r * 4 + (picked + BATCH * r) * c * es,
                                       PEAK_F32)
            gather_rows.append(dict(shape=f"{name} {str(dtype)[6:]}: ({BATCH}, {n}, {c}) at "
                                          f"({BATCH}, {r}), {picked} rows picked",
                                    calls=1, bitwise=same, max_abs_err=max_err(got, want), ms=ms,
                                    card_ms=card_ms, plain_ms=plain_ms, library_ms=plain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by,
                                    note="library: torch.gather, the plain version itself"))
            log(f"gather_rows {name} {dtype}: ({BATCH}, {n}, {c}) at ({BATCH}, {r}): bitwise "
                f"{same}, wrapper {ms:.4f} ms (card time {card_ms:.4f} ms), "
                f"torch.gather {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            del table, got, want
    if failures:
        raise AssertionError(f"ViT kernels and plain versions disagree: {failures}")
    return [
        dict(name="vit_attention", route="cuda", source="bridgeqa_tpu_torch/csrc/vit_attention.cu",
             replaces=vit_kernel, rows=attn_rows),
        dict(name="gather_rows", route="cuda", source="bridgeqa_tpu_torch/csrc/gather_rows.cu",
             replaces="bridgeqa_tpu/ops/gather.py:29, bridgeqa_tpu/ops/gather.py:73",
             rows=gather_rows, per="one call at each checked shape: no path calls the gather"),
    ]


def head_rel_l2(got, want, heads: int) -> float:
    """The largest relative L2 error of one (image, head) slice of (B, N,
    H) outputs."""
    b, n, h = want.shape
    d = (got.float() - want.float()).view(b, n, heads, h // heads)
    w = want.float().view(b, n, heads, h // heads)
    return float((d.pow(2).sum((1, 3)).sqrt() / w.pow(2).sum((1, 3)).sqrt()).max())


def phase_vit_pass(device, seed: int = 7):
    """A whole 12-block ViT-B/16 at 480 px over 8 random images, the fused
    blocks and the final LayerNorm, kernels against plain versions in bf16,
    every bias and LayerNorm parameter perturbed: the relative L2 error of
    each image's (901, 768) output within 1% (rounding points match,
    summation order does not)."""
    from bridgeqa_tpu_torch.models.layers import init_weights, set_compute_dtype
    from bridgeqa_tpu_torch.models.vit import create_vit
    from bridgeqa_tpu_torch.ops import scoring_layer as sl
    from bridgeqa_tpu_torch.ops import vit_block as vb

    with torch.device(device):
        vit, width = create_vit("base", IMAGE_SIZE)
    gen = torch.Generator(device=device).manual_seed(seed)
    vit = set_compute_dtype(perturb_affine(init_weights(vit, gen), gen), torch.bfloat16).eval()
    images = torch.rand(BATCH, IMAGE_SIZE, IMAGE_SIZE, 3, generator=gen, device=device)
    norm = vit.norm

    def encode(block, layernorm):
        x = vb.fused_vit_blocks(vit, vit.embed(images), block=block)
        return layernorm(x.reshape(-1, width), None, norm.weight, norm.bias, norm.eps)

    with torch.inference_mode():
        got = encode(vb.vit_block, sl.add_layernorm).float().reshape(BATCH, -1)
        want = encode(vb.vit_block_plain, sl.add_layernorm_plain).float().reshape(BATCH, -1)
    rel = float(((got - want).norm(dim=1) / want.norm(dim=1)).max())
    log(f"ViT pass (12 blocks + final norm, bf16, {BATCH} images of {VIT_TOKENS} tokens): "
        f"max relative L2 error per image {rel:.3g} (tol 0.01)")
    if not (rel <= 0.01 and bool(torch.isfinite(got).all())):
        raise AssertionError(f"ViT pass: kernels and plain versions differ by {rel} relative")


def perturb_affine(module, gen, scale: float = 0.5):
    """Add noise of ``scale`` to every bias and LayerNorm parameter of
    ``module``, which ``init_weights`` sets to 0 and (1, 0), so that a
    kernel that drops a bias or an affine changes the result."""
    from bridgeqa_tpu_torch.models.layers import LayerNorm

    with torch.no_grad():
        for m in module.modules():
            for name, p in m.named_parameters(recurse=False):
                if name == "bias" or isinstance(m, LayerNorm):
                    p.add_(torch.randn(p.shape, generator=gen, device=p.device) * scale)
    return module


def phase_decoder_pass(device, seed: int = 6):
    """A whole 12-layer full-width decoder and its loss over the main
    path's 2048 answers, kernels against plain versions in bf16, biases and
    LayerNorm parameters perturbed: per-sequence losses within 1% relative."""
    from bridgeqa_tpu_torch.models.layers import init_weights, param_as, set_compute_dtype
    from bridgeqa_tpu_torch.models.med import BertLMHeadModel, MedConfig
    from bridgeqa_tpu_torch.ops import scoring_layer as sl
    from bridgeqa_tpu_torch.ops import vocab_loss as vl

    cfg = MedConfig()
    with torch.device(device):
        dec = BertLMHeadModel(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    dec = set_compute_dtype(perturb_affine(init_weights(dec, gen), gen), torch.bfloat16).eval()
    rng = np.random.RandomState(seed)
    n = BATCH * K_TEST
    ids = rng.randint(1, 30000, (n, ANSWER_LEN))
    lens = rng.randint(2, ANSWER_LEN + 1, n)
    ids = np.where(np.arange(ANSWER_LEN)[None, :] < lens[:, None], ids, 0)  # right-padded
    ids = torch.from_numpy(ids).to(device)
    labels = torch.where(ids == 0, -100, ids)
    qs = torch.randn(BATCH, QUESTION_LEN, cfg.hidden_size, generator=gen, device=device).to(torch.bfloat16)
    qmask = (torch.arange(QUESTION_LEN, device=device)[None, :]
             < (QUESTION_LEN - 5 * torch.arange(BATCH, device=device))[:, None]).to(torch.int32)
    table = param_as(dec.bert.embeddings.word_embeddings, "weight", torch.bfloat16)

    def loss(layer, reductions):
        x = sl.scoring_decoder_body(dec.bert.encoder, dec.bert.embeddings(ids), qs, qmask,
                                    config=cfg, layer=layer)
        h_t = dec.cls.transform(x)[:, :-1]
        return vl.label_smoothed_loss_streaming(h_t, labels[:, 1:], table, dec.cls.bias,
                                                reductions=reductions)

    with torch.inference_mode():
        got = loss(sl.scoring_layer, vl.lm_vocab_reductions)
        want = loss(sl.scoring_layer_plain, vl.lm_vocab_reductions_plain)
    rel = float(((got - want).abs() / want.abs()).max())
    log(f"decoder pass (12 layers, bf16, {n} answers, right-padded): per-sequence loss max rel "
        f"err {rel:.3g} (tol 0.01), mean loss {float(want.mean()):.3f}")
    if not (rel <= 0.01 and bool(torch.isfinite(got).all())):
        raise AssertionError(f"decoder pass: kernels and plain versions differ by {rel} relative")


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

    model = BridgeQA(cfg, device=device)  # ScanNet's size clusters
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_weights(model, gen).eval()


def tiny_config():
    from bridgeqa_tpu_torch.models.blip_vqa3d import BlipVQA3DConfig
    from bridgeqa_tpu_torch.models.bridgeqa import BridgeQAConfig
    from bridgeqa_tpu_torch.models.med import MedConfig

    med = MedConfig(vocab_size=200, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                    intermediate_size=256, max_position_embeddings=128, encoder_width=128,
                    fused_scoring="force")
    blip = BlipVQA3DConfig(med=med, image_size=64, num_answers=30, vit="custom",
                           vit_custom_embed_dim=128, vit_custom_depth=2, vit_custom_heads=2,
                           bos_token_id=110)
    return BridgeQAConfig(num_answers=30, num_proposal=32, hidden_size=32, blip=blip,
                          mcan_num_layers=1, input_feature_dim=1)


def reset_launches() -> None:
    from bridgeqa_tpu_torch.ops import gather, grouping, sampling, scoring_layer, vit_block
    from bridgeqa_tpu_torch.ops import vocab_loss

    sampling.launches = grouping.launches = vocab_loss.launches = 0
    vit_block.launches = gather.launches = grouping.backward_launches = 0
    for name in scoring_layer.launches:
        scoring_layer.launches[name] = 0


def read_launches() -> dict:
    from bridgeqa_tpu_torch.ops import gather, grouping, sampling, scoring_layer, vit_block
    from bridgeqa_tpu_torch.ops import vocab_loss

    return {"fps": sampling.launches, "ball_query_stripes": grouping.launches,
            **scoring_layer.launches, "vocab_loss": vocab_loss.launches,
            "vit_attention": vit_block.launches, "gather_rows": gather.launches,
            "ball_query_backward": grouping.backward_launches}


# kernels no path runs: checked in phase 3 only
OFF_PATH = ("gather_rows",)
# kernels only a backward runs: the train path's
BACKWARD_ONLY = ("ball_query_backward",)


def phase_reference(device):
    """A tiny rank forward through the kernels on the card against the
    plain versions on the CPU, same weights, f32, the fused scoring path and
    the fused ViT on both sides (forced on the CPU, "auto" on the card).
    Every answer is scored (k_test = the list length), so no top-k tie can
    split the two runs. The decoders' and the ViT's biases and LayerNorm
    parameters are perturbed. Tolerance 1e-3: the two devices sum matrix
    products in another order."""
    from bridgeqa_tpu_torch.ops import vit_block as vb

    cfg = tiny_config()
    cpu_model = build_model(cfg, torch.device("cpu"), seed=3)
    blip = cpu_model.blip_model
    gen = torch.Generator().manual_seed(3)
    perturb_affine(blip.text_decoder, gen)
    if blip._decoder_scene() is not blip.text_decoder:
        perturb_affine(blip._decoder_scene(), gen)
    perturb_affine(blip.visual_encoder, gen)
    card_model = copy.deepcopy(cpu_model).to(device)
    batch = make_batch(cfg, 2, 4096, 64, 20, 6, torch.device("cpu"), seed=4)
    if vb.FUSED_MODE != "auto":
        raise AssertionError("the card runs the ViT with vit_block.FUSED_MODE='auto'")
    with torch.inference_mode():
        try:
            vb.FUSED_MODE = "force"
            want = cpu_model(batch, k_test=cfg.num_answers)
        finally:
            vb.FUSED_MODE = "auto"
        reset_launches()
        got = card_model({k: v.to(device) for k, v in batch.items()}, k_test=cfg.num_answers)
        torch.cuda.synchronize()
        launches = read_launches()
    idle = [k for k, n in launches.items() if n == 0 and k not in OFF_PATH + BACKWARD_ONLY]
    if idle:
        raise AssertionError(f"reference: kernels not launched on the card: {idle}")
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
    log(f"reference (tiny config, f32, fused scoring and ViT, card vs CPU): max abs err "
        f"{json.dumps(worst)}; card launches {json.dumps(launches)}")


STAGES = ("detector", "vit", "twin encoder", "decoder 2D", "decoder 3D")


def stage_times(model, run, reps: int = 3) -> tuple[dict, dict]:
    """ms of each stage in a ``run()``, on the card and on the host: CUDA
    events, and the host clock, before and after each stage's module calls,
    summed over its calls in a run (a decoder runs twice, the first-token
    pass and the scoring pass), medians of ``reps`` runs. The host's span
    is the time it takes to issue a stage's work (and to wait where the
    stage synchronises); where it exceeds the card's work, the card's span
    is the host's less the lead the host had when the stage began."""
    blip = model.blip_model
    modules = dict(zip(STAGES, (model.detector, blip.visual_encoder, blip.text_encoder,
                                blip.text_decoder, blip._decoder_scene())))
    spans, host = {}, {}
    handles = []
    for name, mod in modules.items():
        def pre(_m, _args, name=name):
            spans[name].append([torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True)])
            spans[name][-1][0].record()
            host[name].append(time.perf_counter())

        def post(_m, _args, _out, name=name):
            spans[name][-1][1].record()
            host[name][-1] = time.perf_counter() - host[name][-1]

        handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    runs, host_runs = [], []
    try:
        for _ in range(reps):
            spans.update({name: [] for name in STAGES})
            host.update({name: [] for name in STAGES})
            torch.cuda.synchronize()
            run()
            torch.cuda.synchronize()
            runs.append({name: sum(a.elapsed_time(b) for a, b in spans[name]) for name in STAGES})
            host_runs.append({name: sum(host[name]) * 1e3 for name in STAGES})
    finally:
        for handle in handles:
            handle.remove()
    return ({name: statistics.median(r[name] for r in runs) for name in STAGES},
            {name: statistics.median(r[name] for r in host_runs) for name in STAGES})


def expected_launches(cfg) -> dict:
    """Kernel launches of one rank forward, from the config: one FPS and one
    ball query per main-path shape; each scoring pass runs every decoder
    layer (``LAUNCHES_PER_LAYER`` launches each) and one vocabulary pass;
    the ViT runs every block (``LAUNCHES_PER_BLOCK``) and one more LayerNorm
    (its final norm); no path runs the gather."""
    from bridgeqa_tpu_torch.ops.scoring_layer import LAUNCHES_PER_LAYER
    from bridgeqa_tpu_torch.ops.vit_block import LAUNCHES_PER_BLOCK

    layers, depth = decoder_layers(cfg), vit_depth(cfg)
    counts = {"fps": len(FPS_SHAPES), "ball_query_stripes": len(BQ_SHAPES),
              **{k: n * layers * SCORING_PASSES for k, n in LAUNCHES_PER_LAYER.items()},
              "vocab_loss": SCORING_PASSES, "vit_attention": 0, "gather_rows": 0,
              "ball_query_backward": 0}
    for k, n in LAUNCHES_PER_BLOCK.items():
        counts[k] += n * depth
    counts["scoring_layernorm"] += 1
    return counts


def main_config():
    from bridgeqa_tpu_torch.models.bridgeqa import BridgeQAConfig

    return BridgeQAConfig(num_answers=NUM_ANSWERS, input_feature_dim=1)


def decoder_layers(cfg) -> int:
    return cfg.blip.decoder_layers or cfg.blip.med.num_hidden_layers


def vit_depth(cfg) -> int:
    """Blocks of the config's ViT (``models/vit.py::create_vit``)."""
    return {"base": 12, "large": 24}.get(cfg.blip.vit, cfg.blip.vit_custom_depth)


def phase_main_path(device, reps: int = 5):
    from bridgeqa_tpu_torch.models.layers import set_compute_dtype
    from bridgeqa_tpu_torch.ops import vit_block as vb

    cfg = main_config()
    if cfg.blip.med.fused_scoring != "auto" or vb.FUSED_MODE != "auto":
        raise AssertionError("the main path runs with fused_scoring='auto' and "
                             "vit_block.FUSED_MODE='auto'")
    t0 = time.perf_counter()
    model = set_compute_dtype(build_model(cfg, device), torch.bfloat16)
    batch = make_batch(cfg, BATCH, NUM_POINTS, IMAGE_SIZE, QUESTION_LEN, ANSWER_LEN, device)
    torch.cuda.synchronize()
    log(f"main path: model built and weights drawn in {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters")
    expected = expected_launches(cfg)

    def forward():
        return model(batch, inference="rank", k_test=K_TEST)

    with torch.inference_mode():
        reset_launches()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        out = forward()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = read_launches()
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
            **{f"{n} {k} launches": launches[k] == n for k, n in expected.items()},
        }
        log(f"main path: first forward {first_s:.3f} s, peak memory {peak_gb:.2f} GB, "
            f"launches {json.dumps(launches)}, expected {json.dumps(expected)}")
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"main path checks failed: {failed}")

        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        stages, host_stages = stage_times(model, forward)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels run on one stream, so their durations add up to the busy time
    busy_ms = sum(e.device_time_total for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    averages = prof.key_averages()
    copies = [e for e in averages if e.key == "aten::copy_"]
    log(f"profiled forward: aten::copy_ {sum(e.count for e in copies)} calls, "
        f"{sum(e.device_time_total for e in copies) / 1e3:.2f} ms of device time")
    table = averages.table(sort_by="cuda_time_total", row_limit=40)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "profile_main_path.txt").write_text(table)
    log("\n".join(table.splitlines()[:25]))
    log(f"profiled forward: {busy_ms:.1f} ms of device time in {wall_ms:.1f} ms of wall time "
        f"(busy {busy_ms / wall_ms:.0%})")
    latency = statistics.median(times)
    log(f"main path: rank forward at batch {BATCH}, bf16: median {latency * 1e3:.1f} ms over "
        f"{reps} runs ({', '.join(f'{t * 1e3:.1f}' for t in times)}), "
        f"{BATCH / latency:.2f} QA pairs/s")
    log(f"main path stages (ms of one forward, median of 3): "
        f"{json.dumps({k: round(v, 2) for k, v in stages.items()})}, sum {sum(stages.values()):.1f}")
    log(f"main path stages on the host (ms to issue each stage's work, median of 3): "
        f"{json.dumps({k: round(v, 2) for k, v in host_stages.items()})}, "
        f"sum {sum(host_stages.values()):.1f}")
    return launches


# generate: 2 x 5 beams a question, answers of up to 20 tokens (the BLIP
# config's defaults)
GEN_BEAMS = 5
GEN_MAX_LEN = 20
# the rescored beams' tolerance (``phase_generate``)
RESCORE_REL_TOL = 0.02


# the 2D decoder's attention value and output kernels are scaled by this
# (``sharpen_decoder``)
ATTENTION_GAIN = 10.0


def sharpen_decoder(blip) -> None:
    """Make the drawn 2D decoder's choices decisive and dependent on what it
    attends to: add ``RandomState(1).randn(V) * 4`` to its LM head bias (an
    f32 parameter the head reads as it is), since random weights give
    near-uniform logits over the vocabulary, whose beam choices sit on ~1e-5
    ties that a sum in another order can flip; and scale its self- and
    cross-attention's value and output kernels by ``ATTENTION_GAIN``, since
    at the initialiser's std of 0.02 a layer's attention hardly moves its
    output, and a cache that held the wrong keys and values would go
    unseen. Call it before ``set_compute_dtype``."""
    dec = blip.text_decoder
    pattern = np.random.RandomState(1).randn(dec.cls.bias.shape[0]).astype(np.float32) * 4.0
    with torch.no_grad():
        dec.cls.bias += torch.from_numpy(pattern).to(dec.cls.bias.device)
        for layer in dec.bert.encoder.layer:
            for attention in (layer.attention, layer.crossattention):
                attention.self.value.weight.mul_(ATTENTION_GAIN)
                attention.output.dense.weight.mul_(ATTENTION_GAIN)


class TwinStates:
    """Keeps the twin encoder's (h2d, h3d) of the model's last forward."""

    def __init__(self, model):
        self.states = None
        self.handle = model.blip_model.text_encoder.register_forward_hook(self._keep)

    def _keep(self, _module, _args, out):
        self.states = out

    def remove(self):
        self.handle.remove()


def cached_beams(blip, h2d, h3d, question_mask, num_beams: int = GEN_BEAMS,
                 max_length: int = GEN_MAX_LEN):
    """``beam_search_cached`` called directly on the states generate
    encoded: every beam of every question, best first, and its score."""
    from bridgeqa_tpu_torch.models.generation import beam_search_cached, interleave_streams

    c = blip.cfg
    k = 2 * num_beams
    cache = blip.text_decoder.init_cache(interleave_streams(h2d, h3d, num_beams),
                                         question_mask.repeat_interleave(k, dim=0), max_length)
    return beam_search_cached(blip.text_decoder.decode_step, cache, h2d.shape[0], k,
                              bos_token_id=c.bos_token_id, eos_token_id=c.sep_token_id,
                              pad_token_id=c.pad_token_id, max_length=max_length,
                              min_length=c.generate_min_length)


def phase_generate_reference(device):
    """A tiny generate forward on the card (kernels, f32) against the same
    weights on the CPU (plain versions, f32; ``vit_block.FUSED_MODE``
    "force" there): 2 x 5 beams, answers of up to 20 tokens, the 2D
    decoder sharpened (``sharpen_decoder``). The generated ids must be
    equal; lang_scores, cluster_ref and the best beams' scores (from
    ``beam_search_cached`` called directly on each side's encoded states)
    within 1e-3 (the two devices sum matrix products in another order). The
    detector and ViT kernels must launch on the card, the scoring attentions
    and the vocabulary pass must not."""
    from bridgeqa_tpu_torch.ops import vit_block as vb

    cfg = tiny_config()
    cpu_model = build_model(cfg, torch.device("cpu"), seed=5)
    gen = torch.Generator().manual_seed(5)
    perturb_affine(cpu_model.blip_model.text_decoder, gen)
    perturb_affine(cpu_model.blip_model.visual_encoder, gen)
    sharpen_decoder(cpu_model.blip_model)
    card_model = copy.deepcopy(cpu_model).to(device)
    batch = make_batch(cfg, 2, 4096, 64, 20, 6, torch.device("cpu"), seed=8)
    results = []
    for model, on_card in ((cpu_model, False), (card_model, True)):
        states = TwinStates(model)
        try:
            with torch.inference_mode():
                vb.FUSED_MODE = "auto" if on_card else "force"
                reset_launches()
                out = model({k: v.to(device) if on_card else v for k, v in batch.items()},
                             inference="generate")
                launches = read_launches()
                h2d, h3d = states.states
                _, scores = cached_beams(model.blip_model, h2d, h3d, batch["question_mask"]
                                         .to(h2d.device))
        finally:
            vb.FUSED_MODE = "auto"
            states.remove()
        results.append((out, scores[:, 0], launches))
    (want, want_best, _), (got, got_best, launches) = results
    torch.cuda.synchronize()
    idle = [k for k in ("fps", "ball_query_stripes", "scoring_gemm", "vit_attention",
                        "scoring_layernorm") if launches[k] == 0]
    off = [k for k in ("scoring_attention", "vocab_loss", "gather_rows", "ball_query_backward")
           if launches[k]]
    if idle or off:
        raise AssertionError(f"generate reference: not launched {idle}, launched off the "
                             f"generate path {off}")
    if not torch.equal(got["generated_ids"].cpu(), want["generated_ids"]):
        raise AssertionError(f"generate reference: ids differ: card {got['generated_ids']} "
                             f"CPU {want['generated_ids']}")
    worst = {key: float((got[key].cpu().float() - want[key].float()).abs().max())
             for key in ("lang_scores", "cluster_ref")}
    worst["best beam scores"] = float((got_best.cpu() - want_best).abs().max())
    if not all(err <= 1e-3 for err in worst.values()):
        raise AssertionError(f"generate reference: card and CPU differ by {worst}")
    log(f"generate reference (tiny config, f32, 2 x {GEN_BEAMS} beams, card vs CPU): ids equal "
        f"{want['generated_ids'].tolist()}; max abs err {json.dumps(worst)}; card launches "
        f"{json.dumps(launches)}")


def expected_generate_launches(cfg) -> dict:
    """Kernel launches of one generate forward, from the config: one FPS and
    one ball query per main-path shape and the ViT's blocks and final norm
    (as ``expected_launches``); the decoder steps run the module path (JAX
    decodes in plain XLA), so no scoring attention, no vocabulary pass, and
    the GEMM and the LayerNorm only for the ViT."""
    from bridgeqa_tpu_torch.ops.vit_block import LAUNCHES_PER_BLOCK

    counts = {"fps": len(FPS_SHAPES), "ball_query_stripes": len(BQ_SHAPES),
              "scoring_gemm": 0, "scoring_attention": 0, "scoring_layernorm": 1,
              "vocab_loss": 0, "vit_attention": 0, "gather_rows": 0, "ball_query_backward": 0}
    for k, n in LAUNCHES_PER_BLOCK.items():
        counts[k] += n * vit_depth(cfg)
    return counts


def generate_stage_times(model, run, reps: int = 3) -> tuple[dict, dict]:
    """ms of each stage of a generate ``run()`` on the card (CUDA events)
    and on the host (its time to issue the stage's work), medians of
    ``reps`` runs: detector, ViT and twin encoder (hooks on their modules),
    cache init (``init_cache``), the decode loop (from the first decode
    step to the heads: every step's decoder pass, top-k over the candidates
    and reorder of the cache), of which the decoder passes alone, per step,
    and the heads (from the 2D/3D fusion to the end of the forward: fusion,
    lang_cls, the grounding head)."""
    blip = model.blip_model
    dec = blip.text_decoder
    marks = {}

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.setdefault(name, []).append((ev, time.perf_counter()))

    def timed(name, fn):
        def call(*args, **kwargs):
            mark(f"{name} start")
            result = fn(*args, **kwargs)
            mark(f"{name} end")
            return result
        return call

    handles = []
    for name, mod in (("detector", model.detector), ("vit", blip.visual_encoder),
                      ("twin encoder", blip.text_encoder)):
        handles.append(mod.register_forward_pre_hook(lambda *_, n=name: mark(f"{n} start")))
        handles.append(mod.register_forward_hook(lambda *_, n=name: mark(f"{n} end")))
    handles.append(blip.lowrank_2d.register_forward_pre_hook(lambda *_: mark("heads start")))
    dec.init_cache = timed("cache init", dec.init_cache)
    dec.decode_step = timed("step", dec.decode_step)
    runs, host_runs = [], []
    try:
        for _ in range(reps):
            marks.clear()
            torch.cuda.synchronize()
            run()
            mark("end")
            torch.cuda.synchronize()

            def span(a, b, i=0, j=-1):
                (ea, ta), (eb, tb) = marks[a][i], marks[b][j]
                return ea.elapsed_time(eb), (tb - ta) * 1e3

            steps = len(marks["step start"])
            spans = {name: span(f"{name} start", f"{name} end")
                     for name in ("detector", "vit", "twin encoder", "cache init")}
            spans["decode loop"] = span("step start", "heads start")
            spans["decoder passes"] = tuple(
                sum(span("step start", "step end", i, i)[h] for i in range(steps))
                for h in (0, 1))
            spans["decode step"] = tuple(x / steps for x in spans["decode loop"])
            spans["heads"] = span("heads start", "end")
            runs.append({k: v[0] for k, v in spans.items()})
            host_runs.append({k: v[1] for k, v in spans.items()})
    finally:
        for handle in handles:
            handle.remove()
        del dec.init_cache, dec.decode_step
    return ({k: statistics.median(r[k] for r in runs) for k in runs[0]},
            {k: statistics.median(r[k] for r in host_runs) for k in runs[0]})


def profile_table(prof, path: Path) -> tuple[float, int, int, float]:
    """(device ms, card records, aten::copy_ calls, their device ms) of a
    profiled region; its table by kernel into ``path``."""
    from torch.autograd import DeviceType

    work = [e for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
    averages = prof.key_averages()
    copies = [e for e in averages if e.key == "aten::copy_"]
    path.write_text(averages.table(sort_by="cuda_time_total", row_limit=40))
    return (sum(e.duration_ns() for e in work) / 1e6, len(work), sum(e.count for e in copies),
            sum(e.device_time_total for e in copies) / 1e3)


def phase_generate(device, reps: int = 5):
    """Full-width open-ended generation: ``BridgeQA.forward(batch,
    inference="generate")`` at batch 8 in bf16, 2 x 5 beams, answers of up
    to 20 tokens, the main path's config and inputs, random weights from a
    seed and the 2D decoder sharpened (``sharpen_decoder``). Launch counts
    are zeroed just before the forward and read just after, and must equal
    ``expected_generate_launches``; the ids must be well formed (bos first,
    only pad after the first [SEP]) and lang_scores and cluster_ref finite.

    KV-cache consistency: ``beam_search_cached`` called directly on the
    states the forward encoded (under ``torch.cuda.set_sync_debug_mode(
    "error")``: no step may wait for the card) must give the forward's ids
    as its best beams; then every beam (each question's best among them)
    is rescored by one teacher-forced full-prefix pass of the 2D decoder
    against its question's 2D states (every beam descends from row 0, the
    2D row: only beam 0 is alive at the first step, and a beam carries its
    cross K/V), its log-probs summed up to and including the first [SEP].
    Tolerance:
    the two passes compute the same function in bf16, with products of
    other shapes (one token a row against 20), so a stored activation may
    round one bf16 step (2^-8 relative) the other way; allow each token's
    log-prob five such steps, 5 x 2^-8 = 1.95%, rounded to
    ``RESCORE_REL_TOL`` = 2% relative. A sum of terms of one sign (every
    log-prob is negative) keeps the largest relative error of its terms, so
    the bound holds per row. The same rescoring against the 3D states,
    what a cache that kept the 3D rows' K/V would be held to, is printed
    beside it: how far a stream mix-up moves the scores.

    Times follow: the forward's wall (median of ``reps``, each ending in
    ``torch.cuda.synchronize()``) and the QA pairs/s it implies, the stages
    (``generate_stage_times``), one profiled forward (device time, busy
    share, casts, the table by kernel in ``build/profile_generate.txt``) and
    one profiled decode loop alone (``cached_beams``: its card records, its
    device time and the cache reorder's, ``build/profile_generate_loop.txt``),
    and peak memory."""
    from bridgeqa_tpu_torch.models.layers import set_compute_dtype

    cfg = main_config()
    blip_cfg = cfg.blip
    t0 = time.perf_counter()
    model = build_model(cfg, device)
    sharpen_decoder(model.blip_model)
    set_compute_dtype(model, torch.bfloat16)
    batch = make_batch(cfg, BATCH, NUM_POINTS, IMAGE_SIZE, QUESTION_LEN, ANSWER_LEN, device)
    torch.cuda.synchronize()
    log(f"generate: model built and weights drawn in {time.perf_counter() - t0:.1f} s")
    expected = expected_generate_launches(cfg)

    def forward():
        return model(batch, inference="generate")

    states = TwinStates(model)
    with torch.inference_mode():
        reset_launches()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        out = forward()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        states.remove()
        ids = out["generated_ids"]
        sep, pad = blip_cfg.sep_token_id, blip_cfg.pad_token_id
        after_sep = (ids == sep).int().cumsum(1) - (ids == sep).int() > 0
        checks = {
            "generated_ids shape": tuple(ids.shape) == (BATCH, GEN_MAX_LEN),
            "bos first": bool((ids[:, 0] == blip_cfg.bos_token_id).all()),
            "only pad after the first [SEP]": bool((ids[after_sep] == pad).all()),
            "cluster_ref shape": tuple(out["cluster_ref"].shape) == (BATCH, cfg.num_proposal),
            "lang_scores shape": tuple(out["lang_scores"].shape) == (BATCH, cfg.num_object_class),
            "finite": all(bool(torch.isfinite(out[k].float()).all())
                          for k in ("cluster_ref", "lang_scores", "bbox_corner")),
            **{f"{n} {k} launches": launches[k] == n for k, n in expected.items()},
        }
        log(f"generate: first forward {first_s:.3f} s, peak memory {peak_gb:.2f} GB, launches "
            f"{json.dumps(launches)}, expected {json.dumps(expected)}")
        log(f"generate: ids {ids.tolist()}")
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"generate checks failed: {failed}")

        # KV-cache consistency: the direct call, then the teacher-forced rescoring
        h2d, h3d = states.states
        qmask = batch["question_mask"]
        blip = model.blip_model
        # no step may wait for the card: a synchronising call raises here
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            beams, scores = cached_beams(blip, h2d, h3d, qmask)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if not torch.equal(beams[:, 0], ids):
            raise AssertionError("generate: beam_search_cached's best beams differ from the "
                                 "forward's ids")
        k = 2 * GEN_BEAMS
        seqs = beams.reshape(BATCH * k, GEN_MAX_LEN)
        is_sep = (seqs[:, 1:] == sep).int()
        counted = is_sep.cumsum(1) - is_sep == 0  # up to and including the first [SEP]

        def rescore(states):
            logits, _ = blip.text_decoder(seqs, None, states.repeat_interleave(k, dim=0),
                                          qmask.repeat_interleave(k, dim=0))
            logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
            logp = logp.gather(-1, seqs[:, 1:].long()[..., None])[..., 0]
            rescored = torch.where(counted, logp, 0.0).sum(1).reshape(BATCH, k)
            return ((rescored - scores).abs() / scores.abs()).max(dim=1).values

        rel = rescore(h2d)
        # what the check would read if the cache had kept the 3D rows' states
        rel_3d = rescore(h3d)
        log(f"generate: KV-cache consistency, {BATCH * k} beams rescored by a full-prefix pass: "
            f"max rel err per question {[round(float(x), 6) for x in rel]} (tol "
            f"{RESCORE_REL_TOL}); against the 3D states instead "
            f"{[round(float(x), 6) for x in rel_3d]}; best scores "
            f"{[round(float(x), 4) for x in scores[:, 0]]}; tokens scored per beam "
            f"{counted.sum(1).reshape(BATCH, k).tolist()}")
        if not bool((rel <= RESCORE_REL_TOL).all()):
            raise AssertionError(f"generate: cached scores differ from the rescoring by {rel}")

        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        stages, host_stages = generate_stage_times(model, forward)
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        with torch.profiler.profile(activities=activities) as loop_prof:
            cached_beams(blip, h2d, h3d, qmask)
            torch.cuda.synchronize()
    OUT_DIR.mkdir(exist_ok=True)
    busy_ms, records, copies, copy_ms = profile_table(prof, OUT_DIR / "profile_generate.txt")
    loop_ms, loop_records, _, _ = profile_table(loop_prof, OUT_DIR / "profile_generate_loop.txt")
    reorder_ms = sum(e.device_time_total for e in loop_prof.key_averages()
                     if e.key == "aten::index_select") / 1e3
    log(f"generate profiles on {card_name_and_power()}:")
    log("\n".join((OUT_DIR / "profile_generate.txt").read_text().splitlines()[:20]))
    log(f"generate profiled forward: {busy_ms:.1f} ms of device time in {wall_ms:.1f} ms of wall "
        f"time (busy {busy_ms / wall_ms:.0%}), {records} card records, aten::copy_ {copies} "
        f"calls, {copy_ms:.2f} ms of device time")
    log(f"generate profiled decode loop alone (init_cache + {GEN_MAX_LEN - 1} steps): "
        f"{loop_ms:.2f} ms of device time, {loop_records} card records, cache reorder "
        f"(index_select) {reorder_ms:.2f} ms")
    latency = statistics.median(times)
    log(f"generate timings on {card_name_and_power()}:")
    log(f"generate: forward at batch {BATCH}, bf16, 2 x {GEN_BEAMS} beams, {GEN_MAX_LEN} tokens: "
        f"median {latency * 1e3:.1f} ms over {reps} runs "
        f"({', '.join(f'{t * 1e3:.1f}' for t in times)}), {BATCH / latency:.2f} QA pairs/s")
    log(f"generate stages (ms of one forward on the card, median of 3): "
        f"{json.dumps({k: round(v, 3) for k, v in stages.items()})}")
    log(f"generate stages on the host (ms to issue each stage's work, median of 3): "
        f"{json.dumps({k: round(v, 3) for k, v in host_stages.items()})}")
    return launches


# train: the full-width train step at the JAX bench's batch (bench.py's
# train phase) and the ball query's backward at its shapes
TRAIN_BATCH = 16
TRAIN_STEPS = 5
TRAIN_MAX_OBJ = 8
# (name, N, M, nsample, radius, feature channels, calls a train step): the
# vote aggregation's query is the only one whose inputs want a gradient;
# SA1's (with its height channel) is checked, not run by the path
BQ_BACKWARD_SHAPES = [("votes", 1024, 256, 16, 0.3, 0, 1),
                      ("sa1", NUM_POINTS, 2048, 64, 0.2, 1, 0)]
BQ_BACKWARD_TOL = 1e-5


def phase_train_kernels(device, batch: int = TRAIN_BATCH, reps: int = 20):
    """The stripe ball query's backward kernel against its plain version on
    the card, at the vote aggregation's shape and SA1's (with its feature
    channel): the clouds hold padding and duplicate points, the first four
    centres of each cloud sit far from every point (all-empty balls: their
    slots hold index 0 and send their cotangents to point 0), and the
    other balls have stripes with no qualifier of their own, which take the
    ball's first qualifier. The indices come from the forward kernel on the
    same inputs; the cotangents are drawn from a seed. Each of g_xyz,
    g_center and g_feats within ``BQ_BACKWARD_TOL`` of its largest value:
    the kernel adds with f32 atomics in an order that changes from run to
    run, the plain version with ``index_add_`` and a sum. Times are card
    time (``queued_ms``, the outputs' zeroing included); ``library_ms`` is
    one ``index_add_`` of the xyz cotangents, the scatter part alone (no
    PyTorch call also gives the centres' sums)."""
    from bridgeqa_tpu_torch.ops import grouping

    rng = np.random.RandomState(11)
    rows = []
    for name, n, m, ns, radius, nf, calls in BQ_BACKWARD_SHAPES:
        xyz_np = make_cloud(rng, batch, n)
        centres = xyz_np[:, rng.permutation(n)[:m]].copy()
        centres[:, :4] += 100.0  # empty balls
        xyz = torch.from_numpy(xyz_np).to(device)
        ctr = torch.from_numpy(centres).to(device)
        feats = torch.from_numpy(rng.rand(batch, n, nf).astype(np.float32)).to(device) if nf else None
        with torch.no_grad():
            idx, _, _ = grouping.ball_query_stripes(radius, ns, xyz, ctr, feats)
        picks, np_padded = grouping.stripe_plan(n, ns)
        stripes = ns // picks
        g_rel = torch.randn(batch, m, ns, 3, device=device)
        g_grouped = torch.randn(batch, m, ns, nf, device=device) if nf else None
        before = grouping.backward_launches
        got = grouping.ball_query_stripes_backward(idx, g_rel, g_grouped, n)
        launched = grouping.backward_launches - before
        want = grouping.ball_query_stripes_backward_plain(idx, g_rel, g_grouped, n)
        torch.cuda.synchronize()
        errs, rel = {}, {}
        for key, g, w in zip(("g_xyz", "g_center", "g_feats"), got, want):
            if w is None:
                continue
            errs[key] = max_err(g, w)
            rel[key] = errs[key] / float(w.abs().max())
        empty = bool((idx[:, :4] == 0).all())
        # slots that took the ball's first qualifier: their stripe had none
        slot_stripe = torch.arange(ns, device=device) // picks
        filled = int(((idx // (np_padded // stripes)) != slot_stripe).sum())
        ms = queued_ms(lambda: grouping.ball_query_stripes_backward(idx, g_rel, g_grouped, n),
                       reps)
        plain_ms = queued_ms(lambda: grouping.ball_query_stripes_backward_plain(
            idx, g_rel, g_grouped, n), reps)
        rows_idx = (idx.long() + n * torch.arange(batch, device=device)[:, None, None]).reshape(-1)
        g_rel_flat = g_rel.reshape(-1, 3)
        target = torch.zeros(batch * n, 3, device=device)
        library_ms = queued_ms(lambda: target.index_add_(0, rows_idx, g_rel_flat), reps)
        slots = batch * m * ns
        nbytes = slots * (4 + 12 + 4 * nf) + batch * n * (12 + 4 * nf) + batch * m * 12
        bound_ms, bound_by = bound(slots * (3 + nf + 3), nbytes, PEAK_F32)
        ok = launched == 1 and empty and all(r <= BQ_BACKWARD_TOL for r in rel.values())
        rows.append(dict(shape=f"{name}: B={batch}, N={n}, M={m}, nsample={ns}, nf={nf}",
                         calls=calls, ok=ok, max_abs_err=max(errs.values()), rel_err=rel, ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by, filled_slots=filled))
        log(f"ball query backward {name}: B={batch}, N={n}, M={m}, ns={ns}, nf={nf}: err / largest "
            f"{json.dumps({k: float(f'{v:.3g}') for k, v in rel.items()})} (tol "
            f"{BQ_BACKWARD_TOL}), empty balls {empty}, {filled} slots filled by the ball's first "
            f"qualifier; kernel {ms:.4f} ms card time, plain {plain_ms:.4f} ms, index_add_ of "
            f"the xyz cotangents {library_ms:.4f} ms (card time, queued_ms), bound "
            f"{bound_ms:.4f} ms ({bound_by})")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"ball query backward: kernel and plain version disagree: {bad}")
    return [dict(name="ball_query_backward", route="cuda",
                 source="bridgeqa_tpu_torch/csrc/ball_query_backward.cu",
                 replaces="bridgeqa_tpu/ops/grouping.py:314",
                 replaces_note="the backward of _ball_query_stripes (custom VJP "
                               "_ball_query_stripes_bwd, :314, and _feats_bwd, :354): XLA in "
                               "JAX, no TPU kernel",
                 library_call="index_add_ of the xyz cotangents (the centres' sums not included)",
                 per="one train step: each shape's median times the calls it gets",
                 rows=rows)]


def no_dropout(cfg):
    """``cfg`` with every dropout and drop-path rate 0."""
    med = dataclasses.replace(cfg.blip.med, hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    blip = dataclasses.replace(cfg.blip, med=med, adapter_pdrop=0.0, vit_drop_path_rate=0.0)
    return dataclasses.replace(cfg, blip=blip, head_pdrop=0.0, mcan_pdrop=0.0)


def make_train_batch(cfg, batch: int, num_points: int, image_size: int, question_len: int,
                     answer_len: int, device, seed: int = 0):
    """``make_batch``'s inputs and the labels a train step reads, as
    ``bench.py``'s train phase draws them (``TRAIN_MAX_OBJ`` objects)."""
    out = make_batch(cfg, batch, num_points, image_size, question_len, answer_len, device, seed)
    del out["answer_list_ids"], out["answer_list_mask"]
    rng = np.random.RandomState(seed + 1)
    vmax = min(30000, cfg.blip.med.vocab_size - 2)
    k, na = TRAIN_MAX_OBJ, cfg.num_answers
    f, i = np.float32, np.int32
    arrays = dict(
        answer_ids=rng.randint(1, vmax, (batch, answer_len)),
        answer_mask=np.ones((batch, answer_len), i),
        answer_cat=rng.randint(0, na, (batch,)).astype(i),
        answer_cat_scores=rng.rand(batch, na).astype(f),
        vote_label=(rng.randn(batch, num_points, 9) * 0.1).astype(f),
        vote_label_mask=rng.randint(0, 2, (batch, num_points)).astype(f),
        center_label=rng.randn(batch, k, 3).astype(f),
        box_label_mask=np.ones((batch, k), f),
        sem_cls_label=rng.randint(0, 18, (batch, k)).astype(i),
        size_class_label=rng.randint(0, 18, (batch, k)).astype(i),
        size_residual_label=(rng.randn(batch, k, 3) * 0.1).astype(f),
        heading_class_label=np.zeros((batch, k), i),
        heading_residual_label=np.zeros((batch, k), f),
        ref_center_label=rng.randn(batch, 3).astype(f),
        ref_heading_class_label=np.zeros((batch,), i),
        ref_heading_residual_label=np.zeros((batch,), f),
        ref_size_class_label=rng.randint(0, 18, (batch,)).astype(i),
        ref_size_residual_label=(rng.randn(batch, 3) * 0.1).astype(f),
        ref_obj_mask=np.ones((batch,), i),
        object_cat=rng.randint(0, 18, (batch,)).astype(i),
    )
    out["answer_ids"] = out["question_ids"].new_tensor(arrays.pop("answer_ids"))
    out["answer_ids"][:, 0] = cfg.blip.bos_token_id
    out.update({k: torch.from_numpy(v).to(device) for k, v in arrays.items()})
    return out


# the losses a train step reports and holds finite
TRAIN_LOSSES = ("loss", "vote_loss", "objectness_loss", "box_loss", "sem_cls_loss", "ref_loss",
                "lang_loss", "answer_loss")


# parameters whose gradient is 0 by construction: a softmax ignores a key
# bias (the med-BERT's and the grounding SGA's: a constant shift of a
# query's scores) and the grounding head's output bias (a shift of every
# proposal's logit), and a BatchNorm takes out a bias added before it; their
# gradients are rounding noise on both devices
ZERO_GRADIENT = ("attention.self.key.bias", "crossattention.self.key.bias", "linear_k.bias",
                 "vgen.conv1.bias", "vgen.conv2.bias", "object_cls.fc2.bias")


def _grads(model) -> dict:
    return {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()
            if p.grad is not None}


def phase_train_reference(device):
    """One train step of the tiny config (``tiny_config``), every dropout
    rate 0, BatchNorm in train mode (momentum 0.1), on the card (kernels:
    FPS, the ball query and its backward) and on the CPU (plain versions),
    same weights and batch, ``OptimConfig()``. The model runs in f64; the
    point kernels and their plain versions compute in f32 on both sides, as
    always. In f32 the comparison could not read the kernels: the detector's
    BatchNorm gradients are cancelling sums that f32 gets wrong by up to a
    few percent relative L2 on either device; the same step in f32 on both
    runs too, and its worst gradient against the CPU's f64 step is printed
    (not held), beside the f64 comparison that is.
    Held to: the loss and each sub-loss within 1e-4 relative; every
    parameter's gradient (after the clip) within 1e-3 relative L2, except
    those 0 by construction (``ZERO_GRADIENT``), which must stay within 1e-5
    of the largest gradient on both sides; each updated running statistic
    within 1e-5 relative L2. The two devices sum products and scatter
    cotangents in another order. FPS, the ball query and the backward
    kernel must launch on the card, the fused scoring and ViT kernels must
    not (train mode and grad refuse both gates)."""
    from bridgeqa_tpu_torch.ops import vit_block as vb
    from bridgeqa_tpu_torch.train.optim import build_optimizer
    from bridgeqa_tpu_torch.train.step import train_step

    cfg = no_dropout(tiny_config())
    base = build_model(cfg, torch.device("cpu"), seed=9)
    batch = make_train_batch(cfg, 2, 4096, 64, 20, 6, torch.device("cpu"), seed=12)
    if vb.FUSED_MODE != "auto":
        raise AssertionError("the train reference runs with vit_block.FUSED_MODE='auto'")
    results = {}
    for name, dtype, dev in (("cpu f64", torch.float64, torch.device("cpu")),
                             ("card f64", torch.float64, device),
                             ("cpu f32", torch.float32, torch.device("cpu")),
                             ("card f32", torch.float32, device)):
        model = copy.deepcopy(base).to(device=dev, dtype=dtype)
        reset_launches()
        metrics = train_step(model, build_optimizer(model),
                             {k: (v.to(dtype) if v.is_floating_point() else v).to(dev)
                              for k, v in batch.items()}, bn_momentum=0.1)
        launches = read_launches()
        stats = {n: b.detach().double().cpu() for n, b in model.named_buffers()
                 if n.endswith(("running_mean", "running_var"))}
        results[name] = ({k: float(metrics[k]) for k in TRAIN_LOSSES}, _grads(model), stats,
                         launches)
    # how far f32 alone takes each device from the f64 step (printed, not held)
    f32_worst = {name: max(float((results[name][1][n] - g).norm() / g.norm())
                           for n, g in results["cpu f64"][1].items()
                           if not n.endswith(ZERO_GRADIENT) and float(g.norm()) > 1e-10)
                 for name in ("cpu f32", "card f32")}
    want, want_g, want_s, _ = results["cpu f64"]
    got, got_g, got_s, launches = results["card f64"]
    failures = []
    loss_rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in TRAIN_LOSSES}
    failures += [f"{k} {loss_rel[k]:.2e}" for k in TRAIN_LOSSES if loss_rel[k] > 1e-4]

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm()) if float(b.norm()) >= 1e-10 or \
            float(a.norm()) >= 1e-10 else 0.0

    if set(got_g) != set(want_g):
        failures.append(f"gradients of {sorted(set(got_g) ^ set(want_g))[:5]} on one side only")
    largest = max(float(g.norm()) for g in want_g.values())
    noise = sorted((max(float(got_g[n].norm()), float(want_g[n].norm())) / largest, n)
                   for n in want_g if n.endswith(ZERO_GRADIENT))
    failures += [f"grad {n} not 0: {r:.2e} of the largest" for r, n in noise if r > 1e-5]
    grad_rel = sorted(((rel_l2(got_g[n], want_g[n]), n) for n in want_g
                       if n in got_g and not n.endswith(ZERO_GRADIENT)), reverse=True)
    failures += [f"grad {n} {r:.2e}" for r, n in grad_rel if r > 1e-3]
    stat_rel = sorted(((rel_l2(got_s[n], want_s[n]), n) for n in want_s), reverse=True)
    failures += [f"stat {n} {r:.2e}" for r, n in stat_rel if r > 1e-5]
    idle = [k for k in ("fps", "ball_query_stripes", "ball_query_backward") if launches[k] == 0]
    off = [k for k in ("scoring_gemm", "scoring_attention", "scoring_layernorm", "vocab_loss",
                       "vit_attention", "gather_rows") if launches[k]]
    if idle or off:
        failures.append(f"not launched {idle}, launched off the train path {off}")
    log(f"train reference (tiny config, f64 with the point kernels in f32, card vs CPU): loss "
        f"rel err "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in loss_rel.items()})}; worst gradients "
        f"{[(n, float(f'{r:.3g}')) for r, n in grad_rel[:3]]} of {len(grad_rel)}, those 0 by "
        f"construction at most {noise[-1][0]:.2g} of the largest; worst "
        f"statistics {[(n, float(f'{r:.3g}')) for r, n in stat_rel[:2]]}; card launches "
        f"{json.dumps(launches)}; the same step in f32, worst gradient against the CPU's f64 "
        f"step (relative L2): {json.dumps({k: float(f'{v:.3g}') for k, v in f32_worst.items()})}")
    if failures:
        raise AssertionError(f"train reference: card and CPU differ: {failures[:10]}")


def expected_train_launches(cfg) -> dict:
    """Kernel launches of one train step, from the config: the detector runs
    FPS and the stripe ball query once per main-path shape (SA1-SA4 and the
    vote aggregation: 5 each); the backward kernel once, for the vote
    aggregation's query, whose inputs (the votes, made by the voting
    layers) are the only ones that want a gradient (SA1's points and height
    channel are inputs, SA2-SA4's centres come from FPS over them, and
    their features go through ``group_points``, not the kernel); every fused
    scoring and ViT kernel 0, as train mode and grad refuse both gates
    (JAX's ``not deterministic``)."""
    counts = {k: 0 for k in expected_launches(cfg)}
    counts.update(fps=len(FPS_SHAPES), ball_query_stripes=len(BQ_SHAPES), ball_query_backward=1)
    return counts


def param_groups_norms(optimizer) -> dict:
    """{group: the L2 norms of its parameters} (on the card)."""
    return {g["label"]: torch.stack([p.detach().float().norm() for p in g["params"]])
            for g in optimizer.param_groups}


def phase_train(device, steps: int = TRAIN_STEPS):
    """Full-width training: ``train_step`` (``BridgeQA.forward(batch,
    inference="loss")`` in train mode, ``get_loss``, the backward, the
    3-group AdamW of ``build_optimizer(model, OptimConfig())``) on the main
    path's config at batch 16, as ``bench.py`` trains: ``remat=True,
    remat_mode="block"``, 40k-point scenes with synthetic labels
    (``make_train_batch``), f32 parameters with bf16 compute (the products
    cast the parameters in the graph), the config's dropout rates drawn from
    a seeded generator on the card, BN momentum 0.1.

    One warm-up step, then ``steps`` steps, each with the launch counts set
    to 0 just before it and read just after: they must equal
    ``expected_train_launches``; every loss finite at every step, every
    gradient finite after every step, and the parameters of each of the
    three groups changed. Times: the step's wall (median, host clock around a
    step that ends in ``torch.cuda.synchronize()``) and samples/s; one more
    step split into forward (with the losses), backward and optimizer
    (with the copies' refresh) by CUDA events at ``train_step``'s marks; peak memory of a step; one
    profiled step (device time, busy share, the table by kernel in
    ``build/profile_train_step.txt``); then the same step without remat, a
    model built anew, for its peak memory."""
    from bridgeqa_tpu_torch.models.layers import set_compute_dtype
    from bridgeqa_tpu_torch.train.optim import build_optimizer
    from bridgeqa_tpu_torch.train.step import train_step

    base = main_config()
    cfg = dataclasses.replace(base, blip=dataclasses.replace(base.blip, remat=True,
                                                              remat_mode="block"))
    t0 = time.perf_counter()
    model = set_compute_dtype(build_model(cfg, device), torch.bfloat16)
    optimizer = build_optimizer(model)
    batch = make_train_batch(cfg, TRAIN_BATCH, NUM_POINTS, IMAGE_SIZE, QUESTION_LEN, ANSWER_LEN,
                             device)
    gen = torch.Generator(device=device).manual_seed(7)
    torch.cuda.synchronize()
    log(f"train: model and optimizer built in {time.perf_counter() - t0:.1f} s, groups "
        f"{json.dumps({g['label']: len(g['params']) for g in optimizer.param_groups})}")
    expected = expected_train_launches(cfg)

    def step():
        return train_step(model, optimizer, batch, bn_momentum=0.1, generator=gen)

    before = param_groups_norms(optimizer)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    walls, losses, failed = [], [], []
    for k in range(steps):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = read_launches()
        grads_finite = bool(torch.stack([p.grad.isfinite().all() for p in model.parameters()
                                         if p.grad is not None]).all())
        values = {key: float(metrics[key]) for key in TRAIN_LOSSES}
        losses.append(values)
        if not all(np.isfinite(v) for v in values.values()):
            failed.append(f"step {k}: losses {values}")
        if not grads_finite:
            failed.append(f"step {k}: a gradient is not finite")
        wrong = {key: (launches[key], n) for key, n in expected.items() if launches[key] != n}
        if wrong:
            failed.append(f"step {k}: launches (got, expected) {wrong}")
    after = param_groups_norms(optimizer)
    moved = {g: int((after[g] != before[g]).sum()) for g in before}
    if set(moved) != {"blip", "blip3d", "other"} or not all(moved.values()):
        failed.append(f"parameters changed per group {moved}")
    log(f"train: launches per step {json.dumps(launches)}, expected {json.dumps(expected)}; "
        f"parameters changed per group {json.dumps(moved)}")
    log(f"train: losses per step {[round(v['loss'], 3) for v in losses]}; last "
        f"{json.dumps({k: round(v, 4) for k, v in losses[-1].items()})}")
    if failed:
        raise AssertionError(f"train checks failed: {failed}")

    # one step split by CUDA events at train_step's marks: forward with the
    # losses, backward, optimizer with the copies' refresh
    events = {}

    def mark(part):
        events[part] = torch.cuda.Event(enable_timing=True)
        events[part].record()

    torch.cuda.synchronize()
    mark("start")
    train_step(model, optimizer, batch, bn_momentum=0.1, generator=gen, mark=mark)
    torch.cuda.synchronize()
    parts = list(events)
    split = {part: events[before].elapsed_time(events[part])
             for before, part in zip(parts, parts[1:])}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    OUT_DIR.mkdir(exist_ok=True)
    busy_ms, records, copies, copy_ms = profile_table(prof, OUT_DIR / "profile_train_step.txt")
    del model, optimizer, prof
    torch.cuda.empty_cache()

    # the same step without remat, for its memory
    model = set_compute_dtype(build_model(base, device), torch.bfloat16)
    optimizer = build_optimizer(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    metrics = train_step(model, optimizer, batch, bn_momentum=0.1, generator=gen)
    torch.cuda.synchronize()
    peak_no_remat_gb = torch.cuda.max_memory_allocated(device) / 1e9
    if not np.isfinite(float(metrics["loss"])):
        raise AssertionError("train: the step without remat gave a loss that is not finite")
    del model, optimizer
    torch.cuda.empty_cache()

    latency = statistics.median(walls)
    log(f"train timings on {card_name_and_power()}:")
    log("\n".join((OUT_DIR / "profile_train_step.txt").read_text().splitlines()[:20]))
    log(f"train: step at batch {TRAIN_BATCH}, bf16 compute, remat 'block': warm-up "
        f"{warm_s:.2f} s, median {latency * 1e3:.1f} ms over {steps} steps "
        f"({', '.join(f'{t * 1e3:.1f}' for t in walls)}), {TRAIN_BATCH / latency:.2f} samples/s; "
        f"forward {split['forward']:.1f} ms, backward {split['backward']:.1f} ms, optimizer "
        f"{split['optimizer']:.1f} ms (CUDA events, one step)")
    log(f"train profiled step: {busy_ms:.1f} ms of device time in {wall_ms:.1f} ms of wall time "
        f"(busy {busy_ms / wall_ms:.0%}), {records} card records, aten::copy_ {copies} calls, "
        f"{copy_ms:.2f} ms")
    log(f"train: peak memory {peak_gb:.2f} GB with remat, {peak_no_remat_gb:.2f} GB without")
    return launches


def report_ratios(kernels: dict) -> None:
    """Each product's time over ``F.linear``'s, and the per-forward sums of
    both (decoder and ViT shapes, each shape's ms times its calls); the ViT
    attention's and the scoring attentions' times over
    ``scaled_dot_product_attention``'s (the scoring attentions' both card
    time, the ViT attention's both event-loop time); the traces
    ``device_ms`` took again."""
    rows = kernels["scoring_gemm"]["rows"]
    for r in rows:
        log(f"scoring_gemm {r['shape']}: {r['ms']:.4f} ms, F.linear {r['library_ms']:.4f} ms, "
            f"ratio {r['ms'] / r['library_ms']:.2f}")
    for part, keep in (("decoder", lambda r: not r["shape"].startswith("vit")),
                       ("vit", lambda r: r["shape"].startswith("vit")), ("all", lambda r: True)):
        ms = sum(r["ms"] * r["calls"] for r in rows if keep(r))
        lib = sum(r["library_ms"] * r["calls"] for r in rows if keep(r))
        log(f"scoring_gemm per forward, {part} shapes: {ms:.3f} ms, F.linear {lib:.3f} ms, "
            f"ratio {ms / lib:.2f}")
    for name in ("vit_attention", "scoring_attention"):
        for r in kernels[name]["rows"]:
            log(f"{name} {r['shape']}: {r['ms']:.4f} ms, scaled_dot_product_attention "
                f"{r['library_ms']:.4f} ms, ratio {r['ms'] / r['library_ms']:.2f}")
    log(f"device_ms: {len(dropped_traces)} trace(s) lacked card records and were taken again "
        f"(reps, launches, card records): {dropped_traces}")


def summarize(kernel, launches: int, by_path: dict) -> dict:
    """One kernel's record of the kernels line: its times and bound over
    the calls of one forward (each shape's median times its ``calls``), or
    over what ``per`` names for a kernel no path runs; ``launches`` from the
    rank forward and ``launches_by_path`` from each path's forward."""
    rows = kernel.pop("rows")
    per = kernel.pop("per", "one rank forward: each shape's median times the calls it gets")

    def total(key):
        if any(r[key] is None for r in rows):
            return None
        return sum(r[key] * r["calls"] for r in rows)

    by = {}
    for r in rows:
        by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["bound_ms"] * r["calls"]
    return dict(kernel, launches=launches, launches_by_path=by_path,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
                bound_by=max(by, key=by.get), library_ms=total("library_ms"), per=per,
                shapes=rows)


def main() -> int:
    device = phase_device()
    phase_build()
    cfg = main_config()
    kernels = phase_kernels(device) + phase_scoring_kernels(device, decoder_layers(cfg))
    kernels += phase_vit_kernels(device, {k["name"]: k for k in kernels}, vit_depth(cfg))
    report_ratios({k["name"]: k for k in kernels})
    wrapper_host_us(device)
    phase_decoder_pass(device)
    phase_vit_pass(device)
    phase_reference(device)
    launches = phase_main_path(device)
    phase_generate_reference(device)
    generate_launches = phase_generate(device)
    kernels += phase_train_kernels(device)
    phase_train_reference(device)
    train_launches = phase_train(device)
    records = []
    for k in kernels:
        name = k["name"]
        path = "train" if name in BACKWARD_ONLY else "rank"
        by_path = {"rank": launches[name], "generate": generate_launches[name],
                   "train": train_launches[name]}
        records.append(dict(summarize(k, by_path[path], by_path), launches_path=path))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
