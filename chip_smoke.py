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
   kernels (the GEMM and the ViT attention in bf16 and f32, FPS's cluster
   kernel, the vocabulary pass and the scoring attentions in bf16 and f32,
   the ball query and its backward);
   disassemble the library (``cuobjdump -sass``) and fail unless every
   instantiation of the bf16 GEMM and the vocabulary pass's bf16 kernel
   hold ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA loads), every instantiation
   of the scoring attentions' pipeline ``UTMALDG``, and the f32 GEMM's, ViT
   attention's, scoring attentions' and vocabulary pass's (3xTF32) ``HMMA``
   (mma.sync).
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
     tile. The f32 scoring attentions and vocabulary pass (3xTF32) also at
     the main path's shapes on f32 inputs against f64 (``f32_route_checks``):
     within 1e-5 of each output's largest value (``F32_ROUTE_TOL``; the sum
     of logits of each row's sum of |logit|), both attentions on the f32
     tensor-core kernel, a single visible key's context bitwise its value.
     Then a
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
   counts such traces, and after five such traces in a row times the loop
   by CUDA events behind a spin kernel instead, ``queued_ms``). The
   scoring-attention and ball-query rows carry the launch their C entry
   reports having made (kernel, grid, and the ring's depth and shared
   memory, or the centres a warp); the main path's attentions must have run
   the tensor-core pipeline. The ball query's log
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
   Then the drivers' default, the same forward in f32 (``predict``, ``eval``
   and validation without ``--bf16``; ``phase_main_path_f32``, about 10 s):
   the f32 instantiations of every fused kernel, launches as derived, the
   latency (median of 3), one profiled forward (device time, each kernel's
   card time, ``build/profile_main_path_f32.txt``), and the f32 module path
   (``fused_scoring="off"``, ``FUSED_MODE = "off"``) on the same weights and
   batch: the top-1 answer of each decoder and of their ensemble equal on
   every row, the largest score difference printed; it fails if a kernel
   launched in the forward shows no card time in its profile, or if an f32
   attention took the CUDA-core kernel. Then each f32 kernel's card time at
   the forward's shapes beside its library call and its bounds (FFMA;
   3xTF32 for the four kernels on that route), the attentions' launch
   records, and ``scaled_dot_product_attention`` f32 at the attentions'
   shapes under each backend that takes f32 and the default, with the
   backend the default took (``f32_kernel_rows``, ``sdpa_backends``).
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
     reductions add in another order); ten calls profiled put exactly ten
     kernels on the card, one a call (the kernel zeroes its outputs: no
     fill, no memset); its launch (blocks, cluster, threads), card times beside the
     bound and one ``index_add_``, and the timer that read them.
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
8. drivers (``phase_drivers``): the port's entry points as a user runs them,
   each script's ``main(argv)`` on ``--synthetic`` data at the full width of
   the main path's config, ``--bf16 --remat``, batch 16, two feed workers:
   ``train --stage DET`` (2 steps), the VQA stage on the DET graft (2 epochs
   of 2 steps, validated; 3 steps before phase 9 came), ``--use_checkpoint``
   (2 steps, traced),
   ``predict --open_ended``, ``eval --qa --detection``, ``score``. Every
   artifact written, every logged metric finite, each loop step's and eval
   forward's launches as derived, the graft's parameters copied and BN
   statistics kept, the resumed state bitwise the saved one, no host sync
   between log points (``--check_syncs``); the loop's samples/s with the
   feed beside phase 7's resident step, the feed's fetch mean, the busy
   share of a traced loop step, the phase's seconds and peak memory.
9. parallelism (``phase_parallel``): two ranks (``python3 chip_smoke.py
   --parallel-rank R 2 PORT``, fresh processes) share the card over gloo,
   since NCCL refuses two ranks on one device: phase 7's config, dropout
   off, global batch 16. DDP in f32 against one process on the whole batch
   (losses, every gradient after the all-reduce, BatchNorm statistics,
   the second step's loss), the same f32 check at the tiny config in f64,
   three bf16 DDP steps timed per rank, ``tp=2`` against the same
   reference, and a sharded eval batch with the fused kernels; launches
   per rank as derived. Then the ``train`` driver under ``python -m
   torch.distributed.run --nproc_per_node 1`` (NCCL at world size 1
   through DDP, ``--check_syncs``): DET, VQA and a resume, each run's files
   written once. Two ranks sharing one card check correctness, not
   scaling. Tolerances and cuts in ``phase_parallel``'s docstring.
10. the non-main paths (``phase_nonmain``), each at full width in bf16:
   - the exact scan-order ball query's kernel (``csrc/ball_query_exact.cu``)
     bitwise against its plain version at the five main-path shapes, SA1
     with an odd nsample (63) and SA1 on a dense cloud (every ball holds
     more than nsample: the early stop), batch 8, with the distance tests
     the scan needs on this data, its bound and card time (and the timer
     that read it), and its launch (blocks, warps a block, centres a warp,
     tile points, stages);
   - the main path's detector under ``grouping.FORCE_MODE = "exact"`` (the
     exact kernel 5 launches, the stripe kernel 0, FPS 5) and its time
     beside the stripe detector's;
   - the MCAN 3D-only model (``use_blip=False``, the JAX defaults the
     drivers build for ``--no_blip``): the eval forward at batch 8 and one
     train step at batch 16;
   - classifier mode (``use_text_decoder=False``, with and without
     ``answer_cls_2d3d``): the eval forward at batch 8 (the ViT's kernels
     as in the rank forward, no scoring or vocabulary kernel), one train
     step at batch 16 with remat "block";
   - the rank forward with ``output_attentions``: the dumps' shapes, rows
     summing to 1, the scores bitwise those without dumps;
   - the tiny config card against CPU for the MCAN model, classifier mode
     and the exact-mode detector (indices bitwise).
   Launch counts zeroed just before each path and read just after must be
   as derived; the phase's seconds are printed.
11. the offline tools (``phase_tools``):
   - BLIP-ITM base at 384 px in f32, as the JAX tool builds it: the fused
     ViT's kernels at its shape (64 frames of 577 tokens, 36928 rows; f32
     instantiations) against their plain versions, each within 1e-3 of its
     own largest output, the GEMM's and the attention's (3xTF32) also
     against an f64 reference within 1e-5 of it (``F32_ROUTE_TOL``), with
     card, plain and library time and bounds (FFMA; 3xTF32), and SDPA f32
     at the attention's shape under each backend (``sdpa_backends``); the
     tower three ways on 64 frames (the kernels, the fused blocks through
     the plain versions, the module loop), each image within 1% relative
     L2 of the kernels'; the launches of one ``encode_images`` as derived
     (GEMM 48, ViT attention 12, LayerNorm 25);
   - view selection at full width (``select_best_views``: 2 synthetic
     scenes of 96 frames, two image batches a scene, the second padded; 16
     questions; the rule-based composer): 4 ``encode_images``' launches,
     frames/s and ms a scene, the i2tfile through ``load_scene_view_map``
     and ``make_view_lookup``, ``itm_scores`` at batch 8 finite; the
     ``view_select`` driver at full width;
   - ENet at 256x328, batch 32, f32 (ms a batch, frames/s) and the
     ``compute_multiview_features`` driver; the projection of a 50000-point
     scene into 64 views of 41x32x128 features (ms) and the
     ``project_multiview_{features,labels,color}`` drivers;
   - ``verify_parity`` on a fabricated detector checkpoint (no parameter
     skipped, corners (256, 8, 3), the exact query 5 launches),
     ``profile_train`` at batch 16 with 3 reps a phase, ``profile_loader``
     briefly;
   - the tiny configs card against CPU, same weights, f32 with TF32 off:
     BLIP-ITM within 1e-4, view selection's rankings equal wherever two
     frames' cosines differ by more than 1e-4, ENet within 1e-4 of its
     largest output, the projection's uv and valid (and the features, votes
     and colours after them) equal off the points within 1e-4 of a rounding
     tie.
   The phase's seconds and, at the end, the whole run's are printed.

Bounds: the least time the card could take for a kernel's work, the larger
of the bytes it must move (each input read once, each output written once)
over 3.35 TB/s and its operations over the peak rate for their type
(989 TFLOP/s bf16 tensor-core, 67 TFLOP/s f32), NVIDIA's H100 SXM data
sheet. The 3xTF32 kernels' f32 rows also carry the route's bound: three
times their operations at 495 TFLOP/s TF32. Work that depends on the data (the ball query's scan, masked keys,
causal prefixes) is counted for this run's data.

Matrix products run in full f32 where f32 is used: TF32 is switched off
for both cuBLAS and cuDNN, and the patch embedding is a matrix product.
The last two lines are a ``{"kernels": [...]}`` JSON object (each
kernel's ``launches`` from the path it serves, named by ``launches_path``:
the rank forward, the train step for the backward kernel, or the exact
detector for the exact query; ``f32_shapes``, the f32 rows at the rank
forward's shapes, and ``f32_route``, the f32 instantiation's route;
``launches_by_path`` from the rank forward, the generate forward, a train
step, a step of the ``train`` script's loop, an eval batch of the ``eval``
script, on each rank of phase 9 a DDP step, a ``tp=2`` step and a sharded
eval batch, and phase 10's exact detector, MCAN forward, MCAN train step
and classifier forward, and phase 11's one ``encode_images`` of view
selection, "view select"; the exact query's ``launches`` from the exact
detector; the ViT's three kernels also carry their f32 rows at BLIP-ITM's
shape, ``itm_f32_shapes``) and ``{"ok": true, "device": {...}}``.
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
# the 3xTF32 kernels against an f64 reference, of the largest output: f32's
# accuracy (one TF32 pass misses it by an order of magnitude,
# tests/test_torch_f32_split.py)
F32_ROUTE_TOL = 1e-5
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
# device_ms readings taken by queued_ms after five such traces in a row:
# (reps, ms) of each
queued_fallbacks = []


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
    was launched printed. Late in a run (after phase 9's processes shared
    the card) whole traces come back empty, up to five in a row; then the
    loop is timed by ``queued_ms`` (CUDA events, the gaps between kernels
    included; ``queued_fallbacks``)."""
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
    ms = queued_ms(fn, reps)
    queued_fallbacks.append((reps, ms))
    log(f"device_ms: torch.profiler lost the card's records five times in a row; {reps} calls "
        f"timed by queued_ms instead: {ms:.4f} ms a call")
    return ms


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
    import importlib
    import pkgutil

    import bridgeqa_tpu_torch  # fails outside the repository

    # every module of the port, the tools' and drivers' included
    for mod in pkgutil.walk_packages(bridgeqa_tpu_torch.__path__, "bridgeqa_tpu_torch."):
        importlib.import_module(mod.name)
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
                 "ball_query_backward_kernel", "ball_query_exact_kernel", "gemm_f32_kernel",
                 "vit_attention_f32_kernel", "scoring_attention_f32_kernel", "vocab_f32_kernel")
# kernels whose SASS must hold Hopper instructions (parts of their mangled
# names: wg::gemm_kernel<...>, the vocabulary pass, the scoring attentions'
# pipeline, the 3xTF32 products, ViT attention, scoring attentions and
# vocabulary pass), and which: the wgmma product (HGMMA), the TMA tile load
# (UTMALDG), the mma.sync product (HMMA)
SASS_KERNELS = {"wg11gemm_kernel": ("HGMMA", "UTMALDG"), "vocab_wgmma_kernel": ("HGMMA", "UTMALDG"),
                "attention_pipe_kernel": ("UTMALDG",), "gemm_f32_kernel": ("HMMA",),
                "vit_attention_f32_kernel": ("HMMA",), "scoring_attention_f32_kernel": ("HMMA",),
                "vocab_f32_kernel": ("HMMA",)}
# the route of each kernel's f32 instantiation, for the kernels line
F32_ROUTES = {
    "scoring_gemm": "3xTF32 on mma.sync m16n8k8: gemm_f32_kernel on tile_gemm.cuh's main loop",
    "vit_attention": "3xTF32 on mma.sync m16n8k8: vit_attention_f32_kernel on attention_f32.cuh",
    "scoring_attention": "3xTF32 on mma.sync m16n8k8: scoring_attention_f32_kernel on "
                         "attention_f32.cuh (head width 64, at most 128 question keys; else "
                         "the CUDA-core attention_kernel<float>)",
    "vocab_loss": "3xTF32 on mma.sync m16n8k8: vocab_f32_kernel on tile_gemm.cuh's main loop",
    "scoring_layernorm": "CUDA cores: add_layernorm_kernel<float>"}


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
    log("ptxas, the redesigned kernels (GEMM, ViT attention, scoring attentions and vocabulary "
        "pass in bf16 and f32, FPS, ball query):")
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


def attention_launch(mode: str, pipeline: int = 1):
    """The record of the last attention launch (the C entry's report); the
    main path's shapes must have run a tensor-core kernel: bf16 the pipeline
    (``pipeline`` 1), f32 the 3xTF32 kernel (2)."""
    from bridgeqa_tpu_torch.ops import scoring_layer as sl

    launch = dict(sl.last_attention_launch)
    if launch["pipeline"] != pipeline:
        raise AssertionError(f"the {mode} attention at the main path's shape did not run the "
                             f"tensor-core kernel {pipeline}: {launch}")
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

    route = f32_route_checks(device, gen, failures)
    for r, key in zip(attn_rows, ("self", "cross")):
        r["f32_route"] = route[key]
    vocab_rows[0]["f32_route"] = route["vocab"]
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


def f32_route_checks(device, gen, failures: list) -> dict:
    """The f32 scoring attentions and vocabulary pass (3xTF32 on mma.sync)
    at the main path's shapes, on f32 inputs, against f64 references: each
    output within ``F32_ROUTE_TOL`` of its largest value (the vocabulary's
    sum of logits within it of each row's sum of |logit|). Both attentions
    must have run the f32 tensor-core kernel (launch record "pipeline" 2);
    a single visible key's context must be its value bit for bit (the first
    row of every answer; a question with one valid key). Appends what fails
    to ``failures``; returns {"self", "cross", "vocab": results}."""
    from bridgeqa_tpu_torch.ops import scoring_layer as sl
    from bridgeqa_tpu_torch.ops import vocab_loss as vl

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    def rel(got, exact):
        return float((got.double() - exact).abs().max() / exact.abs().max())

    out = {}
    rows_n, h, hd, la = DECODER_ROWS, HIDDEN, HIDDEN // HEADS, ANSWER_LEN
    seqs = rows_n // la
    qkv = randn(rows_n, 3 * h)
    got = sl.self_attention(qkv, la=la, heads=HEADS)
    launch = dict(sl.last_attention_launch)
    q, k, v = qkv.double().view(seqs, la, 3, HEADS, hd).permute(2, 0, 3, 1, 4)
    causal = torch.tril(torch.ones(la, la, dtype=torch.bool, device=device))
    scores = (q @ k.transpose(-1, -2) / hd ** 0.5).masked_fill(~causal, float("-inf"))
    exact = (torch.softmax(scores, dim=-1) @ v).permute(0, 2, 1, 3).reshape(rows_n, h)
    out["self"] = dict(f64_rel_err=rel(got, exact), pipeline=launch["pipeline"],
                       single_key_bitwise=torch.equal(got.view(seqs, la, h)[:, 0],
                                                      qkv.view(seqs, la, 3 * h)[:, 0, 2 * h:]))
    del qkv, q, k, v, scores, exact, got
    rows_q = rows_n // BATCH
    qc, ck, cv = randn(rows_n, h), randn(BATCH, QUESTION_LEN, h), randn(BATCH, QUESTION_LEN, h)
    valid = QUESTION_LEN - 4 * torch.arange(BATCH, device=device)
    valid[1] = 1  # one valid key: its value on every row
    keep = torch.arange(QUESTION_LEN, device=device)[None, :] < valid[:, None]
    cbias = torch.where(keep, 0.0, sl.NEG).float()
    got = sl.cross_attention(qc, ck, cv, cbias, heads=HEADS)
    launch = dict(sl.last_attention_launch)
    qd = qc.double().view(BATCH, rows_q, HEADS, hd).transpose(1, 2)
    kd, vd = (x.double().view(BATCH, QUESTION_LEN, HEADS, hd).transpose(1, 2) for x in (ck, cv))
    scores = qd @ kd.transpose(-1, -2) / hd ** 0.5 + cbias.double()[:, None, None, :]
    exact = (torch.softmax(scores, dim=-1) @ vd).transpose(1, 2).reshape(rows_n, h)
    out["cross"] = dict(f64_rel_err=rel(got, exact), pipeline=launch["pipeline"],
                        single_key_bitwise=torch.equal(got[rows_q:2 * rows_q],
                                                       cv[1, :1].expand(rows_q, h)))
    del qc, ck, cv, qd, kd, vd, scores, exact, got
    for mode in ("self", "cross"):
        r = out[mode]
        if not (r["f64_rel_err"] <= F32_ROUTE_TOL and r["pipeline"] == 2
                and r["single_key_bitwise"]):
            failures.append(f"scoring_attention f32 {mode}: {r} (tolerance {F32_ROUTE_TOL}, "
                            "pipeline 2, the single key's context bitwise its value)")
        log(f"scoring_attention f32 {mode} at the main path's shape: {r['f64_rel_err']:.3g} of "
            f"the largest output from f64 (tol {F32_ROUTE_TOL}); launch pipeline "
            f"{r['pipeline']}; single key bitwise {r['single_key_bitwise']}")

    hv, table = randn(VOCAB_ROWS, h), randn(VOCAB, h, scale=0.02)
    vbias = randn(VOCAB, scale=0.5)
    labels = torch.randint(0, VOCAB, (VOCAB_ROWS,), generator=gen, device=device,
                           dtype=torch.int32)
    lse, sumlog, tgt = vl.lm_vocab_reductions(hv, table, vbias, labels)
    want = {key: [] for key in ("lse", "sum", "tgt", "abs")}
    t64, b64 = table.double(), vbias.double()
    for lo in range(0, VOCAB_ROWS, 2048):
        logits = hv[lo:lo + 2048].double() @ t64.T + b64
        want["lse"].append(torch.logsumexp(logits, dim=-1))
        want["sum"].append(logits.sum(dim=-1))
        want["tgt"].append(logits.gather(1, labels[lo:lo + 2048].long()[:, None])[:, 0])
        want["abs"].append(logits.abs().sum(dim=-1))
        del logits
    want = {key: torch.cat(x) for key, x in want.items()}
    out["vocab"] = dict(
        lse_f64_rel_err=rel(lse, want["lse"]), target_logit_f64_rel_err=rel(tgt, want["tgt"]),
        sum_logits_f64_rel_err=float(((sumlog.double() - want["sum"]).abs() / want["abs"]).max()))
    del hv, table, t64, want
    if not all(e <= F32_ROUTE_TOL for e in out["vocab"].values()):
        failures.append(f"vocab_loss f32: {out['vocab']} over {F32_ROUTE_TOL}")
    log(f"vocab_loss f32 at the main path's shape, from f64 (tol {F32_ROUTE_TOL}): "
        + json.dumps({k_: float(f"{e:.3g}") for k_, e in out["vocab"].items()}))
    torch.cuda.empty_cache()
    return out


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
    grouping.exact_launches = 0
    for name in scoring_layer.launches:
        scoring_layer.launches[name] = 0


def read_launches() -> dict:
    from bridgeqa_tpu_torch.ops import gather, grouping, sampling, scoring_layer, vit_block
    from bridgeqa_tpu_torch.ops import vocab_loss

    return {"fps": sampling.launches, "ball_query_stripes": grouping.launches,
            **scoring_layer.launches, "vocab_loss": vocab_loss.launches,
            "vit_attention": vit_block.launches, "gather_rows": gather.launches,
            "ball_query_backward": grouping.backward_launches,
            "ball_query_exact": grouping.exact_launches}


# kernels no path runs: checked in phase 3 only
OFF_PATH = ("gather_rows",)
# kernels only a backward runs: the train path's
BACKWARD_ONLY = ("ball_query_backward",)
# kernels only the exact mode runs (grouping.FORCE_MODE = "exact")
EXACT_ONLY = ("ball_query_exact",)


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
    idle = [k for k, n in launches.items()
            if n == 0 and k not in OFF_PATH + BACKWARD_ONLY + EXACT_ONLY]
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
              "ball_query_backward": 0, "ball_query_exact": 0}
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


# the f32 rank forward: the hand-written kernels by the parts of their names
# the profiler shows, for the card time of each in one forward
F32_PROFILE_KERNELS = {"scoring_gemm": ("gemm_f32_kernel",),
                       "vit_attention": ("vit_attention_f32_kernel",),
                       "scoring_attention": ("scoring_attention_f32_kernel",),
                       "scoring_layernorm": ("add_layernorm_kernel",),
                       "vocab_loss": ("vocab_f32_kernel", "vocab_merge_kernel"),
                       "fps": ("fps_cluster_kernel",),
                       "ball_query_stripes": ("ball_query_stripes_kernel", "ball_query_warp_kernel")}
# the scoring attentions' CUDA-core kernel in f32, which no main-path shape
# may take
F32_CUDA_CORE_ATTENTION = "::attention_kernel<float>"
PEAK_TF32 = 495e12  # tensor cores, dense (NVIDIA's data sheet)
TF32_PASSES = 3  # 3xTF32: the route of the f32 products, attentions and vocabulary pass


def tf32_bound(flops: float, nbytes: float) -> float:
    """ms: the 3xTF32 route's least time, three TF32 passes at the tensor
    cores' peak, or the bytes at the HBM rate."""
    return bound(TF32_PASSES * flops, nbytes, PEAK_TF32)[0]


def sdpa_backends(shape: str, q, k, v, reps: int = 3, **kw) -> dict:
    """``scaled_dot_product_attention`` on these f32 inputs: card time
    (``device_ms``) under each backend that takes f32 (the memory-efficient
    kernel, then the math one, each forced with ``sdpa_kernel``) and under
    the default, and which backend the default took, read from the kernels a
    traced call launched. A backend that refuses the inputs reads None."""
    from torch.autograd import DeviceType
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call():
        return F.scaled_dot_product_attention(q, k, v, **kw)

    out = {}
    for name, backend in (("efficient", SDPBackend.EFFICIENT_ATTENTION),
                          ("math", SDPBackend.MATH)):
        with sdpa_kernel(backend):
            try:
                call()
            except RuntimeError as e:  # the backend does not take these inputs
                out[name] = None
                log(f"SDPA f32 {shape}: {name} refused ({str(e).splitlines()[0][:120]})")
                continue
            out[name] = device_ms(call, reps)
    out["default"] = device_ms(call, reps)
    names = []
    for _ in range(5):  # a trace's first records can be lost: several calls, and again if empty
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                call()
                torch.cuda.synchronize()
        names = sorted({e.name() for e in prof.profiler.kineto_results.events()
                        if e.device_type() == DeviceType.CUDA})
        if names:
            break
    joined = " ".join(names)
    out["default_took"] = ("unknown: the traces held no card records" if not names
                           else "efficient" if "MemEff" in joined or "fmha_cutlass" in joined
                           else "flash" if "flash" in joined else "cudnn" if "cudnn" in joined
                           else "math")
    log(f"SDPA f32 {shape}: ms a call " + json.dumps({k_: (None if v_ is None else round(v_, 4))
                                                      if k_ != "default_took" else v_
                                                      for k_, v_ in out.items()})
        + f"; the default's kernels: {[n[:60] for n in names]}")
    return out


def f32_kernel_rows(device, layers: int, depth: int, reps: int = 3) -> dict:
    """The f32 instantiations the f32 rank forward launches, at its shapes:
    card time (``device_ms``), the library call's, the bound at the CUDA
    cores' f32 rate and, for the two 3xTF32 kernels, at TF32's; ``calls`` a
    forward as the config gives them (the log's per-forward sums use them;
    only each kernel's total is counted, in ``phase_main_path_f32``). Their
    agreement with the plain versions at these shapes is phase 3's. Returns
    {kernel: rows}."""
    from bridgeqa_tpu_torch.ops import scoring_layer as sl
    from bridgeqa_tpu_torch.ops import vit_block as vb
    from bridgeqa_tpu_torch.ops import vocab_loss as vl

    gen = torch.Generator(device=device).manual_seed(13)
    rows = {k: [] for k in ("scoring_gemm", "scoring_attention", "scoring_layernorm", "vocab_loss",
                            "vit_attention")}

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    def row(name, shape, fn, library, flops, nbytes, calls, route=False, **extra):
        ms = device_ms(fn, reps)
        lib_ms = None if library is None else device_ms(library, reps)
        bound_ms, bound_by = bound(flops, nbytes, PEAK_F32)
        rows[name].append(dict(shape=shape, calls=calls, ms=ms, library_ms=lib_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
                               tf32x3_bound_ms=tf32_bound(flops, nbytes) if route else None,
                               **extra))
        lib = "none" if lib_ms is None else f"{lib_ms:.3f} ms"
        log(f"f32 {name} {shape}: kernel {ms:.3f} ms, library {lib}, bound {bound_ms:.3f} ms "
            f"({bound_by}, FFMA)" + (f", {rows[name][-1]['tf32x3_bound_ms']:.3f} ms (3xTF32)"
                                     if route else "") + f", {calls} calls a forward")

    passes = layers * SCORING_PASSES
    h, hd = HIDDEN, HIDDEN // HEADS
    for m, shapes, calls in ((DECODER_ROWS, [s + (False,) for s in GEMM_SHAPES], passes),
                             (VIT_ROWS, VIT_GEMM_SHAPES, depth)):
        for name, k, n, gelu, with_res in shapes:
            x, w, b = randn(m, k), randn(n, k, scale=0.02), randn(n, scale=0.5)
            res = randn(m, n, scale=2.0) if with_res else None
            row("scoring_gemm", f"{name}: ({m}, {k}) x ({n}, {k})^T",
                lambda: sl.scoring_gemm(x, w, b, gelu, res), lambda: F.linear(x, w, b),
                2.0 * m * n * k, 4 * (m * k + n * k + n + m * n * (2 if with_res else 1)), calls,
                route=True)
            del x, w, b, res
    la, seqs = ANSWER_LEN, DECODER_ROWS // ANSWER_LEN
    qkv = randn(DECODER_ROWS, 3 * h)
    q, k, v = qkv.view(seqs, la, 3, HEADS, hd).permute(2, 0, 3, 1, 4)
    shape = f"self: ({DECODER_ROWS}, {3 * h}), {seqs} answers of {la}"
    sl.self_attention(qkv, la=la, heads=HEADS)
    launch = attention_launch("f32 self", pipeline=2)
    row("scoring_attention", shape, lambda: sl.self_attention(qkv, la=la, heads=HEADS),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
        4.0 * HEADS * seqs * (la * (la + 1) // 2) * hd, 4 * 4 * DECODER_ROWS * h, passes,
        route=True, launch=launch,
        library_backends=sdpa_backends(shape, q, k, v, is_causal=True))
    del qkv, q, k, v
    qc = randn(DECODER_ROWS, h)
    ck, cv = randn(BATCH, QUESTION_LEN, h), randn(BATCH, QUESTION_LEN, h)
    cbias = torch.zeros(BATCH, QUESTION_LEN, device=device)
    rows_q = DECODER_ROWS // BATCH
    qh = qc.view(BATCH, rows_q, HEADS, hd).transpose(1, 2)
    kh = ck.view(BATCH, QUESTION_LEN, HEADS, hd).transpose(1, 2)
    vh = cv.view(BATCH, QUESTION_LEN, HEADS, hd).transpose(1, 2)
    shape = f"cross: ({DECODER_ROWS}, {h}) against ({BATCH}, {QUESTION_LEN}, {h})"
    mask = cbias[:, None, None, :]
    sl.cross_attention(qc, ck, cv, cbias, heads=HEADS)
    launch = attention_launch("f32 cross", pipeline=2)
    row("scoring_attention", shape, lambda: sl.cross_attention(qc, ck, cv, cbias, heads=HEADS),
        lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
        4.0 * DECODER_ROWS * h * QUESTION_LEN,
        4 * (2 * DECODER_ROWS * h + 2 * BATCH * QUESTION_LEN * h + BATCH * QUESTION_LEN), passes,
        route=True, launch=launch,
        library_backends=sdpa_backends(shape, qh, kh, vh, attn_mask=mask))
    del qc, ck, cv, qh, kh, vh
    scale, shift = randn(h, scale=0.5) + 1.0, randn(h, scale=0.5)
    for m, eps, mode, calls in ((DECODER_ROWS, 1e-12, "add", 3 * passes),
                                (VIT_ROWS, 1e-6, "none", depth + 1), (VIT_ROWS, 1e-6, "sum", depth)):
        a = randn(m, h)
        r = None if mode == "none" else randn(m, h, scale=2.0)
        keep = mode == "sum"
        row("scoring_layernorm", {"add": f"decoder add + LN: ({m}, {h})",
                                  "none": f"vit LN1 and final norm: ({m}, {h})",
                                  "sum": f"vit LN2 keeping the sum: ({m}, {h})"}[mode],
            lambda: sl.add_layernorm(a, r, scale, shift, eps, keep_sum=keep),
            lambda: F.layer_norm(a if r is None else a + r, (h,), scale, shift, eps),
            (8.0 if r is None else 10.0) * m * h,
            4 * ((2 if r is None else 3 + keep) * m * h) + 8 * h, calls)
        del a, r
    hv, table = randn(VOCAB_ROWS, h), randn(VOCAB, h, scale=0.02)
    vbias = randn(VOCAB, scale=0.5)
    labels = torch.randint(0, VOCAB, (VOCAB_ROWS,), generator=gen, device=device,
                           dtype=torch.int32)
    row("vocab_loss", f"({VOCAB_ROWS}, {h}) x ({VOCAB}, {h})^T",
        lambda: vl.lm_vocab_reductions(hv, table, vbias, labels), None,
        2.0 * VOCAB_ROWS * VOCAB * h, 4 * (VOCAB_ROWS * h + VOCAB * h + VOCAB + 4 * VOCAB_ROWS),
        SCORING_PASSES, route=True)
    del hv, table
    qkv = randn(BATCH, VIT_TOKENS, 3 * h)
    q, k, v = qkv.view(BATCH, VIT_TOKENS, 3, VIT_HEADS, hd).permute(2, 0, 3, 1, 4)
    row("vit_attention", f"({BATCH}, {VIT_TOKENS}, {3 * h}), {VIT_HEADS} heads of {hd}",
        lambda: vb.vit_attention(qkv, heads=VIT_HEADS),
        lambda: F.scaled_dot_product_attention(q, k, v),
        4.0 * BATCH * VIT_HEADS * VIT_TOKENS ** 2 * hd, 4 * BATCH * VIT_TOKENS * 4 * h, depth,
        route=True)
    del qkv, q, k, v
    torch.cuda.empty_cache()
    for name, rs in rows.items():
        ms = sum(r["ms"] * r["calls"] for r in rs)
        lib = (None if any(r["library_ms"] is None for r in rs)
               else sum(r["library_ms"] * r["calls"] for r in rs))
        log(f"f32 {name} per forward: {ms:.2f} ms, library "
            f"{'none' if lib is None else f'{lib:.2f} ms'}, FFMA bound "
            f"{sum(r['bound_ms'] * r['calls'] for r in rs):.2f} ms")
    return rows


def phase_main_path_f32(device, reps: int = 3) -> dict:
    """The drivers' default: the main path's rank forward in f32 (``predict``,
    ``eval`` and validation compute in f32 unless ``--bf16``), batch 8,
    k_test 256, ``fused_scoring="auto"`` and ``vit_block.FUSED_MODE =
    "auto"``: the f32 instantiations of every fused kernel. Launches as
    derived; latency (median of ``reps``); one profiled forward (device
    time, the card time of each kernel, ``build/profile_main_path_f32.txt``);
    then the f32 module path (``fused_scoring="off"``, ``FUSED_MODE =
    "off"``) on the same weights and batch: the top-1 answer equal on every
    row, the largest difference of the scores both paths computed printed.
    Then the kernels' rows at the forward's shapes (``f32_kernel_rows``).
    Returns {kernel: rows}."""
    from bridgeqa_tpu_torch.models.med import MedConfig
    from bridgeqa_tpu_torch.ops import vit_block as vb

    t_phase = time.perf_counter()
    cfg = main_config()
    model = build_model(cfg, device)  # f32 parameters and compute: no set_compute_dtype
    batch = make_batch(cfg, BATCH, NUM_POINTS, IMAGE_SIZE, QUESTION_LEN, ANSWER_LEN, device)
    expected = expected_launches(cfg)
    # the module path on the same weights: a copy whose decoders' configs say
    # "off"
    module = copy.deepcopy(model)
    for m in module.modules():
        if isinstance(getattr(m, "config", None), MedConfig):
            m.config = dataclasses.replace(m.config, fused_scoring="off")

    def forward(m):
        return m(batch, inference="rank", k_test=K_TEST)

    with torch.inference_mode():
        reset_launches()
        out = forward(model)
        torch.cuda.synchronize()
        launches = read_launches()
        failed = [f"{k}: {launches[k]} launches, derived {n}" for k, n in expected.items()
                  if launches[k] != n]
        if not all(bool(torch.isfinite(out[k].float()).all())
                   for k in ("answer_scores", "answer_scores_2d", "answer_scores_scene")):
            failed.append("scores not finite")
        latency, times = _timed(lambda: forward(model), reps)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            forward(model)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        try:
            vb.FUSED_MODE = "off"
            reset_launches()
            ref = forward(module)
            torch.cuda.synchronize()
            module_launches = read_launches()
            module_latency, module_times = _timed(lambda: forward(module), reps)
        finally:
            vb.FUSED_MODE = "auto"
    del module
    fused = [k for k, n in module_launches.items()
             if n and k not in ("fps", "ball_query_stripes")]
    if fused:
        failed.append(f"the module path launched {fused}")
    OUT_DIR.mkdir(exist_ok=True)
    busy_ms = profile_table(prof, OUT_DIR / "profile_main_path_f32.txt")[0]
    by_kernel = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name()] = by_kernel.get(e.name(), 0.0) + e.duration_ns() / 1e6
    ours = {k: sum(ms for name, ms in by_kernel.items() if any(p in name for p in parts))
            for k, parts in F32_PROFILE_KERNELS.items()}
    unseen = [k for k, ms in ours.items() if launches.get(k) and not ms > 0]
    if unseen:
        failed.append(f"kernels launched in the f32 forward with no card time in its profile: "
                      f"{unseen}")
    cuda_core = [n for n in by_kernel if F32_CUDA_CORE_ATTENTION in n]
    if cuda_core:
        failed.append(f"an f32 attention of the forward took the CUDA-core kernel: {cuda_core}")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    log("f32 rank forward, the card's largest kernels (ms of one forward): "
        + "; ".join(f"{name[:70]} {ms:.2f}" for name, ms in top))
    # top-1 by each decoder's log-probability sums and by the ensemble
    # exp(s_2d) + exp(w s_3d) taken in log space (random weights put every
    # sum near -100, where the ensemble itself underflows to 0 in f32)
    weight = model.blip_model.cfg.scene_ensemble_weight

    def ranked(o):
        s2d, s3d = o["answer_scores_2d"].double(), o["answer_scores_scene"].double()
        return {"2d": s2d, "scene": s3d, "ensemble": torch.logaddexp(s2d, weight * s3d)}

    got_r, ref_r = ranked(out), ranked(ref)
    same = {k: int((got_r[k].argmax(1) == ref_r[k].argmax(1)).sum()) for k in got_r}
    margin = [round(float(a - b), 4) for a, b in got_r["ensemble"].topk(2, dim=1).values.tolist()]
    diffs = {}
    for key in ("answer_scores_2d", "answer_scores_scene"):
        both = (out[key] != -1e4) & (ref[key] != -1e4)
        diffs[key] = float((out[key] - ref[key]).abs()[both].max())
    if any(n != BATCH for n in same.values()):
        failed.append(f"top-1 answers differ from the module path's: equal on {same} of {BATCH}")
    log(f"f32 rank forward at batch {BATCH}, fused kernels: median {latency:.1f} ms over {reps} "
        f"({', '.join(f'{t:.1f}' for t in times)}), {BATCH / latency * 1e3:.2f} QA pairs/s; "
        f"profiled: {busy_ms:.1f} ms of device time in {wall_ms:.1f} ms (busy "
        f"{busy_ms / wall_ms:.0%}); the hand-written kernels' card ms "
        f"{json.dumps({k: round(v, 2) for k, v in ours.items()})}; launches "
        f"{json.dumps(launches)}, derived {json.dumps(expected)}")
    log(f"f32 module path on the same weights: median {module_latency:.1f} ms over {reps} "
        f"({', '.join(f'{t:.1f}' for t in module_times)}); top-1 equal on {json.dumps(same)} "
        f"of {BATCH} rows; the ensemble's top-1 minus top-2 per row {margin}; largest score "
        f"difference {json.dumps(diffs)}")
    del model, out, ref
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"f32 rank forward: {failed}")
    rows = f32_kernel_rows(device, decoder_layers(cfg), vit_depth(cfg))
    log(f"f32 rank forward step: {time.perf_counter() - t_phase:.1f} s")
    return rows


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
              "vocab_loss": 0, "vit_attention": 0, "gather_rows": 0, "ball_query_backward": 0,
              "ball_query_exact": 0}
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
    the kernel adds with f32 reductions in an order that changes from run to
    run, the plain version with ``index_add_`` and a sum. Ten calls under
    ``torch.profiler`` must make ten launch calls of any kind and put ten
    records on the card, each the backward kernel: one kernel a call and
    nothing else (the kernel zeroes its own outputs; ``backward_card_work``).
    Times are card time (``queued_ms``, named in each row's ``timer``);
    ``library_ms`` is one ``index_add_`` of the xyz cotangents, the scatter
    part alone (no PyTorch call also gives the centres' sums)."""
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
        launch = dict(grouping.last_backward_launch)
        want = grouping.ball_query_stripes_backward_plain(idx, g_rel, g_grouped, n)
        torch.cuda.synchronize()
        card_work = backward_card_work(
            lambda: grouping.ball_query_stripes_backward(idx, g_rel, g_grouped, n))
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
        # each call one launch, and on the card that one kernel and nothing else
        one_kernel = (card_work["launch_calls"] == card_work["calls"] == card_work["card_records"]
                      and all("ball_query_backward" in k for k in card_work["kernels"]))
        ok = (launched == 1 and one_kernel and empty
              and all(r <= BQ_BACKWARD_TOL for r in rel.values()))
        rows.append(dict(shape=f"{name}: B={batch}, N={n}, M={m}, nsample={ns}, nf={nf}",
                         calls=calls, ok=ok, max_abs_err=max(errs.values()), rel_err=rel, ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by, timer="queued_ms", filled_slots=filled,
                         launch=launch, card_work=card_work))
        log(f"ball query backward {name}: B={batch}, N={n}, M={m}, ns={ns}, nf={nf}: err / largest "
            f"{json.dumps({k: float(f'{v:.3g}') for k, v in rel.items()})} (tol "
            f"{BQ_BACKWARD_TOL}), empty balls {empty}, {filled} slots filled by the ball's first "
            f"qualifier; kernel {ms:.4f} ms card time, plain {plain_ms:.4f} ms, index_add_ of "
            f"the xyz cotangents {library_ms:.4f} ms (card time, queued_ms), bound "
            f"{bound_ms:.4f} ms ({bound_by}); launch {json.dumps(launch)}; card work of "
            f"{card_work['calls']} calls {json.dumps(card_work)}")
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
                 timer="queued_ms", rows=rows)]


def backward_card_work(fn, calls: int = 10, tries: int = 5) -> dict:
    """What ``calls`` back-to-back calls of ``fn`` put on the card, from
    ``torch.profiler``: the host's launch calls of any kind (kernels,
    copies, memsets; ``_LAUNCH_CALLS``) and the card's records with their
    names. A trace with fewer card records than launch calls (one traced
    call alone has come back with none) is taken again, up to ``tries``
    times; the last trace is returned as it is."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.profiler.kineto_results.events()
        launched = [e.name() for e in events if e.device_type() == DeviceType.CPU
                    and e.name().startswith(_LAUNCH_CALLS)]
        work = [e.name() for e in events if e.device_type() == DeviceType.CUDA]
        if len(work) >= len(launched):
            break
    return dict(calls=calls, launch_calls=len(launched), launched=sorted(set(launched)),
                card_records=len(work), kernels=sorted({w[:60] for w in work}))


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
    return launches, TRAIN_BATCH / latency


# phase 8: the drivers at full width on synthetic data
DRIVER_BATCH = 16  # the JAX bench's train batch, as phase 7
DRIVER_WORKERS = 2  # the feed's worker processes
DRIVER_ARGS = ["--synthetic", "--bf16", "--remat", "--num_workers", str(DRIVER_WORKERS),
               "--seed", "0", "--val_step", "0", "--check_syncs"]
RUN_ARTIFACTS = ("info.json", "answer_vocab.json", "cmdline.txt", "log.txt", "metrics.jsonl",
                 "model", "model_last", "checkpoint")
EVAL_ARTIFACTS = ("pred.val.json", "score.val.json", "pred.val.pkl", "pred.val.pkl.json",
                  "score.val.pkl", "report.val.json")


def expected_eval_launches(cfg) -> dict:
    """Kernel launches of one eval forward (rank, in eval mode without grad)
    of a script's model: the detector's alone for a DET stage; with remat in
    the config, the decoders on the module path, since the scoring gate
    refuses remat as JAX's does (``expected_generate_launches``: the
    detector's and the ViT's kernels); else ``expected_launches``. The
    inference drivers build their model without remat."""
    if cfg.stage == "DET":
        return {k: (len(FPS_SHAPES) if k in ("fps", "ball_query_stripes") else 0)
                for k in expected_launches(cfg)}
    if cfg.blip.remat:
        return expected_generate_launches(cfg)
    return expected_launches(cfg)


def states_equal(got: dict, want: dict) -> bool:
    """Two ``state_dict``s (of tensors, numbers, lists, dicts) equal bit for
    bit, tensors compared on the host's copy of each."""
    if isinstance(want, dict):
        return (isinstance(got, dict) and list(got) == list(want)
                and all(states_equal(got[k], want[k]) for k in want))
    if isinstance(want, (list, tuple)):
        return len(got) == len(want) and all(states_equal(g, w) for g, w in zip(got, want))
    if isinstance(want, torch.Tensor):
        return (isinstance(got, torch.Tensor) and got.dtype == want.dtype
                and torch.equal(got.cpu(), want.cpu()))
    return got == want


def phase_drivers(device, resident_samples_per_s: float, batch: int = DRIVER_BATCH,
                  args=DRIVER_ARGS):
    """The port's entry points as a user runs them, each script's
    ``main(argv)`` on ``--synthetic`` data at the full width of
    ``main_config()`` (40000 points, ViT-B/16 at 480 px, the 12-layer twin
    encoder and both decoders), ``--bf16 --remat``, batch 16, the feed's
    two worker processes, run directories under ``build/drivers``:

    1. ``train --stage DET``: one epoch of 2 steps;
    2. ``train --first_stage_ckpt_path`` (the VQA stage): 2 epochs of 2
       steps (cut from 3 to make room for phase 9), a validation after each;
    3. ``train --use_checkpoint``: one more epoch, cut to two steps, each
       traced by ``torch.profiler`` (``--trace_dir``; the second is the one
       reported: the first holds the workers' start);
    4. ``predict --open_ended`` (the rank forward and the generate forward
       of each batch; answers decoded by the feed's tokenizer);
    5. ``eval --qa --detection``; 6. ``score``.

    Every train run takes ``--check_syncs``: a host sync between log points
    raises where it happens. Checks, any of which fails the phase: every
    artifact written; every logged metric finite; each train step's
    launches equal ``expected_train_launches``, each eval forward's (the
    validations', predict's and eval's, in eval mode without grad)
    ``expected_eval_launches`` or, for generate,
    ``expected_generate_launches``; the DET graft copied the detector's
    parameters and left the model's BN statistics alone; the resumed model
    and optimizer equal the saved ones bit for bit, epoch included. Printed:
    the loop's samples/s with the feed beside phase 7's step on a resident
    batch, ``PhaseTimer``'s fetch and step means, the card's busy share in
    the traced steps, the phase's seconds, peak memory, which vote path and
    which METEOR stemmer ran.

    Cut: the synthetic data has 4 answers, not ScanQA's thousands (phase
    5's rank forward over 4500 answers stays the measure of scoring), 4
    scenes, random weights."""
    import shutil

    from bridgeqa_tpu_torch import native
    from bridgeqa_tpu_torch.eval import scoring
    from bridgeqa_tpu_torch.models.bridgeqa import BridgeQA
    from bridgeqa_tpu_torch.scripts import eval as eval_script
    from bridgeqa_tpu_torch.scripts import predict, score, train
    from bridgeqa_tpu_torch.train import checkpoints
    from bridgeqa_tpu_torch.train import solver as solver_module

    t_phase = time.perf_counter()
    root = OUT_DIR / "drivers"
    shutil.rmtree(root, ignore_errors=True)
    runs = {name: root / name for name in ("det", "vqa")}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    args = list(args) + ["--device", device.type, "--batch_size", str(batch),
                         "--synthetic_val_records", str(batch)]

    steps, forwards, graft, resumed = [], [], {}, {}
    train_step, forward = solver_module.train_step, BridgeQA.forward
    graft_detector, load_train_state = checkpoints.graft_detector, checkpoints.load_train_state

    def counted_step(model, *args, **kwargs):  # the counts are host counters: no sync
        reset_launches()
        out = train_step(model, *args, **kwargs)
        steps.append((model.cfg, read_launches()))
        return out

    def counted_forward(self, batch, inference="rank", *args, **kwargs):
        if self.training or inference == "loss":
            return forward(self, batch, inference, *args, **kwargs)
        reset_launches()
        out = forward(self, batch, inference, *args, **kwargs)
        forwards.append((self.cfg, inference, torch.is_grad_enabled(), read_launches()))
        return out

    def checked_graft(run_dir, name, model):
        # the persistent buffers: the BN statistics (the compute-dtype copies
        # are made again from the grafted parameters)
        params = dict(model.named_parameters())
        before = {k: v.clone() for k, v in model.state_dict().items() if k not in params}
        out = graft_detector(run_dir, name, model)
        saved = checkpoints.load_state(run_dir, name, device)
        graft["parameters"] = all(torch.equal(p, saved[k]) for k, p in params.items()
                                  if k.startswith("detector."))
        graft["buffers"] = all(torch.equal(v, before[k]) for k, v in model.state_dict().items()
                               if k in before)
        graft["statistics"] = sum(k.startswith("detector.") and k.endswith("running_var")
                                  for k in before)
        return out

    def checked_resume(run_dir, model, optimizer, name="checkpoint"):
        epoch = load_train_state(run_dir, model, optimizer, name)
        saved = torch.load(Path(run_dir) / name, map_location=device, weights_only=True)
        resumed.update(epoch=(epoch, saved["epoch"]),
                       model=states_equal(model.state_dict(), saved["model"]),
                       optimizer=states_equal(optimizer.state_dict(), saved["optimizer"]),
                       counts=[g["count"] for g in optimizer.param_groups])
        del saved
        return epoch

    solver_module.train_step, BridgeQA.forward = counted_step, counted_forward
    checkpoints.graft_detector, checkpoints.load_train_state = checked_graft, checked_resume
    timings = {}
    try:
        for name, argv in (
                ("det", ["--stage", "DET", "--epochs", "1", "--synthetic_records",
                         str(2 * batch), "--verbose", "2"]),
                ("vqa", ["--first_stage_ckpt_path", str(runs["det"]), "--epochs", "2",
                         "--synthetic_records", str(2 * batch), "--verbose", "2"]),
                ("resume", ["--use_checkpoint", str(runs["vqa"]), "--epochs", "3",
                            "--synthetic_records", str(2 * batch), "--max_iters_per_epoch", "2",
                            "--verbose", "2", "--trace_dir", str(root / "trace")])):
            t0 = time.perf_counter()
            tag = "vqa" if name == "resume" else name
            train.main(args + argv + ["--output_root", str(root), "--tag", tag])
            timings[name] = time.perf_counter() - t0
        vqa = str(runs["vqa"])
        t0 = time.perf_counter()
        preds = predict.main(["--run_dir", vqa, "--open_ended", "--device", device.type])
        timings["predict"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        results = eval_script.main(["--run_dir", vqa, "--qa", "--detection", "--device",
                                    device.type])
        timings["eval"] = time.perf_counter() - t0
        report = score.main(["--run_dir", vqa])
    finally:
        solver_module.train_step, BridgeQA.forward = train_step, forward
        checkpoints.graft_detector, checkpoints.load_train_state = graft_detector, load_train_state
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9

    failed = []
    for name, d in runs.items():
        missing = [a for a in RUN_ARTIFACTS + (("predictions.csv",) + EVAL_ARTIFACTS
                                               if name == "vqa" else ()) if not (d / a).exists()]
        if missing:
            failed.append(f"{name}: artifacts not written {missing}")
        records = [json.loads(line) for line in (d / "metrics.jsonl").read_text().splitlines()]
        bad = [r for r in records for v in r.values()
               if isinstance(v, float) and not np.isfinite(v)]
        if bad or not any(r["phase"] == "train" for r in records):
            failed.append(f"{name}: logged metrics not finite or missing {bad[:3]}")
    want_steps = 2 + 2 * 2 + 2
    if len(steps) != want_steps:
        failed.append(f"{len(steps)} train steps, {want_steps} expected")
    for i, (cfg, launches) in enumerate(steps):
        expected = expected_train_launches(cfg)
        if launches != expected:
            failed.append(f"train step {i} ({cfg.stage}): launches {launches}, expected {expected}")
    kinds = [(cfg.stage, inference) for cfg, inference, _, _ in forwards]
    want_kinds = [("DET", "rank")] + [("VQA", "rank")] * 3 + [("VQA", "rank"), ("VQA", "generate"),
                                                              ("VQA", "rank")]
    if kinds != want_kinds:
        failed.append(f"eval forwards {kinds}, expected {want_kinds}")
    for i, (cfg, inference, grad, launches) in enumerate(forwards):
        expected = (expected_generate_launches(cfg) if inference == "generate"
                    else expected_eval_launches(cfg))
        if grad or launches != expected:
            failed.append(f"eval forward {i} ({cfg.stage}, {inference}, remat {cfg.blip.remat}, "
                          f"grad {grad}): launches {launches}, expected {expected}")
    if not (graft.get("parameters") and graft.get("buffers") and graft.get("statistics")):
        failed.append(f"DET graft {graft}")
    epochs = resumed.get("epoch", (None, None))
    if not (resumed.get("model") and resumed.get("optimizer") and epochs == (2, 2)):
        failed.append(f"resumed state {resumed}")
    texts = [p.get("open_ended_answer") for p in preds]
    if len(preds) != batch or not all(isinstance(t, str) for t in texts):
        failed.append(f"predictions {len(preds)}, open-ended answers {texts[:3]}")
    if not all(np.isfinite(v) for v in results["qa"].values()) or "mAP@0.25" not in results:
        failed.append(f"eval results {results}")
    if "EM@1" not in report:
        failed.append(f"score report keys {sorted(report)[:5]}")
    log(f"drivers: train steps {len(steps)} (launches as derived), eval forwards "
        f"{[f'{s}/{i}' for s, i in kinds]}, DET graft {graft}, resumed {resumed}")
    if failed:
        raise AssertionError(f"drivers checks failed: {failed}")

    vqa_records = [json.loads(line) for line in (runs["vqa"] / "metrics.jsonl").read_text()
                   .splitlines()]
    timing = [r for r in vqa_records if r["phase"] == "timing"]
    trace = [r for r in vqa_records if r["phase"] == "trace"]
    stem = scoring._porter_stem()
    log(f"drivers timings on {card_name_and_power()}:")
    for r in timing:
        log(f"drivers: VQA loop at step {r['step']}: {r['samples_per_s']:.2f} samples/s with the "
            f"feed (fetch mean {r['fetch_ms']:.1f} ms, step mean {r['step_ms']:.1f} ms, host "
            f"clock; the interval since the last log point, its metrics read included)")
    steady = timing[1]["samples_per_s"] if len(timing) > 1 else float("nan")
    log(f"drivers: loop with the feed {steady:.2f} samples/s (the VQA stage's second epoch) "
        f"against phase 7's step on a resident batch {resident_samples_per_s:.2f}")
    for r in trace:
        log(f"drivers: traced loop step {r['step']} (fetch and step): {r['device_ms']:.1f} ms of "
            f"card time in {r['wall_ms']:.1f} ms (busy {r['busy']:.0%})")
    log(f"drivers: answers {preds[0]['answer_top10']}, open-ended {texts[:2]}; qa "
        f"{json.dumps({k: round(v, 4) for k, v in results['qa'].items()})}; mAP@0.25 "
        f"{results['mAP@0.25']['mAP']:.4f}; EM@1 {report['EM@1']}")
    log(f"drivers: phase {time.perf_counter() - t_phase:.1f} s (runs "
        f"{json.dumps({k: round(v, 1) for k, v in timings.items()})}), peak memory "
        f"{peak_gb:.2f} GB, vote labels by the {'native' if native.available() else 'numpy'} "
        f"path, METEOR stemmer: "
        f"{'Porter (nltk)' if getattr(stem, '__self__', None) is not None else 'none (no nltk)'}")
    # a step of the loop, and the eval script's rank forward (built without remat)
    return steps[-1][1], forwards[-1][3]


# phase 9: parallelism on the one card (two ranks share it over gloo; NCCL
# refuses two ranks on one device) and the torchrun driver over NCCL
PARALLEL_WORLD = 2
PARALLEL_BATCH = TRAIN_BATCH  # the global batch: 8 a rank
PARALLEL_SEED = 5
PARALLEL_TIMING_STEPS = 3
PARALLEL_DIR = OUT_DIR / "parallel"
PARALLEL_TIMEOUT_S = 900
# the tolerances of phase 9's parity (``phase_parallel``)
PARALLEL_LOSS_TOL = 1e-4
PARALLEL_GRAD_TOL = 1e-3
PARALLEL_DETECTOR_GRAD_TOL = 5e-2
PARALLEL_STAT_TOL = 1e-4
PARALLEL_LOSS2_TOL = 1e-2
PARALLEL_F64_TOL = 1e-9
TINY_PARALLEL_BATCH = 4
TORCHRUN_ARGS = ["--distributed", "--synthetic", "--bf16", "--remat", "--check_syncs", "--tiny",
                 "--num_workers", "1", "--batch_size", "2", "--seed", "0", "--val_step", "0",
                 "--verbose", "1", "--synthetic_val_records", "2"]


def parallel_config():
    """Phase 7's config (the main path's, remat "block"), every dropout
    rate 0."""
    base = main_config()
    return no_dropout(dataclasses.replace(
        base, blip=dataclasses.replace(base.blip, remat=True, remat_mode="block")))


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm().clamp(min=1e-30))


def _parallel_steps(model, step_model, batch, steps: int, grads_to=None):
    """``steps`` train steps of ``step_model`` (``model`` or a DDP of it);
    per step: its loss and sub-losses, its launches; the gradients after the
    first backward (``grads_to``: "cpu" or the card), the running statistics
    after the first step."""
    from bridgeqa_tpu_torch.train.optim import build_optimizer
    from bridgeqa_tpu_torch.train.step import train_step

    optimizer = build_optimizer(model)
    out = {"losses": [], "launches": [], "grads": None, "stats": None}

    def mark(part):
        if part == "backward" and out["grads"] is None and grads_to is not None:
            out["grads"] = {n: p.grad.detach().to(grads_to, copy=True)
                            for n, p in model.named_parameters() if p.grad is not None}

    for k in range(steps):
        reset_launches()
        metrics = train_step(step_model, optimizer, batch, bn_momentum=0.1, mark=mark)
        out["losses"].append({key: float(metrics[key]) for key in TRAIN_LOSSES})
        out["launches"].append(read_launches())
        if k == 0:
            out["stats"] = {n: b.detach().clone() for n, b in model.named_buffers()
                            if n.endswith(("running_mean", "running_var"))}
    del optimizer
    return out


def _sign_flips(got: dict, want: dict) -> list:
    """[gradient elements whose sign differs, elements] over every
    parameter: AdamW's first step is ``lr * sign(g)`` for each element, so
    these are the elements two runs step 2 lr apart."""
    flips = [0, 0]
    for n, g in got.items():
        flips[0] += int((torch.sign(g) != torch.sign(want[n])).sum())
        flips[1] += g.numel()
    return flips


def _rows(batch: dict, lo: int, hi: int) -> dict:
    return {k: v[lo:hi].contiguous() for k, v in batch.items()}


def parallel_worker(rank: int, world: int, port: int) -> int:
    """One rank of phase 9 (``python3 chip_smoke.py --parallel-rank RANK
    WORLD PORT``, started by ``phase_parallel``): both ranks on card 0 over
    gloo. Writes ``build/parallel/rank<RANK>.json``."""
    import gc
    import os

    import torch.distributed as dist

    from bridgeqa_tpu_torch.models.layers import set_compute_dtype
    from bridgeqa_tpu_torch.parallel import mesh
    from bridgeqa_tpu_torch.parallel.eval import make_sharded_eval_step
    from bridgeqa_tpu_torch.parallel.tp import shard_model
    from bridgeqa_tpu_torch.train.optim import build_optimizer
    from bridgeqa_tpu_torch.train.step import train_step

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK="0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cfg = parallel_config()
    batch = make_train_batch(cfg, PARALLEL_BATCH, NUM_POINTS, IMAGE_SIZE, QUESTION_LEN,
                             ANSWER_LEN, device, seed=PARALLEL_SEED)
    half = PARALLEL_BATCH // world
    shard = _rows(batch, rank * half, (rank + 1) * half)
    result = {"rank": rank}
    t_start = time.perf_counter()

    def done(part):  # progress in the rank's log (build/parallel/rank<r>.log)
        print(f"rank {rank}: {part} done at {time.perf_counter() - t_start:.1f} s", flush=True)

    def ddp(module):
        return torch.nn.parallel.DistributedDataParallel(
            module, process_group=mesh.ddp_group(), find_unused_parameters=True,
            broadcast_buffers=False)

    def free():
        # after the caller dropped its names: DDP's reducer holds cycles
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    if rank == 0:
        # the reference: one process on the global batch, before joining the
        # group (the other rank waits in its rendezvous); memory freed after.
        # Twice: how far the card's f32 step repeats itself
        t0 = time.perf_counter()
        refs = []
        for _ in range(2):
            model = build_model(cfg, device, seed=PARALLEL_SEED)
            refs.append(_parallel_steps(model, model, batch, 2, grads_to="cpu"))
            del model
            free()
        ref, again = refs
        ref["stats"] = {k: v.cpu() for k, v in ref["stats"].items()}
        result["reference"] = {
            "losses": ref["losses"], "launches": ref["launches"],
            "repeat_losses": again["losses"],
            "repeat_grads": {n: _rel_l2(g, ref["grads"][n]) for n, g in again["grads"].items()},
            "repeat_sign_flips": _sign_flips(again["grads"], ref["grads"]),
            "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9,
            "seconds": time.perf_counter() - t0}
        del refs, again
        done("reference")
    mesh.initialize_distributed(backend="gloo", device="cuda:0")
    torch.cuda.reset_peak_memory_stats(device)

    # (a) data parallelism, f32: two steps, then the timing in bf16
    mesh.make_mesh()
    model = build_model(cfg, device, seed=PARALLEL_SEED)
    dp = _parallel_steps(model, ddp(model), shard, 2, grads_to=device)
    result["ddp"] = {"losses": dp["losses"], "launches": dp["launches"]}
    if rank == 0:
        grads, flips, flips_by = {}, [0, 0], {}
        for n, g in dp["grads"].items():
            want = ref["grads"].pop(n).to(device)
            grads[n] = _rel_l2(g, want) if float(want.norm()) > 0 else float(g.norm())
            flips_by[n] = int((torch.sign(g) != torch.sign(want)).sum())
            flips[0] += flips_by[n]
            flips[1] += g.numel()
            del want
        missing = sorted(ref["grads"])
        result["ddp"]["grads"] = grads
        result["ddp"]["sign_flips"] = flips
        result["ddp"]["sign_flips_by"] = sorted(((c, n) for n, c in flips_by.items() if c),
                                                reverse=True)[:8]
        result["ddp"]["sign_flips_detector"] = sum(c for n, c in flips_by.items()
                                                   if n.startswith("detector."))
        result["ddp"]["grads_missing"] = missing
        result["ddp"]["stats"] = {n: _rel_l2(s.cpu(), ref["stats"][n])
                                  for n, s in dp["stats"].items()}
        del ref
    result["ddp"]["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    del model, dp
    free()
    done("ddp f32")

    model = set_compute_dtype(build_model(cfg, device, seed=PARALLEL_SEED), torch.bfloat16)
    optimizer, step_model = build_optimizer(model), ddp(model)
    walls = []
    for k in range(1 + PARALLEL_TIMING_STEPS):  # a warm-up step first
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = train_step(step_model, optimizer, shard, bn_momentum=0.1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if not np.isfinite(float(metrics["loss"])):
            raise AssertionError(f"rank {rank}: bf16 step {k} loss {float(metrics['loss'])}")
    result["timing"] = {"walls_s": walls[1:], "median_s": statistics.median(walls[1:])}
    del model, optimizer, step_model, metrics
    free()
    done("ddp bf16 timing")

    # (b) tensor parallelism over both ranks (dp 1), f32, the whole batch
    mesh.make_mesh(data=1, model=world)
    torch.cuda.reset_peak_memory_stats(device)
    model = shard_model(build_model(cfg, device, seed=PARALLEL_SEED))
    tp = _parallel_steps(model, ddp(model), batch, 2)
    result["tp"] = {"losses": tp["losses"], "launches": tp["launches"],
                    "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9}
    del model, tp
    free()
    done("tp")

    # (d) a sharded eval batch, bf16, the fused kernels
    mesh.make_mesh()
    eval_cfg = main_config()
    model = set_compute_dtype(build_model(eval_cfg, device, seed=PARALLEL_SEED), torch.bfloat16)
    table = make_batch(eval_cfg, 1, 1024, 32, 4, ANSWER_LEN, device, seed=PARALLEL_SEED)
    eval_shard = {**shard, "answer_list_ids": table["answer_list_ids"],
                  "answer_list_mask": table["answer_list_mask"]}
    step = make_sharded_eval_step(model, k_test=K_TEST)
    reset_launches()
    out = step(eval_shard)
    launches = read_launches()
    scores = out["answer_scores"]
    result["eval"] = {
        "launches": launches, "shape": list(scores.shape),
        "finite": bool(torch.isfinite(scores).all()) and bool(torch.isfinite(out["loss"])),
        "own_rows": bool(torch.equal(out["point_clouds"][rank * half:(rank + 1) * half],
                                     shard["point_clouds"])),
        "loss": float(out["loss"])}
    del model, out, scores
    free()
    done("sharded eval")

    # (e) the tiny config in f64, DDP against one process on this card: the
    # step's semantics, two AdamW steps, free of f32's rounding
    tcfg = no_dropout(tiny_config())
    tbatch = {k: (v.double() if v.is_floating_point() else v) for k, v in make_train_batch(
        tcfg, TINY_PARALLEL_BATCH, 4096, 64, 20, 6, device, seed=12).items()}
    tiny_half = TINY_PARALLEL_BATCH // world
    if rank == 0:
        with mesh.local_batch():  # one process's step: no collective
            model = build_model(tcfg, device, seed=9).double()
            tref = _parallel_steps(model, model, tbatch, 2, grads_to=device)
        del model
    model = build_model(tcfg, device, seed=9).double()
    tdp = _parallel_steps(model, ddp(model), _rows(tbatch, rank * tiny_half,
                                                   (rank + 1) * tiny_half), 2, grads_to=device)
    result["tiny_f64"] = {"losses": tdp["losses"]}
    if rank == 0:
        result["tiny_f64"].update(
            reference=tref["losses"],
            grads={n: _rel_l2(g, tref["grads"][n]) for n, g in tdp["grads"].items()
                   if float(tref["grads"][n].norm()) > 0},
            stats={n: _rel_l2(b, tref["stats"][n]) for n, b in tdp["stats"].items()})
        del tref
    del model, tdp
    free()
    done("tiny f64")
    PARALLEL_DIR.mkdir(parents=True, exist_ok=True)
    (PARALLEL_DIR / f"rank{rank}.json").write_text(json.dumps(result))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_parallel(device, resident_samples_per_s: float):
    """Parallelism on the one H100. Two ranks share card 0 over gloo (NCCL
    refuses two ranks on one device; gloo all-reduces and broadcasts CUDA
    tensors through the host): two ranks on one card measure correctness,
    not scaling.

    Started as two fresh processes (``parallel_worker``), phase 7's config
    (the main path's at full width, remat "block") with every dropout rate
    0, random weights from ``PARALLEL_SEED``, the synthetic train batch of
    ``make_train_batch`` at global batch 16:

    - reference: one process, the whole batch, f32, two steps of
      ``train_step`` (``OptimConfig()``), run first, its memory freed;
    - (a) data parallelism: the same two f32 steps through
      ``DistributedDataParallel`` on a (2, 1) mesh, 8 samples a rank, the
      BatchNorm statistics and losses over the global batch
      (``parallel/global_batch.py``). Held to the reference: the step-1
      loss and each sub-loss within 1e-4 relative; every gradient after
      DDP's all-reduce within 1e-3 relative L2, except the detector's,
      within 5e-2: its BatchNorm gradients are cancelling sums that f32
      gets wrong by up to a few percent on either device (phase 7's
      reference), and here the batch's sums are taken in two halves;
      those 0 by construction (``ZERO_GRADIENT``) not compared; every
      running statistic after step 1 within 1e-4 relative L2; the step-2
      loss within 1e-2 relative. (Set at 1e-3 before the first run; three
      runs read 1.94e-3 to 1.95e-3. AdamW's first step moves each element by
      lr times the sign of its gradient, and 43,565 of the 622M gradient
      elements come out of DDP's f32 sums with the other sign: most in the
      attention key biases, whose gradient is 0 up to rounding, 697 in the
      detector, whose BatchNorm gradients carry up to 4e-3 of f32 rounding.
      Two runs of the reference flip none and agree to 1e-7. The f64 check
      (e) holds the two steps' semantics.) The reference runs twice; how far
      it repeats itself is printed beside the sign flips. Then 3 bf16 steps
      (after a warm-up): the step's wall per rank and the global samples/s,
      printed beside phase 7's single-process step;
    - (b) tensor parallelism: ``tp=2``, ``dp=1``, f32, the module path,
      each rank on the whole batch: both steps' losses within 1e-4 of the
      reference's;
    - a sharded eval batch (``parallel.eval.make_sharded_eval_step``) of
      the main path's config in bf16, 8 samples a rank, the fused kernels:
      the gathered scores (16, 4500) finite, each rank's rows its own;
    - (e) the tiny config (``tiny_config``, dropout 0) in f64 on the card,
      DDP at batch 4 (2 a rank) against one process: both steps' losses, the
      step-1 gradients (those 0 by construction not compared) and running
      statistics within 1e-9 relative (the point kernels compute in f32 on
      both sides, alike per sample).

    Launches on each rank, each step: as ``expected_train_launches`` for
    (a) and (b) (FPS 5, ball query 5, its backward 1), as
    ``expected_launches`` (a rank forward) for the eval batch.

    (c) The driver: ``python -m torch.distributed.run --standalone
    --nproc_per_node 1 -m bridgeqa_tpu_torch.scripts.train`` with
    ``TORCHRUN_ARGS`` (``--distributed --bf16 --remat --check_syncs``):
    NCCL at world size 1 through DDP. A DET stage of 2 steps, a VQA stage
    of 2 steps on its graft, then a resume for one more epoch; each must
    exit 0, write its run's files once (rank 0 alone: no other rank's
    directory), log its steps once each, and, under ``--check_syncs``,
    raise at any host sync between log points (DDP's own included: its
    traceback names the place). Cut: ``--tiny`` (the detector at full
    width, the BLIP at test width) and batch 2, since phase 8 runs the
    drivers at full width; this checks the process group, DDP over NCCL
    and the sync check."""
    import shutil

    t_phase = time.perf_counter()
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    PARALLEL_DIR.mkdir(parents=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    port = _free_port()
    script = Path(__file__).resolve()
    procs = [subprocess.Popen([sys.executable, str(script), "--parallel-rank", str(r),
                               str(PARALLEL_WORLD), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(PARALLEL_WORLD)]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=PARALLEL_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outputs)):
        (PARALLEL_DIR / f"rank{r}.log").write_text(text)
        if p.returncode != 0:
            raise AssertionError(f"parallel rank {r} exited {p.returncode}:\n{text[-4000:]}")
    ranks = [json.loads((PARALLEL_DIR / f"rank{r}.json").read_text())
             for r in range(PARALLEL_WORLD)]
    t_ranks = time.perf_counter() - t_phase
    cfg = parallel_config()
    expected = expected_train_launches(cfg)
    # each rank runs the rank forward on its shard; the collectives that
    # gather the outputs and average the scalars launch none of ours
    expected_eval = expected_launches(main_config())
    ref = ranks[0]["reference"]
    failed = []

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-12)

    for res in ranks:
        r = res["rank"]
        dp, tp = res["ddp"], res["tp"]
        step1 = {k: rel(dp["losses"][0][k], ref["losses"][0][k]) for k in TRAIN_LOSSES}
        failed += [f"rank {r} ddp step-1 {k} {v:.2e}" for k, v in step1.items()
                   if v > PARALLEL_LOSS_TOL]
        if rel(dp["losses"][1]["loss"], ref["losses"][1]["loss"]) > PARALLEL_LOSS2_TOL:
            failed.append(f"rank {r} ddp step-2 loss {dp['losses'][1]['loss']} against "
                          f"{ref['losses'][1]['loss']}")
        for k in range(2):
            if rel(tp["losses"][k]["loss"], ref["losses"][k]["loss"]) > PARALLEL_LOSS_TOL:
                failed.append(f"rank {r} tp step-{k + 1} loss {tp['losses'][k]['loss']} against "
                              f"{ref['losses'][k]['loss']}")
        for what, counts in (("ddp", dp["launches"]), ("tp", tp["launches"])):
            failed += [f"rank {r} {what} step {k} launches {c}" for k, c in enumerate(counts)
                       if c != expected]
        ev = res["eval"]
        if ev["launches"] != expected_eval:
            failed.append(f"rank {r} eval launches {ev['launches']}, expected {expected_eval}")
        if ev["shape"] != [PARALLEL_BATCH, NUM_ANSWERS] or not ev["finite"] or not ev["own_rows"]:
            failed.append(f"rank {r} eval outputs {ev}")
    if ref["launches"][0] != expected:
        failed.append(f"reference launches {ref['launches'][0]}")
    grads = ranks[0]["ddp"]["grads"]
    checked = {n: v for n, v in grads.items() if not n.endswith(ZERO_GRADIENT)}
    worst = sorted(((v, n) for n, v in checked.items()), reverse=True)
    failed += [f"grad {n} {v:.2e}" for v, n in worst
               if v > (PARALLEL_DETECTOR_GRAD_TOL if n.startswith("detector.")
                       else PARALLEL_GRAD_TOL)]
    if ranks[0]["ddp"]["grads_missing"] or not checked:
        failed.append(f"gradients only in the reference {ranks[0]['ddp']['grads_missing'][:5]}")
    stats = sorted(((v, n) for n, v in ranks[0]["ddp"]["stats"].items()), reverse=True)
    failed += [f"stat {n} {v:.2e}" for v, n in stats if v > PARALLEL_STAT_TOL]
    tiny = ranks[0]["tiny_f64"]
    tiny_loss = max(rel(res["tiny_f64"]["losses"][k][key], tiny["reference"][k][key])
                    for res in ranks for k in range(2) for key in TRAIN_LOSSES)
    tiny_grads = sorted(((v, n) for n, v in tiny["grads"].items()
                         if not n.endswith(ZERO_GRADIENT)), reverse=True)
    tiny_stats = max(tiny["stats"].values())
    if (tiny_loss > PARALLEL_F64_TOL or tiny_grads[0][0] > PARALLEL_F64_TOL
            or tiny_stats > PARALLEL_F64_TOL):
        failed.append(f"tiny f64: losses {tiny_loss:.2e}, gradients {tiny_grads[:3]}, "
                      f"statistics {tiny_stats:.2e}")
    worst_outside = [(n, float(f"{v:.3g}")) for v, n in worst if not n.startswith("detector.")]
    worst_detector = [(n, float(f"{v:.3g}")) for v, n in worst if n.startswith("detector.")]
    log(f"parallel (a) ddp, 2 ranks on one card over gloo, f32 against one process at batch "
        f"{PARALLEL_BATCH}: step-1 loss {ranks[0]['ddp']['losses'][0]['loss']:.6f} against "
        f"{ref['losses'][0]['loss']:.6f}, step-2 {ranks[0]['ddp']['losses'][1]['loss']:.6f} "
        f"against {ref['losses'][1]['loss']:.6f}; worst gradients outside the detector "
        f"{worst_outside[:3]}, in it {worst_detector[:3]} ({len(checked)} compared); worst "
        f"statistics {[(n, float(f'{v:.3g}')) for v, n in stats[:2]]}")
    rep = ref["repeat_grads"]
    rep_worst = sorted(((v, n) for n, v in rep.items() if not n.endswith(ZERO_GRADIENT)),
                       reverse=True)
    rep_shown = [(n, float(f"{v:.3g}")) for v, n in rep_worst[:3]]
    log(f"parallel reference repeated (one process, same weights and batch): step-1 loss "
        f"{ref['repeat_losses'][0]['loss']:.6f}, step-2 {ref['repeat_losses'][1]['loss']:.6f}; "
        f"worst gradients against the first run {rep_shown}; "
        f"gradient elements of another sign: repeat {ref['repeat_sign_flips'][0]} of "
        f"{ref['repeat_sign_flips'][1]}, ddp {ranks[0]['ddp']['sign_flips'][0]} of "
        f"{ranks[0]['ddp']['sign_flips'][1]}")
    log(f"parallel ddp gradient elements of another sign than the reference's, by parameter: "
        f"{ranks[0]['ddp']['sign_flips_by'][:6]}; in the detector "
        f"{ranks[0]['ddp']['sign_flips_detector']} of {ranks[0]['ddp']['sign_flips'][0]}")
    log(f"parallel (e) tiny config, f64, ddp against one process on the card, two steps: "
        f"losses within {tiny_loss:.3g} relative, worst gradients "
        f"{[(n, float(f'{v:.3g}')) for v, n in tiny_grads[:2]]}, statistics {tiny_stats:.3g}")
    log(f"parallel (b) tp=2: losses {[round(x['loss'], 6) for x in ranks[0]['tp']['losses']]} "
        f"against {[round(x['loss'], 6) for x in ref['losses']]}; launches per rank a step "
        f"{json.dumps(ranks[0]['tp']['launches'][0])} (expected {json.dumps(expected)})")
    log(f"parallel eval batch: gathered scores {ranks[0]['eval']['shape']}, mean loss "
        f"{ranks[0]['eval']['loss']:.4f}, launches per rank "
        f"{json.dumps(ranks[0]['eval']['launches'])}")
    log(f"parallel timings on {card_name_and_power()}:")
    for res in ranks:
        t = res["timing"]
        log(f"parallel (a) bf16 step, rank {res['rank']}: median {t['median_s'] * 1e3:.1f} ms "
            f"({', '.join(f'{w * 1e3:.1f}' for w in t['walls_s'])}) -> "
            f"{PARALLEL_BATCH / t['median_s']:.2f} samples/s over the global batch "
            f"{PARALLEL_BATCH}, against phase 7's one process {resident_samples_per_s:.2f} "
            f"samples/s: two ranks sharing one card measure correctness, not scaling")
    log(f"parallel: reference {ref['seconds']:.1f} s, peak memory per rank: reference "
        f"{ref['peak_gb']:.2f} GB, ddp f32 {ranks[0]['ddp']['peak_gb']:.2f} GB, tp f32 "
        f"{ranks[0]['tp']['peak_gb']:.2f} GB; the ranks took {t_ranks:.1f} s")
    if failed:
        raise AssertionError(f"parallel checks failed: {failed[:12]}")
    torchrun_s = phase_torchrun(device)
    log(f"parallel: phase {time.perf_counter() - t_phase:.1f} s (ranks {t_ranks:.1f} s, "
        f"torchrun driver {torchrun_s:.1f} s)")
    return {"ddp": ranks[0]["ddp"]["launches"][0], "tp": ranks[0]["tp"]["launches"][0],
            "sharded eval": ranks[0]["eval"]["launches"]}


def phase_torchrun(device) -> float:
    """Phase 9 (c): the ``train`` driver under torchrun, NCCL at world size 1
    (``phase_parallel``'s docstring). Returns its seconds."""
    import shutil

    t0 = time.perf_counter()
    root = PARALLEL_DIR / "runs"
    shutil.rmtree(root, ignore_errors=True)
    repo = Path(__file__).resolve().parent
    runs = {"det": ["--stage", "DET", "--epochs", "1", "--synthetic_records", "4"],
            "vqa": ["--first_stage_ckpt_path", str(root / "det"), "--epochs", "1",
                    "--synthetic_records", "4"],
            "resume": ["--use_checkpoint", str(root / "vqa"), "--epochs", "2",
                       "--synthetic_records", "4"]}
    failed, seconds = [], {}
    for name, argv in runs.items():
        tag = "vqa" if name == "resume" else name
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m", "bridgeqa_tpu_torch.scripts.train",
               *TORCHRUN_ARGS, "--device", device.type, "--output_root", str(root),
               "--tag", f"{tag}-resumed" if name == "resume" else tag, *argv]
        t1 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True, timeout=600)
        seconds[name] = time.perf_counter() - t1
        (PARALLEL_DIR / f"torchrun-{name}.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise AssertionError(f"torchrun {name} exited {proc.returncode}:\n"
                                 f"{(proc.stdout + proc.stderr)[-5000:]}")
    for name in runs:
        run_dir = root / ("vqa-resumed" if name == "resume" else name)
        missing = [a for a in RUN_ARTIFACTS if not (run_dir / a).exists()]
        others = sorted(p.name for p in run_dir.iterdir() if p.name.startswith("rank"))
        records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text()
                   .splitlines()]
        train_steps = sorted(r["step"] for r in records if r["phase"] == "train")
        log_text = (run_dir / "log.txt").read_text()
        if missing or others or train_steps != sorted(set(train_steps)) or not train_steps:
            failed.append(f"{name}: missing {missing}, other ranks' files {others}, logged "
                          f"steps {train_steps}")
        if "rank 0/1" not in log_text:
            failed.append(f"{name}: the log does not show a one-rank process group")
        if name == "resume" and "resumed from" not in log_text:
            failed.append("resume: no resume in its log")
    if failed:
        raise AssertionError(f"torchrun driver checks failed: {failed}")
    log(f"parallel (c) torchrun train --distributed (NCCL, world size 1, DDP, --check_syncs): "
        f"DET, VQA and resume exit 0, no host sync between log points, files written once; "
        f"seconds {json.dumps({k: round(v, 1) for k, v in seconds.items()})}")
    return time.perf_counter() - t0


# phase 10: the non-main paths. (name, points, centres, nsample, radius,
# calls a detector forward in exact mode makes): the main path's five
# shapes, SA1 with an odd nsample, and SA1 on a dense cloud (a 1 m cube:
# every ball holds far more than nsample, so every centre stops early)
EXACT_SHAPES = [(name, n, m, ns, r, 1) for name, n, m, ns, r, _ in BQ_SHAPES] + [
    ("sa1 odd nsample", NUM_POINTS, 2048, 63, 0.2, 0), ("sa1 dense", NUM_POINTS, 2048, 64, 0.2, 0)]
LANG_LEN = 36  # MAX_TEXT_LEN of the data pipeline: the GloVe words of a question
# a row of bf16 probabilities, each rounded once from the f32 softmax (at
# most 2^-8 of itself), sums to 1 within 2^-8; twice that
DUMP_SUM_TOL = 2.0 ** -7


def exact_scan_tests(radius: float, nsample: int, xyz, ctr) -> tuple[int, int]:
    """(distance tests the exact scan needs, centres whose ball holds at
    least ``nsample``): each centre tests the points up to its
    ``nsample``-th qualifier, or every point when fewer qualify."""
    from bridgeqa_tpu_torch.ops import grouping

    b, n, _ = xyz.shape
    r2 = float(np.float32(radius * radius))
    tests = full = 0
    for s in range(0, ctr.shape[1], 256):
        rank = (grouping.pairwise_sqdist(ctr[:, s:s + 256], xyz) < r2).cumsum(-1, dtype=torch.int32)
        enough = rank[..., -1] >= nsample
        stop = torch.searchsorted(rank, torch.full(rank.shape[:2] + (1,), nsample,
                                                   dtype=torch.int32, device=xyz.device))[..., 0]
        tests += int(torch.where(enough, stop + 1, n).sum())
        full += int(enough.sum())
    return tests, full


def phase_exact_kernel(device, batch: int = BATCH, reps: int = 5):
    """Phase 10 (a): the exact query's kernel (``csrc/ball_query_exact.cu``)
    against its plain version, bitwise, at ``EXACT_SHAPES`` on
    ``make_cloud``'s clouds (padding, duplicates, 4 empty balls but on the
    dense cloud; SA1's 40000 points are no multiple of 128 nor of the
    kernel's 1024-point tile). Card times (``device_ms``, or its
    ``queued_ms`` fallback: each row's ``timer`` says which), the distance
    tests the scan needs on this data and the bound from them, and the
    launch as ``grouping.last_exact_launch`` reports it; no single PyTorch
    call computes the query, so ``library_ms`` is None. Returns its record
    of the kernels line."""
    from bridgeqa_tpu_torch.ops import grouping

    rng = np.random.RandomState(21)
    rows = []
    for name, n, m, ns, radius, calls in EXACT_SHAPES:
        dense = name.endswith("dense")
        xyz_np = make_cloud(rng, batch, n) / (6.0 if dense else 1.0)
        centres = xyz_np[:, rng.permutation(n)[:m]].copy()
        if not dense:
            centres[:, :4] += 100.0  # empty balls
        xyz = torch.from_numpy(xyz_np).to(device)
        ctr = torch.from_numpy(centres).to(device)
        idx = grouping.ball_query_exact(radius, ns, xyz, ctr)
        launch = dict(grouping.last_exact_launch)
        want = grouping.ball_query_exact_plain(radius, ns, xyz, ctr)
        torch.cuda.synchronize()
        same = torch.equal(idx, want)
        tests, full = exact_scan_tests(radius, ns, xyz, ctr)
        ok = same and (full == batch * m if dense else bool((idx[:, :4] == 0).all()))
        fallbacks = len(queued_fallbacks)
        ms = device_ms(lambda: grouping.ball_query_exact(radius, ns, xyz, ctr), reps)
        timer = "device_ms" if len(queued_fallbacks) == fallbacks else "queued_ms"
        plain_ms = device_ms(lambda: grouping.ball_query_exact_plain(radius, ns, xyz, ctr),
                             max(1, reps // 2))
        # a distance test: 3 sub, 3 mul, 2 add, a compare
        bound_ms, bound_by = bound(tests * 9.0, batch * (n * 12 + m * 12 + m * ns * 4), PEAK_F32)
        rows.append(dict(shape=f"{name}: N={n}, M={m}, nsample={ns}, r={radius}, batch {batch}",
                         calls=calls, bitwise=ok, max_abs_err=max_err(idx, want), ms=ms,
                         plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                         bound_by=bound_by, timer=timer, distance_tests=tests, full_balls=full,
                         launch=launch))
        log(f"exact ball query {name}: N={n}, M={m}, ns={ns}, r={radius}: bitwise {same}, "
            f"balls of at least nsample {full} of {batch * m}, kernel {ms:.4f} ms card time "
            f"({timer}), "
            f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}, {tests} tests, "
            f"{tests / (batch * m * n):.3f} of a full scan), library_ms null; launch "
            f"{json.dumps(launch)}")
    bad = [r for r in rows if not r["bitwise"]]
    if bad:
        raise AssertionError(f"the exact ball query's kernel and plain version disagree: {bad}")
    return dict(name="ball_query_exact", route="cuda",
                source="bridgeqa_tpu_torch/csrc/ball_query_exact.cu",
                replaces="bridgeqa_tpu/ops/grouping.py:112", rows=rows,
                timer="+".join(sorted({r["timer"] for r in rows})),
                per="one detector forward in exact mode: each main-path shape's median times "
                    "the calls it gets")


def expected_detector_launches(cfg, exact: bool) -> dict:
    """Kernel launches of a detector forward: FPS and one ball query (the
    stripe kernel, or with ``exact`` the exact one) per main-path shape."""
    counts = {k: 0 for k in expected_launches(cfg)}
    counts.update(fps=len(FPS_SHAPES))
    counts["ball_query_exact" if exact else "ball_query_stripes"] = len(BQ_SHAPES)
    return counts


def add_lang(batch: dict, seed: int) -> dict:
    """The MCAN model's question input: ``LANG_LEN`` 300-d word vectors of
    GloVe's scale and lengths from 1 to ``LANG_LEN``."""
    rng = np.random.RandomState(seed + 50)
    b = batch["point_clouds"].shape[0]
    device = batch["point_clouds"].device
    batch["lang_feat"] = torch.from_numpy((rng.randn(b, LANG_LEN, 300) * 0.4)
                                          .astype(np.float32)).to(device)
    batch["lang_len"] = torch.from_numpy(rng.randint(1, LANG_LEN + 1, b).astype(np.int32)).to(device)
    return batch


def mcan_main_config():
    """The MCAN 3D-only model as the drivers build it for ``--no_blip``: the
    JAX defaults (hidden 128, 2 MCAN layers of 8 heads, AttFlat to 1024,
    the LSTM over 300-d word vectors)."""
    from bridgeqa_tpu_torch.models.bridgeqa import BridgeQAConfig

    return BridgeQAConfig(num_answers=NUM_ANSWERS, input_feature_dim=1, use_blip=False)


def classifier_main_config(two_d3d: bool, remat: bool = False):
    """The main path's config in classifier mode (``use_text_decoder=False``)."""
    base = main_config()
    blip = dataclasses.replace(base.blip, use_scene_classifier_2d3d=two_d3d, remat=remat,
                               remat_mode="block")
    return dataclasses.replace(base, use_text_decoder=False, blip=blip)


def _forward_checked(name, model, batch, expected, keys, shapes, failed, **kw):
    """One forward without grad, launches zeroed just before and read just
    after: they must equal ``expected``; ``keys`` finite, ``shapes`` as
    given. Returns (outputs, launches)."""
    with torch.inference_mode():
        reset_launches()
        out = model(batch, **kw)
        torch.cuda.synchronize()
        launches = read_launches()
    wrong = {k: (launches[k], n) for k, n in expected.items() if launches[k] != n}
    if wrong:
        failed.append(f"{name}: launches (got, expected) {wrong}")
    bad = [k for k in keys if not bool(torch.isfinite(out[k].float()).all())]
    bad += [f"{k} {tuple(out[k].shape)}" for k, s in shapes.items() if tuple(out[k].shape) != s]
    if bad:
        failed.append(f"{name}: outputs not finite or of another shape {bad}")
    return out, launches


def _timed(fn, reps: int) -> tuple[float, list]:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def _profiled_ms(fn, path: Path) -> tuple[float, float]:
    """(device ms, wall ms) of one ``fn()`` under ``torch.profiler``; the
    table by kernel into ``path``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    OUT_DIR.mkdir(exist_ok=True)
    return profile_table(prof, path)[0], wall_ms


def _train_once(name, model, batch, expected, failed, gen) -> tuple[float, float, dict]:
    """One warm-up ``train_step`` and one timed, launches of the timed one
    zeroed just before and read just after (they must equal ``expected``),
    its losses and gradients finite. Returns (step ms, peak GB, launches)."""
    from bridgeqa_tpu_torch.train.optim import build_optimizer
    from bridgeqa_tpu_torch.train.step import train_step

    optimizer = build_optimizer(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_step(model, optimizer, batch, bn_momentum=0.1, generator=gen)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    metrics = train_step(model, optimizer, batch, bn_momentum=0.1, generator=gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    values = {k: float(metrics[k]) for k in TRAIN_LOSSES}
    grads_finite = all(bool(p.grad.isfinite().all()) for p in model.parameters()
                       if p.grad is not None)
    wrong = {k: (launches[k], n) for k, n in expected.items() if launches[k] != n}
    if not all(np.isfinite(v) for v in values.values()) or not grads_finite or wrong:
        failed.append(f"{name}: losses {values}, gradients finite {grads_finite}, launches "
                      f"(got, expected) {wrong}")
    log(f"{name}: step {step_ms:.1f} ms at batch {TRAIN_BATCH} (the second step; host clock), "
        f"peak memory {peak_gb:.2f} GB, loss {values['loss']:.3f}, answer loss "
        f"{values['answer_loss']:.3f}, launches {json.dumps(launches)}")
    return step_ms, peak_gb, launches


def phase_nonmain_reference(device):
    """Phase 10 (f): the tiny config (``tiny_config``) on the card (kernels,
    f32) against the same weights on the CPU (plain versions, f32): the
    MCAN model, classifier mode with ``answer_cls_2d3d`` (the fused ViT on
    both sides: "force" on the CPU, "auto" on the card), and the detector
    in exact mode (``grouping.FORCE_MODE = "exact"``). The exact query's
    indices must be bitwise (every SA module's and the vote aggregation's
    centres follow from them); floats within 1e-3, as ``phase_reference``
    holds them (the two devices sum matrix products in another order)."""
    from bridgeqa_tpu_torch.ops import grouping
    from bridgeqa_tpu_torch.ops import vit_block as vb

    base = tiny_config()
    cases = {
        "mcan": (dataclasses.replace(base, use_blip=False),
                 ("answer_scores", "lang_scores", "cluster_ref", "fuse_feat", "center"),
                 ("fps", "ball_query_stripes")),
        "classify": (dataclasses.replace(base, use_text_decoder=False, blip=dataclasses.replace(
            base.blip, use_scene_classifier_2d3d=True)),
                     ("answer_scores", "answer_scores_2d", "answer_scores_scene",
                      "answer_scores_2d3d", "lang_scores", "cluster_ref"),
                     ("fps", "ball_query_stripes", "scoring_gemm", "vit_attention",
                      "scoring_layernorm")),
        "exact detector": (dataclasses.replace(base, stage="DET"),
                           ("center", "aggregated_vote_xyz", "objectness_scores"),
                           ("fps", "ball_query_exact")),
    }
    worst = {}
    for name, (cfg, keys, launched) in cases.items():
        cpu_model = build_model(cfg, torch.device("cpu"), seed=13)
        card_model = copy.deepcopy(cpu_model).to(device)
        batch = add_lang(make_batch(cfg, 2, 4096, 64, 20, 6, torch.device("cpu"), seed=4), 4)
        exact = name == "exact detector"
        try:
            grouping.FORCE_MODE = "exact" if exact else None
            with torch.inference_mode():
                vb.FUSED_MODE = "force"
                want = cpu_model(batch)
                vb.FUSED_MODE = "auto"
                reset_launches()
                got = card_model({k: v.to(device) for k, v in batch.items()})
                torch.cuda.synchronize()
                launches = read_launches()
        finally:
            grouping.FORCE_MODE = None
            vb.FUSED_MODE = "auto"
        wrong = sorted(k for k, n in launches.items() if (n > 0) != (k in launched))
        if wrong:
            raise AssertionError(f"{name} reference: kernels launched or not against what the "
                                 f"path runs: {wrong}, launches {launches}")
        for key in ("sa1_inds", "sa2_inds", "fp2_inds", "aggregated_vote_inds", "bbox_mask"):
            if not torch.equal(got[key].cpu(), want[key]):
                raise AssertionError(f"{name} reference: {key} differs between the card and "
                                     "the CPU")
        for key in keys:
            err = float((got[key].cpu().float() - want[key].float()).abs().max())
            worst[f"{name} {key}"] = err
            if not err <= 1e-3:
                raise AssertionError(f"{name} reference: {key} differs by {err}")
    log(f"non-main references (tiny config, f32, card vs CPU): indices equal; max abs err "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in worst.items()})}")


def phase_nonmain(device, reps: int = 5) -> dict:
    """Phase 10: the paths off the main one, at full width on the card.
    (a) the exact query's kernel (``phase_exact_kernel``); (b) the main
    path's detector (40000 points, batch 8, bf16) under
    ``grouping.FORCE_MODE = "exact"``: the exact kernel 5 launches, the
    stripe kernel 0, FPS 5, outputs finite, and its time beside the stripe
    detector's (medians of ``reps``, in turns); (c) the MCAN model
    (``mcan_main_config``) in bf16: the eval forward at batch 8 (FPS 5, the
    stripe query 5, nothing else; heads' shapes; median of ``reps`` and
    device time), one train step at batch 16 (the backward kernel 1 more);
    (d) classifier mode (``classifier_main_config``) both ways in bf16: the
    eval forward at batch 8 (the ViT's kernels as in the rank forward, no
    scoring or vocabulary kernel), one train step at batch 16 with remat
    "block"; (e) the rank forward with ``output_attentions``: the four
    dumps' shapes, each row summing to 1 within ``DUMP_SUM_TOL``, and the
    answer scores bitwise those of the same forward without dumps; (f)
    ``phase_nonmain_reference``. Returns (the exact kernel's record, the
    launches of each new path)."""
    from bridgeqa_tpu_torch.models.layers import set_compute_dtype
    from bridgeqa_tpu_torch.ops import grouping

    t_phase = time.perf_counter()
    record = phase_exact_kernel(device)
    failed, paths = [], {}
    base = main_config()
    batch = make_batch(base, BATCH, NUM_POINTS, IMAGE_SIZE, QUESTION_LEN, ANSWER_LEN, device)

    # (b) the detector in exact mode
    det_cfg = dataclasses.replace(base, stage="DET")
    model = set_compute_dtype(build_model(det_cfg, device), torch.bfloat16)
    det_batch = {"point_clouds": batch["point_clouds"]}
    floats = ("center", "objectness_scores", "aggregated_vote_xyz", "size_residuals")
    try:
        grouping.FORCE_MODE = "exact"
        out, paths["exact detector"] = _forward_checked(
            "exact detector", model, det_batch, expected_detector_launches(det_cfg, True), floats,
            {"center": (BATCH, base.num_proposal, 3)}, failed)
        times = {}
        with torch.inference_mode():
            for mode in ("exact", None, "exact", None):
                grouping.FORCE_MODE = mode
                ms, _ = _timed(lambda: model(det_batch), reps)
                times.setdefault(mode or "stripes", []).append(ms)
    finally:
        grouping.FORCE_MODE = None
    log(f"exact detector: launches {json.dumps(paths['exact detector'])}; forward at batch "
        f"{BATCH}, bf16, median of {reps} (two turns each): exact {times['exact']} ms, stripes "
        f"{times['stripes']} ms")
    del model

    # (c) the MCAN model
    cfg = mcan_main_config()
    model = set_compute_dtype(build_model(cfg, device), torch.bfloat16)
    mbatch = add_lang(dict(batch), 0)
    heads = ("answer_scores", "lang_scores", "cluster_ref", "fuse_feat")
    out, paths["mcan forward"] = _forward_checked(
        "mcan forward", model, mbatch, expected_detector_launches(cfg, False), heads,
        {"answer_scores": (BATCH, NUM_ANSWERS), "lang_scores": (BATCH, cfg.num_object_class),
         "cluster_ref": (BATCH, cfg.num_proposal), "fuse_feat": (BATCH, cfg.mcan_flat_out_size)},
        failed)
    with torch.inference_mode():
        latency, runs = _timed(lambda: model(mbatch), reps)
        busy_ms, wall_ms = _profiled_ms(lambda: model(mbatch), OUT_DIR / "profile_mcan_forward.txt")
    log(f"mcan forward at batch {BATCH}, bf16: median {latency:.1f} ms over {reps} runs "
        f"({', '.join(f'{t:.1f}' for t in runs)}), {BATCH / latency * 1e3:.2f} QA pairs/s; "
        f"profiled: {busy_ms:.1f} ms of device time in {wall_ms:.1f} ms (busy "
        f"{busy_ms / wall_ms:.0%}); launches {json.dumps(paths['mcan forward'])}")
    tbatch = add_lang(make_train_batch(cfg, TRAIN_BATCH, NUM_POINTS, IMAGE_SIZE, QUESTION_LEN,
                                       ANSWER_LEN, device), 1)
    gen = torch.Generator(device=device).manual_seed(7)
    expected = expected_detector_launches(cfg, False)
    expected["ball_query_backward"] = 1
    *_, paths["mcan train step"] = _train_once("mcan train step", model, tbatch, expected,
                                               failed, gen)
    del model

    # (d) classifier mode, both ways
    for two_d3d in (False, True):
        cfg = classifier_main_config(two_d3d)
        model = set_compute_dtype(build_model(cfg, device), torch.bfloat16)
        keys = ("answer_scores", "answer_scores_2d", "answer_scores_scene", "lang_scores",
                "cluster_ref") + (("answer_scores_2d3d",) if two_d3d else ())
        name = f"classify forward{' 2d3d' if two_d3d else ''}"
        out, launches = _forward_checked(name, model, batch, expected_generate_launches(cfg),
                                         keys, {k: (BATCH, NUM_ANSWERS) for k in keys[:3]},
                                         failed)
        if not two_d3d:
            paths["classify forward"] = launches
        with torch.inference_mode():
            latency, _ = _timed(lambda: model(batch), reps)
        log(f"{name} at batch {BATCH}, bf16: median {latency:.1f} ms over {reps} runs; launches "
            f"{json.dumps(launches)}")
        del model
    cfg = classifier_main_config(True, remat=True)
    model = set_compute_dtype(build_model(cfg, device), torch.bfloat16)
    tbatch = make_train_batch(cfg, TRAIN_BATCH, NUM_POINTS, IMAGE_SIZE, QUESTION_LEN, ANSWER_LEN,
                              device)
    _train_once("classify train step (2d3d, remat 'block')", model, tbatch,
                expected_train_launches(cfg), failed, gen)
    del model, tbatch

    # (e) the attention dumps of the rank forward
    model = set_compute_dtype(build_model(base, device), torch.bfloat16)
    out, _ = _forward_checked("rank forward with dumps", model, batch, expected_launches(base),
                              ("answer_scores",), {}, failed, k_test=K_TEST,
                              output_attentions=True)
    with torch.inference_mode():
        plain = model(batch, k_test=K_TEST)
    heads = base.blip.med.num_attention_heads
    widths = {"2d_self_attention": QUESTION_LEN, "3d_self_attention": QUESTION_LEN,
              "2d_cross_attention": VIT_TOKENS + QUESTION_LEN,
              "3d_cross_attention": base.num_proposal + QUESTION_LEN}
    sums = {}
    for key, width in widths.items():
        att = out[key]
        if tuple(att.shape) != (BATCH, heads, QUESTION_LEN, width):
            failed.append(f"dumps: {key} {tuple(att.shape)}")
            continue
        sums[key] = float((att.float().sum(-1) - 1.0).abs().max())
        if not sums[key] <= DUMP_SUM_TOL:
            failed.append(f"dumps: {key} rows sum to 1 within {sums[key]}")
    same = {k: torch.equal(out[k], plain[k]) for k in ("answer_scores", "answer_scores_2d",
                                                         "answer_scores_scene", "cluster_ref")}
    if not all(same.values()):
        failed.append(f"dumps: outputs differ from the forward without dumps {same}")
    log(f"rank forward with dumps: shapes {json.dumps({k: list(out[k].shape) for k in widths})}, "
        f"largest |row sum - 1| {json.dumps({k: float(f'{v:.3g}') for k, v in sums.items()})} "
        f"(tolerance {DUMP_SUM_TOL}), equal to the forward without dumps {json.dumps(same)}")
    del model, out, plain
    torch.cuda.empty_cache()

    phase_nonmain_reference(device)
    if failed:
        raise AssertionError(f"non-main path checks failed: {failed}")
    log(f"non-main paths: phase {time.perf_counter() - t_phase:.1f} s")
    return record, paths


# ------------------------------------------------------------------ phase 11

ITM_IMAGE = 384  # BLIP-ITM base, the view-selection tool's default
ITM_TOKENS = (ITM_IMAGE // 16) ** 2 + 1
ITM_FRAMES = 64  # one image batch of the tool
ITM_ROWS = ITM_FRAMES * ITM_TOKENS
ITM_KERNEL_TOL = 1e-3  # of each kernel's largest output, f32 against its plain version
ITM_TOWER_TOL = 0.01  # relative L2 error of each image's tower output
VIEW_SCENES, VIEW_FRAMES, VIEW_QUESTIONS = 2, 96, 16
ENET_BATCH = 32
ENET_H, ENET_W = 256, 328
PROJ_POINTS, PROJ_VIEWS = 50000, 64
TOOLS_DIR = OUT_DIR / "tools"
PROFILE_TRAIN_REPS = 3
# card against CPU at the tiny configs, f32 with TF32 off on both
TINY_ITM_TOL = 1e-4  # features, cosines and logits, absolute
TINY_ENET_TOL = 1e-4  # of the largest feature
TINY_TIE_TOL = 1e-4  # of a half-integer before rounding, of a cosine between frames


def itm_config(tiny: bool):
    from bridgeqa_tpu_torch.models.blip_itm import BlipITMConfig
    from bridgeqa_tpu_torch.models.med import MedConfig

    if not tiny:
        return BlipITMConfig(image_size=ITM_IMAGE)
    med = MedConfig(vocab_size=200, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                    intermediate_size=128, max_position_embeddings=64, encoder_width=128)
    return BlipITMConfig(med=med, image_size=48, vit="custom", embed_dim=32,
                         vit_custom_embed_dim=128, vit_custom_depth=2, vit_custom_heads=2)


def build_itm(cfg, device, seed: int):
    """BLIP-ITM in f32 (as the JAX tool builds it) with weights from
    ``seed`` and every bias and LayerNorm parameter perturbed."""
    from bridgeqa_tpu_torch.models.blip_itm import BLIPITM
    from bridgeqa_tpu_torch.models.layers import init_weights

    gen = torch.Generator(device=device).manual_seed(seed)
    return perturb_affine(init_weights(BLIPITM(cfg, device=device), gen), gen)


def expected_encode_launches(depth: int) -> dict:
    """The kernels one ``encode_images`` launches: every ViT block's, and
    the final LayerNorm."""
    from bridgeqa_tpu_torch.ops import vit_block as vb

    want = {k: n * depth for k, n in vb.LAUNCHES_PER_BLOCK.items()}
    want["scoring_layernorm"] += 1
    return {k: want.get(k, 0) for k in read_launches()}


def itm_kernel_rows(device, reps: int = 3) -> tuple[dict, list]:
    """The fused ViT's kernels in f32 at the ITM shape (64 frames of 577
    tokens) against their plain versions: each within ``ITM_KERNEL_TOL`` of
    its own largest output; card time (``device_ms``), plain and library
    time, bound. Returns ({kernel: rows}, failures)."""
    from bridgeqa_tpu_torch.ops import scoring_layer as sl
    from bridgeqa_tpu_torch.ops import vit_block as vb

    gen = torch.Generator(device=device).manual_seed(11)
    rows, failures = {"scoring_gemm": [], "vit_attention": [], "scoring_layernorm": []}, []

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    def row(name, shape, got, want, fn, plain, library, flops, nbytes, calls, exact=None):
        """``exact``: the f64 reference of a 3xTF32 kernel, held to
        ``F32_ROUTE_TOL`` of its largest output."""
        err = max_err(got, want)
        tol = ITM_KERNEL_TOL * float(want.abs().max())
        if not err <= tol:
            failures.append(f"{name} {shape}: f32 error {err} over {tol}")
        route = {}
        if exact is not None:
            ref = exact()
            rel = float((got.double() - ref).abs().max() / ref.abs().max())
            route = dict(f64_rel_err=rel, tf32x3_bound_ms=tf32_bound(flops, nbytes))
            del ref
            if not rel <= F32_ROUTE_TOL:
                failures.append(f"{name} {shape}: {rel} of the largest output from the f64 "
                                f"reference, over {F32_ROUTE_TOL}")
        ms, plain_ms, lib_ms = device_ms(fn, reps), device_ms(plain, 1), device_ms(library, reps)
        bound_ms, bound_by = bound(flops, nbytes, PEAK_F32)
        rows[name].append(dict(shape=shape, calls=calls, max_abs_err=err, tolerance=tol, ms=ms,
                               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                               bound_by=bound_by, **route))
        log(f"ITM f32 {name} {shape}: err {err:.3g} (tol {tol:.3g})"
            + (f", {route['f64_rel_err']:.3g} of the largest output from f64 (tol "
               f"{F32_ROUTE_TOL})" if route else "")
            + f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library {lib_ms:.3f} ms, bound "
            f"{bound_ms:.3f} ms ({bound_by}, FFMA)"
            + (f", {route['tf32x3_bound_ms']:.3f} ms (3xTF32)" if route else "")
            + f", {calls} calls an encode")

    h = HIDDEN
    for name, k, n, gelu, with_res in VIT_GEMM_SHAPES:
        x, w, b = randn(ITM_ROWS, k), randn(n, k, scale=0.02), randn(n, scale=0.5)
        res = randn(ITM_ROWS, n, scale=2.0) if with_res else None

        def exact():
            y = x.double() @ w.double().T + b.double()
            y = 0.5 * y * (1.0 + torch.erf(y * 0.5 ** 0.5)) if gelu else y
            return y if res is None else res.double() + y

        row("scoring_gemm", f"{name}: ({ITM_ROWS}, {k}) x ({n}, {k})^T",
            sl.scoring_gemm(x, w, b, gelu, res), sl.scoring_gemm_plain(x, w, b, gelu, res),
            lambda: sl.scoring_gemm(x, w, b, gelu, res),
            lambda: sl.scoring_gemm_plain(x, w, b, gelu, res), lambda: F.linear(x, w, b),
            2.0 * ITM_ROWS * n * k, 4 * (ITM_ROWS * k + n * k + n
                                         + ITM_ROWS * n * (2 if with_res else 1)), 12, exact)
        del x, w, b, res
    qkv = randn(ITM_FRAMES, ITM_TOKENS, 3 * h)
    q, k, v = qkv.view(ITM_FRAMES, ITM_TOKENS, 3, VIT_HEADS, h // VIT_HEADS).permute(2, 0, 3, 1, 4)
    got, want = vb.vit_attention(qkv, heads=VIT_HEADS), vb.vit_attention_plain(qkv, heads=VIT_HEADS)

    def exact():
        qd, kd, vd = q.double(), k.double(), v.double()
        ctx = torch.softmax(qd @ kd.transpose(-1, -2) / (h // VIT_HEADS) ** 0.5, dim=-1) @ vd
        return ctx.transpose(1, 2).reshape(ITM_FRAMES, ITM_TOKENS, h)

    row("vit_attention", f"({ITM_FRAMES}, {ITM_TOKENS}, {3 * h}), {VIT_HEADS} heads of 64",
        got, want, lambda: vb.vit_attention(qkv, heads=VIT_HEADS),
        lambda: vb.vit_attention_plain(qkv, heads=VIT_HEADS),
        lambda: F.scaled_dot_product_attention(q, k, v),
        4.0 * ITM_FRAMES * VIT_HEADS * ITM_TOKENS ** 2 * (h // VIT_HEADS),
        4 * ITM_FRAMES * ITM_TOKENS * 4 * h, 12, exact)
    rel = head_rel_l2(got, want, VIT_HEADS)
    log(f"ITM f32 vit_attention: max relative L2 error per image and head {rel:.3g}")
    rows["vit_attention"][-1]["library_backends"] = sdpa_backends(
        f"ITM ({ITM_FRAMES}, {VIT_HEADS}, {ITM_TOKENS}, 64)", q, k, v)
    del qkv, q, k, v, got, want
    a, r = randn(ITM_ROWS, h), randn(ITM_ROWS, h, scale=2.0)
    scale, shift = randn(h, scale=0.5) + 1.0, randn(h, scale=0.5)
    row("scoring_layernorm", f"LN1 and final norm: ({ITM_ROWS}, {h})",
        sl.add_layernorm(a, None, scale, shift, 1e-6),
        sl.add_layernorm_plain(a, None, scale, shift, 1e-6),
        lambda: sl.add_layernorm(a, None, scale, shift, 1e-6),
        lambda: sl.add_layernorm_plain(a, None, scale, shift, 1e-6),
        lambda: F.layer_norm(a, (h,), scale, shift, 1e-6), 8.0 * ITM_ROWS * h,
        4 * 2 * ITM_ROWS * h + 8 * h, 13)
    (gsum, got), (wsum, want) = (sl.add_layernorm(a, r, scale, shift, 1e-6, keep_sum=True),
                                 sl.add_layernorm_plain(a, r, scale, shift, 1e-6, keep_sum=True))
    if not torch.equal(gsum, wsum):
        failures.append("scoring_layernorm LN2: the kept sum is not bitwise a + r")
    row("scoring_layernorm", f"LN2 keeping the sum: ({ITM_ROWS}, {h}) + ({ITM_ROWS}, {h})",
        got, want, lambda: sl.add_layernorm(a, r, scale, shift, 1e-6, keep_sum=True),
        lambda: sl.add_layernorm_plain(a, r, scale, shift, 1e-6, keep_sum=True),
        lambda: F.layer_norm(a + r, (h,), scale, shift, 1e-6), 10.0 * ITM_ROWS * h,
        4 * 4 * ITM_ROWS * h + 8 * h, 12)
    del a, r, gsum, got, wsum, want
    torch.cuda.empty_cache()
    return rows, failures


def itm_tower(device, model, images) -> tuple[dict, list]:
    """The image tower three ways on the same frames: the kernels
    (``vit_block.FUSED_MODE`` "auto"), the fused blocks through their plain
    versions, and the module loop ("off"); each image's output within
    ``ITM_TOWER_TOL`` relative of the kernels'. Returns (the launches of one
    ``encode_images``, failures)."""
    from bridgeqa_tpu_torch.ops import scoring_layer as sl
    from bridgeqa_tpu_torch.ops import vit_block as vb

    vit, failures = model.visual_encoder, []
    norm = vit.norm

    def plain_tower():
        x = vb.fused_vit_blocks(vit, vit.embed(images), block=vb.vit_block_plain)
        return sl.add_layernorm_plain(x.reshape(-1, vit.embed_dim), None, norm.weight,
                                      norm.bias, norm.eps).reshape(x.shape)

    def module_tower():
        try:
            vb.FUSED_MODE = "off"
            return vit(images)
        finally:
            vb.FUSED_MODE = "auto"

    with torch.inference_mode():
        reset_launches()
        model.encode_images(images)
        torch.cuda.synchronize()
        launches = read_launches()
        want = expected_encode_launches(len(vit.blocks))
        if launches != want:
            failures.append(f"encode_images launches {launches}, derived {want}")
        got = vit(images).float().flatten(1)
        times = {"kernels": time_ms(lambda: vit(images), 1), "plain": time_ms(plain_tower, 1),
                 "module loop": time_ms(module_tower, 1)}
        errs = {}
        for name, fn in (("plain", plain_tower), ("module loop", module_tower)):
            ref = fn().float().flatten(1)
            errs[name] = float(((got - ref).norm(dim=1) / ref.norm(dim=1)).max())
            if not errs[name] <= ITM_TOWER_TOL:
                failures.append(f"ITM tower, kernels against {name}: {errs[name]} relative")
            del ref
    frames_s = {k: ITM_FRAMES / (v / 1e3) for k, v in times.items()}
    log(f"ITM tower (ViT-B/16 at {ITM_IMAGE} px, f32, {ITM_FRAMES} frames of {ITM_TOKENS} "
        f"tokens): kernels {times['kernels']:.1f} ms, fused blocks through the plain versions "
        f"{times['plain']:.1f} ms, module loop {times['module loop']:.1f} ms; frames/s "
        f"{json.dumps({k: round(v, 1) for k, v in frames_s.items()})}; max relative L2 error "
        f"per image against the kernels {json.dumps(errs)} (tol {ITM_TOWER_TOL}); launches per "
        f"encode_images {json.dumps({k: n for k, n in launches.items() if n})}")
    return launches, failures


class _FramePool:
    """A ``SceneViewsPool`` stand-in for the view lookup's round trip: a
    frame's "image" is its number (the card's machine reads no JPEG)."""

    def get(self, scene_id, name):
        return np.float32(name[:-4]), np.zeros((2, 2), np.float32), np.eye(4, dtype=np.float32)


def view_selection(device, model) -> list:
    """``select_best_views`` at full width: ``VIEW_SCENES`` synthetic scenes
    of ``VIEW_FRAMES`` frames at 384 px (two image batches a scene, the
    second padded), ``VIEW_QUESTIONS`` questions and the rule-based
    composer; the launches of 2 x 2 ``encode_images``; the i2tfile through
    ``load_scene_view_map`` and ``make_view_lookup``; ``itm_scores`` at batch
    8 finite. Then the ``view_select`` driver at full width."""
    from bridgeqa_tpu_torch.data import views
    from bridgeqa_tpu_torch.data.sources import synthetic_records, synthetic_tokenizer
    from bridgeqa_tpu_torch.scripts import view_select as view_script
    from bridgeqa_tpu_torch.tools import compose_decl
    from bridgeqa_tpu_torch.tools.view_select import save_i2tfile, select_best_views

    failures = []
    records = synthetic_records(VIEW_QUESTIONS, num_scenes=VIEW_SCENES)
    tokenizer = synthetic_tokenizer()
    decl = compose_decl.compose_declarations(records, str(TOOLS_DIR / "decl.json"),
                                             resume=False)
    frames = view_script.SyntheticFrames(ITM_IMAGE, VIEW_FRAMES)
    batches = VIEW_SCENES * -(-VIEW_FRAMES // ITM_FRAMES)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    i2t = select_best_views(model, records, tokenizer, frames, decl_map=decl,
                            image_batch=ITM_FRAMES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = {k: n * batches for k, n in expected_encode_launches(len(model.visual_encoder.blocks)).items()}
    if launches != want:
        failures.append(f"view selection launches {launches}, derived {want}")
    path = TOOLS_DIR / "i2t.json"
    save_i2tfile(i2t, str(path))
    loaded = views.load_scene_view_map(str(path))
    lookup = views.make_view_lookup(_FramePool(), loaded, topk=3)
    bad = [r["question_id"] for r in records
           if lookup(r["scene_id"], str(r["question_id"]))[0].tolist()
           != [int(n[:-4]) for n in i2t["view"][str(r["question_id"])][:3]]]
    if loaded != i2t["view"] or len(loaded) != VIEW_QUESTIONS or bad:
        failures.append(f"i2tfile round trip: {len(loaded)} questions, lookups differ for {bad}")
    if any(len(v) != VIEW_FRAMES or sorted(s, reverse=True) != s
           for v, s in zip(i2t["view"].values(), i2t["itm_scores"].values())):
        failures.append("view selection: a ranking is not every frame, best first")
    ids, mask = tokenizer.encode_batch([decl[str(r["question_id"])] for r in records[:8]], 40)
    with torch.inference_mode():
        _, images = frames(records[0]["scene_id"])
        logits = model.itm_scores(torch.from_numpy(images[:8]).to(device),
                                  torch.from_numpy(ids).to(device),
                                  torch.from_numpy(mask).to(device))
    if logits.shape != (8, 2) or not bool(torch.isfinite(logits).all()):
        failures.append(f"itm_scores: {tuple(logits.shape)}, finite "
                        f"{bool(torch.isfinite(logits).all())}")
    log(f"view selection ({VIEW_SCENES} scenes x {VIEW_FRAMES} frames at {ITM_IMAGE} px, "
        f"{VIEW_QUESTIONS} questions, {batches} image batches of {ITM_FRAMES}): {wall:.2f} s, "
        f"{VIEW_SCENES * VIEW_FRAMES / wall:.1f} frames/s, {wall / VIEW_SCENES * 1e3:.0f} ms a "
        f"scene; launches {json.dumps({k: n for k, n in launches.items() if n})}; itm_scores at "
        f"batch 8 {tuple(logits.shape)}, finite")

    reset_launches()
    t0 = time.perf_counter()
    out = view_script.main(["--synthetic", "--device", "cuda",
                            "--out", str(TOOLS_DIR / "driver_i2t.json")])
    launches = read_launches()
    n_batches = len({r["scene_id"] for r in synthetic_records(8)})
    want = {k: n * n_batches for k, n in expected_encode_launches(12).items()}
    if launches != want or len(out["view"]) != 8:
        failures.append(f"view_select driver: {len(out['view'])} questions, launches {launches}, "
                        f"derived {want}")
    log(f"view_select driver (--synthetic, base at {ITM_IMAGE} px): {len(out['view'])} "
        f"questions in {time.perf_counter() - t0:.1f} s with the model's build")
    return failures


def enet_and_projection(device) -> list:
    """ENet's encoder at 256x328, batch 32, f32, and the projection of a
    ``PROJ_POINTS``-point scene into ``PROJ_VIEWS`` views of 41x32x128
    features: times; then their drivers on synthetic data."""
    from bridgeqa_tpu_torch.models.enet import ENetEncoder
    from bridgeqa_tpu_torch.models.layers import init_weights
    from bridgeqa_tpu_torch.scripts import (compute_multiview_features,
                                            project_multiview_color,
                                            project_multiview_features,
                                            project_multiview_labels)
    from bridgeqa_tpu_torch.tools import projection

    failures = []
    gen = torch.Generator(device=device).manual_seed(12)
    encoder = init_weights(ENetEncoder(device), gen)
    frames = torch.rand(ENET_BATCH, ENET_H, ENET_W, 3, generator=gen, device=device)
    with torch.inference_mode():
        feats = encoder(frames)
        ms = time_ms(lambda: encoder(frames), 5)
    if feats.shape != (ENET_BATCH, ENET_H // 8, ENET_W // 8, 128) or not bool(
            torch.isfinite(feats).all()):
        failures.append(f"ENet: {tuple(feats.shape)}")
    log(f"ENet encoder (batch {ENET_BATCH} at {ENET_H}x{ENET_W}, f32, cuDNN): {ms:.2f} ms a "
        f"batch, {ENET_BATCH / ms * 1e3:.1f} frames/s; features {tuple(feats.shape)}")
    del encoder, frames, feats

    # the scene: points in a 6 x 6 x 3 m room, cameras at 1.5 m looking
    # across it, each depth map the nearest point it sees (so hits are real)
    rng = np.random.RandomState(13)
    w, h = projection.FEATURE_DIMS
    intr = projection.adjust_intrinsic(np.array([[577.870605, 0, 319.5, 0],
                                                 [0, 577.870605, 239.5, 0], [0, 0, 1, 0],
                                                 [0, 0, 0, 1]]), (640, 480), (w, h))
    points = (rng.rand(PROJ_POINTS, 3) * [6.0, 6.0, 3.0]).astype(np.float32)
    poses = np.zeros((PROJ_VIEWS, 4, 4), np.float32)
    for k in range(PROJ_VIEWS):
        yaw = 2 * np.pi * k / PROJ_VIEWS
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        down = np.array([0.0, 0.0, -1.0])
        right = np.cross(down, fwd)
        poses[k, :3, :3] = np.stack([right, down, fwd], 1)
        poses[k, :3, 3] = [3.0 - 2.0 * fwd[0], 3.0 - 2.0 * fwd[1], 1.5]
        poses[k, 3, 3] = 1.0
    helper = projection.ProjectionHelper(intr)
    pts, pose_t = torch.from_numpy(points).to(device), torch.from_numpy(poses).to(device)
    with torch.inference_mode():
        pcam = (torch.cat([pts, torch.ones_like(pts[:, :1])], 1)
                @ torch.linalg.inv(pose_t).transpose(1, 2))[..., :3]
        z = pcam[..., 2]
        safe_z = torch.where(z.abs() < 1e-6, 1e-6, z)
        u = torch.round(float(intr[0, 0]) * pcam[..., 0] / safe_z + float(intr[0, 2]))
        v = torch.round(float(intr[1, 1]) * pcam[..., 1] / safe_z + float(intr[1, 2]))
        seen_by = ((u >= 0) & (u < w) & (v >= 0) & (v < h) & (z >= projection.DEPTH_MIN)
                   & (z <= projection.DEPTH_MAX))
        pixel = (v.clamp(0, h - 1) * w + u.clamp(0, w - 1)).long()
        depth = torch.full((PROJ_VIEWS, h * w), 1e9, device=device)
        depth.scatter_reduce_(1, pixel, torch.where(seen_by, z, 1e9), "amin")
        depth = depth.view(PROJ_VIEWS, h, w)
        depth = torch.where(depth < 1e9, depth, 0.0)
        features = torch.rand(PROJ_VIEWS, h, w, 128, generator=gen, device=device)
        out = projection.project_scene_multiview(helper, pts, pose_t, depth, features)
        _, valid = helper.project(pts, pose_t, depth)
        ms = time_ms(lambda: projection.project_scene_multiview(helper, pts, pose_t, depth,
                                                                features), 5)
    seen = float((valid.any(0)).float().mean())
    if out.shape != (PROJ_POINTS, 128) or not bool(torch.isfinite(out).all()) or seen == 0:
        failures.append(f"projection: {tuple(out.shape)}, {seen} of the points seen")
    log(f"projection ({PROJ_POINTS} points, {PROJ_VIEWS} views of {w}x{h}x128, maxpool): "
        f"{ms:.2f} ms; {int(valid.sum())} hits, {seen:.1%} of the points seen by a view")
    del depth, features, out, valid, pcam, z, u, v, pixel, seen_by

    t0 = time.perf_counter()
    n = compute_multiview_features.main(["--synthetic", "--device", "cuda",
                                         "--out", str(TOOLS_DIR / "multiview")])
    files = sorted((TOOLS_DIR / "multiview").rglob("*.npy"))
    shapes = {np.load(f).shape for f in files}
    if n != 8 or len(files) != 8 or shapes != {(ENET_H // 8, ENET_W // 8, 128)}:
        failures.append(f"compute_multiview_features: {n} frames, {len(files)} files {shapes}")
    for mod, extra in ((project_multiview_features, []),
                       (project_multiview_labels, ["--what", "labels"]),
                       (project_multiview_color, [])):
        name = mod.__name__.rsplit(".", 1)[-1]
        out_dir = TOOLS_DIR / name
        n = mod.main(["--synthetic", "--device", "cuda", "--out", str(out_dir)] + extra)
        arr = np.load(out_dir / "synth0000_00.npy")
        if n != 1 or not np.isfinite(arr).all():
            failures.append(f"{name}: {n} scenes, finite {np.isfinite(arr).all()}")
        log(f"{name} driver: {arr.shape} {arr.dtype}")
    log(f"multiview drivers: {time.perf_counter() - t0:.1f} s")
    return failures


def reference_detector_state_dict(tree, seed: int) -> dict:
    """A reference checkpoint's detector (the ScanQA module names, torch
    layouts) at the shapes of ``tree``, a DET-stage model's
    ``export_jax_variables``, drawn from ``seed``: the detector part of
    ``tests/test_torch_converters.py::_RefStateDict``."""
    rng = np.random.RandomState(seed)
    sd = {}

    def draw(shape, scale=0.05):
        return (rng.randn(*shape) * scale).astype(np.float32)

    def conv1x1(key, node):
        cin, cout = node["kernel"].shape
        sd[f"{key}.weight"] = draw((cout, cin, 1))
        if "bias" in node:
            sd[f"{key}.bias"] = draw(node["bias"].shape)

    def norm(key, node):
        n = node["scale"].shape
        sd[f"{key}.weight"], sd[f"{key}.bias"] = 1.0 + draw(n, 0.1), draw(n, 0.1)
        sd[f"{key}.running_mean"] = draw(n, 0.3)
        sd[f"{key}.running_var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)

    def shared_mlp(prefix, node):
        j = 0
        while f"layer{j}" in node:
            conv1x1(f"{prefix}.layer{j}.conv", node[f"layer{j}"])
            norm(f"{prefix}.layer{j}.bn.bn", node[f"bn{j}"])
            j += 1

    p = tree["params"]["detector"]
    for name in ("sa1", "sa2", "sa3", "sa4"):
        shared_mlp(f"detection_backbone.{name}.mlp_module", p["backbone_net"][name]["mlp_module"])
    for name in ("fp1", "fp2"):
        shared_mlp(f"detection_backbone.{name}.mlp", p["backbone_net"][name]["mlp"])
    for i in (1, 2, 3):
        conv1x1(f"voting_net.conv{i}", p["vgen"][f"conv{i}"])
    for i in (1, 2):
        norm(f"voting_net.bn{i}", p["vgen"][f"bn{i}"])
    prop = p["proposal"]
    shared_mlp("proposal_net.vote_aggregation.mlp_module", prop["vote_aggregation"]["mlp_module"])
    conv1x1("proposal_net.proposal.0", prop["proposal_mlp"]["layer0"])
    norm("proposal_net.proposal.1", prop["proposal_mlp"]["bn0"])
    conv1x1("proposal_net.proposal.3", prop["proposal_mlp"]["layer1"])
    norm("proposal_net.proposal.4", prop["proposal_mlp"]["bn1"])
    conv1x1("proposal_net.proposal.6", prop["proposal_out"])
    return sd


def parity_and_profilers(device) -> list:
    """``verify_parity`` on a fabricated detector checkpoint (20000
    synthetic points, 256 proposals, the exact query on the card), then
    ``profile_train`` at batch 16 with ``PROFILE_TRAIN_REPS`` reps a phase
    and ``profile_loader`` briefly."""
    from bridgeqa_tpu_torch.convert import export_jax_variables
    from bridgeqa_tpu_torch.models.bridgeqa import BridgeQA, BridgeQAConfig
    from bridgeqa_tpu_torch.ops import grouping
    from bridgeqa_tpu_torch.scripts import profile_loader, profile_train, verify_parity

    failures = []
    det = BridgeQA(BridgeQAConfig(num_answers=1, stage="DET"), device="cpu")
    sd = reference_detector_state_dict(export_jax_variables(det), seed=3)
    ckpt = TOOLS_DIR / "detector.pth"
    torch.save({"model": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}}, ckpt)
    reset_launches()
    t0 = time.perf_counter()
    report = verify_parity.main(["--checkpoint", str(ckpt), "--synthetic", "--device", "cuda",
                                 "--out", str(TOOLS_DIR / "parity_report.json")])
    launches = read_launches()
    corners = np.asarray(report["bbox_corners"])
    if (report["params_skipped"] or report["params_loaded"] != len(sd)
            or corners.shape != (256, 8, 3) or not np.isfinite(corners).all()
            or launches["ball_query_exact"] != 5 or launches["ball_query_stripes"] != 0
            or grouping.FORCE_MODE is not None):
        failures.append(f"verify_parity: loaded {report['params_loaded']} of {len(sd)}, skipped "
                        f"{report['params_skipped'][:3]}, corners {corners.shape}, launches "
                        f"{launches}")
    log(f"verify_parity (fabricated detector checkpoint, 20000 points): {report['params_loaded']}"
        f" arrays loaded, {len(report['params_skipped'])} skipped, {report['num_boxes_kept']} "
        f"boxes kept, {time.perf_counter() - t0:.1f} s; launches "
        f"{json.dumps({k: n for k, n in launches.items() if n})}")

    t0 = time.perf_counter()
    reps, profile_train.REPS = profile_train.REPS, PROFILE_TRAIN_REPS
    try:
        results = profile_train.main(["--batch", "16", "--device", "cuda"])
    finally:
        profile_train.REPS = reps
    if set(results) != set(profile_train.PHASES) or not all(t > 0 for t in results.values()):
        failures.append(f"profile_train: {results}")
    log(f"profile_train (batch 16, {PROFILE_TRAIN_REPS} reps a phase): "
        f"{time.perf_counter() - t0:.1f} s with the model's build")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    sps = profile_loader.main(["--device", "cuda", "--batch", "4", "--num_workers", "2",
                               "--min_samples", "16"])
    if not sps > 0:
        failures.append(f"profile_loader: {sps} samples/s")
    log(f"profile_loader (batch 4, 2 workers, 16 samples): {time.perf_counter() - t0:.1f} s")
    return failures


def _tie_free(helper, points, poses):
    """(N,) True for the points whose u and v, before rounding, lie more
    than ``TINY_TIE_TOL`` from a half-integer in every view (CPU, f32)."""
    intr = torch.as_tensor(helper.intrinsic)
    pcam = (torch.cat([points, torch.ones_like(points[:, :1])], 1)
            @ torch.linalg.inv(poses).transpose(1, 2))[..., :3]
    z = torch.where(pcam[..., 2].abs() < 1e-6, 1e-6, pcam[..., 2])
    pre = torch.stack([intr[0, 0] * pcam[..., 0] / z + intr[0, 2],
                       intr[1, 1] * pcam[..., 1] / z + intr[1, 2]], -1)
    return ((pre - pre.floor() - 0.5).abs() > TINY_TIE_TOL).all(-1).all(0)


def tools_reference(device) -> list:
    """The tiny configs on the card against the CPU, same weights, f32 (TF32
    off): BLIP-ITM's features, cosines and logits within ``TINY_ITM_TOL``
    (the fused ViT forced on the CPU, the kernels on the card); view
    selection's rankings equal wherever two frames' cosines differ by more
    than ``TINY_TIE_TOL``; ENet within ``TINY_ENET_TOL`` of its largest
    feature; the projection's uv and valid equal and its features, label
    votes and colours equal on the points no view rounds on a tie."""
    from bridgeqa_tpu_torch.data.sources import synthetic_records, synthetic_tokenizer
    from bridgeqa_tpu_torch.models.enet import create_enet_for_3d
    from bridgeqa_tpu_torch.models.layers import init_weights
    from bridgeqa_tpu_torch.ops import vit_block as vb
    from bridgeqa_tpu_torch.scripts import project_multiview_labels as labels
    from bridgeqa_tpu_torch.tools import projection
    from bridgeqa_tpu_torch.tools.view_select import select_best_views

    failures, errs, cpu = [], {}, torch.device("cpu")
    cpu_itm = build_itm(itm_config(tiny=True), cpu, seed=14)
    card_itm = copy.deepcopy(cpu_itm).to(device)
    rng = np.random.RandomState(14)
    images = rng.rand(3, 48, 48, 3).astype(np.float32)
    ids = rng.randint(1, 200, (3, 12)).astype(np.int32)
    mask = np.ones((3, 12), np.int32)
    mask[1, 7:] = 0

    def itm_outputs(model, dev):
        args = [torch.from_numpy(a).to(dev) for a in (images, ids, mask)]
        with torch.inference_mode():
            return {"encode_images": model.encode_images(args[0]),
                    "encode_texts": model.encode_texts(*args[1:]),
                    "itc_scores": model(*args), "itm_scores": model(*args, match_head="itm")}

    try:
        vb.FUSED_MODE = "force"
        want = itm_outputs(cpu_itm, cpu)
    finally:
        vb.FUSED_MODE = "auto"
    reset_launches()
    got = itm_outputs(card_itm, device)
    if read_launches()["vit_attention"] != 3 * 2:
        failures.append("tiny ITM: the ViT's kernels did not run on the card")
    for key in want:
        errs[key] = max_err(got[key].cpu(), want[key])
        if not errs[key] <= TINY_ITM_TOL:
            failures.append(f"tiny ITM {key}: {errs[key]}")

    records = synthetic_records(6, num_scenes=2)

    def frames(scene_id):
        r = np.random.RandomState(sum(map(ord, scene_id)))
        return [f"{i * 20}.jpg" for i in range(7)], r.rand(7, 48, 48, 3).astype(np.float32)

    try:
        vb.FUSED_MODE = "force"
        want_i2t = select_best_views(cpu_itm, records, synthetic_tokenizer(), frames,
                                     image_batch=4, text_len=12)
    finally:
        vb.FUSED_MODE = "auto"
    got_i2t = select_best_views(card_itm, records, synthetic_tokenizer(), frames, image_batch=4,
                                text_len=12)
    for qid, names in want_i2t["view"].items():
        score = dict(zip(names, want_i2t["itm_scores"][qid]))
        rank = {n: i for i, n in enumerate(got_i2t["view"][qid])}
        if any(score[a] > score[b] + TINY_TIE_TOL and rank[a] > rank[b]
               for a in names for b in names):
            failures.append(f"tiny view selection: question {qid} ranked otherwise")
    errs["view scores"] = max(float(np.abs(np.subtract(got_i2t["itm_scores"][q],
                                                       want_i2t["itm_scores"][q])).max())
                              for q in want_i2t["itm_scores"])
    del cpu_itm, card_itm

    gen = torch.Generator().manual_seed(15)
    cpu_enc, cpu_cls = create_enet_for_3d(41, device=cpu)
    for m in (cpu_enc, cpu_cls):
        init_weights(m, gen)
    with torch.no_grad():  # random statistics and slopes, so none hides
        for m in cpu_enc.modules():
            if hasattr(m, "running_var"):
                m.running_mean.normal_(0.0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
                m.weight.normal_(1.0, 0.2, generator=gen)
                m.bias.normal_(0.0, 0.2, generator=gen)
            elif hasattr(m, "alpha"):
                m.alpha.uniform_(0.0, 0.5, generator=gen)
    card_enc, card_cls = copy.deepcopy(cpu_enc).to(device), copy.deepcopy(cpu_cls).to(device)
    x = torch.rand(2, 48, 64, 3, generator=gen)
    with torch.inference_mode():
        want = cpu_cls(cpu_enc(x))
        got = card_cls(card_enc(x.to(device))).cpu()
    errs["enet"] = max_err(got, want) / float(want.abs().max())
    if not errs["enet"] <= TINY_ENET_TOL:
        failures.append(f"tiny ENet: {errs['enet']} of the largest logit")

    w, h = projection.FEATURE_DIMS
    intr = np.eye(4)
    intr[0, 0] = intr[1, 1] = 20.0
    intr[0, 2], intr[1, 2] = w / 2, h / 2
    helper = projection.ProjectionHelper(intr)
    points = torch.from_numpy((rng.rand(3000, 3) * [3, 3, 4] - [1.5, 1.5, 0]).astype(np.float32))
    poses = torch.eye(4).repeat(4, 1, 1)
    poses[:, :3, 3] = torch.from_numpy(rng.randn(4, 3).astype(np.float32) * 0.2)
    depths = torch.from_numpy(rng.uniform(0.5, 4.0, (4, h, w)).astype(np.float32))
    feats = torch.from_numpy(rng.rand(4, h, w, 16).astype(np.float32))
    maps = torch.from_numpy(rng.randint(-1, 6, (4, h, w)).astype(np.int32))
    keep = _tie_free(helper, points, poses)

    def project(dev):
        a = [t.to(dev) for t in (points, poses, depths, feats, maps)]
        uv, valid = helper.project(a[0], a[1], a[2])
        return {"uv": uv, "valid": valid,
                "maxpool": projection.project_scene_multiview(helper, *a[:4]),
                "labels": labels.project_labels(helper, *a[:3], a[4], 5),
                "color": labels.project_color(helper, *a[:3], a[3][..., :3])}

    want, got = project(cpu), {k: v.cpu() for k, v in project(device).items()}
    for key in want:
        # the points off the ties: along the views' axis for uv and valid
        g, w_ = ((t.transpose(0, 1)[keep] if key in ("uv", "valid") else t[keep])
                 for t in (got[key], want[key]))
        # the colours are means over the views: summed in another order
        ok = (max_err(g, w_) <= 1e-6) if key == "color" else torch.equal(g, w_)
        if not ok:
            failures.append(f"tiny projection {key}: the card differs from the CPU")
    errs["projection points on a tie"] = int((~keep).sum())
    log(f"tools reference (tiny configs, f32, card vs CPU): errors {json.dumps(errs)} (ITM "
        f"tol {TINY_ITM_TOL}, ENet {TINY_ENET_TOL} of its largest logit, ties "
        f"{TINY_TIE_TOL}); projection: uv, valid, features, votes and colours equal off the "
        f"ties, {int(want['valid'].sum())} hits")
    return failures


def phase_tools(device) -> tuple[dict, dict]:
    """Phase 11: the offline tools on the card. (a) BLIP-ITM base at 384 px
    in f32: the fused ViT's kernels at its shape (64 frames of 577 tokens)
    against their plain versions (``itm_kernel_rows``), and the tower three
    ways with the launches of one ``encode_images`` (``itm_tower``); (b)
    view selection at full width and its driver (``view_selection``); (c)
    ENet, the projection and their drivers (``enet_and_projection``); (d)
    ``verify_parity``, ``profile_train`` and ``profile_loader``
    (``parity_and_profilers``); (e) the tiny configs card against CPU
    (``tools_reference``). Returns ({kernel: its ITM rows}, the launches of
    one ``encode_images``, the "view select" path)."""
    t_phase = time.perf_counter()
    TOOLS_DIR.mkdir(parents=True, exist_ok=True)
    rows, failures = itm_kernel_rows(device)
    model = build_itm(itm_config(tiny=False), device, seed=10)
    gen = torch.Generator(device=device).manual_seed(10)
    images = torch.rand(ITM_FRAMES, ITM_IMAGE, ITM_IMAGE, 3, generator=gen, device=device)
    launches, tower_failures = itm_tower(device, model, images)
    failures += tower_failures
    del images
    failures += view_selection(device, model)
    del model
    torch.cuda.empty_cache()
    failures += enet_and_projection(device)
    failures += parity_and_profilers(device)
    failures += tools_reference(device)
    if failures:
        raise AssertionError(f"tool checks failed: {failures}")
    log(f"tools: phase {time.perf_counter() - t_phase:.1f} s")
    return rows, launches


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
    t_run = time.perf_counter()
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
    f32_rows = phase_main_path_f32(device)
    phase_generate_reference(device)
    generate_launches = phase_generate(device)
    kernels += phase_train_kernels(device)
    phase_train_reference(device)
    train_launches, resident_samples_per_s = phase_train(device)
    loop_launches, eval_launches = phase_drivers(device, resident_samples_per_s)
    parallel_launches = phase_parallel(device, resident_samples_per_s)
    exact_record, nonmain_launches = phase_nonmain(device)
    kernels.append(exact_record)
    itm_rows, view_select_launches = phase_tools(device)
    records = []
    for k in kernels:
        name = k["name"]
        path = ("train" if name in BACKWARD_ONLY else "exact detector" if name in EXACT_ONLY
                else "rank")
        by_path = {"rank": launches[name], "generate": generate_launches[name],
                   "train": train_launches[name], "train loop": loop_launches[name],
                   "eval": eval_launches[name],
                   **{f"{p} per rank": n[name] for p, n in parallel_launches.items()},
                   **{p: n[name] for p, n in nonmain_launches.items()},
                   "view select": view_select_launches[name]}
        record = dict(summarize(k, by_path[path], by_path), launches_path=path)
        if name in f32_rows:  # phase 5: f32 at the rank forward's shapes; a shape's
            # calls are the config's reckoning, not counted, and stay in the log
            record["f32_shapes"] = [{k: v for k, v in r.items() if k != "calls"}
                                    for r in f32_rows[name]]
            record["f32_route"] = F32_ROUTES[name]
        if name in itm_rows:  # phase 11: f32 at BLIP-ITM's 577 tokens, 64 frames
            record["itm_f32_shapes"] = itm_rows[name]
        records.append(record)
    log(f"device_ms: {len(dropped_traces)} trace(s) lacked card records in the whole run; "
        f"{len(queued_fallbacks)} reading(s) timed by queued_ms instead (reps, ms): "
        f"{queued_fallbacks}")
    log(f"whole run: {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:  # one of phase 9's ranks
        sys.exit(parallel_worker(*map(int, sys.argv[2:5])))
    sys.exit(main())
