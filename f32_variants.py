#!/usr/bin/env python3
"""Time the f32 kernels' and the point kernels' design choices, and the
kernels against an older tree's, in turns, in one process on one CUDA card.

    python3 f32_variants.py [--parent DIR]

- The vocabulary pass (``csrc/vocab_loss.cu``, f32) at the main path's
  shape (22528 rows, 30524 words, width 768) with its launch bound at one
  block an SM (the tree's) and at two (a copy of the source with
  ``kF32Blocks`` changed, built into ``build/variants/``), both at the
  split ``_splits`` picks; then under several splits (runs, tiles a run):
  ``_splits``' own, 40 tiles, one tile, the whole vocabulary in one run.
- The plan helpers' choices, each against every other choice, through the
  kernels' C entries: the exact scan-order ball query
  (``csrc/ball_query_exact.cu``) at ``grouping.exact_plan``'s centres a
  warp and at each other C, at the main path's five ball-query shapes
  (``chip_smoke.BQ_SHAPES``, batch 8) and SA1's dense cloud; the stripe
  query's backward (``csrc/ball_query_backward.cu``) at
  ``grouping.backward_plan``'s blocks a cloud and at each other count, at
  ``chip_smoke.BQ_BACKWARD_SHAPES`` (batch 16).
- With ``--parent DIR`` (an older commit unpacked there, for example by
  ``git archive <commit> | tar -x -C build/parent``): DIR's kernels against
  the tree's, parent, change, change, parent. DIR's library is built by
  DIR's own ``ops/cuda_lib.py`` (its sources and flags, into
  ``DIR/build/kernels``; its C entries typed by its ``_SIGNATURES``). The
  f32 kernels: the products and the ViT attention at BLIP-ITM's shape (64
  frames of 577 tokens), the scoring attentions at the rank forward's
  (24576 rows against 8 questions of 80 keys), and the vocabulary pass,
  each tree at its own ``_splits``. The point kernels through each tree's
  own wrappers (DIR's ``ops/grouping.py`` on DIR's library): the exact
  query at the five ``BQ_SHAPES``, the backward at both
  ``BQ_BACKWARD_SHAPES``; their outputs must agree (the exact indices
  bitwise, the backward within ``chip_smoke.BQ_BACKWARD_TOL`` of the
  largest value).

Card time per call by ``torch.profiler`` (``chip_smoke.device_ms``; the
vocabulary pass, which takes the card ~20 ms a call, by CUDA events around
back-to-back calls, ``chip_smoke.time_ms``; the backward, as its
``chip_smoke.py`` row, by ``chip_smoke.queued_ms``, 20 calls a loop, the
gaps between a call's kernels included). Prints one JSON line per
comparison and writes them all to ``build/f32_variants.json``; fails
without a card.
"""

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

ROWS, VOCAB, H = cs.VOCAB_ROWS, cs.VOCAB, cs.HIDDEN
OUT = cs.OUT_DIR / "variants"


def build(srcs: list[Path], name: str):
    """nvcc ``srcs`` (each beside the headers it includes) into
    ``OUT/name`` with the tree's flags; the library, its C entries typed."""
    from bridgeqa_tpu_torch.ops import cuda_lib

    OUT.mkdir(parents=True, exist_ok=True)
    objs = [OUT / f"{name}.{s.stem}.o" for s in srcs]
    procs = [subprocess.Popen([cuda_lib._nvcc(), *cuda_lib.source_flags(s), "-c", str(s), "-o",
                               str(o)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    for p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed:\n{log[-4000:]}")
    subprocess.run([cuda_lib._nvcc(), "-shared", *map(str, objs), "-o", str(OUT / name)],
                   check=True)
    lib = ctypes.CDLL(str(OUT / name))
    for entry, argtypes in cuda_lib._SIGNATURES.items():
        if hasattr(lib, entry):
            getattr(lib, entry).argtypes = argtypes
    return lib


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_parent_modules = {}


def parent_module(root: Path, name: str):
    """``root``'s ``bridgeqa_tpu_torch/ops/<name>.py``, loaded beside the
    tree's. Its ``cuda_lib`` is ``root``'s own (``root``'s sources, flags and
    ``_SIGNATURES``, built into ``root/build/kernels``); its other imports
    are the tree's."""
    key = (root.resolve(), name)
    if key not in _parent_modules:
        path = root / "bridgeqa_tpu_torch" / "ops" / f"{name}.py"
        if name == "cuda_lib":
            _parent_modules[key] = _load("parent_cuda_lib", path)
        else:
            import bridgeqa_tpu_torch.ops as ops
            from bridgeqa_tpu_torch.ops import cuda_lib

            parent_lib = parent_module(root, "cuda_lib")
            ops.cuda_lib = sys.modules["bridgeqa_tpu_torch.ops.cuda_lib"] = parent_lib
            try:
                _parent_modules[key] = _load(f"parent_{name}", path)
            finally:
                ops.cuda_lib = sys.modules["bridgeqa_tpu_torch.ops.cuda_lib"] = cuda_lib
    return _parent_modules[key]


def vocab_inputs(device):
    gen = torch.Generator(device=device).manual_seed(4)
    return (torch.randn(ROWS, H, generator=gen, device=device),
            torch.randn(VOCAB, H, generator=gen, device=device) * 0.02,
            torch.randn(VOCAB, generator=gen, device=device) * 0.5,
            torch.randint(0, VOCAB, (ROWS,), generator=gen, device=device, dtype=torch.int32))


def vocab_call(lib, inputs, split, device):
    """One f32 vocabulary pass through ``lib``'s C entry at ``split``."""
    from bridgeqa_tpu_torch.ops import cuda_lib

    h, table, bias, labels = inputs
    partial = torch.empty((split[0], ROWS, 4), device=device)
    out = [torch.empty(ROWS, device=device) for _ in range(3)]
    cuda_lib.check(lib.bq_vocab_reductions(
        h.data_ptr(), table.data_ptr(), bias.data_ptr(), labels.data_ptr(), partial.data_ptr(),
        *(o.data_ptr() for o in out), ROWS, VOCAB, H, *split, 0,
        cuda_lib.stream_handle(device)), "bq_vocab_reductions")
    return out


def in_turns(label: str, calls: dict, timer, results: list) -> None:
    """Time each of two ``calls`` as a, b, b, a and record the readings."""
    a, b = calls
    ms = {a: [], b: []}
    for k in (a, b, b, a):
        ms[k].append(timer(calls[k]))
    results.append({"what": label, "ms_a_call": ms})
    print(json.dumps(results[-1]), flush=True)


def exact_inputs(device, n, m, seed, dense=False):
    """``chip_smoke.phase_exact_kernel``'s clouds: padding, duplicates and 4
    empty balls a cloud, or a dense cloud with none."""
    rng = np.random.RandomState(seed)
    xyz = cs.make_cloud(rng, cs.BATCH, n) / (6.0 if dense else 1.0)
    centres = xyz[:, rng.permutation(n)[:m]].copy()
    if not dense:
        centres[:, :4] += 100.0
    return torch.from_numpy(xyz).to(device), torch.from_numpy(centres).to(device)


def backward_inputs(device, n, m, ns, radius, nf, seed):
    """``chip_smoke.phase_train_kernels``' indices (the forward kernel's, 4
    empty balls a cloud) and cotangents."""
    from bridgeqa_tpu_torch.ops import grouping

    rng = np.random.RandomState(seed)
    b = cs.TRAIN_BATCH
    xyz_np = cs.make_cloud(rng, b, n)
    centres = xyz_np[:, rng.permutation(n)[:m]].copy()
    centres[:, :4] += 100.0
    xyz, ctr = torch.from_numpy(xyz_np).to(device), torch.from_numpy(centres).to(device)
    feats = torch.from_numpy(rng.rand(b, n, nf).astype(np.float32)).to(device) if nf else None
    with torch.no_grad():
        idx, _, _ = grouping.ball_query_stripes(radius, ns, xyz, ctr, feats)
    gen = torch.Generator(device=device).manual_seed(seed)
    g_rel = torch.randn(b, m, ns, 3, generator=gen, device=device)
    g_grouped = torch.randn(b, m, ns, nf, generator=gen, device=device) if nf else None
    return idx, g_rel, g_grouped, n


def exact_at(c: int, radius, ns, xyz, ctr):
    """The tree's exact query through its C entry at ``c`` centres a warp
    (``ball_query_exact`` takes ``exact_plan``'s)."""
    from bridgeqa_tpu_torch.ops import cuda_lib, grouping

    b, n, _ = xyz.shape
    m = ctr.shape[1]
    idx = torch.empty((b, m, ns), dtype=torch.int32, device=xyz.device)
    cuda_lib.check(cuda_lib.lib().bq_ball_query_exact(
        xyz.data_ptr(), ctr.data_ptr(), idx.data_ptr(), b, n, m, ns, grouping._r2(radius), c,
        -(-m // (grouping.EXACT_WARPS * c)), (ctypes.c_int * 5)(),
        cuda_lib.stream_handle(xyz.device)), "bq_ball_query_exact")
    return idx


def backward_at(k: int, idx, g_rel, g_grouped, n):
    """The tree's backward through its C entry at ``k`` blocks a cloud
    (``ball_query_stripes_backward`` takes ``backward_plan``'s)."""
    from bridgeqa_tpu_torch.ops import cuda_lib

    b, m, s = idx.shape
    nf = 0 if g_grouped is None else g_grouped.shape[-1]
    out = [torch.empty(shape, device=idx.device) for shape in ((b, n, 3), (b, m, 3), (b, n, nf))]
    cuda_lib.check(cuda_lib.lib().bq_ball_query_backward(
        idx.data_ptr(), g_rel.data_ptr(), g_grouped.data_ptr() if nf else None,
        *(o.data_ptr() if o.numel() else None for o in out), b, n, m, s, nf, k, -(-n // k),
        -(-m // k), (ctypes.c_int * 3)(), cuda_lib.stream_handle(idx.device)),
        "bq_ball_query_backward")
    return out


def point_choices(device, results: list) -> None:
    """Each plan helper's choice against every other, in turns."""
    from bridgeqa_tpu_torch.ops import grouping

    sms = grouping._sms(device)
    exact = [(name, n, m, ns, r, False) for name, n, m, ns, r, _ in cs.BQ_SHAPES]
    exact.append(("sa1 dense", cs.NUM_POINTS, 2048, 64, 0.2, True))
    for name, n, m, ns, radius, dense in exact:
        xyz, ctr = exact_inputs(device, n, m, 21, dense)
        own = grouping.exact_plan(cs.BATCH, m, sms)["centres_per_warp"]
        for other in (c for c in grouping.CENTRES_PER_WARP if c != own):
            if not torch.equal(exact_at(other, radius, ns, xyz, ctr),
                               grouping.ball_query_exact(radius, ns, xyz, ctr)):
                raise AssertionError(f"exact query at {name}: C {other} gives other indices")
            in_turns(f"exact query at {name} (B={cs.BATCH}, N={n}, M={m}, nsample={ns}): "
                     f"{own} centres a warp (the plan) against {other}", {
                         str(c): (lambda c=c: exact_at(c, radius, ns, xyz, ctr))
                         for c in (own, other)},
                     lambda fn: cs.device_ms(fn, 5), results)
    for name, n, m, ns, radius, nf, _ in cs.BQ_BACKWARD_SHAPES:
        bw = backward_inputs(device, n, m, ns, radius, nf, 11)
        own = grouping.backward_plan(cs.TRAIN_BATCH, n, m, ns)["blocks_per_cloud"]
        for other in (k for k in (1, 2, 4, 8) if k != own):
            in_turns(f"backward at {name} (B={cs.TRAIN_BATCH}, N={n}, M={m}, nsample={ns}, "
                     f"nf={nf}): {own} blocks a cloud (the plan) against {other}", {
                         str(k): (lambda k=k, bw=bw: backward_at(k, *bw)) for k in (own, other)},
                     lambda fn: cs.queued_ms(fn, 20), results)


def point_parent(root: Path, device, results: list) -> None:
    """``root``'s point kernels against the tree's, each through its own
    tree's wrapper, in turns."""
    from bridgeqa_tpu_torch.ops import grouping

    pgrouping = parent_module(root, "grouping")
    for name, n, m, ns, radius, _ in cs.BQ_SHAPES:
        xyz, ctr = exact_inputs(device, n, m, 21)
        if not torch.equal(pgrouping.ball_query_exact(radius, ns, xyz, ctr),
                           grouping.ball_query_exact(radius, ns, xyz, ctr)):
            raise AssertionError(f"exact query at {name}: the parent's indices differ")
        in_turns(f"exact query at {name} (B={cs.BATCH}, N={n}, M={m}, nsample={ns}): parent "
                 f"against change", {
                     key: (lambda mod=mod: mod.ball_query_exact(radius, ns, xyz, ctr))
                     for key, mod in (("parent", pgrouping), ("change", grouping))},
                 lambda fn: cs.device_ms(fn, 5), results)
    for name, n, m, ns, radius, nf, _ in cs.BQ_BACKWARD_SHAPES:
        bw = backward_inputs(device, n, m, ns, radius, nf, 11)
        for g, w in zip(grouping.ball_query_stripes_backward(*bw),
                        pgrouping.ball_query_stripes_backward(*bw)):
            if w is not None and cs.max_err(g, w) > cs.BQ_BACKWARD_TOL * float(w.abs().max()):
                raise AssertionError(f"backward at {name}: the parent's sums differ")
        in_turns(f"backward at {name} (B={cs.TRAIN_BATCH}, N={n}, M={m}, nsample={ns}, "
                 f"nf={nf}): parent against change", {
                     key: (lambda mod=mod, bw=bw: mod.ball_query_stripes_backward(*bw))
                     for key, mod in (("parent", pgrouping), ("change", grouping))},
                 lambda fn: cs.queued_ms(fn, 20), results)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", type=Path, help="an older tree to compare with")
    args = parser.parse_args()
    device = cs.phase_device()
    cs.phase_build()
    from bridgeqa_tpu_torch.ops import cuda_lib
    from bridgeqa_tpu_torch.ops import vocab_loss as vl

    csrc = Path(cuda_lib.CSRC)
    tree = cuda_lib.lib()
    results = []
    inputs = vocab_inputs(device)
    split = vl._splits(ROWS, VOCAB, torch.float32, device)

    def events(fn):
        return cs.time_ms(fn, 3)

    # the launch bound: a copy of the sources with two blocks an SM
    two = OUT / "two_blocks"
    two.mkdir(parents=True, exist_ok=True)
    for f in csrc.glob("*.cuh"):
        (two / f.name).write_text(f.read_text())
    src = (csrc / "vocab_loss.cu").read_text()
    if "constexpr int kF32Blocks = 1;" not in src:
        raise RuntimeError("vocab_loss.cu: kF32Blocks is not 1")
    (two / "vocab_loss.cu").write_text(src.replace("constexpr int kF32Blocks = 1;",
                                                   "constexpr int kF32Blocks = 2;"))
    lib2 = build([two / "vocab_loss.cu"], "libvocab_two_blocks.so")
    in_turns(f"vocabulary pass f32 at split {split}: one block an SM against two",
             {"one": lambda: vocab_call(tree, inputs, split, device),
              "two": lambda: vocab_call(lib2, inputs, split, device)}, events, results)
    vtiles = -(-VOCAB // 128)
    for other in ((-(-vtiles // 40), 40), (vtiles, 1), (1, vtiles)):
        in_turns(f"vocabulary pass f32, one block an SM: split {split} against {other}",
                 {str(split): lambda: vocab_call(tree, inputs, split, device),
                  str(other): lambda o=other: vocab_call(tree, inputs, o, device)},
                 events, results)

    if args.parent:
        parent = parent_module(args.parent, "cuda_lib").lib()
        pvl = parent_module(args.parent, "vocab_loss")
        psplit = pvl._splits(ROWS, VOCAB, torch.float32, device)
        libs = {"parent": parent, "change": tree}
        stream = cuda_lib.stream_handle(device)
        gen = torch.Generator(device=device).manual_seed(5)

        def randn(*shape, scale=1.0):
            return torch.randn(*shape, generator=gen, device=device) * scale

        def device_ms(fn):
            return cs.device_ms(fn, 3)

        m = cs.ITM_ROWS
        for name, k, n, gelu, with_res in cs.VIT_GEMM_SHAPES:
            x, w, b = randn(m, k), randn(n, k, scale=0.02), randn(n)
            res = randn(m, n) if with_res else None
            y = torch.empty(m, n, device=device)
            in_turns(f"ITM {name} f32: parent against change", {
                key: (lambda lib=lib, x=x, w=w, b=b, res=res, y=y, n=n, k=k, gelu=gelu:
                      lib.bq_scoring_gemm(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                          None if res is None else res.data_ptr(), y.data_ptr(),
                                          m, n, k, int(gelu), 0, stream))
                for key, lib in libs.items()}, device_ms, results)
            del x, w, b, res, y
        qkv, ctx = randn(cs.ITM_FRAMES, cs.ITM_TOKENS, 3 * H), torch.empty(
            cs.ITM_FRAMES, cs.ITM_TOKENS, H, device=device)
        in_turns("ITM vit attention f32: parent against change", {
            key: (lambda lib=lib: lib.bq_vit_attention(qkv.data_ptr(), ctx.data_ptr(),
                                                       cs.ITM_FRAMES, cs.ITM_TOKENS, 12, 64,
                                                       0.125, 0, stream))
            for key, lib in libs.items()}, device_ms, results)
        del qkv, ctx
        r = cs.DECODER_ROWS
        record = (ctypes.c_int * 10)()
        qkv, out = randn(r, 3 * H), torch.empty(r, H, device=device)
        base, step = qkv.data_ptr(), H * 4
        in_turns("self attention f32, 2048 answers of 12: parent against change", {
            key: (lambda lib=lib: lib.bq_scoring_attention(
                base, base + step, base + 2 * step, None, out.data_ptr(), r, 12, 64, 3 * H,
                3 * H, H, cs.ANSWER_LEN, 0, 0, 0, 0.125, 0, record, stream))
            for key, lib in libs.items()}, device_ms, results)
        del qkv
        qc, ck, cv = randn(r, H), randn(cs.BATCH, cs.QUESTION_LEN, H), randn(
            cs.BATCH, cs.QUESTION_LEN, H)
        cbias = torch.zeros(cs.BATCH, cs.QUESTION_LEN, device=device)
        in_turns("cross attention f32, 8 questions of 80 keys: parent against change", {
            key: (lambda lib=lib: lib.bq_scoring_attention(
                qc.data_ptr(), ck.data_ptr(), cv.data_ptr(), cbias.data_ptr(), out.data_ptr(), r,
                12, 64, H, H, H, 1, r // cs.BATCH, cs.QUESTION_LEN, 1, 0.125, 0, record, stream))
            for key, lib in libs.items()}, device_ms, results)
        del qc, ck, cv, out
        in_turns(f"vocabulary pass f32: parent at {psplit} against change at {split}",
                 {"parent": lambda: vocab_call(parent, inputs, psplit, device),
                  "change": lambda: vocab_call(tree, inputs, split, device)}, events, results)
        point_parent(args.parent, device, results)
    point_choices(device, results)
    (cs.OUT_DIR / "f32_variants.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
