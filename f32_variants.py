#!/usr/bin/env python3
"""Time the f32 kernels' design choices, in turns, in one process on one
CUDA card.

    python3 f32_variants.py [--parent DIR]

- The vocabulary pass (``csrc/vocab_loss.cu``, f32) at the main path's
  shape (22528 rows, 30524 words, width 768) with its launch bound at one
  block an SM (the tree's) and at two (a copy of the source with
  ``kF32Blocks`` changed, built into ``build/variants/``), both at the
  split ``_splits`` picks; then under several splits (runs, tiles a run):
  ``_splits``' own, 40 tiles, one tile, the whole vocabulary in one run.
- With ``--parent DIR`` (an older commit unpacked there, for example by
  ``git archive <commit> | tar -x -C build/parent``): DIR's f32 kernels
  against the tree's, parent, change, change, parent: the products and the
  ViT attention at BLIP-ITM's shape (64 frames of 577 tokens), the scoring
  attentions at the rank forward's (24576 rows against 8 questions of 80
  keys), and the vocabulary pass, each tree at its own ``_splits``.

Card time per call by ``torch.profiler`` (``chip_smoke.device_ms``; the
vocabulary pass, which takes the card ~20 ms a call, by CUDA events around
back-to-back calls, ``chip_smoke.time_ms``). Prints one JSON line per
comparison and writes them all to ``build/f32_variants.json``; fails
without a card.
"""

import argparse
import ctypes
import importlib.util
import json
import subprocess
from pathlib import Path

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
        psrc = args.parent / "bridgeqa_tpu_torch" / "csrc"
        parent = build([psrc / n for n in ("scoring_gemm.cu", "vit_attention.cu",
                                           "vocab_loss.cu", "scoring_attention.cu")],
                       "libparent_f32.so")
        spec = importlib.util.spec_from_file_location(
            "parent_vocab_loss", args.parent / "bridgeqa_tpu_torch" / "ops" / "vocab_loss.py")
        pvl = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(pvl)
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
    (cs.OUT_DIR / "f32_variants.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
