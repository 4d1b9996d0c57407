"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into an
object, all of them at once, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. The point kernels
(``BITWISE_SOURCES``) are built without FMA contraction, which their
bitwise parity with the plain versions needs; the scoring kernels keep it.
The build runs at the first CUDA use and lands in ``build/kernels/`` at the
repository root (listed in ``.gitignore``), under a name derived from the
sources and flags, so an unchanged tree reuses it.

Nothing here runs when the module is imported: the CPU tests import every
module, and a machine without ``nvcc`` never builds.
"""

import ctypes
import hashlib
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no FMA contraction: the kernels must round a*a + b*b as the plain
    # PyTorch versions do, or boundary decisions (d2 < r2, argmax) flip
    "-fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
# sources held bitwise to their plain versions; the others are held to a
# tolerance and are built with FMA contraction
BITWISE_SOURCES = {"fps.cu", "ball_query_stripes.cu"}


def source_flags(src: Path) -> list[str]:
    """nvcc flags of one source: ``NVCC_FLAGS``, less ``-fmad=false`` for a
    source outside ``BITWISE_SOURCES``."""
    if src.name in BITWISE_SOURCES:
        return NVCC_FLAGS
    return [f for f in NVCC_FLAGS if f != "-fmad=false"]


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "bq_fps": [_P, _P, _P, _P, _I, _I, _I, _P],
    "bq_ball_query_stripes": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                              ctypes.c_float, _P],
    "bq_scoring_gemm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "bq_scoring_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             ctypes.c_float, _I, _P],
    "bq_scoring_layernorm": [_P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _P],
    "bq_vocab_reductions": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "bq_vit_attention": [_P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _P],
    "bq_gather_rows": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_lib = None
# the loaded library's file
library_path = None
# what the last build printed (ptxas register and shared-memory use) and took
build_log = ""
build_seconds = None


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")
    return found


def _build() -> Path:
    global build_log, build_seconds
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources:
        digest.update(" ".join([src.name, *source_flags(src)]).encode() + src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    tag = digest.hexdigest()[:16]
    out = BUILD_DIR / f"libbridgeqa_kernels-{tag}.so"
    if out.exists():
        build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = [BUILD_DIR / f"{src.stem}-{tag}.o" for src in sources]
    # one nvcc per source, all started together
    procs = [subprocess.Popen([nvcc, *source_flags(src), "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs, failed = [], []
    for src, proc in zip(sources, procs):
        text, _ = proc.communicate()
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = out.with_suffix(".so.tmp")
    link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o", str(tmp)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernel library failed:\n{link.stdout}{link.stderr}")
    tmp.replace(out)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, library_path
    if _lib is None:
        library_path = _build()
        loaded = ctypes.CDLL(str(library_path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(loaded, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = loaded
    return _lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


# the working types the kernels are instantiated for, as their C entries number them
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_cuda(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is contiguous and on the first one's CUDA
    device, and ``dtype`` (the call's working type) is one the kernels take."""
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: the kernel takes float32 or bfloat16, got {dtype}")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel needs contiguous tensors")


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, for a kernel launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
