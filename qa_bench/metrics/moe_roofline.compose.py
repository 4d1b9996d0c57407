"""% of the roofline in the grouped expert products (csrc/moe_gemm.cu): the
least time of every grouped product of the profiled batches, the larger of
its operations over the bf16 peak and its bytes over the HBM rate (each
call's rows, and the weights of only the experts that received rows, from
the routing the program recorded in those batches: the session's
``products("moe_gemm", i)``), against the profiler's time of the kernels
named below. The names are held here: kernel_groups.json has no group for
this kernel. A program without the kernel reads None."""

from qa_bench.harness import log

KERNELS = ("moe_gemm_kernel",)


def read(t):
    if t.trace is None:
        return None
    calls = [c for i in t.profiled for c in t.session.products("moe_gemm", i)]
    hits = [d for n, _, d in t.trace.kernels if any(k in n for k in KERNELS)]
    if not calls or not hits:
        return None
    log(f"moe_gemm: {len(hits)} kernel records and {len(calls)} calls counted over "
        f"{len(t.profiled)} batches")
    least = sum(max(f / t.peak, b / t.session.hbm_bytes_per_s) for f, b in calls)
    return 100.0 * least / (sum(hits) / 1e9)
