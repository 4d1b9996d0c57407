"""% of the roofline in the hand-written product kernels (scoring_gemm):
the least time their products could take (operations at the precision's
peak, or bytes at the HBM rate, per call) over the profiler's time of the
kernels that kernel_groups.json maps to "gemm"."""


def read(t):
    return t.roofline("gemm")
