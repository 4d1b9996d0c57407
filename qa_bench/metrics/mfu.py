"""% of the chip's peak: every matrix product of the batches timed on the host
clock before the profiler opened (qa_bench/flops.py), over their wall time,
against the precision's peak (peaks.json)."""


def read(t):
    return t.mfu()
