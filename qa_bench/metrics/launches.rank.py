"""Kernel launches per rank forward, counted from the profiler's runtime
events (every launch call of the profiled batches, over the batches)."""


def read(t):
    if t.trace is None:
        return None
    return t.trace.launches / len(t.profiled)
