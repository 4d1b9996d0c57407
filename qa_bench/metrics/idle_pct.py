"""% of the profiled window in which no operation ran on the card (the
union of the card records' intervals against the window)."""


def read(t):
    if t.trace is None or not t.trace.window_s:
        return None
    return 100.0 * (1.0 - t.trace.busy_s / t.trace.window_s)
