"""Card ms a composition batch in latent attention: the union of the card
records inside the program's ``lm/attention`` spans (the input norm, the
projections, the rotary embedding, the cache writes, the expanded attention
in prefill and the absorbed one over the latent cache in decode), over the
profiled pass of qa_bench/spans.py."""

from qa_bench import spans


def read(t):
    found = spans.of(t)
    return None if found is None else found.busy_ms("lm/attention")
