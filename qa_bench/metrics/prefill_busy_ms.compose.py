"""Card ms a composition batch in prefill: the union of the card records
whose launch calls lie inside the program's ``lm/prefill`` span (the
packed prompts through every layer, the latent cache written, the first
token's logits), over the profiled pass of qa_bench/spans.py."""

from qa_bench import spans


def read(t):
    found = spans.of(t)
    return None if found is None else found.busy_ms("lm/prefill")
