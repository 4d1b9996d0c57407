"""Card ms a composition batch in the mixture-of-experts layers: the union of
the card records inside the program's ``lm/moe`` spans (routing, the
permutation by expert, the two grouped expert products with the shared
experts, the combine), prefill and decode, over the profiled pass of
qa_bench/spans.py."""

from qa_bench import spans


def read(t):
    found = spans.of(t)
    return None if found is None else found.busy_ms("lm/moe")
