"""% of the roofline in the vocabulary pass (vocab_loss): as
gemm_roofline, over the kernels that kernel_groups.json maps to "vocab"."""


def read(t):
    return t.roofline("vocab")
