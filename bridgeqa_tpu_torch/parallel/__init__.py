"""Parallelism (counterpart of ``bridgeqa_tpu/parallel/``): the process
group and the (data, model) mesh (``mesh``), the collectives of the global
batch (``global_batch``), the sharded eval step (``eval``) and Megatron
tensor parallelism (``tp``). Only ``mesh`` and ``global_batch`` load with
the package: the models import them.
"""
