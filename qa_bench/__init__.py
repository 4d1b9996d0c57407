"""The benchmark of the PyTorch and CUDA port (``bridgeqa_tpu_torch``).

``python3 -m qa_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once; ``qa_bench/README.md`` says how to
add a configuration, a cell or a metric as files."""
