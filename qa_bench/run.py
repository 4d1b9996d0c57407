"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m qa_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``qa_bench/configs/<config>.json``) and a
traffic mix (``qa_bench/workloads/<traffic>.json``, whose ``kind`` names the
generator ``qa_bench/kinds/<kind>.py``). The last line of standard output is
the result: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(and ``breakdown`` when traced), then ``checks``, each compared number with
its limit, which the last lines of standard error repeat. Without a CUDA
card the run prints no result and exits with 2.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
CACHES = {"TRITON_CACHE_DIR": "build/triton", "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "CUDA_CACHE_PATH": "build/nv_compute_cache"}
# torch's host threads: on an 8-core host 4 read the same as torch's default
# of 8 in the rank and view selection cells (PERF.md, section 2), and leave
# cores to the host's own work
THREADS = 4


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for key, rel in CACHES.items():
        os.environ[key] = str(CHECKOUT / rel)
    import torch

    from qa_bench import harness

    try:
        bench, cell, cfg, traffic = harness.find_cell(args.workload, CHECKOUT)
    except KeyError:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    torch.set_num_threads(THREADS)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run(bench, cell, cfg, traffic, args.seed, args.seconds, bool(args.trace),
                         device, START)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
