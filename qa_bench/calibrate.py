"""The readings a cell's limits are set from, on the card, in one process.

    python3 -m qa_bench.calibrate --workload <cell> --seeds 1-12 --control 4 \
        [--exact detector] [--out FILE]

For each seed: the cell's set-up and warm-up, one batch of the cell's own
size through the timed path (for view selection the cycle's largest scene),
the program's numbers against the reference, and for the first ``--control``
seeds the control's: the reference computed one precision below (the
traffic's ``control``) in the program's place. ``--exact`` keeps the named
submodules of the reference in the cell's precision under the control, so
that only the layers after them are lowered. One JSON line per seed on
standard output, and the largest program reading and the smallest control
reading of each number at the end, each with the card's name. Without a
CUDA card it prints nothing and exits with 2: limits are set from the
card's readings only.
"""

import argparse
import json
import sys
import time

import torch

from qa_bench import harness


def seeds(spec: str) -> list:
    out = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def readings(cfg: dict, traffic: dict, seed: int, device, control: bool,
             exact: tuple = ()) -> dict:
    session = harness.session_for(cfg, traffic, seed, device)
    session.warm()
    frames = traffic.get("scene_frames")
    session.batch(frames.index(max(frames)) if frames else 0, 0)
    session.release()
    out = {"seed": seed, "program": session.numbers()[0]}
    if control:
        out["control"] = session.numbers(control=True, exact=exact)[0]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", type=int, default=3)
    parser.add_argument("--exact", default="",
                        help="comma-separated submodules of the reference the control "
                             "keeps in the cell's precision")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card: the limits are set from the card's readings", file=sys.stderr)
        return 2
    _, _, cfg, traffic = harness.find_cell(args.workload)
    device = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(device)
    exact = tuple(n for n in args.exact.split(",") if n)
    rows = []
    for n, seed in enumerate(seeds(args.seeds)):
        t0 = time.perf_counter()
        rows.append({"card": card, **readings(cfg, traffic, seed, device, n < args.control,
                                              exact)})
        rows[-1]["seconds"] = time.perf_counter() - t0
        print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": args.workload, "card": card, "exact": list(exact),
               "program_max": {k: max(r["program"][k] for r in rows) for k in rows[0]["program"]}}
    ctrl = [r["control"] for r in rows if "control" in r]
    if ctrl:
        summary["control_min"] = {k: min(c[k] for c in ctrl) for k in ctrl[0]}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(r) for r in rows + [summary]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
