"""Run a tiny cell of one traffic kind through the harness on the CPU and
print its result line; with a fault, the timed path is broken underneath.

    python3 -m qa_bench.tests.tiny_cell rank|views [--trace] [--fault answer|half]

The harness's look for a card is skipped: everything after it runs as in a
run on the card. The last line of standard error names the loaded modules
of JAX or the JAX package (none, when the run is sound)."""

import argparse
import json
import sys
import time

START = time.perf_counter()

import torch  # noqa: E402

from qa_bench import harness  # noqa: E402
from qa_bench.tests import tiny  # noqa: E402

CELLS = {"rank": "rank-f32-b8", "views": "views-f32-b64"}


def break_rank(fault: str) -> None:
    from bridgeqa_tpu_torch.models import blip_vqa3d, bridgeqa

    if fault == "answer":  # one scored answer altered where the decoder produces it
        rank = blip_vqa3d.BLIPVQA3D._rank_with_decoder

        def altered(self, *args, **kwargs):
            ids, sums = rank(self, *args, **kwargs)
            sums = sums.clone()
            sums[0, 0] += 1.0
            return ids, sums

        blip_vqa3d.BLIPVQA3D._rank_with_decoder = altered
    elif fault == "half":  # half of the batch left out, its rows copied from the rest
        forward = bridgeqa.BridgeQA.forward

        def half(self, batch, *args, **kwargs):
            out = forward(self, batch, *args, **kwargs)
            b = batch["point_clouds"].shape[0]
            for k, v in out.items():
                if torch.is_tensor(v) and v.dim() and v.shape[0] == b:
                    v = v.clone()
                    v[b // 2:] = v[: b - b // 2]
                    out[k] = v
            return out

        bridgeqa.BridgeQA.forward = half


def break_views(fault: str) -> None:
    from bridgeqa_tpu_torch.models import blip_itm

    encode = blip_itm.BLIPITM.encode_images
    if fault == "answer":  # one frame's feature altered where the tower produces it
        def altered(self, images):
            out = encode(self, images).clone()
            out[0] = out[0].roll(1)
            return out

        blip_itm.BLIPITM.encode_images = altered
    elif fault == "half":  # half of each image batch left out, copied from the rest
        def half(self, images):
            n = images.shape[0]
            out = encode(self, images[: n - n // 2])
            return torch.cat([out, out])[:n]

        blip_itm.BLIPITM.encode_images = half


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("kind", choices=sorted(CELLS))
    parser.add_argument("--trace", action="store_true")
    parser.add_argument("--fault", choices=("answer", "half"))
    parser.add_argument("--seed", type=int, default=2**31 + 11)
    args = parser.parse_args(argv)
    torch.set_num_threads(2)
    if args.fault:
        (break_rank if args.kind == "rank" else break_views)(args.fault)
    bench, cell, _, _ = harness.find_cell(CELLS[args.kind])
    cfg, traffic = getattr(tiny, f"{args.kind}_config")(), getattr(tiny, f"{args.kind}_traffic")()
    result = harness.run(bench, cell, cfg, traffic, args.seed, 1.0, args.trace,
                         torch.device("cpu"), START)
    print(json.dumps(result), flush=True)
    print(f"forbidden modules: {harness.forbidden_modules()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
