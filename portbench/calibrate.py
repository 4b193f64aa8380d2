"""Readings for the limits of a cell's check, on the card, in one process.

    python3 portbench/calibrate.py --workload pdunet_parallel.volume \
        --seeds 12 --control-seeds 3 --seconds 5 --out calib.jsonl

For each program seed, a whole run of the cell (``harness.run_cell``, with
a window of ``--seconds``) and every number its check compares (the lower
readings). On the first ``--control-seeds`` seeds also the kind's
controls on the same state: the reference put in the program's place at
the precision below the configuration's (TF32 operands where float32 is
stated, fp8 where bfloat16 is), and for a training cell a fault planted
in the reference, half of each batch left out (the upper readings). A
state left unchanged reads 1 by the training measure and needs no run.
One JSON line per reading.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def readings(cell: str, seeds: list, control_seeds: int, seconds: float, device="cuda",
             emit=print, config_overrides=None, traffic_overrides=None) -> list:
    """Every reading of ``cell``: the program on each of ``seeds``, the
    controls on the first ``control_seeds`` of them. The overrides shrink
    the cell for the tests."""
    from portbench import harness

    out = []

    def record(seed, reading, numbers):
        out.append(dict(seed=seed, reading=reading, **numbers))
        emit(json.dumps(out[-1]))

    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()

        def on_check(numbers, controls):
            record(seed, "program", numbers)
            if i < control_seeds:
                for name, got in controls().items():
                    record(seed, name, got)

        harness.run_cell(cell, seed, seconds, False, device, config_overrides=config_overrides,
                         traffic_overrides=traffic_overrides, on_check=on_check)
        emit(f"# seed {seed}: {time.perf_counter() - t0:.1f} s")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_011)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", required=True)
    p.add_argument("--override", action="append", default=[], metavar="FIELD=JSON",
                   help="a field of the program's configuration, as run (a witness "
                        "at another precision: model.use_bfloat16=false)")
    args = p.parse_args(argv)
    overrides = {k: json.loads(v) for k, v in (o.split("=", 1) for o in args.override)}

    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    name = torch.cuda.get_device_name(0)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    with open(args.out, "a") as f:
        def emit(line):
            print(line, flush=True)
            if not line.startswith("#"):
                f.write(json.dumps(dict(json.loads(line), workload=args.workload, device=name,
                                        overrides=overrides)) + "\n")
                f.flush()

        readings(args.workload, seeds, args.control_seeds, args.seconds, "cuda", emit,
                 config_overrides=overrides)
    return 0


if __name__ == "__main__":
    sys.exit(main())
