"""Readings the limits of ``cfbench/limits/`` are set from, on the card,
for a one-card cell:

    python3 -m cfbench.calibrate --workload NAME --seeds A,B,... \
        [--control-seeds C,D,E] [--seconds S] [--out FILE]

One process builds the cell's system once and, for each seed, makes its
inputs, warm-starts, runs a window of ``S`` seconds (the cell's load: the
same report intervals and sizes) and reads the comparison's numbers of the
program.  For each control seed it also reads the control's: the
reference computed in TF32 put in the program's place at the same frames.
The benchmark's own runs never run the control.  Prints one line per seed
and writes all readings as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import harness, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m cfbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or cell["chips"] != 1:
        print("cfbench.calibrate: needs a CUDA card and a one-card cell",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    t = cell["traffic"]
    drv = spec.driver(t["driver"])(cell["config"], t, dev)
    rows = []
    for seed in sorted(set(seeds) | control):
        t0 = time.perf_counter()
        harness.start(drv, seed)
        win = harness.window(drv, args.seconds, False, dev)
        row = {"seed": seed, "intervals": win["intervals"],
               "failed": win["failed"], "info": drv.info,
               "ms_per_step": 1e3 * win["wall_s"] / win["steps"]}
        inputs = drv.check_inputs()
        t1 = time.perf_counter()
        row["program"] = harness.readings(cell, drv.frames, seed, dev,
                                          inputs)
        row["reference_s"] = time.perf_counter() - t1
        if seed in control:
            row["control"] = harness.readings(cell, drv.frames, seed, dev,
                                              inputs, precision="tf32")
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
