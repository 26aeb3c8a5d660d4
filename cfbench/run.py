"""The benchmark of ``chargeflux_tpu_torch``, one run of one cell:

    python3 -m cfbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  Set-up (imports, the system, inputs from the
seed, the warm start and the capture of every chunk graph the window
replays) is ``setup_s``; then report intervals for ``S`` seconds, the
end-to-end metrics from the host clock (``--trace 0``) or one traced
interval and the per-layer metrics from the profiler's device trace
(``--trace 1``).  Once the window has closed, the frames it produced are
held against the plain float64 reference (``cfbench.checks``).  Every
cell runs on one card: a cell across cards needs a driver of ranks here
first.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (report intervals), ``failed`` (intervals whose energies or
frame are not finite), ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``compared``: each number of the comparison beside
its limit, which also end standard error.  Without the cards the cell asks
for, or with JAX or the JAX package loaded once the window has closed, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def set_caches(root):
    """Build and kernel caches at fixed paths inside the checkout, so only
    a checkout's first run builds (the program's own nvcc build lives in
    its package's ``_build/``)."""
    base = root / ".cfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m cfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import harness, spec

    cell = spec.load_cell(args.workload)
    if cell["chips"] != 1:
        log(f"cfbench: {args.workload} asks for {cell['chips']} cards; "
            f"this harness runs one-card cells only")
        return 2
    set_caches(spec.ROOT)
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"cfbench: {args.workload} needs {cell['chips']} CUDA card(s); "
            f"found {found}")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T0, log=log)
    found = harness.forbidden_modules()
    if found:
        log(f"cfbench: JAX or the JAX package was loaded: {found}")
        return 3
    log(f"cfbench: card {card_line()}")
    log(f"cfbench: metrics {json.dumps(out['metrics'])}")
    for name, c in out["compared"].items():
        log(f"cfbench: compared {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
