"""The readings that a cell's limits are set from, on the card, in one
process: the program on many seeds, and each control and planted fault
(``controls.py``: HIGH, DEFAULT, float32, state_unchanged, half_batch,
altered) on a few, each through a short window at the cell's own load.

    python3 portbench/readings.py --workload <name> --seeds 1,2,3 \
        [--control float32 --control HIGH --control-seeds 4,5,6] \
        [--seconds 1.5] [--out readings.jsonl]

Prints one JSON line a run: the seed, the control or fault (``as
configured`` for a sound run), each number compared and the window's
``capture_msamp_s``.  The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import cells, controls  # noqa: E402
from portbench import run as bench  # noqa: E402


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control", action="append", default=[],
                    choices=controls.NAMES)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=1.5)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    bench.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    spec = cells.load(args.workload).config["spec"]
    plan = [(s, None) for s in args.seeds]
    plan += [(s, c) for c in args.control for s in args.control_seeds]
    try:
        for seed, name in plan:
            with (controls.planted(name, spec) if name
                  else contextlib.nullcontext()) as prec:
                result, checks = bench.run_cell(
                    args.workload, seed, args.seconds, False, "cuda:0",
                    time.perf_counter(), precision=prec)
            line = json.dumps({
                "workload": args.workload, "seed": seed,
                "class": name or "as configured",
                "correct": result["correct"],
                "checks": {k: v for k, (v, _) in checks.items()},
                "capture_msamp_s":
                    result["metrics"]["capture_msamp_s"]["value"]})
            print(line, flush=True)
            if out is not None:
                out.write(line + "\n")
                out.flush()
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
