"""Run one benchmark cell once and print its result as the last line of
standard output.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

(``python3 -m portbench.run ...`` is the same.)  The cell's configuration,
traffic mix, session runner and per-layer metrics are found by name
(``portbench/cells.py``).  Set-up makes the capture from the seed on the
card and warms up the cell's shapes; the window then runs the session for
``--seconds``; the comparison with the plain reference decides
``correct``.  ``--trace 0`` reports the end-to-end metrics, ``--trace 1``
the per-layer ones, read from a profile of a steady stretch of steps.
The kernels' library is built on the first run in a checkout, into
``kspecanal_tpu_torch/build/``; other caches go under ``.portbench_cache/``.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Modules that nothing the benchmark runs may load, by top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "kspecanal_tpu")
PORT = "kspecanal_tpu_torch"


def forbidden_loaded():
    """Top-level names of loaded modules that the benchmark forbids,
    compared whole (the port's name begins with the JAX package's)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def set_cache_dirs(root: Path = ROOT) -> None:
    """Fixed cache directories inside the checkout for every compiler cache
    a run could fill."""
    base = root / ".portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str, t0: float, precision=None, traffic=None,
             limits=None, root: Path = ROOT):
    """One run of ``workload`` of ``root``'s benchmark on ``device``:
    ``(result, checks)``, the result line as a dict and each number
    compared as ``name: (value, limit)``.  ``precision``, ``traffic`` and
    ``limits`` are the runner's (a control; smaller captures and the
    limits of the CPU's plain float32 chain in tests)."""
    import torch

    from portbench import cells, tracing

    cell = cells.load(workload, root)
    runner = cells.runner(cell, root)
    cuda = torch.device(device).type == "cuda"
    run = runner.prepare(cell, seed, device, precision=precision,
                         traffic=traffic, limits=limits)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    mix = traffic or cell.traffic
    prof = (tracing.StepProfiler(int(mix["trace"]["after_steps"]),
                                 int(mix["trace"]["steps"]),
                                 runner.trace_cell(run)) if trace else None)
    e2e = runner.window(run, seconds, prof, mix["spans"] if trace else None)
    view = prof.finish() if prof is not None else None
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    attempted, failed = runner.counts(run)
    checks = runner.check(run)
    del run
    metrics = {}
    if not trace:
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    elif view is not None:
        for m in cell.per_layer:
            value = cells.reader(m["name"], root)(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell.workload.get("chips", 1)),
           "memory_peak_bytes": int(peak)}
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if view is not None:
        win = view.window()
        dev["busy_s"] = view.busy_us() * 1e-6
        dev["window_s"] = (win[1] - win[0]) * 1e-6 if win else 0.0
        result["breakdown"] = view.breakdown()
    result["checks"] = {k: {"value": v if math.isfinite(v) else str(v),
                            "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()

    import torch

    from portbench import cells

    chips = int(cells.load(args.workload).workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import importlib
    port = Path(importlib.import_module(PORT).__file__).resolve()
    if ROOT not in port.parents:
        print(f"portbench: {PORT} loads from {port}, not from the checkout "
              f"{ROOT}", file=sys.stderr)
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", _T0)
    found = forbidden_loaded()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, (value, lim) in checks.items():
        print(f"check {name} {value!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
