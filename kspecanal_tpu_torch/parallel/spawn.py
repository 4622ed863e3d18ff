"""Start a world of ranks from one process, for the scripts that measure
or check the sharded paths at several world sizes (``scripts/
scaling_bench.py``, ``scripts/dryrun_multichip.py``, ``chip_smoke.py``):

    results = run_world("pkg.module:rank_main", world=2, args={...},
                        backend="gloo", device_type="cuda", share_card=True)

Each rank is ``python -m kspecanal_tpu_torch.parallel.spawn ...``: it joins
the world through a ``file://`` store in a fresh temporary directory,
calls ``rank_main(args)`` (which builds its meshes with ``make_mesh(...,
device_type=args["device_type"], share_card=args["share_card"])``) and
writes what it returns (JSON) for the parent.  The target's module is
imported from the repository root.  A rank that fails or outlives
``timeout_s`` fails the call, and every rank is stopped before it
returns."""
from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List

from kspecanal_tpu_torch.parallel import mesh as mesh_mod

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class WorldFailed(RuntimeError):
    """A rank of a spawned world failed or timed out."""


def run_world(target: str, world: int, args: Dict[str, Any], *,
              backend: str, device_type: str, share_card: bool = False,
              timeout_s: float = mesh_mod.TIMEOUT_S) -> List[Any]:
    """Run ``target`` (``"module:function"``) on ``world`` ranks; returns
    each rank's result in rank order.  ``device_type``/``share_card`` are
    handed to the ranks for their ``make_mesh`` calls (``args`` carries
    them as ``device_type``/``share_card``); ``backend`` is the world's."""
    args = dict(args, device_type=device_type, share_card=share_card)
    with tempfile.TemporaryDirectory(prefix="kspec-world-") as tmp:
        with open(os.path.join(tmp, "args.json"), "w") as f:
            json.dump(args, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_REPO, env.get("PYTHONPATH", "")) if p)
        procs = [subprocess.Popen(
            [sys.executable, "-m", "kspecanal_tpu_torch.parallel.spawn",
             target, str(r), str(world), backend, tmp, str(timeout_s)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
        outs, failed = [], []
        deadline = time.monotonic() + timeout_s
        try:
            for r, p in enumerate(procs):
                try:
                    out = p.communicate(
                        timeout=max(1.0, deadline - time.monotonic()))[0]
                except subprocess.TimeoutExpired:
                    p.kill()
                    out = p.communicate()[0] + "\n(timed out)"
                outs.append(out)
                if p.returncode != 0:
                    failed.append(r)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, out in enumerate(outs):
            print("".join(f"  [rank {r}] {ln}\n"
                          for ln in out.rstrip().splitlines()), end="")
        if failed:
            raise WorldFailed(f"{target}: rank(s) {failed} of {world} "
                              f"failed")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"result-{r}.json")) as f:
                results.append(json.load(f))
        return results


def _rank(target: str, rank: int, world: int, backend: str, tmp: str,
          timeout_s: float) -> None:
    import torch.distributed as dist
    with open(os.path.join(tmp, "args.json")) as f:
        args = json.load(f)
    module, fn = target.split(":")
    rank_main = getattr(importlib.import_module(module), fn)
    mesh_mod.init_distributed(backend,
                              init_method=f"file://{tmp}/store",
                              world_size=world, rank=rank,
                              timeout_s=timeout_s)
    try:
        result = rank_main(args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"result-{rank}.json"), "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    _rank(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
          sys.argv[5], float(sys.argv[6]))
