"""The ptxas resource lines of the port's production library, beside those
of another tree's (a parent commit unpacked with ``git archive``): one
``nvcc -Xptxas -v`` a source of each tree, the port's own flags, all
started together, then for each kernel its registers, stack frame, spill
stores and loads and static shared memory, and whether they equal the
other tree's.

    python -m kspecanal_tpu_torch.scripts.ptxas_report [--against TREE]
        [--source NAME.cu ...] [--define NAME=VALUE ...]

``--source`` takes some of ``csrc/*.cu`` (default all) and ``--define``
compiles them as a forensic build (e.g. ``--define KSPEC_TC_HIGHEST=1
--define KSPEC_TC_ABLATE=1 --source curscan_tc_high.cu``).

Kernel names are compared demangled (``c++filt``), the precision class's
template argument written as its bf16 parts (DEFAULT 1, HIGH 2) where a tree
takes it as a bool, and the direct kernel's ``FORENSIC`` argument dropped:
that instantiation, where a tree has it, is listed as its own.  The objects
go under ``kspecanal_tpu_torch/build/ptxas/`` and are removed.
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from kspecanal_tpu_torch.ops import _build

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_CLASS_ARG = re.compile(r"(curscan_tc(?:_split)?_kernel<[^,<>]+, )"
                        r"(true|false)")
_FORENSIC = re.compile(r"(curscan_sublane_kernel<[^<>]*?), (true|false)>")


def compile_log(srcs: List[Path], out: Path,
                defines=()) -> Dict[Path, str]:
    """ptxas' report of each source (compiled at once, with ``-D`` each of
    ``defines``), by source."""
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    procs = {src: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, *(f"-D{d}" for d in defines), "-c",
         "-o", str(out / f"{i}.o"), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i, src in enumerate(srcs)}
    logs = {}
    for src, p in procs.items():
        logs[src] = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{logs[src]}")
    return logs


def parse(log: str) -> Dict[str, Tuple[int, int, int, int, int]]:
    """``{mangled entry: (registers, stack frame, spill stores, spill
    loads, smem bytes)}`` of one ptxas report."""
    rows: Dict[str, Tuple[int, int, int, int, int]] = {}
    entry, props, frame = None, None, (0, 0, 0)
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            entry, frame = m.group(1), (0, 0, 0)
            continue
        m = _PROPS.search(line)
        if m:
            props = m.group(1)
            continue
        m = _FRAME.search(line)
        if m and entry is not None and props == entry:
            frame = tuple(int(x) for x in m.groups())
            continue
        m = _USED.search(line)
        if m and entry is not None:
            smem = _SMEM.search(line)
            rows[entry] = (int(m.group(1)), *frame,
                           int(smem.group(1)) if smem else 0)
            entry = None
    return rows


def demangle(names: List[str]) -> List[str]:
    """The demangled names (the mangled ones where ``c++filt`` is
    missing)."""
    tool = shutil.which("c++filt")
    if tool is None:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True, check=True).stdout
    return out.splitlines()


def key(name: str) -> str:
    """A kernel's comparable name: without its parameter list, the class
    argument as bf16 parts, the direct kernel's FORENSIC argument
    dropped ('forensic' appended where it was true)."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].replace("void ", "")
    name = _CLASS_ARG.sub(
        lambda m: m.group(1) + ("2" if m.group(2) == "true" else "1"), name)
    return _FORENSIC.sub(lambda m: m.group(1) + ">"
                         + (" forensic" if m.group(2) == "true" else ""),
                         name)


def report(tree: Path, out: Path, names=(),
           defines=()) -> Dict[str, Tuple[int, ...]]:
    """``{kernel: (registers, stack, spill stores, spill loads, smem)}`` of
    the sources ``names`` (default every ``csrc/*.cu``) of ``tree``."""
    csrc = tree / "kspecanal_tpu_torch" / "csrc"
    srcs = ([csrc / n for n in names] if names
            else sorted(csrc.glob("*.cu")))
    rows: Dict[str, Tuple[int, ...]] = {}
    for src, log in compile_log(srcs, out, defines).items():
        parsed = parse(log)
        for mangled, name in zip(parsed, demangle(list(parsed))):
            rows[f"{src.name}: {key(name)}"] = parsed[mangled]
    return rows


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Print each kernel's line (and, with ``--against``, whether it equals
    the other tree's); returns the rows and the comparison."""
    p = argparse.ArgumentParser(prog="ptxas_report", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--against", type=Path, default=None)
    p.add_argument("--source", action="append", default=[])
    p.add_argument("--define", action="append", default=[])
    args = p.parse_args(argv)
    here = Path(_build.__file__).resolve().parents[2]
    work = _build.BUILD_DIR / "ptxas"
    try:
        mine = report(here, work / "here", args.source, args.define)
        theirs = (report(args.against.resolve(), work / "against",
                         args.source, args.define)
                  if args.against else {})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    same, differ = [], []
    for name in sorted(mine):
        regs, stack, st, ld, smem = mine[name]
        line = (f"{name}: {regs} registers, {stack} B stack, {st} B spill "
                f"stores, {ld} B spill loads, {smem} B smem")
        if args.against:
            other = theirs.get(name)
            line += (" (absent there)" if other is None else
                     " == there" if other == mine[name] else
                     f" != there {other}")
            (same if other == mine[name] else differ).append(name)
        print(line, flush=True)
    gone = sorted(set(theirs) - set(mine))
    for name in gone:
        print(f"{name}: only there {theirs[name]}", flush=True)
    if args.against:
        print(f"{len(same)} kernels equal, {len(differ)} differ or are new, "
              f"{len(gone)} only there", flush=True)
    return {"rows": mine, "same": same, "differ": differ, "gone": gone}


if __name__ == "__main__":
    main(sys.argv[1:])
