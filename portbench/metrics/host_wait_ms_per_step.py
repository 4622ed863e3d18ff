"""Host milliseconds per session step spent in the program's wait sites:
the summed ``kspec.wait.*`` spans (``utils/profiling.wait``: the host
blocked on the card or on its acquire worker) inside the complete
``kspec.step`` spans of the traced stretch.

:func:`host_split` is shared with ``loop_host_ms_per_step``,
``curscan_host_ms_per_step`` and ``display_host_ms_per_step``: the four
split the mean complete step exactly.  A step is complete when the trace
holds host events that end before it starts and start after it ends; the
profiler starts and stops inside a step, so the first and last are cut.
The spans are taken as one thread's: the cells run no acquire worker."""
import bisect

STEP, CURSCAN, DISPLAY = "kspec.step", "kspec.curscan", "kspec.display"
WAIT = "kspec.wait."


def _within(ranges, t):
    """Whether ``t`` lies in one of the sorted disjoint ``ranges``."""
    i = bisect.bisect_right(ranges, (t, float("inf"))) - 1
    return i >= 0 and ranges[i][0] <= t <= ranges[i][1]


def host_split(view):
    """Host ms per complete ``kspec.step``: ``wait`` (the waits),
    ``curscan`` and ``display`` (those spans less the waits inside them)
    and ``loop`` (the rest of the step); None when the trace holds no
    complete ``kspec.step`` or no device operation."""
    if not view.has_device:
        return None
    named = {STEP: [], CURSCAN: [], DISPLAY: [], WAIT: []}
    events = view.host + view.runtime
    for e in view.host:
        key = WAIT if e.name.startswith(WAIT) else e.name
        if key in named:
            named[key].append((e.ts, e.end))
    if not named[STEP] or not events:
        return None
    first_end = min(e.end for e in events)
    last_start = max(e.ts for e in events)
    steps = sorted((s, e) for s, e in named[STEP]
                   if first_end <= s and e <= last_start)
    if not steps:
        return None
    curscan = sorted(r for r in named[CURSCAN] if _within(steps, r[0]))
    display = sorted(r for r in named[DISPLAY] if _within(steps, r[0]))
    waits = {"curscan": 0.0, "display": 0.0, "loop": 0.0}
    for s, e in named[WAIT]:
        if _within(steps, s):
            where = ("curscan" if _within(curscan, s)
                     else "display" if _within(display, s) else "loop")
            waits[where] += e - s
    total = {name: sum(e - s for s, e in ranges) for name, ranges in
             (("step", steps), ("curscan", curscan), ("display", display))}
    per_step_ms = 1e-3 / len(steps)
    return {
        "wait": sum(waits.values()) * per_step_ms,
        "loop": (total["step"] - total["curscan"] - total["display"]
                 - waits["loop"]) * per_step_ms,
        "curscan": (total["curscan"] - waits["curscan"]) * per_step_ms,
        "display": (total["display"] - waits["display"]) * per_step_ms,
    }


def read(view):
    split = host_split(view)
    return None if split is None else split["wait"]
