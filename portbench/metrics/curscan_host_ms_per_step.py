"""Host milliseconds per session step of the curscan wrapper: the
``kspec.curscan`` spans (around ``ops/spectrum.curscan_auto_batched`` in
``models/zerospan``) less the waits inside them: the route, the plan, the
launch arguments and the launches.  Split as in
``host_wait_ms_per_step.host_split``."""
from portbench.metrics.host_wait_ms_per_step import host_split


def read(view):
    split = host_split(view)
    return None if split is None else split["curscan"]
