"""Host milliseconds per session step of the display chain: the
``kspec.display`` spans (around ``models/zerospan.display_updates``) less
the waits inside them (``kspec.wait.display_weights``): the Python and
launches of the chain.  Split as in
``host_wait_ms_per_step.host_split``."""
from portbench.metrics.host_wait_ms_per_step import host_split


def read(view):
    split = host_split(view)
    return None if split is None else split["display"]
