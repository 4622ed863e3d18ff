"""Host milliseconds per session step of the session loop itself: the
complete ``kspec.step`` spans less the ``kspec.curscan`` and
``kspec.display`` spans and the waits outside them (``acquire``, the
stop check, ``log_iter``, ``_emit``, toggles; ``session.py``).  Split as
in ``host_wait_ms_per_step.host_split``."""
from portbench.metrics.host_wait_ms_per_step import host_split


def read(view):
    split = host_split(view)
    return None if split is None else split["loop"]
