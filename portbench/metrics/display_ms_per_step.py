"""Device milliseconds per session step of the operations launched inside
the display chain's span (``models/zerospan.display_updates``)."""


def read(view):
    ops = view.launched_in("display")
    if not ops:
        return None
    return sum(d.dur for d in ops) * 1e-3 / view.steps
