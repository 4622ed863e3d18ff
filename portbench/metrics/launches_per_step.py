"""Device operations (kernels, copies, fills) launched per session step
in the traced stretch."""


def read(view):
    ops = view.launched_in_stretch()
    if not ops:
        return None
    return len(ops) / view.steps
