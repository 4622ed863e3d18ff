"""Share of the traced window in which no operation ran on the device:
the window, from the first traced operation's start to the last one's
end, less the union of the kernels', copies' and fills' intervals."""


def read(view):
    win = view.window()
    if win is None or win[1] <= win[0]:
        return None
    return 100.0 * (1.0 - view.busy_us() / (win[1] - win[0]))
