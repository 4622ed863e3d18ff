"""The curscan's share of its roofline: the frozen bound of the spectra a
traced step makes (``roofline.curscan_bound_ms``) over the device time of
the operations launched inside the curscan's span
(``ops/spectrum.curscan_auto_batched``), whatever kernel they run."""

from portbench.roofline import curscan_bound_ms


def read(view):
    ops = view.launched_in("curscan")
    busy_ms = sum(d.dur for d in ops) * 1e-3
    if busy_ms <= 0:
        return None
    c = view.cell
    bound_ms, _ = curscan_bound_ms(c["fft_size"], c["num_windows"],
                                   c["full_size"], c["batch"],
                                   c["plane_bytes"])
    return 100.0 * bound_ms * view.steps / busy_ms
