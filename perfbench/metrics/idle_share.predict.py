"""Share of the traced window in which the device ran no operation
(kernel, copy or fill), in a predict cell: 100 * (1 - busy / window)."""


def read(run):
    if run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
