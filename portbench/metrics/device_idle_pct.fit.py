"""The share of a fit window in which nothing ran on the card:
1 − the union of the device's intervals over the window."""


def read(run):
    if run.trace is None or run.kind != "fit":
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
