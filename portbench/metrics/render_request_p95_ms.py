"""The 95th percentile over all of the window's requests of a request's
milliseconds, from the ``render_batch`` call to the end of its device
synchronisation."""

from portbench.core.cell import percentile


def read(run):
    if run.kind != "render":
        return None
    return percentile(run.latencies, 95) * 1e3
