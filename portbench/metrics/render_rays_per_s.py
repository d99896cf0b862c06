"""Pixels of every request completed in the window over the window's
seconds (host clock, each request ending in a device synchronisation)."""


def read(run):
    if run.kind != "render":
        return None
    return run.frames * run.width * run.height / run.seconds
