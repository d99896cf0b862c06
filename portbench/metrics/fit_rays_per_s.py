"""Pixels times the fit steps completed in the window over the window's
seconds (host clock; each ``fit_scene`` job ends in a device
synchronisation)."""


def read(run):
    if run.kind != "fit":
        return None
    return run.steps * run.width * run.height / run.seconds
