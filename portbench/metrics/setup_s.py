"""Set-up: seconds from the process's start to the first timed request
(loading, the scene's build or the load of its built library, the
inputs, the reference's target of a fit, the warm-up)."""


def read(run):
    return run.setup_s
