"""Host microseconds a frame spent in ``render_batch`` up to its return,
before the request's synchronisation: the render entry and the forward
wrapper (pack, library lookup, allocation, launch) and the stack."""


def read(run):
    if run.kind != "render" or not run.frames:
        return None
    return sum(run.enqueue) / run.frames * 1e6
