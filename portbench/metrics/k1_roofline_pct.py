"""K1's share of its roofline: the least time of the window's frames
(``core/roofline.py``: the reference's march counts on the cell's cameras,
the frozen operation tables) over K1's device time in the trace."""

KERNEL = "sdf3d_render_fwd_kernel"


def read(run):
    if run.trace is None or run.k1_bound_s is None:
        return None
    busy = run.trace.kernel_s(KERNEL)
    return 100.0 * run.k1_bound_s / busy if busy > 0 else None
