"""K3's share of its roofline, its column total with it: the least time of
the window's fit steps (``core/roofline.py``: the reference's march counts
on the target scene at the reference camera, the frozen operation tables)
over the device time of both kernels in the trace."""

KERNELS = ("sdf3d_fit_step_kernel", "sdf3d_column_total_kernel")


def read(run):
    if run.trace is None or run.k3_bound_s is None:
        return None
    busy = run.trace.kernel_s(*KERNELS)
    return 100.0 * run.k3_bound_s / busy if busy > 0 else None
