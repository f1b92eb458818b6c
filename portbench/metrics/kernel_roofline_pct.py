"""kernel_roofline_pct: the least time an H100 could take for the stage's
work (the cell's entry counts it with portbench/roofline.py, per stage:
inputs read once, outputs written once) over the device time of the
kernels that did it, the union of their intervals in the traced
stretch, in percent."""

from portbench import roofline, tracing


def read(run):
    t_kernels = tracing.busy_seconds(run.trace.kernels())
    if not t_kernels or not run.frames or run.work is None:
        return None
    return 100.0 * roofline.least_seconds(run.work)[0] / t_kernels
