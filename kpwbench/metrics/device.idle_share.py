"""Share of the window in which no operation ran on the device: one less
the union of the kernel, copy and memset intervals that the PyTorch
profiler recorded, over the window's length, in percent."""

from kpwbench.breakdown import busy


def read(run):
    if not run.device_ops:
        return None
    return 100.0 * (1.0 - busy(run) / (run.w1 - run.w0))
