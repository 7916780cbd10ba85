"""The program's own kernels: the sum of each recorded launch's bound over
their device time in the profiled units."""
from harness import readers


def read(out):
    return readers.kernel_roofline_pct(out)
