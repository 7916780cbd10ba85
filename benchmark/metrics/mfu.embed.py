"""Model FLOPs utilization: the model's FLOPs a unit over its time, timed
before the profiler starts, over the configuration's product peak."""
from harness import readers


def read(out):
    return readers.mfu_pct(out)
