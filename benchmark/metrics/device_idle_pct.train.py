"""Share of the profiled window in which no kernel or copy ran on the card."""
from harness import readers


def read(out):
    return readers.device_idle_pct(out)
