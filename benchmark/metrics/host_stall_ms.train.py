"""Device idle ms a step while the host was inside the program's ``step``
span (its own code or a phase's)."""
from harness import spans


def read(out):
    return spans.host_stall_ms(out, "step")
