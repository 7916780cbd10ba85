"""Device idle ms a call while the host was inside the program's
``embed.call`` span (its own code or a phase's)."""
from harness import spans


def read(out):
    return spans.host_stall_ms(out, "embed.call")
