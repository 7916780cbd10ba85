"""Device ms a call of the host-to-device copies."""
from harness import readers


def read(out):
    return readers.copies_ms(out, "HtoD")
