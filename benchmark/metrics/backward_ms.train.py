"""Device ms a step of the program's ``step.backward`` span."""
from harness import spans


def read(out):
    return spans.phase_ms(out, "step.backward")
