"""Device ms a step of the program's ``step.forward`` spans: the student's
(or encoder's) forward, its head and the loss."""
from harness import spans


def read(out):
    return spans.phase_ms(out, "step.forward")
