"""Device ms a step of the program's ``step.teacher`` span: the teacher's
forward."""
from harness import spans


def read(out):
    return spans.phase_ms(out, "step.teacher")
