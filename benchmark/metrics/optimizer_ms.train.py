"""Device ms a step of the program's ``step.optimizer`` span: the update
(K7, or finetuning's per-leaf update), the gradient norm and clip."""
from harness import spans


def read(out):
    return spans.phase_ms(out, "step.optimizer")
