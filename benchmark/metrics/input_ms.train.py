"""Device ms a step of the program's ``step.input`` span: the host batch in,
crop, mel, mixup, freq warp or SpecAugment and RandomResizeCrop, masks,
drop-path multipliers."""
from harness import spans


def read(out):
    return spans.phase_ms(out, "step.input")
