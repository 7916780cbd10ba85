"""Device ms a step of aten's elementwise kernels and reductions."""
from harness import readers


def read(out):
    return readers.groups_ms(out, ("aten elementwise", "aten reductions"))
