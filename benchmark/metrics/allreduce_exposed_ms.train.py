"""Device ms a step of the gradient all-reduce that no other device work
overlaps (the NCCL kernels' time outside every other kernel and copy)."""
from harness import readers


def read(out):
    return readers.exposed_collective_ms(out)
