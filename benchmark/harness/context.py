"""What a mix is given and what it gives back."""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict, Optional

import torch


@dataclasses.dataclass
class Ctx:
    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    control: bool = False  # the configuration's next lower precision
    fault: Optional[str] = None  # planted in a mix's own processes
    t0: float = dataclasses.field(default_factory=time.perf_counter)
    # set-up counts from here: the process's start in a run


@dataclasses.dataclass
class Outcome:
    setup_s: float
    attempted: int
    failed: int
    e2e: Dict[str, float]          # end-to-end metrics (--trace 0)
    memory_peak_bytes: int
    numbers: Dict[str, float]      # what the comparison with the reference read
    traces: Optional[list] = None  # trace.Trace of each chip's traced stretch
    unit_s: Optional[float] = None  # seconds a step or call, timed stretch
    unit_flops: Optional[float] = None
    peak_flops: Optional[float] = None
    bound_ctx: dict = dataclasses.field(default_factory=dict)

    @property
    def trace(self):
        """The first chip's trace, or None."""
        return self.traces[0] if self.traces else None


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0


def reset_peak(device) -> None:
    """The peak from here on: the window's, not the set-up's snapshots."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def closed_loop(fn: Callable[[int], None], seconds: float, device):
    """Calls fn(i) for i = 0, 1, ... until ``seconds`` have passed on the
    host clock, then waits for the device. -> (calls, seconds to the end of
    the last call's device work)."""
    sync(device)
    t0 = time.perf_counter()
    n = 0
    while True:
        fn(n)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    return n, time.perf_counter() - t0
