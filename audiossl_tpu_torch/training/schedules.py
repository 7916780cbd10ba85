"""Training schedules as plain functions of the step (PyTorch port of
``audiossl_tpu/training/schedules.py``): linear warmup, then cosine decay,
matching the reference's precomputed ``cosine_scheduler_step`` arrays."""
from __future__ import annotations

import math


def cosine_schedule(base_value: float, final_value: float, max_steps: int,
                    warmup_steps: int = 0, start_warmup_value: float = 0.0):
    """Returns f(step) -> float: ``start + step * (base - start) /
    (warmup_steps - 1)`` during warmup, then cosine from base to final
    over the remaining steps."""
    decay_steps = max_steps - warmup_steps

    def schedule(step: int) -> float:
        if step < warmup_steps:
            if warmup_steps > 1:
                return start_warmup_value + step * (
                    (base_value - start_warmup_value) / (warmup_steps - 1))
            return base_value
        i = min(max(step - warmup_steps, 0), max(decay_steps - 1, 1))
        return final_value + 0.5 * (base_value - final_value) * (
            1.0 + math.cos(math.pi * i / decay_steps))

    return schedule
