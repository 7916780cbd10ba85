"""Small helpers shared by the command lines (the port's own copy of
``bool_flag`` from ``audiossl_tpu/methods/atstframe/train.py``)."""
from __future__ import annotations

import argparse


def bool_flag(s: str) -> bool:
    """argparse type of the reference's boolean flags: off/false/0 and
    on/true/1, in any case."""
    if s.lower() in ("off", "false", "0"):
        return False
    if s.lower() in ("on", "true", "1"):
        return True
    raise argparse.ArgumentTypeError(f"invalid bool {s!r}")
