"""Scan a packed training set's mel dB range (port of
``scripts/calculate_min_max.py``; reference
``methods/atstframe/calculate_min_max.py``, the provenance of the
``MinMax(-79.6482, 50.6842)`` constants): each clip's unnormalized
log-mel (``log_melspec(normalize=False)``, the mel kernel K1 on the card)
and the smallest and largest dB over the first ``--max_items`` clips.

Usage:
    python -m audiossl_tpu_torch.tools.calculate_min_max --data_path DATA
        [--split train] [--max_items 2000]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from audiossl_tpu_torch.tools import add_device_flag, device_of


def build_parser():
    p = argparse.ArgumentParser("calculate_min_max",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--data_path", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--max_items", type=int, default=2000)
    return add_device_flag(p)


def db_range(ds, n: int, device, plain: bool = False):
    """(min, max) dB of the first ``n`` clips of ``ds``; ``plain`` takes
    the mel kernel's plain version."""
    from audiossl_tpu_torch.ops.melspec import MelConfig, log_melspec

    cfg = MelConfig()
    lo, hi = np.inf, -np.inf
    for i in range(min(len(ds), n)):
        wav, _ = ds[i]
        w = torch.from_numpy(np.asarray(wav, np.float32)[None]).to(device)
        db = log_melspec(w, cfg=cfg, normalize=False, plain=plain)
        lo = min(lo, float(db.min()))
        hi = max(hi, float(db.max()))
        if i % 200 == 0:
            print(i, lo, hi, flush=True)
    return lo, hi


def main(argv=None) -> dict:
    from audiossl_tpu_torch.datasets.packed import PackedAudioDataset

    args = build_parser().parse_args(argv)
    dev = device_of(args)
    ds = PackedAudioDataset(args.data_path, args.split)
    lo, hi = db_range(ds, args.max_items, dev)
    print(f"min={lo:.4f} max={hi:.4f}")
    return {"min": lo, "max": hi}


if __name__ == "__main__":
    main()
