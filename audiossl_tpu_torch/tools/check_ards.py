"""Sanity-print a .ards pack (port of ``scripts/check_ards.py``; reference
``scripts/dataset_preprocess/check_lmdb.py``): its record count and the
first five records' shape, dtype, sample rate and label. Reads the pack
on the host; ``--device`` is checked as every tool's is.

Usage:
    python -m audiossl_tpu_torch.tools.check_ards PATH.ards
"""
from __future__ import annotations

import argparse

from audiossl_tpu_torch.tools import add_device_flag, device_of


def build_parser():
    p = argparse.ArgumentParser("check_ards",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("path")
    return add_device_flag(p)


def main(argv=None) -> dict:
    from audiossl_tpu_torch.datasets.packed import PackedReader

    args = build_parser().parse_args(argv)
    device_of(args)
    r = PackedReader(args.path)
    print(f"{args.path}: {len(r)} records")
    head = []
    for i in range(min(5, len(r))):
        wav, label, sr = r.read(i)
        print(i, wav.shape, wav.dtype, "sr", sr, "label",
              label if not hasattr(label, "shape") else
              f"array{label.shape}")
        head.append({"shape": list(wav.shape), "dtype": str(wav.dtype),
                     "sr": int(sr)})
    return {"records": len(r), "head": head}


if __name__ == "__main__":
    main()
