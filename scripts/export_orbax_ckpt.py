"""Export an orbax encoder directory of ``audiossl_tpu`` as a ``.ckpt`` that
``audiossl_tpu_torch`` loads.

The JAX package saves an exported encoder's params with
``training.checkpoint.save_params`` (an orbax directory) and its
``embedding.load_model`` reads them back with ``restore_params``. Reading
orbax needs JAX, orbax and tensorstore, which the PyTorch package does not
import, so this script runs where they are installed: it restores the
directory as JAX's ``load_model`` does, maps the flax params onto the
PyTorch encoder's names with ``audiossl_tpu_torch.compat.checkpoint.
state_dict_from_flax``, and writes the reference Lightning layout the
PyTorch loaders read: ``state_dict`` with ``model.teacher.encoder.<name>``
keys, and ``hyper_parameters["arch"]``, the size tier that
``infer_arch`` reads off the tensors' width and block count.

    python scripts/export_orbax_ckpt.py ORBAX_DIR OUT.ckpt

``audiossl_tpu_torch.embedding.load_model(OUT.ckpt)`` and
``downstream.train_freeze.load_encoder(OUT.ckpt, ...)`` then read it as
any ``.ckpt``.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def export(orbax_dir: str, out_path: str) -> dict:
    """Restore ``orbax_dir`` and write ``out_path``; returns the state
    dict as written."""
    import torch

    from audiossl_tpu.training.checkpoint import restore_params
    from audiossl_tpu_torch.compat.checkpoint import (infer_arch,
                                                      state_dict_from_flax)

    sd = state_dict_from_flax(restore_params(orbax_dir))
    ckpt = {"state_dict": {f"model.teacher.encoder.{k}": v
                           for k, v in sd.items()},
            "hyper_parameters": {"arch": infer_arch(sd)[1]}}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.save(ckpt, out_path)
    return ckpt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("orbax_dir", help="a directory written by "
                    "audiossl_tpu.training.checkpoint.save_params")
    ap.add_argument("out", help="the .ckpt to write")
    args = ap.parse_args(argv)
    if not args.out.endswith(".ckpt"):
        ap.error("the output must end in .ckpt: the loaders tell the "
                 "layout by the suffix")
    ckpt = export(args.orbax_dir, args.out)
    print(f"wrote {args.out}: {len(ckpt['state_dict'])} tensors, arch "
          f"{ckpt['hyper_parameters']['arch']}")


if __name__ == "__main__":
    main()
