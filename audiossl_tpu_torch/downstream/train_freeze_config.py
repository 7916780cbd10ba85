"""Config-file-driven linear-probe entry (PyTorch port of
``audiossl_tpu/downstream/train_freeze_config.py``; reference hydra
variant ``methods/atst/downstream/train_freeze_hydra.py:197-210`` +
``downstream/conf/config.yaml``).

A YAML config file is the reproducible record of a probe run, without
hydra: keys map 1:1 onto the ``train_freeze`` flags (``device`` among
them) and dispatch into the same ``main``. PyYAML is imported inside
:func:`main` only. Grouped sections mirror the
reference config's ``data:`` / ``model:`` / ``train:`` layout; flat
keys work too. CLI ``key=value`` overrides emulate hydra's override
grammar.

Example config::

    data:
      dataset_name: spcv2
      data_path: /data/spcv2
    model:
      pretrained_ckpt_path: /ckpt/last.ckpt
      model_type: clip
      arch: small
      chunk_len_s: 6.0
      n_last_blocks: 12
    train:
      learning_rate: 2e-3
      batch_size: 1024
      max_epochs: 100
      save_path: /out/probe

Usage: ``python -m audiossl_tpu_torch.downstream.train_freeze_config
cfg.yaml train.max_epochs=2``
"""
from __future__ import annotations

import sys

from audiossl_tpu_torch.downstream import train_freeze

# config keys -> train_freeze flags (grouped or flat; unknown keys error)
_SECTIONS = ("data", "model", "train")


def _flatten(cfg: dict) -> dict:
    flat = {}
    for k, v in cfg.items():
        if k in _SECTIONS and isinstance(v, dict):
            for kk, vv in v.items():
                if vv is not None:
                    flat[kk] = vv
        elif v is not None:
            flat[k] = v
    return flat


def _parse_override(tok: str):
    """hydra-style ``section.key=value`` / ``key=value`` override."""
    if "=" not in tok:
        raise SystemExit(f"override {tok!r} is not key=value")
    key, val = tok.split("=", 1)
    key = key.split(".")[-1]  # section prefix is cosmetic
    return key, val


def config_to_argv(cfg: dict, overrides=()) -> list:
    valid = {a.dest for a in train_freeze.build_parser()._actions
             if a.dest != "help"}
    flat = _flatten(cfg)
    for tok in overrides:
        k, v = _parse_override(tok)
        flat[k] = v
    unknown = sorted(set(flat) - valid)
    if unknown:
        raise SystemExit(
            f"unknown config keys {unknown}; valid: {sorted(valid)}")
    argv = []
    for k, v in flat.items():
        argv += [f"--{k}", str(v)]
    return argv


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return None
    import yaml

    with open(argv[0]) as f:
        cfg = yaml.safe_load(f) or {}
    if not isinstance(cfg, dict):
        raise SystemExit(f"{argv[0]} must contain a YAML mapping")
    return train_freeze.main(config_to_argv(cfg, argv[1:]))


if __name__ == "__main__":
    main()
