"""Weights into the port: reference checkpoints and the JAX package's params.

* :func:`load_pretrain_checkpoint` reads a reference pretraining
  Lightning ``.ckpt`` and returns the encoder's state dict under the
  reference names the port's modules use (counterpart of
  ``audiossl_tpu/compat/torch_import.py:201``);
* :func:`state_dict_from_flax` turns the JAX package's
  ``AudioTransformer`` param tree (numpy arrays) into the port's state
  dict, the inverse of ``torch_import.encoder_params_from_torch``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def strip_prefixes(sd: Mapping[str, object], prefixes=("module.", "backbone.")):
    out = {}
    for k, v in sd.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


def subtree(sd: Mapping[str, object], prefix: str) -> Dict[str, object]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _t(a, transpose=False) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a))


def _dense(p, prefix, out):
    """flax Dense {kernel [in, out], bias} -> torch Linear [out, in]."""
    out[prefix + ".weight"] = _t(p["kernel"], transpose=True)
    if "bias" in p:
        out[prefix + ".bias"] = _t(p["bias"])


def _norm(p, prefix, out):
    out[prefix + ".weight"] = _t(p["scale"])
    out[prefix + ".bias"] = _t(p["bias"])


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Frame ``AudioTransformer`` flax params -> the port's state dict.

    Dense kernels are transposed to torch's ``[out, in]``; a qkv Dense
    without bias (``qkv_bias=False``) gives no ``qkv.bias`` key, as in
    the reference. Raises on param groups a frame encoder does not hold,
    so nothing is dropped unnoticed."""
    out: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        if name == "patch_proj":
            _dense(p, "patch_embed.patch_embed", out)
        elif name in ("pos_embed", "mask_embed"):
            out[name] = _t(p)
        elif name == "norm":
            _norm(p, "norm_frame", out)
        elif name.startswith("blocks_"):
            b = "blocks." + name[len("blocks_"):]
            _norm(p["norm1"], b + ".norm1", out)
            _norm(p["norm2"], b + ".norm2", out)
            _dense(p["attn"]["qkv"], b + ".attn.qkv", out)
            _dense(p["attn"]["proj"], b + ".attn.proj", out)
            _dense(p["mlp"]["fc1"], b + ".mlp.fc1", out)
            _dense(p["mlp"]["fc2"], b + ".mlp.fc2", out)
        else:
            raise KeyError(f"param group {name!r} has no place in the "
                           "frame encoder")
    return out


def load_pretrain_checkpoint(path: str, which: str = "teacher"):
    """Reference pretraining ``.ckpt`` (Lightning) -> (encoder state dict of
    ``which`` in {'teacher', 'student'}, hyper_parameters dict).

    The encoder is found under ``model.{which}.encoder.``, then
    ``{which}.encoder.``, else the dict is taken as a raw encoder state
    dict; ``module.``/``backbone.`` prefixes are stripped first. The file
    is read with ``weights_only=True``: tensors and plain containers."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = strip_prefixes(ckpt.get("state_dict", ckpt))
    enc = subtree(sd, f"model.{which}.encoder.")
    if not enc:
        enc = subtree(sd, f"{which}.encoder.")
    if not enc:
        enc = sd
    return enc, dict(ckpt.get("hyper_parameters", {}))
