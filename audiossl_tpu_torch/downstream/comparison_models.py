"""The encoder-adapter interface of the downstream SED drivers (PyTorch
port of ``audiossl_tpu/downstream/comparison_models.py``; reference
``downstream/comparison_models/*_module.py``).

An adapter exposes ``frame_embeddings(wav, valid, dps=None) -> [B, T',
D]``, ``embed_dim``, ``frame_rate_divisor`` and ``token_count``. The port
has the adapters of the repository's own encoders: ``frameatst``,
``clipatst`` (the CLS token dropped) and ``distillatst`` (a distilled
checkpoint's student). The registry names all eleven of the reference's
``--arch`` choices (``train_dcase.py:139-161``); the eight comparison
encoders (BEATs, BYOL-A, AudioMAE, M2D, SSAST and MAE-AST, frame and
patch) raise ``NotImplementedError``: their ports are ROADMAP Queue 1
item 6.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from audiossl_tpu_torch.models.atst import AudioTransformer
from audiossl_tpu_torch.ops.melspec import MelConfig, log_melspec

_ADAPTERS: Dict[str, Callable] = {}


def register_adapter(name: str):
    def deco(fn):
        _ADAPTERS[name] = fn
        return fn
    return deco


def get_adapter(name: str, **kw):
    if name not in _ADAPTERS:
        raise KeyError(
            f"unknown encoder adapter {name!r}; available: "
            f"{sorted(_ADAPTERS)}")
    return _ADAPTERS[name](**kw)


def list_adapters():
    return sorted(_ADAPTERS)


@dataclasses.dataclass
class EncoderAdapter:
    """An ATST encoder as a frame encoder: frame_embeddings(wav, valid) ->
    the final norm of the last block's tokens [B, T', D]."""
    encoder: AudioTransformer
    mel: MelConfig = dataclasses.field(default_factory=MelConfig)

    @property
    def embed_dim(self):
        return self.encoder.embed_dim

    @property
    def frame_rate_divisor(self):
        return self.encoder.patch_w

    def token_count(self, n_samples: int) -> int:
        return n_samples // self.mel.hop_length // self.encoder.patch_w

    def frame_embeddings(self, wav: torch.Tensor, valid: torch.Tensor,
                         dps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The mel (K1 on the card; no gradient: nothing before it trains),
        then ``get_intermediate_layers(n=1, scene=False)``; ``dps``
        [depth, 2, B]: drop-path keep multipliers (training), or None."""
        with torch.no_grad():
            spec = log_melspec(wav, valid, self.mel)
        length = valid // self.mel.hop_length + 1
        out = self.encoder.get_intermediate_layers(spec, length, n=1,
                                                   scene=False, dps=dps)
        if self.encoder.use_cls:
            # a clip encoder as a frame encoder: the CLS token dropped
            # (reference clip_atst_module.py:19-29)
            out = out[:, 1:]
        return out


def _atst(model_type: str, which: str):
    def make(ckpt_path: str, arch: str = "base", device="cuda", **kw):
        from audiossl_tpu_torch.downstream.train_freeze import load_encoder

        enc = load_encoder(ckpt_path, model_type, arch, spec_w=1001,
                           which=which, device=device)
        return EncoderAdapter(encoder=enc, **kw)
    return make


register_adapter("frameatst")(_atst("frame", "teacher"))
register_adapter("clipatst")(_atst("clip", "teacher"))
register_adapter("distillatst")(_atst("frame", "student"))


def _not_ported(name: str):
    def make(**kw):
        raise NotImplementedError(
            f"the {name!r} comparison encoder is not ported to "
            "audiossl_tpu_torch yet (ROADMAP Queue 1 item 6); the port runs "
            "its own encoders: frameatst, clipatst, distillatst")
    return make


for _name in ("audioMAE", "beats", "byola", "maeast", "mmd", "patchmaeast",
              "patchssast", "ssast"):
    register_adapter(_name)(_not_ported(_name))
