"""The encoder-adapter interface of the downstream SED drivers (PyTorch
port of ``audiossl_tpu/downstream/comparison_models.py``; reference
``downstream/comparison_models/*_module.py``).

An adapter exposes ``frame_embeddings(wav, valid, dps=None) -> [B, T',
D]``, ``embed_dim``, ``frame_rate_divisor``, ``token_count`` and the
``encoder`` module that SED finetuning trains in place. The registry holds
all eleven of the reference's ``--arch`` choices (``train_dcase.py:
139-161``) under JAX's names: the repository's own encoders
(``frameatst``, ``clipatst`` with the CLS token dropped, ``distillatst``:
a distilled checkpoint's student) and the eight comparison encoders of
``compat/`` (``beats``, ``byola``, ``audioMAE``, ``mmd``, ``ssast``,
``patchssast``, ``maeast``, ``patchmaeast``), each read from its authors'
checkpoint file. Only the own encoders take drop-path multipliers
(``dps``); the comparison adapters ignore them, as JAX's ignore ``rngs``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional

import torch

from audiossl_tpu_torch.compat import audiomae, beats, byola, m2d, maeast, ssast
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


# the published fbank normalization of BEATs (reference beats_module.py)
BEATS_FBANK_MEAN = 15.41663
BEATS_FBANK_STD = 6.55582


@dataclasses.dataclass
class BEATsAdapter:
    """BEATs as a frame encoder of the SED drivers (reference
    beats_module.py:19-69): the Kaldi fbank of the wave times 2**15 with
    the published normalization, the valid frames as a key mask, the
    encoder's tokens averaged over each time step's 8 freq patches
    (AvgPool1d(8, 8)) -> one embedding per 16 fbank frames."""
    encoder: torch.nn.Module

    @property
    def embed_dim(self):
        return self.encoder.cfg.encoder_embed_dim

    @property
    def frame_rate_divisor(self):
        # the strong labels are pooled by this factor from 100 fps fbank
        # frames (ManyHotEncoder's net_pooling)
        return self.encoder.cfg.input_patch_size

    def token_count(self, n_samples: int) -> int:
        frames = 1 + (n_samples - 400) // 160  # Kaldi snip_edges
        return frames // self.encoder.cfg.input_patch_size

    def frame_embeddings(self, wav, valid,
                         dps: Optional[torch.Tensor] = None):
        """-> [B, T', D]; ``dps`` is not read."""
        with torch.no_grad():
            fb = beats.kaldi_fbank(wav.float() * 2.0 ** 15)
            fb = (fb - BEATS_FBANK_MEAN) / (2.0 * BEATS_FBANK_STD)
            vf = torch.clamp_min(1 + torch.div(valid - 400, 160,
                                               rounding_mode="floor"), 1)
        toks = self.encoder(fb, valid_frames=vf)
        B, N, D = toks.shape
        F = 8  # freq patches a time step (128 mels / 16)
        return toks.reshape(B, N // F, F, D).mean(dim=2)


@dataclasses.dataclass
class BYOLAAdapter:
    """The BYOL-A v2 CNN as a frame encoder (reference byola_module.py):
    the Slaney log-mel with the published PrecomputedNorm statistics, the
    convolutions pooling time by 4 -> 25 fps frame embeddings of dim 3072.
    The BatchNorms keep the checkpoint's running statistics, in training
    too (``compat.byola.RunningStatsBatchNorm2d``)."""
    encoder: torch.nn.Module

    @property
    def embed_dim(self):
        return self.encoder.d

    @property
    def frame_rate_divisor(self):
        return 4  # two 2x time maxpools over 100 fps mels

    def token_count(self, n_samples: int) -> int:
        return (n_samples // 160 + 1) // 4

    def frame_embeddings(self, wav, valid,
                         dps: Optional[torch.Tensor] = None):
        """-> [B, T', D]; ``valid`` and ``dps`` are not read."""
        with torch.no_grad():
            lms = byola.byola_logmel(wav)
        return self.encoder(lms)


# each comparison arch: its adapter and its loader of the authors' file
COMPARISON = {
    "beats": (BEATsAdapter, beats.load_beats_checkpoint),
    "byola": (BYOLAAdapter, byola.load_byola_checkpoint),
    "audioMAE": (audiomae.AudioMAEAdapter, audiomae.load_audiomae_checkpoint),
    "mmd": (m2d.M2DAdapter, m2d.load_m2d_checkpoint),
    "ssast": (ssast.SSASTAdapter, functools.partial(
        ssast.load_ssast_checkpoint, variant="frame")),
    "patchssast": (ssast.SSASTAdapter, functools.partial(
        ssast.load_ssast_checkpoint, variant="patch")),
    "maeast": (maeast.MAEASTAdapter, functools.partial(
        maeast.load_maeast_checkpoint, variant="frame")),
    "patchmaeast": (maeast.MAEASTAdapter, functools.partial(
        maeast.load_maeast_checkpoint, variant="patch")),
}


def comparison_adapter(arch: str, encoder: torch.nn.Module):
    """``arch``'s adapter around an encoder of its family."""
    return COMPARISON[arch][0](encoder)


def _comparison(arch: str):
    """The registry entry of ``arch``: ``make(ckpt_path, device="cuda")``
    reads the authors' checkpoint."""
    adapter, load = COMPARISON[arch]

    def make(ckpt_path: str, device="cuda"):
        return adapter(load(ckpt_path, device=device))

    return make


for _arch in COMPARISON:
    register_adapter(_arch)(_comparison(_arch))


class EnsembleModel:
    """The mean of clip and frame classifiers' logits (a working version of
    the reference's dead ensemble code, downstream/ensemble.py)."""

    def __init__(self, predict_fns):
        self.predict_fns = list(predict_fns)

    def __call__(self, *args, **kw):
        logits = [f(*args, **kw) for f in self.predict_fns]
        return sum(logits) / len(logits)


def cal_norm(extract_fn, loader):
    """The embeddings' mean and standard deviation over a dataset, on the
    host (reference downstream/cal_norm.py); ``extract_fn(wav, valid)``
    returns a tensor or an array."""
    import numpy as np

    total, total_sq, n = 0.0, 0.0, 0
    for batch in loader:
        e = extract_fn(batch["wav"], batch["valid"])
        e = (e.detach().cpu().numpy() if isinstance(e, torch.Tensor)
             else np.asarray(e))
        total = total + e.sum(0)
        total_sq = total_sq + (e ** 2).sum(0)
        n += len(e)
    mean = total / n
    std = np.sqrt(np.maximum(total_sq / n - mean ** 2, 0.0))
    return mean, std
