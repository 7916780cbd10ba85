"""BEATs encoder family and the Kaldi fbank front end (PyTorch port of
``audiossl_tpu/compat/beats.py``; reference ``downstream/
comparison_models/beats_module.py:19-69`` and ``models/beats/{BEATs,
backbone,modules}.py``):

* :class:`BEATsEncoder` — the BEATs fairseq-style encoder (``BEATs.py:
  74-180`` + ``backbone.py:26-686``): a 16x16 patch convolution on
  128-bin Kaldi fbanks, LayerNorm and the 512 -> 768 projection, the
  grouped-convolution position embedding, 12 post-LN layers with DeepNorm
  residual scaling, and the T5-style bucketed relative position bias
  (shared across layers) with GRU-style gating, including the
  reference's alpha = 32 max-subtracted softmax rescaling. Its GELUs are
  exact erf (``F.gelu``), as JAX's ``jax.nn.gelu(approximate=False)``,
  not the A&S polynomial of the port's ViT blocks.
* :func:`convert_beats_state_dict` — the authors' state dict -> the
  port's (the weight norm of the position convolution collapsed on
  load).
* :func:`kaldi_fbank` — ``torchaudio.compliance.kaldi.fbank`` at the
  reference's settings (``beats_module.py:45``: 128 mels, 25 ms / 10 ms,
  snip_edges, povey window, preemphasis 0.97, DC removal, natural-log
  mels). The card's machine has no ``torchaudio``: this is torch alone.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiossl_tpu_torch.compat.vit import f32, unwrap
from audiossl_tpu_torch.kernels.build import resolve_device


@dataclasses.dataclass(frozen=True)
class BEATsConfig:
    """The reference BEATsConfig's fields the encoder uses (reference
    models/beats/BEATs.py:25-72). Defaults = BEATs_iter3."""
    input_patch_size: int = 16
    embed_dim: int = 512
    conv_bias: bool = False
    encoder_layers: int = 12
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_attention_heads: int = 12
    layer_norm_first: bool = False
    deep_norm: bool = True
    conv_pos: int = 128
    conv_pos_groups: int = 16
    relative_position_embedding: bool = True
    num_buckets: int = 320
    max_distance: int = 800
    gru_rel_pos: bool = True

    @classmethod
    def from_checkpoint_cfg(cls, cfg: dict) -> "BEATsConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cfg.items() if k in names})


def _relative_position_bucket(relative_positions: torch.Tensor,
                              num_buckets: int, max_distance: int
                              ) -> torch.Tensor:
    """T5 bidirectional bucketing (reference backbone.py:393-418)."""
    num_buckets = num_buckets // 2
    buckets = (relative_positions > 0).long() * num_buckets
    rel = relative_positions.abs()
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    large = max_exact + (
        torch.log(rel.clamp_min(1).float() / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).long()
    large = large.clamp_max(num_buckets - 1)
    return buckets + torch.where(is_small, rel, large)


class BEATsSelfAttention(nn.Module):
    """fairseq MultiheadAttention with the gated relative position bias
    (reference backbone.py:278-686). The bias table lives in the encoder
    (shared by the layers); each layer applies its own GRU gate, computed
    from the unscaled q."""

    def __init__(self, cfg: BEATsConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.encoder_embed_dim
        H = cfg.encoder_attention_heads
        self.q_proj = nn.Linear(D, D, device=device)
        self.k_proj = nn.Linear(D, D, device=device)
        self.v_proj = nn.Linear(D, D, device=device)
        self.out_proj = nn.Linear(D, D, device=device)
        if cfg.gru_rel_pos:
            self.grep_linear = nn.Linear(D // H, 8, device=device)
            self.grep_a = nn.Parameter(torch.ones(1, H, 1, 1, device=device))

    def forward(self, x, position_bias, key_mask=None):
        c = self.cfg
        H = c.encoder_attention_heads
        B, T, D = x.shape
        d = D // H
        scaling = d ** -0.5
        alpha = 32.0
        q0 = self.q_proj(x)  # the raw q: the gate's input
        k = self.k_proj(x)
        v = self.v_proj(x)
        q = q0 * (scaling / alpha)

        def heads(t):
            return t.reshape(B, T, H, d).transpose(1, 2)

        s = torch.einsum("bhtd,bhsd->bhts", heads(q), heads(k))
        # the alpha-rescaled max subtraction (reference backbone.py:624-625)
        s = (s - s.amax(dim=-1, keepdim=True).detach()) * alpha
        if key_mask is not None:
            s = s + key_mask[:, None, None, :]
        if position_bias is not None:
            bias = position_bias[None]  # [1, H, T, T]
            if c.gru_rel_pos:
                # the gate from the unscaled q (reference backbone.py:652-658)
                gates = torch.sigmoid(self.grep_linear(heads(q0)).reshape(
                    B, H, T, 2, 4).sum(-1))
                gate_a, gate_b = gates[..., 0], gates[..., 1]
                gate = gate_a * (gate_b * self.grep_a[..., 0] - 1.0) + 2.0
                bias = gate[..., None] * bias
            s = s + bias
        p = s.softmax(dim=-1)
        o = torch.einsum("bhts,bhsd->bhtd", p, heads(v))
        return self.out_proj(o.transpose(1, 2).reshape(B, T, D))


class BEATsLayer(nn.Module):
    """Post-LN (DeepNorm) transformer layer (reference backbone.py:152-281,
    the else branch of its forward)."""

    def __init__(self, cfg: BEATsConfig, device=None):
        super().__init__()
        if cfg.layer_norm_first:
            raise NotImplementedError("released BEATs checkpoints are "
                                      "post-LN")
        self.cfg = cfg
        D = cfg.encoder_embed_dim
        self.self_attn = BEATsSelfAttention(cfg, device)
        self.self_attn_layer_norm = nn.LayerNorm(D, eps=1e-5, device=device)
        self.fc1 = nn.Linear(D, cfg.encoder_ffn_embed_dim, device=device)
        self.fc2 = nn.Linear(cfg.encoder_ffn_embed_dim, D, device=device)
        self.final_layer_norm = nn.LayerNorm(D, eps=1e-5, device=device)

    def forward(self, x, position_bias, key_mask=None):
        c = self.cfg
        dn_alpha = (2.0 * c.encoder_layers) ** 0.25 if c.deep_norm else 1.0
        x = x * dn_alpha + self.self_attn(x, position_bias, key_mask)
        x = self.self_attn_layer_norm(x)
        y = self.fc2(F.gelu(self.fc1(x)))
        return self.final_layer_norm(x * dn_alpha + y)


class BEATsEncoder(nn.Module):
    """BEATs feature extractor: fbank [B, T, 128] -> tokens
    [B, (T//16)*8, encoder_embed_dim] (reference BEATs.extract_features,
    BEATs.py:138-180, without its Kaldi front end)."""

    def __init__(self, cfg: BEATsConfig = BEATsConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        P = cfg.input_patch_size
        D = cfg.encoder_embed_dim
        self.patch_embedding = nn.Conv2d(1, cfg.embed_dim, P, stride=P,
                                         bias=cfg.conv_bias, device=device)
        self.layer_norm = nn.LayerNorm(cfg.embed_dim, eps=1e-5,
                                       device=device)
        if cfg.embed_dim != D:
            self.post_extract_proj = nn.Linear(cfg.embed_dim, D,
                                               device=device)
        self.pos_conv = nn.Conv1d(D, D, cfg.conv_pos,
                                  padding=cfg.conv_pos // 2,
                                  groups=cfg.conv_pos_groups, device=device)
        self.encoder_layer_norm = nn.LayerNorm(D, eps=1e-5, device=device)
        if cfg.relative_position_embedding:
            self.relative_attention_bias = nn.Parameter(torch.zeros(
                cfg.num_buckets, cfg.encoder_attention_heads, device=device))
        self.layers = nn.ModuleList(BEATsLayer(cfg, device)
                                    for _ in range(cfg.encoder_layers))

    def forward(self, fbank: torch.Tensor,
                valid_frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        P = c.input_patch_size
        B = fbank.shape[0]
        x = self.patch_embedding(fbank.float()[:, None])  # [B, E, T', F']
        _, E, Tt, Ft = x.shape
        x = x.permute(0, 2, 3, 1).reshape(B, Tt * Ft, E)  # time-major
        x = self.layer_norm(x)
        if c.embed_dim != c.encoder_embed_dim:
            x = self.post_extract_proj(x)
        key_mask = None
        if valid_frames is not None:
            # Ft freq patches per time step; the valid time patches
            vt = torch.div(valid_frames, P, rounding_mode="floor")[:, None]
            tpos = torch.div(torch.arange(Tt * Ft, device=x.device), Ft,
                             rounding_mode="floor")[None]
            key_mask = torch.where(tpos < vt, 0.0, -1e4)
            x = x * (key_mask >= 0)[..., None]
        # the grouped-convolution position embedding, its SamePad trim of
        # an even width, and GELU (reference backbone.py:32-46, 112-115)
        pos = self.pos_conv(x.transpose(1, 2)).transpose(1, 2)
        if c.conv_pos % 2 == 0:
            pos = pos[:, :-1]
        x = self.encoder_layer_norm(x + F.gelu(pos))
        position_bias = None
        if c.relative_position_embedding:
            N = x.shape[1]
            pos_i = torch.arange(N, device=x.device)
            bucket = _relative_position_bucket(
                pos_i[None, :] - pos_i[:, None], c.num_buckets,
                c.max_distance)
            position_bias = self.relative_attention_bias[bucket].permute(
                2, 0, 1)  # [H, N, N]
        for layer in self.layers:
            x = layer(x, position_bias, key_mask)
        return x


# --------------------------- torch importer --------------------------- #

def convert_beats_state_dict(sd: Mapping, cfg: BEATsConfig
                             ) -> Dict[str, torch.Tensor]:
    """The authors' ``BEATs.state_dict()`` -> :class:`BEATsEncoder`'s state
    dict: the weight norm of ``pos_conv`` collapsed (g * v / ||v||, the
    norm over the (out, in) dims of each tap: torch ``weight_norm(dim=2)``)
    and layer 0's ``relative_attention_bias`` as the shared table. Reads
    no other keys than those."""
    out = {"patch_embedding.weight": f32(sd["patch_embedding.weight"])}
    if "patch_embedding.bias" in sd:
        out["patch_embedding.bias"] = f32(sd["patch_embedding.bias"])
    for k in ("layer_norm.weight", "layer_norm.bias"):
        out[k] = f32(sd[k])
    if "post_extract_proj.weight" in sd:
        out["post_extract_proj.weight"] = f32(sd["post_extract_proj.weight"])
        out["post_extract_proj.bias"] = f32(sd["post_extract_proj.bias"])
    g = f32(sd["encoder.pos_conv.0.weight_g"]).double()
    v = f32(sd["encoder.pos_conv.0.weight_v"]).double()
    norm = v.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
    out["pos_conv.weight"] = (g * v / norm.clamp_min(1e-12)).float()
    out["pos_conv.bias"] = f32(sd["encoder.pos_conv.0.bias"])
    out["encoder_layer_norm.weight"] = f32(sd["encoder.layer_norm.weight"])
    out["encoder_layer_norm.bias"] = f32(sd["encoder.layer_norm.bias"])
    if cfg.relative_position_embedding:
        out["relative_attention_bias"] = f32(
            sd["encoder.layers.0.self_attn.relative_attention_bias.weight"])
    names = ["self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
             "self_attn.out_proj", "self_attn_layer_norm", "fc1", "fc2",
             "final_layer_norm"]
    if cfg.gru_rel_pos:
        names.append("self_attn.grep_linear")
    for i in range(cfg.encoder_layers):
        pre = f"encoder.layers.{i}."
        for n in names:
            for p in ("weight", "bias"):
                out[f"layers.{i}.{n}.{p}"] = f32(sd[f"{pre}{n}.{p}"])
        if cfg.gru_rel_pos:
            out[f"layers.{i}.self_attn.grep_a"] = f32(
                sd[f"{pre}self_attn.grep_a"])
    return out


def beats_from_state_dict(sd: Mapping, cfg: Optional[dict] = None,
                          device="cuda") -> BEATsEncoder:
    """The authors' state dict and ``cfg`` dict (a released checkpoint's
    ``model`` and ``cfg``) -> :class:`BEATsEncoder` on ``device``, in eval
    mode."""
    c = BEATsConfig.from_checkpoint_cfg(cfg or {})
    enc = BEATsEncoder(c, device=resolve_device(device))
    enc.load_state_dict(convert_beats_state_dict(sd, c))
    return enc.eval()


def load_beats_checkpoint(path: str, device="cuda") -> BEATsEncoder:
    """A released BEATs checkpoint (a torch ``.pt`` of ``{'cfg', 'model'}``,
    a trusted third-party file read with ``weights_only=False`` as the
    JAX loader reads it) -> :class:`BEATsEncoder` (reference
    beats_module.py:22-28)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return beats_from_state_dict(unwrap(ckpt, "model"), ckpt.get("cfg", {}),
                                 device)


# --------------------------- Kaldi fbank ------------------------------ #

# torchaudio.compliance.kaldi.fbank's settings in the reference
# (beats_module.py:45): 25 ms povey windows every 10 ms, snip_edges,
# remove_dc_offset, preemphasis 0.97, a 512-point FFT, the Kaldi mel scale
# from 20 Hz to Nyquist, natural-log mel energies.
_KALDI_EPS = 1.1920928955078125e-07  # float eps, Kaldi's log floor


@functools.lru_cache(maxsize=8)
def _kaldi_mel_banks(num_bins, n_fft, sr, low_freq=20.0, high_freq=0.0):
    """Kaldi's triangular mel filters [num_bins, n_fft // 2 + 1] (numpy,
    f32), the DC bin left out."""
    nyq = sr / 2.0
    high = nyq + high_freq if high_freq <= 0 else high_freq

    def mel(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)

    lo_m, hi_m = mel(low_freq), mel(high)
    centers = np.linspace(lo_m, hi_m, num_bins + 2)
    fft_mel = mel(np.arange(n_fft // 2 + 1) * (sr / n_fft))
    fb = np.zeros((num_bins, n_fft // 2 + 1), np.float32)
    for b in range(num_bins):
        left, c, right = centers[b], centers[b + 1], centers[b + 2]
        up = (fft_mel - left) / (c - left)
        down = (right - fft_mel) / (right - c)
        fb[b] = np.maximum(0.0, np.minimum(up, down))
    fb[:, 0] = 0.0  # Kaldi leaves the DC bin out of the triangles
    return fb


@functools.lru_cache(maxsize=4)
def _kaldi_window(win: int, window_type: str) -> np.ndarray:
    n = np.arange(win, dtype=np.float64)
    hanning = 0.5 - 0.5 * np.cos(2 * np.pi * n / (win - 1))
    if window_type == "povey":
        return (hanning ** 0.85).astype(np.float32)
    if window_type == "hanning":
        return hanning.astype(np.float32)
    raise ValueError(f"unsupported window_type {window_type!r}")


def kaldi_fbank(wav: torch.Tensor, num_mel_bins: int = 128, sr: int = 16000,
                frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0,
                preemphasis: float = 0.97,
                window_type: str = "povey") -> torch.Tensor:
    """Kaldi-compatible log-mel fbank of [B, L] waveforms -> [B, T, M], as
    ``torchaudio.compliance.kaldi.fbank(waveform, num_mel_bins=...)``
    computes it: snip_edges framing (T = 1 + (L - 400) // 160), per-frame
    DC removal, preemphasis with the first sample replicated, the povey
    or hanning window, the power spectrum of a 512-point real FFT
    (``torch.fft.rfft``, as the port's boundary frames take theirs), Kaldi
    mel filters, ln(max(e, eps)). The caller applies the reference's
    2**15 scaling and normalization (beats_module.py:44-47);
    ``window_type='hanning'`` is the SSAST and AudioMAE transforms'
    (ssast_module.py:73)."""
    wav = wav.float()
    win = int(sr * frame_length_ms / 1000.0)  # 400
    hop = int(sr * frame_shift_ms / 1000.0)   # 160
    n_fft = 1 << (win - 1).bit_length()       # 512
    frames = wav.unfold(1, win, hop)          # [B, T, win], snip_edges
    frames = frames - frames.mean(dim=-1, keepdim=True)  # DC offset
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - preemphasis * prev
    window = torch.from_numpy(_kaldi_window(win, window_type)).to(wav.device)
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.from_numpy(_kaldi_mel_banks(num_mel_bins, n_fft, sr)).to(
        wav.device)
    mel = torch.einsum("btf,mf->btm", power, fb)
    return torch.log(mel.clamp_min(_KALDI_EPS))
