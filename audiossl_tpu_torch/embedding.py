"""Public embedding API (PyTorch port of ``audiossl_tpu/embedding.py``).

* ``load_model(ckpt_path, arch, which, fused, device)`` loads ATST-Frame
  weights from a reference Lightning ``.ckpt`` or from the port's own
  pretraining checkpoint (a ``state.pt`` or its step directory) and
  returns a ready ``EmbeddingModel``;
* ``get_scene_embedding(audio, model)`` gives one embedding per clip:
  chunk into 1001-frame windows, encode, average over chunks
  -> [B, n_blocks*embed_dim];
* ``get_timestamp_embedding(audio, model)`` gives frame-rate embeddings
  concatenated along time with 40 ms timestamps
  -> ([B, T, n_blocks*embed_dim], timestamps_ms [B, T]).

All DSP runs on the model's device, the card unless the caller asks for
another; the mel kernel runs in both model variants, the block kernels
under ``fused=True``, their int8 variants (K2q, K3q) under
``quant="int8"``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from audiossl_tpu_torch.compat.checkpoint import (
    load_encoder_state,
    load_pretrain_checkpoint,
    port_state_path,
)
from audiossl_tpu_torch.kernels.build import resolve_device
from audiossl_tpu_torch.models.atst import (
    AudioTransformer,
    frame_ast_base,
    frame_ast_small,
    frame_ast_tiny,
)
from audiossl_tpu_torch.ops.melspec import MelConfig, log_melspec

CHUNK_FRAMES = 1001  # 10 s at hop 160 (reference embedding.py:61)
_ARCHS = {"tiny": frame_ast_tiny, "small": frame_ast_small,
          "base": frame_ast_base}


@dataclasses.dataclass
class EmbeddingModel:
    encoder: AudioTransformer
    n_blocks: int = 12
    mel: MelConfig = dataclasses.field(default_factory=MelConfig)

    @property
    def device(self) -> torch.device:
        return self.encoder.pos_embed.device

    @property
    def embed_dim(self):
        return self.encoder.embed_dim

    @property
    def scene_embedding_size(self):
        return self.encoder.embed_dim * self.n_blocks

    @property
    def timestamp_embedding_size(self):
        return self.encoder.embed_dim * self.n_blocks


def load_model(ckpt_path: str, arch: Optional[str] = None,
               which: str = "teacher", fused: bool = False,
               device="cuda", quant: str = "none") -> EmbeddingModel:
    """Load atstframe_{tiny,small,base} weights from a reference PyTorch
    Lightning checkpoint (.ckpt) onto ``device`` (the card unless the
    caller asks for the CPU; without a card that raises). Either
    patch-embed layout loads, and keys the encoder does not read are
    ignored (``compat.checkpoint.encoder_state_from_torch``). A port
    pretraining checkpoint (``<save>/ckpt/<step>/state.pt`` of the frame
    CLI, or that step directory) loads ``which`` branch's encoder as it
    is, every tensor of it.

    An orbax directory of the JAX package is read through its ``.ckpt``
    export (``scripts/export_orbax_ckpt.py``, run where JAX is installed).

    ``arch`` defaults to the checkpoint's ``hyper_parameters["arch"]``
    (for a port checkpoint, the tier its shapes have), else "base".
    ``fused=True`` builds the encoder JAX's ``load_model(fused=True)``
    builds: it computes in bf16 from the patch
    projection on, holds the block matmul weights in bf16, runs the blocks
    through the inference block kernels and normalizes with
    ``LayerNormPG`` in bf16, rounding where JAX rounds; the embeddings
    come back in f32, an exact cast of those bf16 values.
    ``fused=False`` is the plain f32 module path. ``quant="int8"`` (with
    ``fused=True`` only, as in JAX) keeps the f32 weights and runs the
    blocks' products in int8 (K2q, K3q): about 1e-2 relative change of
    each block's output, for bulk extraction rather than parity
    evaluation."""
    device = resolve_device(device)
    if quant not in ("none", "int8"):
        raise ValueError(f"unknown quant mode {quant!r} "
                         "(supported: 'none', 'int8')")
    if quant != "none" and not fused:
        raise ValueError("quant requires fused=True (the quantized "
                         "products live in the fused block kernels)")
    if not (ckpt_path.endswith(".ckpt") or port_state_path(ckpt_path)):
        raise NotImplementedError(
            "only reference .ckpt files and the port's state.pt checkpoints "
            "load; turn an orbax directory into a .ckpt with "
            "scripts/export_orbax_ckpt.py where JAX and orbax are installed")
    sd, hparams = load_pretrain_checkpoint(ckpt_path, which=which)
    layout = hparams.get("layout", "reference")
    if layout == "port":
        found = (hparams["model_type"], hparams["arch"])
        if found != ("frame", arch or found[1]):
            raise ValueError(f"{ckpt_path} holds a {' '.join(found)} "
                             "encoder, not an ATST-Frame "
                             f"{arch or found[1]} one")
    arch = arch or hparams.get("arch", "base")
    enc = _ARCHS[arch](spec_w=CHUNK_FRAMES, fused=fused, device=device,
                       dtype=torch.bfloat16 if fused else torch.float32,
                       infer_quant=quant)
    if layout == "port" and sd["pos_embed"].shape != enc.pos_embed.shape:
        raise ValueError(
            f"{ckpt_path} holds {sd['pos_embed'].shape[1] - 1} position "
            f"embeddings; serving encodes chunks of {CHUNK_FRAMES} frames, "
            f"{enc.pos_embed.shape[1] - 1} patches (pretrain with "
            "--anchor_len 10)")
    load_encoder_state(enc, sd, layout=layout)
    enc.requires_grad_(False)
    return EmbeddingModel(encoder=enc.eval())


def _chunkify(mel, length, chunk_len):
    """[B, F, T] -> ([B*nc, F, chunk_len], per-chunk frame counts, chunk
    has-audio mask [B, nc], nc)."""
    B, F, T = mel.shape
    nc = max((T + chunk_len - 1) // chunk_len, 1)
    melp = torch.nn.functional.pad(mel, (0, nc * chunk_len - T))
    chunks = melp.reshape(B, F, nc, chunk_len).permute(0, 2, 1, 3).reshape(
        B * nc, F, chunk_len)
    ks = torch.arange(nc, device=mel.device)
    cur = torch.clamp(length[:, None] - ks[None, :] * chunk_len, min=0)
    return chunks, torch.clamp(cur.reshape(-1), max=chunk_len), cur > 0, nc


def _encode(audio, model: EmbeddingModel, scene: bool):
    """audio [B, n] (or [n]) -> (per-chunk embeddings, chunk mask, B, nc)."""
    wav = torch.as_tensor(audio, dtype=torch.float32, device=model.device)
    wav = torch.atleast_2d(wav)
    B, n = wav.shape
    valid = torch.full((B,), n, dtype=torch.int64, device=wav.device)
    mel = log_melspec(wav, valid, model.mel)
    length = valid // model.mel.hop_length + 1
    chunks, cur, has, nc = _chunkify(mel, length, CHUNK_FRAMES)
    emb = model.encoder.get_intermediate_layers(chunks, cur, n=model.n_blocks,
                                                scene=scene)
    return emb, has, B, nc


@torch.inference_mode()
def get_scene_embedding(audio, model: EmbeddingModel) -> torch.Tensor:
    """audio: [B, n_samples] (or [n_samples]) 16 kHz waveform ->
    [B, n_blocks*embed_dim] scene embeddings, f32 (the chunk mean rounded
    to the encoder's dtype, as JAX takes it)."""
    emb, has, B, nc = _encode(audio, model, scene=True)
    dt = model.encoder.dtype
    w = has.float()[:, :, None]
    total = (emb.reshape(B, nc, -1) * w).sum(dim=1).to(dt)
    return (total / torch.clamp(w.sum(dim=1), min=1.0).to(dt)).float()


@torch.inference_mode()
def get_timestamp_embedding(audio, model: EmbeddingModel
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """audio: [B, n_samples] -> (embeddings [B, T, n_blocks*D],
    timestamps in ms [B, T]) at one embedding per patch (40 ms)."""
    emb, _, B, nc = _encode(audio, model, scene=False)
    emb = emb.reshape(B, nc * emb.shape[1], emb.shape[-1])
    T = emb.shape[1]
    pw = model.encoder.patch_w
    hop_ms = model.mel.hop_length / model.mel.sample_rate * 1000.0
    ts = (torch.arange(T, device=emb.device) * pw + pw / 2.0) * hop_ms
    return emb, ts[None, :].expand(B, T)
