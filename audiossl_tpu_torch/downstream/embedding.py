"""Frozen-encoder embedding extraction (PyTorch port of
``audiossl_tpu/downstream/embedding.py``, phase 1 of the linear probe).

Reference flow (``methods/atst/downstream/train_freeze.py:75-110``): the
frozen pretrained encoder runs once over each split, clip encoders through
``get_intermediate_layers_chunks`` and frame encoders through a chunked
scene embedding, and the embeddings are cached in memory for the probe.

An extractor takes one padded batch (``wav`` [B, L], ``valid`` [B]), moves
it to the encoder's device in one copy, and runs the central crop, the
mel (K1 on the card, once a batch), the chunking and the encoder there
under ``torch.inference_mode()``. The two extractors chunk differently,
each as JAX does:

* clip: ``T // chunk_len + 1`` chunks, lengths not clamped
  (:meth:`AudioTransformer.get_intermediate_layers_chunks`);
* frame: ``max(T // chunk_len, 1)`` chunks, the tail past them dropped,
  each chunk's length clamped to ``chunk_len``; a later chunk counts when
  it holds more than ``chunk_len // 2`` frames.

Neither is serving's ``_chunkify`` (``audiossl_tpu_torch/embedding.py``),
which ceil-divides.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from audiossl_tpu_torch.models.atst import AudioTransformer
from audiossl_tpu_torch.ops.melspec import MelConfig, log_melspec
from audiossl_tpu_torch.parallel.mesh import gather_rows


def central_crop_frames(wav: torch.Tensor, valid: torch.Tensor,
                        crop_samples: int):
    """CentralCrop(train_len, pad=False) of the reference: the middle
    ``crop_samples`` of each clip's valid samples; a shorter clip keeps its
    own length. -> (crop [B, min(crop_samples, L)] zero past its valid
    count, valid counts [B])."""
    B, L = wav.shape
    width = min(crop_samples, L)
    start = torch.clamp((valid - crop_samples) // 2, min=0)
    start = torch.clamp(start, max=max(L - crop_samples, 0))
    pos = torch.arange(width, device=wav.device)
    out = torch.gather(wav, 1, start[:, None] + pos[None, :])
    out_valid = torch.clamp(valid, max=crop_samples)
    out = torch.where(pos[None, :] < out_valid[:, None], out,
                      out.new_zeros(()))
    return out, out_valid


def _batch(encoder: AudioTransformer, wav, valid):
    """One batch onto the encoder's device: wav f32 [B, L], valid int64."""
    dev = encoder.pos_embed.device
    return (torch.as_tensor(wav, dtype=torch.float32, device=dev),
            torch.as_tensor(valid, device=dev).long())


def make_clip_extractor(encoder: AudioTransformer, crop_len_s: float = 12.0,
                        n_blocks: int = 12, chunk_len: int = 601,
                        avgpool: bool = True, mel: MelConfig = MelConfig(),
                        sr: int = 16000) -> Callable:
    """-> extract(wav [B, L], valid [B]) -> [B, 2*n_blocks*D] embeddings on
    the encoder's device (reference PretrainedEncoderPLModule,
    downstream/model.py:18-41)."""
    crop_samples = int(crop_len_s * sr)

    @torch.inference_mode()
    def extract(wav, valid):
        crop, cv = central_crop_frames(*_batch(encoder, wav, valid),
                                       crop_samples)
        spec = log_melspec(crop, cv, mel)
        frames = cv // mel.hop_length + 1
        return encoder.get_intermediate_layers_chunks(
            spec, frames, n=n_blocks, chunk_len=chunk_len, avgpool=avgpool)

    return extract


def make_frame_extractor(encoder: AudioTransformer, crop_len_s: float = 12.0,
                         n_blocks: int = 12, chunk_len_s: float = 6.0,
                         mel: MelConfig = MelConfig(),
                         sr: int = 16000) -> Callable:
    """-> extract(wav [B, L], valid [B]) -> [B, n_blocks*D] scene
    embeddings of the frame encoder (reference
    atstframe/downstream/model.py:18-61): the mel cut into chunks of the
    pretraining length, each chunk's scene embedding (the last n blocks'
    masked means), averaged over the chunks a clip marks."""
    crop_samples = int(crop_len_s * sr)
    chunk_len = int(chunk_len_s * sr) // mel.hop_length + 1

    @torch.inference_mode()
    def extract(wav, valid):
        crop, cv = central_crop_frames(*_batch(encoder, wav, valid),
                                       crop_samples)
        spec = log_melspec(crop, cv, mel)
        length = cv // mel.hop_length + 1
        B, Fq, T = spec.shape
        nc = max(T // chunk_len, 1)
        pad_to = nc * chunk_len
        specp = torch.nn.functional.pad(spec, (0, max(pad_to - T, 0)))
        chunks = specp[:, :, :pad_to].reshape(B, Fq, nc, chunk_len)
        chunks = chunks.permute(0, 2, 1, 3).reshape(B * nc, Fq, chunk_len)
        ks = torch.arange(nc, device=spec.device)
        cur = torch.clamp(length[:, None] - ks[None, :] * chunk_len, min=0)
        mark = torch.where(ks[None, :] == 0, cur > 0, cur > chunk_len // 2)
        emb = encoder.get_intermediate_layers(
            chunks, torch.clamp(cur.reshape(-1), max=chunk_len), n=n_blocks,
            scene=True).reshape(B, nc, -1)
        w = mark.to(emb.dtype)[:, :, None]
        return (emb * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0)

    return extract


def extract_split(extract_fn: Callable, loader,
                  timings: Optional[list] = None) -> tuple:
    """Run the extractor over a ``BatchLoader``; -> (embeddings, labels) as
    numpy arrays. ``timings``, when given, receives (clips, seconds) per
    batch: the time from the end of the previous batch (or the start) to
    this batch's embeddings on the host, loading included. Under a process
    group every rank reads every batch, extracts its rows of it (a ragged
    batch padded: extraction is row-independent) and receives all of
    them (``parallel.gather_rows``)."""
    embs, labels = [], []
    t0 = time.perf_counter()
    for batch in loader:
        e = gather_rows(lambda b: extract_fn(b["wav"], b["valid"]),
                        {"wav": batch["wav"], "valid": batch["valid"]})
        embs.append(e.cpu().numpy())  # waits for the device
        labels.append(np.asarray(batch["label"]))
        if timings is not None:
            t1 = time.perf_counter()
            timings.append((len(e), t1 - t0))
            t0 = t1
    return np.concatenate(embs), np.concatenate(labels)
