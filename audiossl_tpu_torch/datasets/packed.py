"""Packed audio record store and reader (the port's own copy of
``audiossl_tpu/datasets/packed.py``; the same file format, byte for byte).

The reference stores audio as LMDB databases of pyarrow-serialized
``(waveform, label)`` tuples (reference ``datasets/lmdb.py:12-97``). This
store is a flat seekable pack:

* ``<split>.ards``      — magic + records back to back; each record is a
  fixed 24-byte header followed by the raw waveform payload and a label
  payload (serialized with numpy or JSON, not pickle).
* ``<split>.ards.idx``  — ``uint64[N+1]`` byte offsets (npy), so any
  record is one mmap slice.

``PackedAudioDataset`` reads a pack in the reference ``LMDBDataset``'s
order. ``write_synthetic_pack`` writes seeded synthetic packs for tests
and checks.
"""
from __future__ import annotations

import io
import json
import os
import struct
from typing import Optional

import numpy as np

MAGIC = b"ARDS0001"
_HEADER = struct.Struct("<IIBBHI8x")  # wav_bytes, label_bytes, dtype, ch, _, sr
_DTYPES = {0: np.int16, 1: np.float32}
_DTYPE_CODES = {np.dtype(np.int16): 0, np.dtype(np.float32): 1}


class PackedWriter:
    """Append-only writer for .ards packs."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._offsets = [len(MAGIC)]

    def add(self, waveform: np.ndarray, label, sample_rate: int = 16000):
        wav = np.ascontiguousarray(waveform)
        if wav.dtype not in _DTYPE_CODES:
            wav = wav.astype(np.float32)
        code = _DTYPE_CODES[wav.dtype]
        ch = 1 if wav.ndim == 1 else wav.shape[0]
        lab = _encode_label(label)
        self._f.write(_HEADER.pack(wav.nbytes, len(lab), code, ch, 0,
                                   sample_rate))
        self._f.write(wav.tobytes())
        self._f.write(lab)
        self._offsets.append(self._f.tell())

    def close(self):
        self._f.close()
        with open(self.path + ".idx", "wb") as f:
            np.save(f, np.asarray(self._offsets, np.uint64))

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def _encode_label(label) -> bytes:
    if isinstance(label, np.ndarray):
        buf = io.BytesIO()
        np.save(buf, label)
        return b"N" + buf.getvalue()
    return b"J" + json.dumps(label).encode()


def _decode_label(raw: bytes):
    if raw[:1] == b"N":
        return np.load(io.BytesIO(raw[1:]))
    return json.loads(raw[1:].decode())


class PackedReader:
    """mmap-backed random-access reader."""

    def __init__(self, path: str):
        self.path = path
        self.offsets = np.load(path + ".idx")
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        assert bytes(self._mm[: len(MAGIC)]) == MAGIC, f"bad magic in {path}"

    def __len__(self):
        return len(self.offsets) - 1

    def read(self, i: int):
        """-> (waveform float32 [n] scaled to [-1,1] for int16 input,
        label, sample_rate)."""
        lo = int(self.offsets[i])
        head = _HEADER.unpack(bytes(self._mm[lo: lo + _HEADER.size]))
        wav_bytes, label_bytes, code, ch, _, sr = head
        p = lo + _HEADER.size
        wav = np.frombuffer(self._mm[p: p + wav_bytes], dtype=_DTYPES[code])
        if code == 0:
            wav = wav.astype(np.float32) / 32768.0
        else:
            wav = np.asarray(wav, np.float32)
        if ch > 1:
            wav = wav.reshape(ch, -1).mean(axis=0)
        label = _decode_label(bytes(self._mm[p + wav_bytes:
                                             p + wav_bytes + label_bytes]))
        return wav, label, sr

    def num_samples(self, i: int) -> int:
        lo = int(self.offsets[i])
        wav_bytes, _, code, ch, _, _ = _HEADER.unpack(
            bytes(self._mm[lo: lo + _HEADER.size]))
        return wav_bytes // np.dtype(_DTYPES[code]).itemsize // max(ch, 1)

    def dtype_code(self, i: int) -> int:
        """Record i's stored sample dtype: 0=int16, 1=float32."""
        lo = int(self.offsets[i])
        return _HEADER.unpack(bytes(self._mm[lo: lo + _HEADER.size]))[2]

    def all_int16(self, probe: int = 256) -> bool:
        """True when every probed record stores int16 samples (the headers
        of up to ``probe`` evenly spaced records): the pretraining loaders
        then emit int16 batches, which the step scales by 1/32768 exactly
        as the float path does."""
        n = len(self)
        if n == 0:
            return False
        idx = np.unique(np.linspace(0, n - 1, min(probe, n)).astype(int))
        return all(self.dtype_code(int(i)) == 0 for i in idx)


class PackedAudioDataset:
    """Reference ``LMDBDataset`` equivalent over a .ards pack.

    The keys are the first ``subset`` entries of a permutation of the
    records drawn from ``RandomState(seed)`` (lmdb.py:33-38), so an epoch
    is ``subset`` records long."""

    def __init__(self, path: str, split: str = "train",
                 subset: Optional[int] = None, seed: int = 1234):
        self.reader = PackedReader(os.path.join(path, f"{split}.ards"))
        keys = np.random.RandomState(seed).permutation(len(self.reader))
        self.keys = keys if subset is None else keys[:subset]

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, i: int):
        wav, label, _ = self.reader.read(int(self.keys[i]))
        return wav, label


def _synth_wav(rng, ln: int, sr: int, kind: str) -> np.ndarray:
    """One synthetic waveform. kind="noise": white noise (cheap, used
    by most tests). kind="tones": AM-modulated harmonic stacks over a
    noise floor — real time-frequency structure for convergence
    checks (an SSL objective has nothing to learn from pure noise)."""
    if kind == "noise":
        return (rng.randn(ln) * 3000).astype(np.int16)
    t = np.arange(ln, dtype=np.float64) / sr
    sig = np.zeros(ln)
    f0 = rng.uniform(80.0, 800.0)
    for k in range(1, 4):
        sig += rng.uniform(0.2, 1.0) / k * np.sin(
            2 * np.pi * f0 * k * t + rng.uniform(0, 2 * np.pi))
    env = 0.5 * (1.0 + np.sin(2 * np.pi * rng.uniform(0.5, 8.0) * t
                              + rng.uniform(0, 2 * np.pi)))
    sig = sig * env + 0.05 * rng.randn(ln)
    sig *= 8000.0 / (np.abs(sig).max() + 1e-9)
    return sig.astype(np.int16)


def write_synthetic_pack(path: str, split: str, n: int, sr: int = 16000,
                         min_s: float = 1.0, max_s: float = 10.0,
                         num_labels: int = 10, multi_label: bool = False,
                         seed: int = 0, kind: str = "noise"):
    """Synthetic data generator used by tests and benchmarks."""
    rng = np.random.RandomState(seed)
    os.makedirs(path, exist_ok=True)
    with PackedWriter(os.path.join(path, f"{split}.ards")) as w:
        for _ in range(n):
            ln = int(rng.uniform(min_s, max_s) * sr)
            wav = _synth_wav(rng, ln, sr, kind)
            if multi_label:
                label = (rng.rand(num_labels) < 0.05).astype(np.float32)
            else:
                label = int(rng.randint(num_labels))
            w.add(wav, label, sr)
