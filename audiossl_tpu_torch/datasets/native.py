"""ctypes bindings for the native .ards batched reader (the port's own copy
of ``audiossl_tpu/datasets/native.py``).

The C++ reader (``audiossl_tpu_torch/native/ards_reader.cc``) assembles
whole padded batches off the GIL with a thread pool: the replacement for
the reference's per-sample Python LMDB decode inside DataLoader workers.
It is built with g++ at first use into ``build/`` at the repository root,
under a name that carries a hash of the source and flags, so an edited
source is rebuilt and a stale library never loaded. Without g++,
:func:`library` raises and the pretraining runner takes the Python
``BatchLoader`` instead (it prints which loader it took).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from audiossl_tpu_torch.datasets.pipeline import prefetched
from audiossl_tpu_torch.kernels.build import BUILD_DIR

SRC = Path(__file__).resolve().parent.parent / "native" / "ards_reader.cc"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def build() -> Path:
    """Compile the reader into ``build/libards_reader_<hash>.so`` unless it
    is there; returns its path. Raises RuntimeError without g++ or when
    the compiler fails."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    lib = BUILD_DIR / f"libards_reader_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native .ards reader is "
                           "built with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / lib.name
        r = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(out)],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"g++ failed on {SRC.name}:\n"
                               f"{r.stderr[:4000]}")
        os.replace(out, lib)  # atomic: concurrent builds agree
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built reader, loaded once per process."""
    lib = ctypes.CDLL(str(build()))
    lib.ards_open.restype = ctypes.c_void_p
    lib.ards_open.argtypes = [ctypes.c_char_p]
    lib.ards_len.restype = ctypes.c_long
    lib.ards_len.argtypes = [ctypes.c_void_p]
    lib.ards_num_samples.restype = ctypes.c_long
    lib.ards_num_samples.argtypes = [ctypes.c_void_p, ctypes.c_long]
    for name, dtype in (("ards_read_batch", np.float32),
                        ("ards_read_batch_i16", np.int16)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_long, ctypes.c_int,
            np.ctypeslib.ndpointer(dtype, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
    lib.ards_close.restype = None
    lib.ards_close.argtypes = [ctypes.c_void_p]
    return lib


class NativeReader:
    """Batched reader over one .ards pack."""

    def __init__(self, pack_path: str):
        self._lib = library()
        self._h = self._lib.ards_open(pack_path.encode())
        if not self._h:
            raise IOError(f"failed to open {pack_path}")

    def __len__(self):
        return int(self._lib.ards_len(self._h))

    def num_samples(self, i: int) -> int:
        if not 0 <= i < len(self):
            raise IndexError(f"record {i} of {len(self)}")
        return int(self._lib.ards_num_samples(self._h, i))

    def read_batch(self, indices, pad_samples: int, n_threads: int = 8,
                   dtype=np.float32):
        """-> (wav [n, pad_samples] float32 or int16, valid [n] int32).

        ``dtype=np.int16`` emits the 16-bit samples as stored (float32
        records are re-quantized): half the batch bytes, and the step's
        exact /32768 scale gives the float path's values bit for bit."""
        idx = np.ascontiguousarray(indices, np.int64)
        n = len(idx)
        dtype = np.dtype(dtype)
        if dtype not in (np.dtype(np.float32), np.dtype(np.int16)):
            raise ValueError(
                f"read_batch emits float32 or int16, not {dtype}")
        wav = np.empty((n, pad_samples), dtype)
        valid = np.empty((n,), np.int32)
        fn = (self._lib.ards_read_batch_i16 if dtype == np.int16
              else self._lib.ards_read_batch)
        rc = fn(self._h, idx, n, pad_samples, n_threads, wav, valid)
        if rc != 0:
            raise IOError(f"ards_read_batch failed with code {rc}")
        return wav, valid

    def close(self):
        if getattr(self, "_h", None):
            self._lib.ards_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


class NativeBatchLoader:
    """Pretraining loader over a ``PackedAudioDataset`` through the native
    reader: the batches of ``BatchLoader(include_labels=False)`` in
    shuffled order (the same keys, order and padding; labels omitted, the
    SSL step needs none).

    A worker thread reads ``pipeline.PREFETCH`` batches ahead (the C++ read
    releases the GIL, so assembly overlaps the device step)."""

    def __init__(self, dataset, batch_size: int, pad_samples: int,
                 seed: int = 0, epoch: int = 0, n_threads: int = 8,
                 wav_dtype=np.float32):
        self.keys = np.asarray(dataset.keys, np.int64)
        self.reader = NativeReader(dataset.reader.path)
        self.batch_size = batch_size
        self.pad_samples = pad_samples
        self.seed = seed
        self.epoch = epoch
        self.n_threads = n_threads
        self.wav_dtype = np.dtype(wav_dtype)

    def __len__(self):
        return len(self.keys) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.keys))
        np.random.RandomState(self.seed + self.epoch).shuffle(order)

        def produce():
            for b in range(len(self)):
                sel = self.keys[order[b * self.batch_size:
                                      (b + 1) * self.batch_size]]
                wav, valid = self.reader.read_batch(
                    sel, self.pad_samples, self.n_threads, self.wav_dtype)
                yield {"wav": wav, "valid": valid}

        return prefetched(produce)
