"""Host audio IO: wav loading and resampling without torchaudio (the
port's own copy of ``audiossl_tpu/datasets/audio_io.py``).

The reference reads audio with torchaudio inside its dataset classes; here
WAV files are read with scipy and resampled with polyphase filtering.
"""
from __future__ import annotations

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def load_wav(path: str, target_sr: int = 16000) -> np.ndarray:
    """-> mono float32 waveform at target_sr, range [-1, 1]."""
    sr, data = wavfile.read(path, mmap=True)
    if data.dtype == np.int16:
        wav = np.asarray(data, np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = np.asarray(data, np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (np.asarray(data, np.float32) - 128.0) / 128.0
    else:
        wav = np.asarray(data, np.float32)
    if wav.ndim == 2:
        wav = wav.mean(axis=1)
    if sr != target_sr:
        g = np.gcd(int(sr), int(target_sr))
        wav = resample_poly(wav, target_sr // g, sr // g).astype(np.float32)
    return np.ascontiguousarray(wav, np.float32)
