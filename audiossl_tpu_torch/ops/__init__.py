from audiossl_tpu_torch.ops.melspec import (
    MEL_MAX,
    MEL_MIN,
    MelConfig,
    hann_window,
    log_melspec,
    mel_filterbank,
    minmax_scale,
    power_spectrogram,
)

__all__ = [
    "MelConfig",
    "hann_window",
    "mel_filterbank",
    "power_spectrogram",
    "minmax_scale",
    "log_melspec",
    "MEL_MIN",
    "MEL_MAX",
]
