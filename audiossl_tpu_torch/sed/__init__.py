"""Sound event detection (PyTorch port of ``audiossl_tpu/sed/``; reference
``datasets/dcase_utils`` + ``downstream/utils_psds_eval`` +
``downstream/utils_dcase``): the ManyHotEncoder, decoding (median filter)
and intersection metrics on the scores' device, the strong/weak SED head,
and PSDS / event-F1 scoring on the host with numpy."""
from audiossl_tpu_torch.sed.encoder import ManyHotEncoder
from audiossl_tpu_torch.sed.decode import (
    median_filter_1d,
    decode_preds,
    preds_to_events,
)
from audiossl_tpu_torch.sed.metrics import intersection_stats, f1_from_stats
from audiossl_tpu_torch.sed.head import SEDHead

__all__ = [
    "ManyHotEncoder",
    "median_filter_1d",
    "decode_preds",
    "preds_to_events",
    "intersection_stats",
    "f1_from_stats",
    "SEDHead",
]
