"""Plot helpers (PyTorch port of ``audiossl_tpu/utils/plot.py``; reference
``audiossl/utils/plot.py`` + ``methods/atstframe/plot_attention.py``).
matplotlib is imported only to write an image: the card's machine has
none, and :func:`plot_attention` returns its maps without it."""
from __future__ import annotations

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_spec(spec, path: str, title: str = ""):
    """Save a spectrogram heatmap [F, T] (an array or a tensor) to
    ``path``."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.imshow(_host(spec), origin="lower", aspect="auto",
              interpolation="nearest")
    ax.set_xlabel("frames")
    ax.set_ylabel("mel bins")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def plot_attention(encoder, mel, length=None, path: str = None) -> np.ndarray:
    """The last block's attention maps of each head (DINO-style, reference
    visualize_attention.py): ``encoder.get_last_selfattention(mel,
    length)`` without a gradient, as a [B, H, N, N] numpy array; with
    ``path``, also a grid image of the first clip's heads saved there."""
    import torch

    with torch.no_grad():
        attn = _host(encoder.get_last_selfattention(mel, length))
    if path is not None:
        plt = _pyplot()
        H = attn.shape[1]
        fig, axes = plt.subplots(1, H, figsize=(3 * H, 3), squeeze=False)
        for h in range(H):
            axes[0, h].imshow(attn[0, h], aspect="auto")
            axes[0, h].set_title(f"head {h}")
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return attn
