"""audiossl_tpu_torch — the PyTorch / CUDA port of ``audiossl_tpu``.

The port runs on an NVIDIA Hopper GPU (H100). Plain tensor code is
PyTorch; every TPU (Pallas) kernel on a ported path is a hand-written
CUDA C++ kernel under ``csrc/``, built by ``kernels/build.py`` at first
CUDA use. The layout mirrors ``audiossl_tpu`` (``ops/``, ``models/``,
``compat/``, ``embedding.py``). The package imports neither JAX nor flax.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy top-level API, as in audiossl_tpu
    if name in ("load_model", "get_scene_embedding",
                "get_timestamp_embedding", "EmbeddingModel"):
        import audiossl_tpu_torch.embedding as _e

        return getattr(_e, name)
    raise AttributeError(name)
