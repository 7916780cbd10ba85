"""Downstream evaluation (PyTorch port of ``audiossl_tpu/downstream/``):
frozen-encoder embedding extraction, the linear probe over cached
embeddings, its metrics and the ``train_freeze`` drivers.
"""
