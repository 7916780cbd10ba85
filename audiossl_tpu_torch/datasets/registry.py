"""Dataset registry (the port's own copy of
``audiossl_tpu/datasets/registry.py``; reference
``audiossl/datasets/registry.py:4-53``): named datasets carry their creator
and the metadata downstream evaluation needs (multi_label, num_labels,
num_folds).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List


@dataclasses.dataclass
class DatasetInfo:
    name: str
    creator: Callable
    multi_label: bool = False
    num_labels: int = 0
    num_folds: int = 1


_REGISTRY: Dict[str, DatasetInfo] = {}


def register_dataset(name: str, multi_label: bool = False,
                     num_labels: int = 0, num_folds: int = 1):
    """Decorator: register ``creator(path, split[, fold]) -> dataset``."""

    def deco(creator):
        _REGISTRY[name] = DatasetInfo(
            name=name, creator=creator, multi_label=multi_label,
            num_labels=num_labels, num_folds=num_folds)
        return creator

    return deco


def get_dataset(name: str) -> DatasetInfo:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown dataset {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_all_datasets() -> List[str]:
    return sorted(_REGISTRY)
