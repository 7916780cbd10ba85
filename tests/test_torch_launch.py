"""``parallel.launch.spawn`` starts its ranks on the card unless the
caller asks for the CPU, as every other entry point of the port does."""
import inspect

import pytest
import torch

from audiossl_tpu_torch.parallel import launch


def _noop():
    pass


def test_spawn_defaults_to_the_card():
    """The default device is ``"cuda"``: without a card, a rank started
    with it raises naming the missing card (on a card it runs)."""
    assert inspect.signature(launch.spawn).parameters["device"].default \
        == "cuda"
    if torch.cuda.is_available():
        launch.spawn(_noop, 1, timeout_s=120)
        return
    with pytest.raises(Exception, match="no CUDA device is available"):
        launch.spawn(_noop, 1, timeout_s=120)
