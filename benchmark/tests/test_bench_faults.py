"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of the run driven at a tiny
size on the CPU with the committed limits, once for each fault the cell can
have. The sound run beside them comes out correct."""
import pytest
import torch

import run
from harness import faults
from tiny import DDP, tiny_cell

CASES = [("frame_base.pretrain_bf16", "unchanged"),
         ("frame_base.pretrain_bf16", "half_batch"),
         ("clip_base.finetune_f32", "unchanged"),
         ("clip_base.finetune_f32", "half_batch"),
         ("frame_base.embed_bf16", "altered"),
         ("frame_base.embed_bf16", "half_batch"),
         (DDP, "no_exchange"),
         (DDP, "half_batch")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_not_correct(workload, fault):
    c = tiny_cell(workload)
    # planted here, and by the mix in the processes it starts
    with faults.planted(c["traffic"]["mix"], fault):
        out, _, correct, checks = run.execute(c, 2 ** 31 + 5, 0.3, False,
                                              torch.device("cpu"),
                                              fault=fault)
    assert not correct, checks
    assert out.attempted > 0
