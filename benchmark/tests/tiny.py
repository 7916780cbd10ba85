"""Tiny versions of the benchmark's cells for the CPU tests: the published
configurations with the tiny encoder's widths, short clips and small
batches, run through the measured program's plain versions."""
from __future__ import annotations

import copy
import json

import run

# the data-parallel mix, which no cell runs yet: cell 1's configuration
# and limits with the four-card traffic
DDP = "frame_base.pretrain_bf16:pretrain_bf16_4chip"
CELLS = ("frame_base.pretrain_bf16", "clip_base.finetune_f32",
         "frame_base.embed_bf16", DDP)
TINY_ENCODER = dict(hidden_size=64, num_layers=2, num_heads=2,
                    intermediate_size=256)


def tiny_cell(workload: str, root=run.ROOT) -> dict:
    workload, _, traffic = workload.partition(":")
    c = copy.deepcopy(run.cell(workload, root))
    if traffic:
        c["traffic"] = json.loads((root / "benchmark" / "traffic"
                                   / f"{traffic}.json").read_text())
    cfg, tr = c["config"], c["traffic"]
    cfg.update(TINY_ENCODER)
    mix = tr["mix"]
    if mix in ("pretrain_step", "ddp_step"):
        cfg.update(arch="tiny", crop_s=1.0, crop_frames=101, pos_frames=101,
                   head_hidden=128, head_out=32, products="float32")
        tr.update(batch=4, pool=4)
        if mix == "ddp_step":
            tr.update(batch=2, ranks=4, rank_timeout_s=240)
    elif mix == "embed_calls":
        cfg.update(arch="tiny", serve_blocks=2)
        tr.update(batch=3, pool=2, clip_s=2.0)
    elif mix == "finetune_step":
        cfg.update(head_blocks=2, encoder="ast_tiny")
        tr.update(batch=4, pool=4, crop_s=2.0, clip_s=1.5)
        tr["recipe_flags"] = tr["recipe_flags"] + ["--n_last_blocks", "2",
                                                   "--arch", "tiny"]
    return c
