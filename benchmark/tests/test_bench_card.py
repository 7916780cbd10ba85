"""On the card (skipped without one): a cell run end to end prints a correct
line; the control (the configuration's next lower precision) comes out not
correct at the cell's own size."""
import json
import subprocess
import sys

import pytest
import torch

import run

CELLS = ("frame_base.pretrain_bf16", "clip_base.finetune_f32",
         "frame_base.embed_bf16")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
def test_embed_cell_runs_on_the_card():
    _card()
    p = subprocess.run([sys.executable, str(run.BENCH / "run.py"),
                        "--workload", "frame_base.embed_bf16", "--seed",
                        "2147483999", "--seconds", "2", "--trace", "0"],
                       capture_output=True, text=True, cwd=run.ROOT,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    _card()
    c = run.cell(workload)
    if torch.cuda.device_count() < c["entry"]["chips"]:
        pytest.skip(f"needs {c['entry']['chips']} cards")
    _, _, correct, checks = run.execute(c, 2147483991, 1.0, False,
                                        torch.device("cuda", 0), control=True)
    assert not correct, checks
