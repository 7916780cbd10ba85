"""Each cell's mix at a tiny size on the CPU, through the measured
program's plain versions, down to the shape of the result line; a run
without a card; and a throwaway cell added with new files alone."""
import json
import shutil
import subprocess
import sys

import pytest
import torch

import run
from tiny import CELLS, DDP, tiny_cell

CPU = torch.device("cpu")
E2E = {"frame_base.pretrain_bf16": {"train_clips_per_s", "setup_s"},
       "clip_base.finetune_f32": {"train_clips_per_s", "setup_s"},
       "frame_base.embed_bf16": {"embed_clips_per_s", "embed_call_p95_ms",
                                 "setup_s"},
       DDP: {"train_clips_per_s", "setup_s"}}


@pytest.mark.parametrize("workload", CELLS)
def test_tiny_cell_is_correct_and_shaped(workload):
    c = tiny_cell(workload)
    out, metrics, correct, checks = run.execute(c, 2 ** 31 + 17, 0.3, False,
                                                CPU)
    assert correct, checks
    assert out.attempted > 0 and out.failed == 0
    assert set(metrics) == E2E[workload]
    line = run.result_line(out, metrics, correct, checks,
                           {"platform": "cpu rehearsal"})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["checks"]) == set(c["limits"])
    assert all(v["value"] <= v["limit"] for v in line["checks"].values())
    json.dumps(line)


def test_without_a_card_it_exits_nonzero_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    p = subprocess.run([sys.executable, str(run.BENCH / "run.py"),
                        "--workload", "frame_base.embed_bf16", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=run.ROOT,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_a_cell_added_by_files_alone(tmp_path):
    """A new traffic (with its own mix module), limits and per-layer metric are
    picked up by name from new files and new BENCHMARK.json entries."""
    shutil.copytree(run.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "benchmark"
    (b / "traffic" / "throwaway.json").write_text(json.dumps(
        {"mix": "throwaway", "calls": 5}))
    (b / "mixes" / "throwaway.py").write_text(
        "from harness.context import Outcome\n\n\n"
        "def run(ctx):\n"
        "    n = ctx.traffic['calls']\n"
        "    return Outcome(setup_s=0.5, attempted=n, failed=0,\n"
        "                   e2e={'throwaway_per_s': 2.0 * n},\n"
        "                   memory_peak_bytes=0, numbers={'gap': 0.0},\n"
        "                   unit_s=0.1)\n")
    (b / "limits" / "atst_frame_base.throwaway.json").write_text(
        json.dumps({"limits": {"gap": 0.1}}))
    (b / "metrics" / "throwaway_unit_ms.py").write_text(
        "def read(out):\n    return 1e3 * out.unit_s\n")
    spec["workloads"].append({"name": "atst_frame_base.throwaway",
                              "config": "atst_frame_base",
                              "traffic": "throwaway", "chips": 1,
                              "why": "a throwaway cell"})
    spec["end_to_end"].append({"name": "throwaway_per_s", "unit": "1/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["atst_frame_base.throwaway"]})
    spec["per_layer"].append({"name": "throwaway_unit_ms", "unit": "ms",
                              "better": "lower", "source": "host_clock",
                              "layer": "model step",
                              "moves": "throwaway_per_s",
                              "workloads": ["atst_frame_base.throwaway"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    c = run.cell("atst_frame_base.throwaway", tmp_path)
    _, metrics, correct, checks = run.execute(c, 3, 0.1, False, CPU)
    assert correct and metrics["throwaway_per_s"]["value"] == 10.0
    assert metrics["setup_s"]["value"] == 0.5
    _, metrics, _, _ = run.execute(c, 3, 0.1, True, CPU)
    assert metrics == {"throwaway_unit_ms": {"value": pytest.approx(100.0),
                                             "unit": "ms"}}
