"""``chip_smoke.py`` refuses to run, and prints no result, without the port
beside it or without a CUDA device: it exits 2 with its reason on stderr
and nothing on stdout (its last stdout line is the result a caller reads)."""
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _run(cwd, script):
    return subprocess.run([sys.executable, str(script)], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_alone_exits_without_a_result(tmp_path):
    """Copied into a directory that holds nothing else of the repository,
    the script stops before it touches the device, with its reason."""
    script = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", script)
    r = _run(tmp_path, script)
    assert r.returncode == 2, r.stderr
    assert r.stdout == ""
    assert "audiossl_tpu_torch package is not beside this script" in r.stderr
    assert "Traceback" not in r.stderr


def test_chip_smoke_without_a_card_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    r = _run(ROOT, ROOT / "chip_smoke.py")
    assert r.returncode == 2, r.stderr
    assert r.stdout == ""
    assert "no CUDA device" in r.stderr


def test_chip_ab_without_a_card_exits_without_running():
    """``chip_ab.py`` (same-card comparisons of chip_smoke.py's phases)
    stops before it imports a checkout when no CUDA device is present."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_ab.py would run")
    r = subprocess.run([sys.executable, str(ROOT / "chip_ab.py"), str(ROOT),
                        "here", "gemm"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 2, r.stderr
    assert r.stdout == ""
    assert "no CUDA device" in r.stderr
