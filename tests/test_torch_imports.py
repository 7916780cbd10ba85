"""The port stands without JAX (and its probe, finetuning, SED and
distillation slices and pretraining CLIs without pandas and PyYAML; its
comparison encoders, data modules and plots without matplotlib; its tools
without any of those or lmdb), the
orbax exporter lies outside it, and its kernel wrappers launch nothing
for a CPU tensor (they take their plain versions)."""
import subprocess
import sys
from pathlib import Path

import torch

from audiossl_tpu_torch.kernels import build as kb
from audiossl_tpu_torch.ops import block_infer, mel_db
from audiossl_tpu_torch.ops.quant import quantize_weight_q8

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'pandas',\n"
        "          'yaml'):\n"
        "    sys.modules[m] = None\n"
        "import audiossl_tpu_torch, audiossl_tpu_torch.embedding\n"
        "import audiossl_tpu_torch.ops, audiossl_tpu_torch.models\n"
        "import audiossl_tpu_torch.methods.atstframe.method\n"
        "import audiossl_tpu_torch.methods.atst.method\n"
        "import audiossl_tpu_torch.ops.mha, audiossl_tpu_torch.ops.layer_norm\n"
        "import audiossl_tpu_torch.ops.quant\n"
        "import audiossl_tpu_torch.compat.checkpoint\n"
        "import audiossl_tpu_torch.datasets\n"
        "import audiossl_tpu_torch.downstream.train_freeze\n"
        "import audiossl_tpu_torch.downstream.train_freeze_config\n"
        "import audiossl_tpu_torch.downstream.linear\n"
        "import audiossl_tpu_torch.downstream.embedding\n"
        "import audiossl_tpu_torch.training.checkpoint\n"
        "import audiossl_tpu_torch.training.runner\n"
        "import audiossl_tpu_torch.datasets.native\n"
        "import audiossl_tpu_torch.utils.common\n"
        "import audiossl_tpu_torch.methods.atstframe.train\n"
        "import audiossl_tpu_torch.methods.atst.train\n"
        "import audiossl_tpu_torch.methods.mae, audiossl_tpu_torch.methods.dual\n"
        "import audiossl_tpu_torch.methods.mae.method\n"
        "import audiossl_tpu_torch.methods.mae.train\n"
        "import audiossl_tpu_torch.methods.dual.method\n"
        "import audiossl_tpu_torch.methods.dual.train\n"
        "import audiossl_tpu_torch.models.heads\n"
        "import audiossl_tpu_torch.downstream.finetune\n"
        "import audiossl_tpu_torch.downstream.train_finetune\n"
        "import audiossl_tpu_torch.transforms.target\n"
        "import audiossl_tpu_torch.methods.distill.train\n"
        "import audiossl_tpu_torch.methods.distill.method\n"
        "import audiossl_tpu_torch.methods.distill.train_other\n"
        "import audiossl_tpu_torch.sed, audiossl_tpu_torch.sed.psds\n"
        "import audiossl_tpu_torch.sed.module\n"
        "import audiossl_tpu_torch.datasets.sed\n"
        "import audiossl_tpu_torch.downstream.comparison_models\n"
        "import audiossl_tpu_torch.downstream.train_dcase\n"
        "import audiossl_tpu_torch.downstream.train_as_strong\n"
        "import audiossl_tpu_torch.parallel\n"
        "import audiossl_tpu_torch.parallel.launch\n"
        "import audiossl_tpu_torch.parallel.dryrun\n"
        "import audiossl_tpu_torch.compat.vit, audiossl_tpu_torch.compat.beats\n"
        "import audiossl_tpu_torch.compat.audiomae\n"
        "import audiossl_tpu_torch.compat.ssast\n"
        "import audiossl_tpu_torch.compat.maeast\n"
        "import audiossl_tpu_torch.compat.m2d\n"
        "import audiossl_tpu_torch.compat.byola\n"
        "import audiossl_tpu_torch.compat.synthetic\n"
        "import audiossl_tpu_torch.datamodules\n"
        "import audiossl_tpu_torch.utils.plot\n"
        "from audiossl_tpu_torch.downstream.comparison_models import (\n"
        "    get_adapter, EnsembleModel, cal_norm)\n"
        "assert 'matplotlib' not in sys.modules\n"
        "from audiossl_tpu_torch import load_model, get_scene_embedding\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'audiossl_tpu']\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_orbax_exporter_is_outside_the_package():
    """Reading orbax needs JAX: the exporter is a script beside the
    packages, and no module of the port names orbax in an import."""
    assert (ROOT / "scripts" / "export_orbax_ckpt.py").is_file()
    pkg = ROOT / "audiossl_tpu_torch"
    assert not list(pkg.rglob("export_orbax*"))
    for path in pkg.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("orbax", "jax", "flax", "audiossl_tpu"), (
                    path, line)


def test_wrappers_on_cpu_launch_nothing():
    kb.reset_launches()
    g = torch.Generator().manual_seed(0)
    B, N, C, H = 2, 8, 32, 1
    x = torch.randn(B, N, C, generator=g)
    valid = torch.ones(B, N)
    ln_w, ln_b = torch.ones(C), torch.zeros(C)
    y = block_infer.attn_block_infer(
        x, valid, ln_w, ln_b, torch.randn(3 * C, C, generator=g) * 0.1, None,
        torch.randn(C, C, generator=g) * 0.1, torch.zeros(C), H)
    y = block_infer.mlp_block_infer(
        y, ln_w, ln_b, torch.randn(4 * C, C, generator=g) * 0.1,
        torch.zeros(4 * C), torch.randn(C, 4 * C, generator=g) * 0.1,
        torch.zeros(C))
    db = mel_db.stft_to_mel_db(torch.rand(B, 2 * 5, 7, generator=g),
                               torch.rand(5, 3, generator=g))
    assert y.shape == (B, N, C) and db.shape == (B, 3, 7)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(db).all())
    assert set(kb.LAUNCHES) >= {"mel_db", "attn_block", "mlp_block"}
    assert not any(kb.LAUNCHES.values()), kb.LAUNCHES


def test_q8_wrappers_on_cpu_launch_nothing():
    """K2q and K3q through their wrappers on CPU tensors: the plain
    versions, no launch."""
    kb.reset_launches()
    g = torch.Generator().manual_seed(1)
    B, N, C, H = 2, 8, 32, 2
    x = torch.randn(B, N, C, generator=g).to(torch.bfloat16)
    valid = torch.ones(B, N)
    ln_w, ln_b = torch.ones(C), torch.zeros(C)
    w = [torch.randn(*s, generator=g) * 0.1
         for s in ((3 * C, C), (C, C), (4 * C, C), (C, 4 * C))]
    y = block_infer.attn_block_infer_q8(
        x, valid, ln_w, ln_b, *quantize_weight_q8(w[0]), None,
        *quantize_weight_q8(w[1]), torch.zeros(C), H)
    y = block_infer.mlp_block_infer_q8(
        y, ln_w, ln_b, *quantize_weight_q8(w[2]), torch.zeros(4 * C),
        *quantize_weight_q8(w[3]), torch.zeros(C))
    assert y.shape == (B, N, C) and bool(torch.isfinite(y.float()).all())
    assert not any(kb.LAUNCHES.values()), kb.LAUNCHES


TOOLS = ("roofline", "profile_step", "kernel_microbench", "int8_drift",
         "probe_gain", "convergence_check", "calculate_min_max",
         "dataset2ards", "check_ards", "verify_released")


def test_tools_import_and_help_without_jax():
    """Every ``audiossl_tpu_torch.tools`` module imports, and its ``--help``
    runs as ``python -m`` runs it, with JAX, flax, optax, orbax, pandas,
    PyYAML, matplotlib and lmdb blocked; nothing of ``audiossl_tpu`` is
    imported."""
    code = (
        "import contextlib, io, runpy, sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'pandas',\n"
        "          'yaml', 'matplotlib', 'lmdb'):\n"
        "    sys.modules[m] = None\n"
        f"for name in {TOOLS!r}:\n"
        "    mod = 'audiossl_tpu_torch.tools.' + name\n"
        "    sys.argv = [mod, '--help']\n"
        "    out = io.StringIO()\n"
        "    try:\n"
        "        with contextlib.redirect_stdout(out):\n"
        "            runpy.run_module(mod, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (name, e.code)\n"
        "    else:\n"
        "        raise AssertionError(name + ': --help did not exit')\n"
        "    assert 'usage:' in out.getvalue() and '--device' in out.getvalue(), name\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'audiossl_tpu']\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr


def test_prep_tool_imports_and_help_without_pandas():
    """``audioset_strong_prep`` (no tensor, so no ``--device``) imports and
    its ``--help`` runs as ``python -m`` runs it, naming its three
    subcommands, with pandas and JAX blocked; it imports neither torch
    nor anything of ``audiossl_tpu``."""
    code = (
        "import contextlib, io, runpy, sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'pandas',\n"
        "          'yaml', 'matplotlib', 'lmdb'):\n"
        "    sys.modules[m] = None\n"
        "mod = 'audiossl_tpu_torch.tools.audioset_strong_prep'\n"
        "sys.argv = [mod, '--help']\n"
        "out = io.StringIO()\n"
        "try:\n"
        "    with contextlib.redirect_stdout(out):\n"
        "        runpy.run_module(mod, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "else:\n"
        "    raise AssertionError('--help did not exit')\n"
        "text = out.getvalue()\n"
        "assert 'usage:' in text, text\n"
        "assert all(c in text for c in ('gen_tsv', 'common', 'merge')), text\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('audiossl_tpu', 'torch')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
