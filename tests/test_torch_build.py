"""The port's kernel build and dispatch plumbing, without a GPU: nvcc is
replaced by a stand-in script, so the parallel compile, the link, the
log and the hashed library name are exercised here; the CUDA sources
themselves compile only on the card (``chip_smoke.py``)."""
import ctypes
import os
import re
import stat

import pytest
import torch

from audiossl_tpu_torch.kernels import build as kb
from audiossl_tpu_torch.ops import (adamw_ema, attn_train, block_infer,
                                    gelu, layer_norm, mel_db, mha, mlp_train)

FAKE_NVCC = """#!/bin/sh
# stand-in for nvcc: write the -o target, or fail when asked to
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
if [ -n "$FAKE_NVCC_FAIL" ]; then echo "error: $FAKE_NVCC_FAIL" >&2; exit 1; fi
echo "ptxas info    : Used 32 registers"
echo built > "$out"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{nvcc.parent}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(kb, "BUILD_DIR", tmp_path / "build")
    return tmp_path / "build"


def test_build_compiles_every_source_and_links_once(fake_nvcc):
    lib = kb.build()
    assert lib.parent == fake_nvcc and lib.read_text() == "built\n"
    digest = lib.name[len("libaudiossl_kernels_"):-len(".so")]
    log = (fake_nvcc / f"{digest}.log").read_text()
    n_sources = len(list(kb.CSRC.glob("*.cu")))
    assert n_sources == 10
    assert log.count("Used 32 registers") == n_sources + 1  # + the link
    assert kb.build() == lib  # an existing library is not rebuilt
    # objects were built in a temporary directory that is gone
    assert {p.name for p in fake_nvcc.iterdir()} == {lib.name,
                                                       f"{digest}.log"}


def test_build_failure_raises_with_compiler_output(fake_nvcc, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "expected a ';'")
    with pytest.raises(RuntimeError, match="expected a ';'"):
        kb.build()
    assert not list(fake_nvcc.glob("*.so"))


def test_library_name_follows_the_sources(tmp_path):
    a = tmp_path / "a.cu"
    a.write_text("// one")
    d1 = kb._digest([a])
    a.write_text("// two")
    assert kb._digest([a]) != d1


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(kb, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kb.build()


@pytest.mark.parametrize("name", sorted(kb._SIGNATURES))
def test_signatures_match_the_c_entry_points(name):
    """Each ctypes argument list matches its C declaration in csrc, one
    type per parameter (a pointer, an int or a float), so a launcher whose
    parameters changed (such as ``mel_db_launch``'s band table, group and
    pair counts) cannot be called with a stale list."""
    src = "\n".join(p.read_text() for p in sorted(kb.CSRC.glob("*.cu")))
    decl = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
    assert decl, f"{name} is declared in csrc"
    kinds = [ctypes.c_void_p if "*" in p else
             ctypes.c_float if p.split()[-2:-1] == ["float"] else ctypes.c_int
             for p in (q.strip() for q in decl.group(1).split(","))]
    assert kinds == kb._SIGNATURES[name]


@pytest.mark.parametrize("which", ["mel_db", "attn_block", "mlp_block",
                                   "attn_train_fwd", "attn_train_bwd",
                                   "mlp_train_fwd", "mlp_train_bwd",
                                   "adamw_ema", "mha_fwd", "mha_bwd",
                                   "ln_pg_bwd", "attn_block_q8",
                                   "mlp_block_q8", "attn_train_fwd_q8",
                                   "attn_train_bwd_q8dx", "mlp_train_fwd_q8",
                                   "mlp_train_bwd_q8dx", "gelu_fwd",
                                   "gelu_bwd"])
def test_wrappers_raise_for_a_tensor_off_the_cpu_and_cuda(which):
    """A tensor that is not on the CPU never takes the plain version: it
    reaches the kernel path, which refuses a non-CUDA device."""
    meta = torch.device("meta")
    bf, f32 = torch.bfloat16, torch.float32
    C = 64

    def t(*shape, dtype=f32):
        return torch.empty(*shape, device=meta, dtype=dtype)

    i8 = torch.int8

    kb.reset_launches()
    with pytest.raises(ValueError, match="CUDA device"):
        if which == "mel_db":
            mel_db.stft_to_mel_db(t(2, 10, 7), t(5, 3))
        elif which == "attn_block":
            block_infer.attn_block_infer(
                t(2, 8, C, dtype=bf), t(2, 8), t(C), t(C),
                t(3 * C, C, dtype=bf), None, t(C, C, dtype=bf), t(C), 2)
        elif which == "mlp_block":
            block_infer.mlp_block_infer(
                t(2, 8, C, dtype=bf), t(C), t(C), t(4 * C, C, dtype=bf),
                t(4 * C), t(C, 4 * C, dtype=bf), t(C))
        elif which == "attn_train_fwd":
            attn_train.attn_train_fwd(
                t(2, 8, C, dtype=bf), t(2, 8), t(2), t(C), t(C),
                t(3 * C, C), None, t(C, C), t(C), 2)
        elif which == "attn_train_bwd":
            attn_train.attn_train_bwd(
                t(2, 8, C, dtype=bf), t(2, 8, C, dtype=bf),
                t(2, 8, 3 * C, dtype=bf), t(2, 8, C, dtype=bf), t(2, 8, 2),
                t(2, 8), t(2), t(C), t(C), t(3 * C, C), t(C, C), 2)
        elif which == "mlp_train_fwd":
            mlp_train.mlp_train_fwd(
                t(2, 8, C, dtype=bf), t(2), t(C), t(C), t(4 * C, C),
                t(4 * C), t(C, 4 * C), t(C))
        elif which == "mlp_train_bwd":
            mlp_train.mlp_train_bwd(
                t(2, 8, C, dtype=bf), t(2, 8, C, dtype=bf),
                t(2, 8, 4 * C, dtype=bf), t(2), t(C), t(C), t(4 * C, C),
                t(C, 4 * C))
        elif which == "mha_fwd":
            mha.mha_fwd(t(2, 8, 3 * C), t(2, 8), 2, 0.125)
        elif which == "mha_bwd":
            mha.mha_bwd(t(2, 8, 3 * C), t(2, 8), t(2, 8, C), t(2, 8, 2),
                        t(2, 8, C), 2, 0.125)
        elif which == "ln_pg_bwd":
            layer_norm.ln_bwd(t(16, C), t(16, C), t(C), 1e-6)
        elif which == "gelu_fwd":
            gelu.gelu_fwd(t(2, 8, 4 * C))
        elif which == "gelu_bwd":
            gelu.gelu_bwd(t(2, 8, 4 * C), t(2, 8, 4 * C))
        elif which == "attn_block_q8":
            block_infer.attn_block_infer_q8(
                t(2, 8, C, dtype=bf), t(2, 8), t(C), t(C),
                t(3 * C, C, dtype=i8), t(3 * C), None, t(C, C, dtype=i8),
                t(C), t(C), 2)
        elif which == "mlp_block_q8":
            block_infer.mlp_block_infer_q8(
                t(2, 8, C, dtype=bf), t(C), t(C), t(4 * C, C, dtype=i8),
                t(4 * C), t(4 * C), t(C, 4 * C, dtype=i8), t(C), t(C))
        elif which == "attn_train_fwd_q8":
            attn_train.attn_train_fwd_q8(
                t(2, 8, C, dtype=bf), t(2, 8), t(2), t(C), t(C),
                t(3 * C, C, dtype=i8), t(3 * C), None, t(C, C, dtype=i8),
                t(C), t(C), 2)
        elif which == "attn_train_bwd_q8dx":
            attn_train.attn_train_bwd_q8dx(
                t(2, 8, C, dtype=bf), t(2, 8, C, dtype=bf),
                t(2, 8, 3 * C, dtype=bf), t(2, 8, C, dtype=bf), t(2, 8, 2),
                t(2, 8), t(2), t(C), t(C), t(3 * C, C, dtype=i8), t(C),
                t(C, C, dtype=i8), t(C), 2)
        elif which == "mlp_train_fwd_q8":
            mlp_train.mlp_train_fwd_q8(
                t(2, 8, C, dtype=bf), t(2), t(C), t(C), t(4 * C, C, dtype=i8),
                t(4 * C), t(4 * C), t(C, 4 * C, dtype=i8), t(C), t(C))
        elif which == "mlp_train_bwd_q8dx":
            mlp_train.mlp_train_bwd_q8dx(
                t(2, 8, C, dtype=bf), t(2, 8, C, dtype=bf),
                t(2, 8, 4 * C, dtype=bf), t(2), t(C), t(C),
                t(4 * C, C, dtype=i8), t(C), t(C, 4 * C, dtype=i8), t(4 * C))
        else:
            adamw_ema.adamw_ema(
                [t(C, C)], [t(C, C)], [t(C, C)], [t(C, C)], [None], [True],
                adamw_ema.update_scalars(1e-3, 0.04, 0.99, 1, 0.9, 0.999,
                                         1e-6), adamw_ema.LeafTable())
    assert kb.LAUNCHES[which] == 0
