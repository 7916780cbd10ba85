"""Build the hand-written CUDA kernels with nvcc and bind them by ctypes.

All ``csrc/*.cu`` files compile for Hopper (``sm_90a``) into one shared
library with a plain C interface, at the first CUDA call, into
``build/`` at the repository root. The library's name carries a hash of
the sources and flags, so an edited source is rebuilt and a stale
library is never loaded. Each C entry point takes the device index, raw
device pointers and the CUDA stream, and returns ``cudaGetLastError()``.

``LAUNCHES`` counts the kernel launches of each wrapper; a wrapper adds
one only where it launched its kernel, so a run can show that its main
path went through the kernels. It lists the counterparts of the TPU
kernels and the module route's GELU (``gelu_fwd``, ``gelu_bwd``:
``ops/gelu.py``, which replaces no TPU kernel): ``gemm_bf16`` and
``gemm_s8`` (the block kernels' GEMM templates alone) and ``rcp_check``
(``ops/gemm.py``) launch through :func:`call` and are not counted.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"mel_db": 0, "attn_block": 0, "mlp_block": 0,
            "attn_train_fwd": 0, "attn_train_bwd": 0,
            "mlp_train_fwd": 0, "mlp_train_bwd": 0, "adamw_ema": 0,
            "mha_fwd": 0, "mha_bwd": 0, "ln_pg_bwd": 0,
            "attn_block_q8": 0, "mlp_block_q8": 0, "attn_train_fwd_q8": 0,
            "attn_train_bwd_q8dx": 0, "mlp_train_fwd_q8": 0,
            "mlp_train_bwd_q8dx": 0, "gelu_fwd": 0, "gelu_bwd": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # every entry point starts with the device index and ends with the
    # stream; the kernel library links its own CUDA runtime, whose current
    # device is set from the first argument.
    # stft, band table, out, B, F, T, n_mels, n_groups, n_pairs, amin
    "mel_db_launch": [_I, _P, _P, _P] + [_I] * 6 + [_F, _P],
    # x, valid_k, valid_v, dp, ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj,
    # out, h, qkv, o, B, N, C, H, scale, eps
    "attn_block_launch": [_I] + [_P] * 14 + [_I, _I, _I, _I, _F, _F, _P],
    # x, dp, ln_w, ln_b, w1, b1, w2, b2, out, h, u, B, N, C, Hd, eps
    "mlp_block_launch": [_I] + [_P] * 11 + [_I, _I, _I, _I, _F, _P],
    # as attn_block, then r; B, N, C, H, scale, eps
    "attn_train_fwd_launch": [_I] + [_P] * 15 + [_I, _I, _I, _I, _F, _F, _P],
    # x, dy, qkv, o, r, valid_k, dp, ln_w, ln_b, w_qkv, w_proj, dx, dw_qkv,
    # db_qkv, dw_proj, db_proj, dls, dlb, h, dyb, dor, dqkv, d_f32, nd,
    # B, N, C, H, scale, eps
    "attn_train_bwd_launch": [_I] + [_P] * 24 + [_I, _I, _I, _I, _F, _F, _P],
    # x, dp, ln_w, ln_b, w1, b1, w2, b2, out, h, u, a, B, N, C, Hd, eps
    "mlp_train_fwd_launch": [_I] + [_P] * 12 + [_I, _I, _I, _I, _F, _P],
    # x, dy, u, dp, ln_w, ln_b, w1, w2, dx, dw1, db1, dw2, db2, dls, dlb,
    # h, dyb, a, du, dh, B, N, C, Hd, eps
    "mlp_train_bwd_launch": [_I] + [_P] * 20 + [_I, _I, _I, _I, _F, _P],
    # table, grads, n_leaves, n_chunks, lr, wd, m, 1-m, rc1, rc2, b1, 1-b1,
    # b2, 1-b2, eps
    "adamw_ema_launch": [_I, _P, _P, _I, _I] + [_F] * 11 + [_P],
    # qkv, valid, out, r, dtype, B, N, C, H, scale
    "mha_fwd_launch": [_I] + [_P] * 4 + [_I] * 5 + [_F, _P],
    # qkv, valid, out, r, d_out, dqkv, dor, nd, dtype, B, N, C, H, scale
    "mha_bwd_launch": [_I] + [_P] * 8 + [_I] * 5 + [_F, _P],
    # x, dy, scale, dx, partial, dsb, blocks, dtype, R, C, eps
    "ln_pg_bwd_launch": [_I] + [_P] * 6 + [_I] * 4 + [_F, _P],
    # x, valid_k, valid_v, dp, ln_w, ln_b, wq_qkv, s_qkv, b_qkv, wq_proj,
    # s_proj, b_proj, out, hq, hr, qkv, o, oq, or; B, N, C, H, scale, eps
    "attn_block_q8_launch": [_I] + [_P] * 19 + [_I, _I, _I, _I, _F, _F, _P],
    # x, dp, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, out, hq, hr, u, aq, ar;
    # B, N, C, Hd, eps
    "mlp_block_q8_launch": [_I] + [_P] * 16 + [_I, _I, _I, _I, _F, _P],
    # as attn_block_q8 with r before oq; B, N, C, H, scale, eps
    "attn_train_fwd_q8_launch": [_I] + [_P] * 20
    + [_I, _I, _I, _I, _F, _F, _P],
    # x, dy, qkv, o, r, valid_k, dp, ln_w, ln_b, wt_qkv, st_qkv, wt_proj,
    # st_proj, dx, dw_qkv, db_qkv, dw_proj, db_proj, dls, dlb, h, dyb, dor,
    # dqkv, d_f32, nd, aq, ar; B, N, C, H, scale, eps
    "attn_train_bwd_q8dx_launch": [_I] + [_P] * 28
    + [_I, _I, _I, _I, _F, _F, _P],
    # x, dp, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, out, hq, hr, u, uf, aq, ar;
    # B, N, C, Hd, eps
    "mlp_train_fwd_q8_launch": [_I] + [_P] * 17 + [_I, _I, _I, _I, _F, _P],
    # x, dy, u, dp, ln_w, ln_b, wt1, st1, wt2, st2, dx, dw1, db1, dw2, db2,
    # dls, dlb, h, dyb, a, du, duf, dh, aq, ar; B, N, C, Hd, eps
    "mlp_train_bwd_q8dx_launch": [_I] + [_P] * 25 + [_I, _I, _I, _I, _F, _P],
    # u, y, n, dtype
    "gelu_fwd_launch": [_I, _P, _P, _I, _I, _P],
    # u, dy, du, n, dtype
    "gelu_bwd_launch": [_I, _P, _P, _P, _I, _I, _P],
    # a, b, out, bias; M, N, K, layout, epilogue, splits
    "gemm_bf16_launch": [_I] + [_P] * 4 + [_I] * 6 + [_P],
    # a, b, ra, sb, out, bias; M, N, K, epilogue
    "gemm_s8_launch": [_I] + [_P] * 6 + [_I] * 4 + [_P],
    # mismatches (one zeroed int64)
    "rcp_check_launch": [_I, _P, _P],
}

# the element-type codes of the kernels templated on it
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc (set CUDA_HOME)")
    return path


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` (in parallel, one nvcc per file) and link them
    into ``build/libaudiossl_kernels_<hash>.so``; returns its path. The
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside it in ``<hash>.log``."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = _digest(sorted(CSRC.glob("*.cu*")))
    lib = BUILD_DIR / f"libaudiossl_kernels_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
             str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(link.stdout)
        (BUILD_DIR / f"{digest}.log").write_text("\n".join(logs))
        failed = [(s.name, log) for s, p, log in zip(sources, procs, logs)
                  if p.returncode]
        if failed or link.returncode:
            # the failed files' output first: the others' ptxas reports
            # would push the errors out of the message
            raise RuntimeError(
                f"nvcc failed ({[n for n, _ in failed] or 'link'}):\n"
                + "\n".join(log for _, log in failed or [("", logs[-1])]
                             )[:8000])
        os.replace(tmp_lib, lib)  # atomic: concurrent builds agree
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.audiossl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.audiossl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device when
    PyTorch sees no card (the port's entry points run on the card unless
    the caller passes ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def call(name: str, device: torch.device, *args) -> None:
    """Call the C entry point ``<name>_launch`` on ``device`` and PyTorch's
    current stream there; raises when the launch was refused or faulted."""
    lib = library()
    s = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    err = getattr(lib, f"{name}_launch")(device.index or 0, *args, s)
    if err:
        msg = lib.audiossl_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {msg} ({err})")


def launch(name: str, device: torch.device, *args) -> None:
    """:func:`call`, and count the launch in ``LAUNCHES``."""
    call(name, device, *args)
    LAUNCHES[name] += 1


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Checks a kernel wrapper makes before it launches: every tensor on
    the same CUDA device, contiguous and 16-byte aligned (the kernels
    load 16 bytes at a time)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} "
                             "is not contiguous and 16-byte aligned")
