"""The port's tools (``audiossl_tpu_torch.tools``) against the JAX
package's scripts (CPU).

* ``synth_class_audio``, ``synth_shape_audio`` and ``ridge_probe``
  bit-equal to ``scripts/int8_drift.py`` / ``probe_gain.py``'s, and the
  roofline's FLOP functions equal to ``scripts/roofline.py``'s at the same
  N (the port counts the logical tokens, JAX pads N to 128);
* ``convergence_check.build`` and ``probe_gain``'s configuration equal to
  JAX's field by field (``build``, and the configuration JAX's
  ``probe_gain`` builds on a TPU), the ``--tiny`` override included;
* ``probe_gain``'s pooled teacher frames at ``--tiny`` equal to JAX's
  ``enc.apply`` pooling on the bridged parameters (atol 1e-5, f32);
* each tool's ``main`` with ``--device cpu --tiny`` writing its JSON with
  JAX's keys (``convergence_check`` takes 20 steps: its pass criterion,
  JAX's, is a loss that fell); ``int8_drift`` on the bf16 route takes the
  int8 block kernels' route and drifts (rel L2 > 0); without ``--device``
  each tool raises here (no card);
* ``profile_step``'s grouping of kernel names (the port's GEMM template
  in the hand-written group, cuBLAS in the library's, the groups adding up
  to the total) and its records-kept averaging;
* the pack tools: ``dataset2ards synth`` and ``folder`` write the packs
  JAX's script writes, byte for byte; ``check_ards`` and
  ``calculate_min_max`` read them.
"""
import csv
import dataclasses
import importlib.util
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from audiossl_tpu.compat.torch_import import encoder_params_from_torch  # noqa: E402
from audiossl_tpu.models.atst import AudioTransformer as JAudioTransformer  # noqa: E402
from audiossl_tpu.ops.melspec import log_melspec as jlog_melspec  # noqa: E402
from audiossl_tpu_torch.ops import block_infer  # noqa: E402
from audiossl_tpu_torch.tools import (calculate_min_max, check_ards,  # noqa: E402
                                      convergence_check, dataset2ards,
                                      int8_drift, kernel_microbench,
                                      probe_gain, profile_step, roofline)

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"


def _script(name):
    """A JAX script under ``scripts/`` as a module (``probe_gain`` imports
    ``int8_drift`` by its bare name)."""
    if str(SCRIPTS) not in sys.path:
        sys.path.insert(0, str(SCRIPTS))
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------------ #
# numpy helpers and the roofline
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("k, n_classes, noise", [(0, 6, 0.05), (5, 6, 1.2),
                                                 (17, 24, 0.3)])
def test_synth_audio_and_probe_bit_equal(k, n_classes, noise):
    jd, jp = _script("int8_drift"), _script("probe_gain")
    for mine, theirs in ((int8_drift.synth_class_audio, jd.synth_class_audio),
                         (probe_gain.synth_shape_audio, jp.synth_shape_audio)):
        a = mine(np.random.RandomState(k), 3, 16000, 0.25, k, n_classes,
                 noise)
        b = theirs(np.random.RandomState(k), 3, 16000, 0.25, k, n_classes,
                   noise)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    rng = np.random.RandomState(k)
    f, lab = rng.randn(40, 9).astype(np.float32), rng.randint(4, size=40)
    assert (int8_drift.ridge_probe(f[:30], lab[:30], f[30:], lab[30:])
            == jd.ridge_probe(f[:30], lab[:30], f[30:], lab[30:]))


@pytest.mark.parametrize("B, N, C, depth", [(96, 250, 768, 12),
                                            (32, 150, 384, 12), (2, 7, 64, 2)])
def test_roofline_flops_equal_jax(B, N, C, depth):
    jr = _script("roofline")
    assert (roofline.encoder_flops_per_view(B, N, C, depth)
            == jr.encoder_flops_per_view(B, N, C, depth))
    for pred in (True, False):
        assert (roofline.head_flops_per_view(B, N, C, predictor=pred)
                == jr.head_flops_per_view(B, N, C, predictor=pred))


def test_roofline_main_counts_logical_tokens(capsys):
    r = roofline.main(["--device", "cpu"])
    assert r["N"] == 250 and r["B"] == 96  # 1001 frames // 4, unpadded
    enc = roofline.encoder_flops_per_view(96, 250, 768, 12)
    head = roofline.head_flops_per_view(96, 250, 768)
    assert r["student_s"] == pytest.approx(6 * (enc + head) / 989e12)
    assert "ceiling" in capsys.readouterr().out


# ------------------------------------------------------------------ #
# configurations
# ------------------------------------------------------------------ #
def _assert_config_equal(port, ref):
    """Every field JAX's configuration has, equal in the port's (the mel
    and optimizer configurations field by field); the port adds only the
    encoders' drop-path rate."""
    pf = {f.name for f in dataclasses.fields(port)}
    jf = {f.name for f in dataclasses.fields(ref)}
    assert pf - jf == {"drop_path_rate"} and jf <= pf
    for name in jf:
        a, b = getattr(port, name), getattr(ref, name)
        if dataclasses.is_dataclass(b):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), name
        else:
            assert a == b, name


def _assert_tiny_branches(method, jmethod):
    """The port's ``--tiny`` branches are JAX's override's."""
    for side in ("student", "teacher"):
        enc, jenc = getattr(method, side).encoder, getattr(jmethod,
                                                           side).encoder
        for attr in ("embed_dim", "depth", "num_heads", "spec_h", "spec_w",
                     "use_cls"):
            assert getattr(enc, attr) == getattr(jenc, attr), attr
        assert enc.dtype == torch.float32 and jenc.dtype == jnp.float32
        assert not (enc.fused_attention or enc.fused_infer)
        assert not jenc.fused_attention and not jenc.fused_infer
        head, jbranch = getattr(method, side).head, getattr(jmethod, side)
        assert head.projector.fc0.weight.shape[0] == jbranch.hidden_dim
        assert head.projector.fc1.weight.shape[0] == jbranch.out_dim
        assert (head.predictor is not None) == jbranch.predictor
    assert method.depth == 2


@pytest.mark.parametrize("tiny", [True, False])
@pytest.mark.parametrize("name", ["frame", "clip"])
def test_convergence_build_equals_jax(name, tiny):
    jc = _script("convergence_check")
    jmethod, jcfg, jkey = jc.build(name, tiny, "int8", "int8dx")
    _assert_config_equal(convergence_check.build_config(
        name, tiny, "int8", "int8dx"), jcfg)
    assert convergence_check.STD_KEYS[name][0] == jkey
    if not tiny:  # the small branches are drawn on the card alone
        return
    method, cfg, key = convergence_check.build(name, tiny, "int8", "int8dx",
                                               device="cpu")
    assert key == jkey
    _assert_config_equal(cfg, jcfg)
    _assert_tiny_branches(method, jmethod)


def _jax_probe_gain_config(args):
    """The configuration ``scripts/probe_gain.py`` builds on a TPU
    (``on_tpu`` True: bf16, fused attention), from the same arguments."""
    from audiossl_tpu.methods.atstframe.method import FramePretrainConfig
    from audiossl_tpu.training.pretrain import OptimizerConfig

    return FramePretrainConfig(
        arch="tiny" if args.tiny else "small",
        anchor_len=2.0 if args.tiny else 6.0,
        optimizer=OptimizerConfig(
            learning_rate=4e-4, warmup_steps=max(args.steps // 20, 10),
            max_steps=max(args.steps, 100), ema=0.99),
        dtype="bfloat16", fused_attention=True,
        teacher_quant=args.teacher_quant, student_quant=args.student_quant)


@pytest.mark.parametrize("argv", [["--tiny", "--steps", "40"],
                                  ["--steps", "2000", "--teacher-quant",
                                   "int8", "--student-quant", "int8"]])
def test_probe_gain_config_equals_jax(argv):
    args = probe_gain.build_parser().parse_args(argv)
    _assert_config_equal(probe_gain.build_config(args),
                         _jax_probe_gain_config(args))


def test_probe_gain_tiny_branches_and_pooling_equal_jax():
    """The tiny method's branches are JAX's override; its teacher's pooled
    frames equal JAX's ``enc.apply`` pooling on the bridged parameters."""
    jc = _script("convergence_check")
    args = probe_gain.build_parser().parse_args(["--tiny", "--device",
                                                 "cpu"])
    method = probe_gain.build_method(args, torch.device("cpu"))
    jmethod, _, _ = jc.build("frame", True)
    _assert_tiny_branches(method, jmethod)
    cfg = method.cfg
    enc = method.student.encoder
    rng = np.random.RandomState(3)
    wav = (rng.randn(5, int(cfg.anchor_len * cfg.sr)) * 0.1).astype(
        np.float32)
    got = int8_drift.pooled_frames(enc, wav, cfg, "cpu", bs=4)

    jenc = JAudioTransformer(embed_dim=32, depth=2, num_heads=2, spec_h=64,
                             spec_w=cfg.out_frames, use_cls=False)
    params = encoder_params_from_torch(
        {k: v.numpy() for k, v in enc.state_dict().items()})

    def fn(w):  # scripts/probe_gain.py's probe_acc
        mel = jlog_melspec(w, cfg=_jax_mel(cfg.mel))[:, :, :cfg.out_frames]
        ln = jnp.full((w.shape[0],), mel.shape[2], jnp.int32)
        frames, sel = jenc.apply({"params": params}, mel, ln,
                                 apply_mask=False, deterministic=True)
        selv = sel.astype(jnp.float32)[:, :, None]
        return (jnp.sum(frames.astype(jnp.float32) * selv, 1)
                / jnp.maximum(jnp.sum(selv, 1), 1.0))

    want = np.asarray(fn(jnp.asarray(wav)))
    assert got.shape == want.shape == (5, 32)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _jax_mel(cfg):
    from audiossl_tpu.ops.melspec import MelConfig

    return MelConfig(**dataclasses.asdict(cfg))


# ------------------------------------------------------------------ #
# each tool's main on the CPU
# ------------------------------------------------------------------ #
JAX_DRIFT_KEYS = {"cos_mean", "cos_p5", "cos_min", "rel_l2", "probe_acc_bf16",
                  "probe_acc_int8", "probe_acc_cross", "probe_delta",
                  "embed_cos_mean", "embed_cos_min"}


def test_int8_drift_main_takes_the_int8_route(tmp_path, monkeypatch):
    calls = {"q8": 0}
    q8 = block_infer.attn_block_infer_q8

    def counted(*a, **k):
        calls["q8"] += 1
        return q8(*a, **k)

    monkeypatch.setattr(block_infer, "attn_block_infer_q8", counted)
    r = int8_drift.main(["--device", "cpu", "--tiny", "--steps", "2",
                         "--batch", "4", "--classes", "3", "--per-class",
                         "4", "--out", str(tmp_path)])
    with open(tmp_path / "int8_drift.json") as f:
        saved = json.load(f)
    assert saved == json.loads(json.dumps(r))
    assert set(saved) == {"arch", "backend", "at_init", "after_steps"}
    assert set(saved["at_init"]) == JAX_DRIFT_KEYS
    assert set(saved["after_steps"]) == JAX_DRIFT_KEYS | {"steps"}
    assert saved["arch"] == "tiny" and saved["after_steps"]["steps"] == 2
    for part in ("at_init", "after_steps"):
        assert 0 < saved[part]["rel_l2"] < 0.1
        assert 0.99 < saved[part]["cos_mean"] <= 1.0
    # the int8 teacher's blocks ran K2q's wrapper (its plain version here):
    # two blocks a forward, for both drift and both probe measurements
    assert calls["q8"] >= 4 * 2


def test_probe_gain_main_writes_jax_keys(tmp_path):
    r = probe_gain.main(["--device", "cpu", "--tiny", "--steps", "3",
                         "--probe-every", "2", "--batch", "4", "--classes",
                         "3", "--per-class", "4", "--out", str(tmp_path)])
    with open(tmp_path / "probe_gain.json") as f:
        saved = json.load(f)
    assert set(saved) == {"arch", "steps", "batch", "classes", "noise",
                          "corpus", "teacher_quant", "student_quant",
                          "acc_init", "acc_final", "acc_gain", "wall_s",
                          "curve"}
    assert [c["step"] for c in saved["curve"]] == [0, 2, 3]
    assert all(0.0 <= c["acc"] <= 1.0 for c in saved["curve"])
    assert saved["acc_gain"] == r["acc_final"] - r["acc_init"]


def test_convergence_check_main_writes_jax_keys(tmp_path):
    out = convergence_check.main(["--device", "cpu", "--tiny", "--method",
                                  "frame", "--steps", "20", "--batch", "4",
                                  "--out", str(tmp_path)])
    with open(tmp_path / "frame_curve.json") as f:
        saved = json.load(f)
    assert set(saved) == {"method", "steps", "batch", "tiny",
                          "teacher_quant", "student_quant", "head_loss",
                          "tail_loss", "loss_drop",
                          "min_teacher_std_after_warmup", "wall_s", "loss",
                          "std_tea", "std_stu"}
    assert len(saved["loss"]) == 20 and np.isfinite(saved["loss"]).all()
    assert min(saved["std_tea"]) > 1e-3
    assert out["frame"][0]["tail_loss"] < out["frame"][0]["head_loss"]


def test_kernel_microbench_main(capsys):
    r = kernel_microbench.main(["--device", "cpu", "--tiny", "--iters", "1"])
    assert r["shape"] == [2, 16, 64, 2]
    assert 0 < r["int8_rel_err"]["mlp_mean"] < 2e-2
    assert "int8 rel err" in capsys.readouterr().out


def test_profile_step_main_on_cpu(tmp_path):
    r = profile_step.main(["--device", "cpu", "--tiny", "--batch", "2",
                           "--steps", "2", "--top", "5", "--keep",
                           str(tmp_path)])
    assert r["device_ms"] > 0
    assert sum(r["groups"].values()) == pytest.approx(r["device_ms"])
    assert (tmp_path / "trace.json").is_file()


@pytest.mark.parametrize("tool, argv", [
    (roofline, []), (profile_step, []), (kernel_microbench, []),
    (int8_drift, ["--steps", "0"]), (probe_gain, ["--steps", "0"]),
    (convergence_check, ["--steps", "1"]),
    (calculate_min_max, ["--data_path", "x"]), (check_ards, ["x.ards"]),
    (dataset2ards, ["synth", "--out", "x"])])
def test_tools_raise_without_a_card(tool, argv):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)


# ------------------------------------------------------------------ #
# profile_step's grouping
# ------------------------------------------------------------------ #
EVENTS = {
    "void gemm_bf16_kernel<OpBf16, true, true, EpiGelu>(CUtensorMap, "
    "CUtensorMap, float const*, int, int, int)": 4.0,
    "attn::attn_fwd_mma_kernel<__nv_bfloat16, 64>(int)": 1.5,
    "_ZN12_GLOBAL__N_116adamw_ema_kernelEPKN12_GLOBAL__N_14LeafEPKPKfii": 1.0,
    "mel_db_kernel(float const*, int const*, float*, int, int, int, int, "
    "int, int, float)": 0.25,
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256x64_warpgroup"
    "size2x1x1_execute_segment_k_off_kernel__5x_cublas": 3.0,
    "nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNT": 0.5,
    "Memcpy HtoD (Pageable -> Device)": 0.3,
    "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_"
    "impl_nocast<at::native::direct_copy_kernel_cuda(at::TensorIteratorBase"
    "&)::{lambda()#3}::operator()() const::{lambda()#7}::operator()() const"
    "::{lambda(float)#1}> >(int, at::native::gpu_kernel_impl_nocast<...>)":
        0.2,
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
    "at::native::func_wrapper_t<float, at::native::sum_functor<float, float,"
    " float>::operator()(at::TensorIterator&)::{lambda(float, float)#1}>, "
    "unsigned int, float, 4> >(at::native::ReduceOp<...>)": 0.4,
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, at::native::"
    "CUDAFunctor_add<float>, std::array<char*, 3ul>)": 0.6,
    "void at::native::(anonymous namespace)::GammaBetaBackwardCUDAKernel<"
    "float, float>(long, long, float const*, float const*, float const*, "
    "float const*, float*, float*)": 0.05,
}


def test_profile_step_groups_kernel_names():
    names = profile_step.source_kernel_names()
    assert {"gemm_bf16_kernel", "gemm_s8_kernel", "mel_db_kernel",
            "adamw_ema_kernel", "attn_fwd_mma_kernel",
            "ln_pg_bwd_kernel"} <= names
    g = {k: profile_step.group_of(k, names) for k in EVENTS}
    hand, lib = profile_step.HAND_WRITTEN, "library GEMMs (cuBLAS/cuDNN/CUTLASS)"
    keys = list(EVENTS)
    assert [g[k] for k in keys[:4]] == [hand] * 4  # the port's GEMM too
    assert g[keys[4]] == g[keys[5]] == lib
    assert g[keys[6]] == g[keys[7]] == "copies/layout"
    assert g[keys[8]] == "aten reductions"
    assert g[keys[9]] == "aten elementwise"
    assert g[keys[10]] == "op:GammaBetaBackwardCUDAKernel"
    grouped = profile_step.group_totals(EVENTS, names)
    assert sum(grouped.values()) == pytest.approx(sum(EVENTS.values()))
    assert grouped[hand] == pytest.approx(6.75)
    assert grouped[lib] == pytest.approx(3.5)


def test_profile_step_averages_over_kept_records():
    """A kernel launched once a step whose window kept 9 of 10 records
    counts its mean once a step; one launched 12 times a step with all
    records, 12 means."""
    ev = [types.SimpleNamespace(key="a", count=9,
                                self_device_time_total=900.0),
          types.SimpleNamespace(key="b", count=120,
                                self_device_time_total=2400.0),
          types.SimpleNamespace(key="c", count=5,
                                self_device_time_total=0.0)]
    prof = types.SimpleNamespace(key_averages=lambda: ev)
    totals, kept, expected = profile_step.device_op_totals(prof, 10)
    assert totals == {"a": pytest.approx(0.1), "b": pytest.approx(0.24)}
    assert (kept, expected) == (129, 130)


def test_kernel_identifier_reads_mangled_names():
    ident = profile_step.kernel_identifier
    assert ident("_Z13mel_db_kernelPKfPKiPfiiiiiif") == "mel_db_kernel"
    assert ident("_ZN4attnL19attn_fwd_mma_kernelI13__nv_bfloat16Li64EEEvPKT_"
                 ) == "attn_fwd_mma_kernel"
    assert ident("_ZL12ln_q8_kernelPK13__nv_bfloat16PKfS4_Pai") \
        == "ln_q8_kernel"


# ------------------------------------------------------------------ #
# the pack tools
# ------------------------------------------------------------------ #
def _write_wav(path, seconds, seed):
    from scipy.io import wavfile

    rng = np.random.RandomState(seed)
    wavfile.write(path, 16000, (rng.randn(int(16000 * seconds)) * 3000)
                  .astype(np.int16))


def test_dataset2ards_writes_jax_packs(tmp_path, capsys):
    jd = _script("dataset2ards")
    mine, theirs = tmp_path / "mine", tmp_path / "theirs"
    r = dataset2ards.main(["--device", "cpu", "synth", "--out", str(mine),
                           "--n", "6"])
    # scripts/dataset2ards.py's synth subcommand at its defaults
    jd.write_synthetic_pack(str(theirs), "train", 6, num_labels=527,
                            multi_label=False)
    assert r == {"train": 6}
    for name in ("train.ards", "train.ards.idx"):
        assert (mine / name).read_bytes() == (theirs / name).read_bytes()

    audio = tmp_path / "audio"
    audio.mkdir()
    rows = [("a.wav", "dog", "train"), ("b.wav", "cat", "val"),
            ("c.wav", "dog", "train"), ("d.wav", "bird", "val")]
    with open(tmp_path / "meta.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["file_name", "label", "split"])
        for i, row in enumerate(rows):
            _write_wav(audio / row[0], 0.2 + 0.1 * i, i)
            w.writerow(row)
    args = ["--audio_root", str(audio), "--csv", str(tmp_path / "meta.csv")]
    r = dataset2ards.main(["--device", "cpu", "folder", *args, "--out",
                           str(tmp_path / "f_mine")])
    jd.convert_folder(types.SimpleNamespace(
        audio_root=str(audio), csv=str(tmp_path / "meta.csv"),
        out=str(tmp_path / "f_theirs"), split_col="split", sr=16000))
    assert r == {"train": 2, "valid": 2}
    for name in ("train.ards", "valid.ards", "valid.ards.idx"):
        assert ((tmp_path / "f_mine" / name).read_bytes()
                == (tmp_path / "f_theirs" / name).read_bytes()), name

    got = check_ards.main(["--device", "cpu",
                           str(tmp_path / "f_mine" / "valid.ards")])
    assert got["records"] == 2 and got["head"][0]["sr"] == 16000
    lo_hi = calculate_min_max.main(["--device", "cpu", "--data_path",
                                    str(mine), "--max_items", "3"])
    assert np.isfinite([lo_hi["min"], lo_hi["max"]]).all()
    assert lo_hi["min"] < lo_hi["max"]
    capsys.readouterr()


def test_calculate_min_max_equals_jax(tmp_path, capsys):
    """The unnormalized dB range of a pack, the port's mel (K1's plain
    version here) against JAX's ``log_melspec(normalize=False)``."""
    from audiossl_tpu.datasets.packed import PackedAudioDataset as JPacked
    from audiossl_tpu.ops.melspec import MelConfig

    dataset2ards.main(["--device", "cpu", "synth", "--out", str(tmp_path),
                       "--n", "3"])
    got = calculate_min_max.main(["--device", "cpu", "--data_path",
                                  str(tmp_path)])
    ds = JPacked(str(tmp_path), "train")
    lo, hi = np.inf, -np.inf
    for i in range(len(ds)):
        db = np.asarray(jlog_melspec(jnp.asarray(ds[i][0][None]),
                                     cfg=MelConfig(), normalize=False))
        lo, hi = min(lo, float(db.min())), max(hi, float(db.max()))
    assert got["min"] == pytest.approx(lo, abs=1e-3)
    assert got["max"] == pytest.approx(hi, abs=1e-3)
    capsys.readouterr()
