"""The port's MAE and dual pretraining CLIs (``python -m
audiossl_tpu_torch.methods.mae.train`` and ``...methods.dual.train``) and
their steps on 2 ranks, on the CPU.

Each parser has JAX's flags plus ``--device``, and builds JAX's config
from the same arguments; ``main`` runs each CLI at tiny width with the
flags of JAX's ``tests/test_cli.py:76-110`` on a synthetic pack, writes a
checkpoint, and a second run resumes from it, takes no step, and holds
the saved state tensor for tensor. 2 gloo ranks, spawned once for the
file, run a step of each method against one process on the global batch
with the same draws (loss rel 1e-6, every metric and the updated values
rel 1e-5, both ranks bit-equal), then each CLI's ``main`` at
``--n_devices 2`` (it joins their group), which ends within rel L2 1e-4
of one process at ``--n_devices 1`` on the global batch. (The CLIs
starting their own ranks is ``launch.run_cli``'s, held by
``test_torch_pretrain_cli.py``.) The JAX modules are imported inside the
tests that read them, so the spawned ranks do not import JAX.
``torch.utils.tensorboard`` is kept from importing (it loads TensorFlow
when that is installed).
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from audiossl_tpu_torch.datasets import write_synthetic_pack
from audiossl_tpu_torch.methods.dual import method as tdm
from audiossl_tpu_torch.methods.dual import train as tdual
from audiossl_tpu_torch.methods.mae import method as tmm
from audiossl_tpu_torch.methods.mae import train as tmae
from audiossl_tpu_torch.parallel import launch
from audiossl_tpu_torch.parallel.mesh import local_rows, world
from audiossl_tpu_torch.training import checkpoint as tck
from audiossl_tpu_torch.training import pretrain as tpt

CLIS = {"mae": tmae, "dual": tdual}
# JAX's tests/test_cli.py:76-110, less the paths
FLAGS = {
    "mae": ["--batch_size_per_device", "2", "--max_steps", "2",
            "--warmup_steps", "1", "--anchor_len", "0.5",
            "--embed_dim", "32", "--depth", "2", "--num_heads", "2",
            "--dec_embed_dim", "32", "--dec_depth", "1",
            "--dec_num_heads", "2", "--clip_len", "1.0", "--subset", "16",
            "--ckpt_interval", "2"],
    "dual": ["--arch", "tiny", "--batch_size_per_device", "2",
             "--max_steps", "2", "--warmup_steps", "1",
             "--anchor_len", "0.5", "--expander_dim", "64",
             "--out_dim", "16", "--clip_len", "1.0", "--subset", "16",
             "--ckpt_interval", "2"]}
N_RANKS, B = 2, 4
OPT = dict(learning_rate=5e-4, warmup_steps=0, max_steps=1000)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("pack"))
    write_synthetic_pack(data, "train", 16, min_s=0.6, max_s=1.0, seed=1)
    return data


def _jax_cli(which):
    pytest.importorskip("jax")
    if which == "mae":
        from audiossl_tpu.methods.mae import train as jmod
    else:
        from audiossl_tpu.methods.dual import train as jmod
    return jmod


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("which", sorted(CLIS))
def test_parser_has_jax_flags_and_device(which):
    jmod, tmod = _jax_cli(which), CLIS[which]
    want, got = _actions(jmod.build_parser()), _actions(tmod.build_parser())
    assert set(got) == set(want) | {"device"}
    assert got["device"].default == "cuda"
    for dest, w in want.items():
        g = got[dest]
        for attr in ("option_strings", "default", "choices", "nargs",
                     "required", "const", "type"):
            assert getattr(g, attr) == getattr(w, attr), (dest, attr)


ARGVS = {"mae": [[], FLAGS["mae"], ["--mask_ratio", "0.5",
                                    "--batch_size_per_device", "96",
                                    "--learning_rate", "1e-3"]],
         "dual": [["--anchor_len", "6.4"], FLAGS["dual"],
                  ["--anchor_len", "6.4", "--dtype", "bfloat16",
                   "--mask_len", "3", "--mask_ratio", "0.5",
                   "--batch_size_per_device", "96"]]}


@pytest.mark.parametrize("which, i", [(w, i) for w in sorted(ARGVS)
                                      for i in range(len(ARGVS[w]))])
def test_config_equals_jax(which, i, monkeypatch):
    """The config JAX's ``main`` builds (its dataset and run loop stubbed,
    one device) equals the port's field by field."""
    jmod, tmod = _jax_cli(which), CLIS[which]
    argv = ARGVS[which][i]
    seen = {}
    monkeypatch.setattr(jmod, "PackedAudioDataset", lambda *a, **k: None)
    monkeypatch.setattr(jmod, "run_pretraining",
                        lambda method, *a, **k: seen.setdefault("m", method))
    jmod.main(["--data_path", "unused", "--n_devices", "1", *argv])
    args = tmod.build_parser().parse_args(["--data_path", "unused", *argv])
    got, want = tmod.build_config(args), seen["m"].cfg
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.out_samples == want.out_samples
    assert got.optimizer.learning_rate == (
        args.learning_rate * args.batch_size_per_device / 256.0)


def test_dual_cli_refuses_the_frame_count_before_reading_data(tmp_path):
    """JAX's default 6.0 s: a ValueError naming the rule, though the data
    path does not exist."""
    with pytest.raises(ValueError, match=r"T mod 16 must be below 4"):
        tdual.main(["--data_path", str(tmp_path / "absent"), "--device",
                    "cpu", "--arch", "tiny"])


@pytest.mark.parametrize("which", sorted(CLIS))
def test_cli_without_a_card_raises(which, pack):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device runs")
    argv = ["--data_path", pack, *FLAGS[which]]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLIS[which].main(argv)


def _state_tensors(state):
    out = {f"student.{k}": v for k, v in state.student.state_dict().items()}
    out.update({f"mu.{k}": v for k, v in state.mu.items()})
    out.update({f"nu.{k}": v for k, v in state.nu.items()})
    out["generator"] = state.generator.get_state()
    return out


@pytest.mark.parametrize("which", sorted(CLIS))
def test_main_checkpoints_and_resumes(which, pack, tmp_path, capsys):
    """JAX's CLI test flags: 2 steps, a checkpoint at step 2; run again it
    resumes there, takes no step, and its state is the saved one tensor
    for tensor (no teacher saved)."""
    tmod = CLIS[which]
    save = str(tmp_path / "exp")
    argv = ["--data_path", pack, "--save_path", save, "--device", "cpu",
            *FLAGS[which]]
    state = tmod.main(argv)
    out = capsys.readouterr().out
    assert state.step == state.count == 2 and state.teacher is None
    assert "loader: native" in out and "run ended at step 2" in out
    assert sorted(os.listdir(os.path.join(save, "ckpt"))) == ["2"]
    saved = torch.load(os.path.join(save, "ckpt", "2", "state.pt"),
                       weights_only=True)
    assert saved["teacher"] is None and saved["step"] == 2
    first = {k: v.clone() for k, v in _state_tensors(state).items()}
    again = tmod.main(argv)
    out = capsys.readouterr().out
    assert "resumed from step 2\n" in out
    assert "run ended at step 2: 0 steps taken" in out
    got = _state_tensors(again)
    assert got.keys() == first.keys()
    unequal = [k for k in got if not torch.equal(got[k], first[k])]
    assert not unequal, unequal
    assert all(bool(torch.isfinite(v).all()) for v in saved["mu"].values())


def _rel(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _no_batch_flag(which):
    flags = list(FLAGS[which])
    i = flags.index("--batch_size_per_device")
    del flags[i:i + 2]
    return flags


def _cli_argv(which, pack, save, n, bs):
    return ["--data_path", pack, "--save_path", save, "--device", "cpu",
            "--n_devices", str(n), "--batch_size_per_device", str(bs),
            *_no_batch_flag(which)]


@pytest.mark.parametrize("which", sorted(CLIS))
def test_two_ranks_end_as_one_process(which, ranks, pack, tmp_path):
    """``main`` with ``--n_devices 2`` on the 2 gloo ranks (2 clips a
    rank) against ``--n_devices 1`` at 4 clips in this process: the same
    global batches, draws and learning rate; rank 0 alone prints and
    writes; the saved parameters and moments after 2 steps within rel L2
    1e-4."""
    save = str(tmp_path / "one")
    CLIS[which].main(_cli_argv(which, pack, save, 1, 4))
    one = torch.load(os.path.join(save, "ckpt", "2", "state.pt"),
                     weights_only=True)
    two = torch.load(os.path.join(ranks["workdir"], which, "ckpt", "2",
                                  "state.pt"), weights_only=True)
    log = ranks["logs"][which]
    assert "(rank 0 of 2), 4 batches of 4 an epoch" in log
    assert log.count("run ended at step 2: 2 steps taken") == 1
    assert one["step"] == two["step"] == 2 and two["teacher"] is None
    for group in ("student", "mu", "nu"):
        assert one[group].keys() == two[group].keys()
        flat = [torch.cat([r[group][k].double().flatten()
                           for k in sorted(one[group])])
                for r in (two, one)]
        assert _rel(*flat) < 1e-4, group


def _method(which):
    opt = tpt.OptimizerConfig(**OPT)
    if which == "mae":
        return tmm.MAEMethod(tmm.MAEConfig(
            anchor_len=0.5, embed_dim=32, depth=2, num_heads=2,
            dec_embed_dim=32, dec_depth=1, dec_num_heads=2, optimizer=opt),
            device="cpu", seed=3)
    return tdm.DualMethod(tdm.DualConfig(
        arch="tiny", anchor_len=0.5, expander_dim=64, out_dim=16,
        optimizer=opt), device="cpu", seed=3)


def _inputs():
    rng = np.random.RandomState(11)
    wav = torch.from_numpy((rng.randn(B, 12000) * 0.1).astype(np.float32))
    valid = torch.tensor([12000, 9000, 12000, 7000])
    out = {}
    for which in ("mae", "dual"):
        method = _method(which)
        draws = method.draw(torch.Generator().manual_seed(16), B)
        out[which] = dict(batch={"wav": wav, "valid": valid}, draws=draws)
    return out


def _step(which, inputs, rows):
    method = _method(which)
    state = method.init_state(0)
    batch = {k: v[rows] for k, v in inputs[which]["batch"].items()}
    out = method.make_step()(state, batch, inputs[which]["draws"])
    return dict(metrics={k: float(v) for k, v in out.items()},
                student={k: v.detach().clone() for k, v in
                         state.student.state_dict().items()},
                mu={k: v.clone() for k, v in state.mu.items()},
                nu={k: v.clone() for k, v in state.nu.items()})


def _ranks(workdir, pack):
    """On each rank: one step of each method on its rows of the global
    batch, then each CLI's ``main`` at ``--n_devices 2`` (it joins this
    group), rank 0's lines to ``<which>.log``."""
    import contextlib

    sys.modules["torch.utils.tensorboard"] = None
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    res = {w: _step(w, inputs, local_rows(B)) for w in ("mae", "dual")}
    torch.save(res, os.path.join(workdir, f"rank{world().rank}.pt"))
    for which, tmod in CLIS.items():
        log = os.path.join(workdir, f"{which}_rank{world().rank}.log")
        with open(log, "w") as f, contextlib.redirect_stdout(f):
            tmod.main(_cli_argv(which, pack, os.path.join(workdir, which),
                                N_RANKS, B // N_RANKS))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, pack):
    workdir = str(tmp_path_factory.mktemp("ranks"))
    inputs = _inputs()
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    launch.spawn(_ranks, N_RANKS, (workdir, pack), device="cpu",
                 timeout_s=180)
    got = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                      weights_only=False) for r in range(N_RANKS)]
    one = {w: _step(w, inputs, slice(None)) for w in ("mae", "dual")}
    logs = {}
    for which in CLIS:
        logs[which] = ""
        for r in range(N_RANKS):
            with open(os.path.join(workdir, f"{which}_rank{r}.log")) as f:
                logs[which] += f.read()
    return dict(got=got, one=one, inputs=inputs, workdir=workdir, logs=logs)


@pytest.mark.parametrize("which", ["mae", "dual"])
def test_two_rank_step_matches_one_process_step(ranks, which):
    """Each rank's loss is its share: the summed loss, the dual's seven
    aux values (masked-MSE counts and variance statistics over the global
    batch) and the updated parameters and moments are one process's on
    the global batch; both ranks end bit-equal."""
    one = ranks["one"][which]
    a, b = (g[which] for g in ranks["got"])
    assert a["metrics"]["loss"] == pytest.approx(one["metrics"]["loss"],
                                                 rel=1e-6)
    assert a["metrics"].keys() == one["metrics"].keys()
    for k, v in one["metrics"].items():
        assert a["metrics"][k] == pytest.approx(v, rel=1e-5), k
    for group in ("student", "mu", "nu"):
        keys = sorted(one[group])
        flat = [torch.cat([s[group][k].double().flatten() for k in keys])
                for s in (a, one)]
        assert _rel(*flat) < 1e-5, group
        for k in keys:
            assert torch.equal(a[group][k], b[group][k]), (group, k)
    if which == "dual":  # a dropped branch on each rank's rows
        draws = ranks["inputs"]["dual"]["draws"]
        for rows in (slice(0, 2), slice(2, 4)):
            assert bool((draws.patch_dp[..., rows] == 0).any()
                        | (draws.frame_dp[..., rows] == 0).any())


def test_teacherless_state_refuses_a_teacher_checkpoint(tmp_path):
    """A state without a teacher restores only a checkpoint without one."""
    from audiossl_tpu_torch.methods.atstframe import method as tfm

    mae = _method("mae").init_state(0)
    saved = tck.host_state(mae)
    assert saved["teacher"] is None
    frame = tfm.FrameMethod(tfm.FramePretrainConfig(arch="tiny"),
                            device="cpu").init_state(0)
    framed = tck.host_state(frame)
    framed["mu"], framed["nu"] = saved["mu"], saved["nu"]
    with pytest.raises(KeyError, match="holds a teacher"):
        tck.load_host_state(mae, framed)
