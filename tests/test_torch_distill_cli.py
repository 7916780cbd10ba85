"""The two distillation CLIs on the CPU at tiny width, and distillation on
2 gloo ranks against one process.

* ``python -m audiossl_tpu_torch.methods.distill.train`` (in a
  subprocess, run by ``runpy`` with the configuration's arch patched to
  tiny: the CLI has no arch flag) on a synthetic ``audioset_b`` pack with a reference-layout
  teacher ``.ckpt`` (``encoder.encoder.*``, ``head.*``: a LinearHead with
  running statistics) and the student as a reference pretraining
  ``.ckpt``; then ``main`` with the student as the port's own pretraining
  ``state.pt``: the saved state (the first epoch's, as the checkpoint
  manager takes it) read back through ``load_pretrain_checkpoint(
  which="student")`` and the ``distillatst`` adapter equal, tensor for
  tensor, to the student at that step; an orbax directory refused; and
  without ``--device`` the CLI raises here (no card);
* ``python -m audiossl_tpu_torch.methods.distill.train_other --arch tiny``
  in a subprocess on a seeded ``spcv2`` tree (1 s clips, the 12 s central
  crop): ``result.json`` with finite val and test accuracies;
* 2 gloo ranks spawned once for the file (``parallel.launch.spawn``, a
  hard limit of 240 s) while the one-process runs go on here: two steps of
  the multi-label random-crop case and of the single-label central-crop
  case with a chunked student (3 chunks a clip, drop path 0.4), each rank
  on its rows of a global batch of 4 with the global draws, against one
  process on the global batch: loss rel 1e-6, the other logged values rel
  1e-5, every parameter, statistic and trace leaf rel L2 1e-5 or three
  times what the row order alone moves it (the one-process step with the
  ranks' halves swapped, as ``test_torch_ddp_downstream.py`` holds its
  steps), both ranks bit-equal; then
  ``train_other`` at ``--n_devices 2``: rank 0 alone writes, both ranks
  return the same result, its per-step losses rel 1e-5 and its saved
  student rel L2 1e-4 of the one-process run's (as
  ``test_torch_ddp_drivers.py`` holds the drivers).
"""
import builtins
import dataclasses
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from audiossl_tpu_torch import datasets as tds
from audiossl_tpu_torch.compat.checkpoint import load_pretrain_checkpoint
from audiossl_tpu_torch.downstream.comparison_models import get_adapter
from audiossl_tpu_torch.methods.distill import method as tdm
from audiossl_tpu_torch.methods.distill import train as ttrain
from audiossl_tpu_torch.methods.distill import train_other
from audiossl_tpu_torch.models.atst import ast_tiny, frame_ast_tiny
from audiossl_tpu_torch.models.heads import LinearHead
from audiossl_tpu_torch.parallel import launch
from audiossl_tpu_torch.parallel.mesh import world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RANKS = 2
SPAWN_S = 240
SPCV2_LABELS = ("yes", "no", "stop", "up", "down")
STEP_CASES = {
    "multi_random": dict(num_labels=5, max_len=1.0, pretrain_frames=101,
                         chunk_len=61),
    "single_central": dict(num_labels=5, max_len=1.5, pretrain_frames=101,
                           chunk_len=61, multi_label=False, crop="central",
                           student_chunk_len=61),
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@dataclasses.dataclass(frozen=True)
class TinyConfig(tdm.DistillConfig):
    arch: str = "tiny"


def teacher_files(root, num_labels):
    """A clip-tiny classifier as a reference-layout ``.ckpt`` (its
    head's BatchNorm with running statistics and the reference's
    ``num_batches_tracked``) and a frame-tiny pretraining ``.ckpt``; ->
    their paths."""
    enc = ast_tiny(spec_w=1001, device="cpu",
                   generator=torch.Generator().manual_seed(8))
    head = LinearHead(2 * 64, num_labels,
                      generator=torch.Generator().manual_seed(9))
    g = torch.Generator().manual_seed(10)
    with torch.no_grad():
        head.linear.weight.normal_(0.0, 0.3, generator=g)
        head.norm.running_mean.normal_(0.0, 0.2, generator=g)
        head.norm.running_var.uniform_(0.5, 1.5, generator=g)
    sd = {f"encoder.encoder.{k}": v for k, v in enc.state_dict().items()}
    sd.update((f"head.{k}", v) for k, v in head.state_dict().items())
    sd["head.norm.num_batches_tracked"] = torch.tensor(100)
    teacher = os.path.join(root, f"teacher{num_labels}.ckpt")
    torch.save({"state_dict": sd}, teacher)
    student = os.path.join(root, "student.ckpt")
    fenc = frame_ast_tiny(spec_w=1001, device="cpu",
                          generator=torch.Generator().manual_seed(11))
    torch.save({"state_dict": {f"model.teacher.encoder.{k}": v
                               for k, v in fenc.state_dict().items()}},
               student)
    return teacher, student


def write_spcv2(root, n_per=5):
    """A seeded ``spcv2`` tree (``tests/test_distill_other.py``'s
    layout): 1 s int16 clips of ``SPCV2_LABELS``, a label's second-to-last
    clip in validation and its last in test."""
    rng = np.random.RandomState(0)
    val, test = [], []
    for lab in SPCV2_LABELS:
        os.makedirs(os.path.join(root, lab), exist_ok=True)
        for i in range(n_per):
            rel = f"{lab}/{lab}_{i}.wav"
            wavfile.write(os.path.join(root, rel), 16000,
                          (rng.randn(16000) * 3000).astype(np.int16))
            (val if i == n_per - 2 else test if i == n_per - 1
             else []).append(rel)
    for name, rels in (("validation_list.txt", val),
                       ("testing_list.txt", test)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(rels) + "\n")


def other_argv(data, teacher, student, save):
    return ["--dataset_name", "spcv2", "--data_path", data,
            "--teacher_ckpt_path", teacher, "--student_ckpt_path", student,
            "--arch", "tiny", "--batch_size", "4", "--max_epochs", "2",
            "--warmup_epochs", "1", "--save_path", save, "--device", "cpu"]


# ------------------------------------------------------------------ #
# the steps, built alike here and on the ranks
# ------------------------------------------------------------------ #
def step_method(inp):
    cfg = tdm.DistillConfig(arch="tiny", lambda_d=0.5, learning_rate=0.1,
                            max_epochs=2, steps_per_epoch=1,
                            warmup_epochs=0, drop_path_rate=0.4,
                            **STEP_CASES[inp["case"]])
    teacher = ast_tiny(spec_w=101, device="cpu")
    teacher.load_state_dict(inp["teacher"])
    t_head = LinearHead(128, cfg.num_labels)
    t_head.load_state_dict(inp["t_head"])
    method = tdm.DistillMethod(cfg, teacher, t_head,
                               frame_ast_tiny(spec_w=101, device="cpu"))
    method.student.load_state_dict(inp["student"])
    return method, method.init_state(torch.Generator().manual_seed(0))


def run_steps(inp, rows=None):
    """``inp``'s two steps, each on this rank's rows of its global batch
    (``rows`` None) or on ``rows`` of it in one process, with the global
    draws; -> the final student, head statistics, trace and metrics."""
    from audiossl_tpu_torch.parallel.mesh import shard_batch

    method, state = step_method(inp)
    metrics = []
    for batch, draws in zip(inp["batches"], inp["draws"]):
        local = shard_batch(batch) if rows is None else \
            {k: v[rows] for k, v in batch.items()}
        _, m = method.train_step(state, local, draws)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(values=tdm.student_state(state),
                mu={k: v.clone() for k, v in state.mu.items()},
                metrics=metrics)


def step_inputs(case, seed):
    """The seeded teacher, head, student, two global batches of 4 clips and
    the port's draws for ``case``."""
    rng = np.random.RandomState(seed)
    cfg = dict(STEP_CASES[case])
    g = torch.Generator().manual_seed(seed)
    teacher = ast_tiny(spec_w=101, device="cpu", generator=g)
    t_head = LinearHead(128, cfg["num_labels"], generator=g)
    with torch.no_grad():
        t_head.linear.weight.normal_(0.0, 0.3, generator=g)
        t_head.norm.running_mean.normal_(0.0, 0.2, generator=g)
        t_head.norm.running_var.uniform_(0.5, 1.5, generator=g)
    student = frame_ast_tiny(spec_w=101, device="cpu", generator=g)
    inp = dict(case=case, teacher=teacher.state_dict(),
               t_head=t_head.state_dict(), student=student.state_dict())
    method, state = step_method(inp)
    L = 24000
    batches, draws = [], []
    for _ in range(2):
        wav = (rng.randn(4, L) * 0.1).astype(np.float32)
        valid = np.asarray([24000, 20000, 12000, 9000], np.int32)
        for i, v in enumerate(valid):
            wav[i, v:] = 0.0
        label = ((rng.rand(4, 5) > 0.5).astype(np.float32)
                 if cfg.get("multi_label", True)
                 else rng.randint(5, size=4).astype(np.int32))
        batches.append({"wav": wav, "valid": valid, "label": label})
        draws.append(method.draw(state, 4, L))
    inp.update(batches=batches, draws=draws)
    return inp


def swap(inp):
    """``inp`` with each batch's halves exchanged and the draws to match:
    each clip keeps its crop uniform and its chunks' drop-path uniforms."""
    perm = np.asarray([2, 3, 0, 1])
    out = dict(inp, batches=[{k: v[perm] for k, v in b.items()}
                             for b in inp["batches"]], draws=[])
    for d in inp["draws"]:
        per = d.dp.shape[-1] // 4
        dp = d.dp.reshape(*d.dp.shape[:-1], 4, per)[..., perm, :].reshape(
            d.dp.shape)
        out["draws"].append(tdm.DistillDraws(
            None if d.crop is None else d.crop[perm], dp))
    return out


# ------------------------------------------------------------------ #
# the ranks
# ------------------------------------------------------------------ #
def ranks_main(workdir):
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    res = {case: run_steps(inputs[case]) for case in STEP_CASES}
    writes = []
    save, opened = torch.save, builtins.open

    def record_save(obj, f, *a, **k):
        if isinstance(f, (str, os.PathLike)):
            writes.append(str(f))
        return save(obj, f, *a, **k)

    def record_open(f, mode="r", *a, **k):
        if any(c in mode for c in "wax") and isinstance(f, (str,
                                                           os.PathLike)):
            writes.append(str(f))
        return opened(f, mode, *a, **k)

    record = {}
    torch.save, builtins.open = record_save, record_open
    try:
        result = train_other.main(inputs["other_argv"] + [
            "--n_devices", str(N_RANKS)], record)
    finally:
        torch.save, builtins.open = save, opened
    res["other"] = dict(result=result, record=record, writes=writes)
    torch.save(res, os.path.join(workdir, f"rank{world().rank}.pt"))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("distill_cli"))
    pack = os.path.join(root, "pack")
    tds.write_synthetic_pack(pack, "train", 8, min_s=1.0, max_s=12.0,
                             num_labels=527, multi_label=True, seed=1,
                             kind="tones")
    spcv2 = os.path.join(root, "spcv2")
    write_spcv2(spcv2)
    teacher, student = teacher_files(root, 527)
    teacher35, _ = teacher_files(root, 35)
    # the port's own pretraining checkpoint of the same student
    port = os.path.join(root, "pretrain", "ckpt", "6")
    os.makedirs(port)
    enc = load_pretrain_checkpoint(student)[0]
    torch.save({"step": 6, "teacher": {f"encoder.{k}": v
                                       for k, v in enc.items()},
                "student": {f"encoder.{k}": v for k, v in enc.items()}},
               os.path.join(port, "state.pt"))
    return dict(root=root, pack=pack, spcv2=spcv2, teacher=teacher,
                teacher35=teacher35, student=student, port=port)


@pytest.fixture(scope="module")
def ranks(files):
    workdir = os.path.join(files["root"], "ranks")
    os.makedirs(workdir)
    inputs = {case: step_inputs(case, 20 + i)
              for i, case in enumerate(STEP_CASES)}
    inputs["other_argv"] = other_argv(
        files["spcv2"], files["teacher35"], files["student"],
        os.path.join(workdir, "other"))
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    failed = []

    def spawn():
        try:
            launch.spawn(ranks_main, N_RANKS, (workdir,), device="cpu",
                         timeout_s=SPAWN_S)
        except BaseException as e:  # raised below, in the fixture
            failed.append(e)

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        one = {case: run_steps(inputs[case], slice(None))
               for case in STEP_CASES}
        witness = {case: run_steps(swap(inputs[case]), slice(None))
                   for case in STEP_CASES}
        record = {}
        one["other"] = dict(result=train_other.main(other_argv(
            files["spcv2"], files["teacher35"], files["student"],
            os.path.join(files["root"], "other_one")), record),
            record=record)
    finally:
        thread.join()
    if failed:
        raise failed[0]
    got = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                      weights_only=False) for r in range(N_RANKS)]
    return dict(inputs=inputs, one=one, witness=witness, got=got,
                workdir=workdir)


# ------------------------------------------------------------------ #
# the CLIs
# ------------------------------------------------------------------ #
def _train_argv(files, student, save, *extra):
    return ["--data_path", files["pack"], "--teacher_ckpt_path",
            files["teacher"], "--student_ckpt_path", student,
            "--save_path", save, "--batch_size", "4", "--max_epochs", "2",
            "--warmup_epochs", "1", "--balanced_sampling", "--lambda_d",
            "0.5", *extra]


def test_train_cli_runs_and_saves_the_student(files, tmp_path):
    """``python -m ...distill.train`` (the arch patched to tiny) with a
    reference ``.ckpt`` student: 2 epochs of 2 steps; the checkpoint
    manager keeps the first epoch's save (step 2) alone, and the
    ``distillatst`` adapter reads its student."""
    save = str(tmp_path / "as")
    code = ("import dataclasses, runpy, sys\n"
            "from audiossl_tpu_torch.methods.distill import method\n"
            "method.DistillConfig = dataclasses.make_dataclass(\n"
            "    'TinyConfig', [('arch', str, 'tiny')],\n"
            "    bases=(method.DistillConfig,), frozen=True)\n"
            "sys.argv[0] = 'train'\n"
            "runpy.run_module('audiossl_tpu_torch.methods.distill.train',\n"
            "                 run_name='__main__', alter_sys=True)\n")
    r = subprocess.run([sys.executable, "-c", code, *_train_argv(
        files, files["student"], save, "--device", "cpu")], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ckpt = os.path.join(save, "ckpt")
    assert sorted(os.listdir(ckpt)) == ["2"]
    saved = torch.load(os.path.join(ckpt, "2", "state.pt"),
                       weights_only=True)
    assert saved["step"] == 2 and set(saved) == {"step", "student", "mu",
                                                 "generator"}
    assert {k.split(".")[0] for k in saved["student"]} == {"encoder", "head"}
    sd, hp = load_pretrain_checkpoint(os.path.join(ckpt, "2"),
                                      which="student")
    assert (hp["model_type"], hp["arch"]) == ("frame", "tiny")
    enc = get_adapter("distillatst", ckpt_path=os.path.join(ckpt, "2"),
                      arch="tiny", device="cpu").encoder
    for k, v in enc.state_dict().items():
        assert torch.equal(v, sd[k]), k
        assert torch.equal(v, saved["student"][f"encoder.{k}"]), k


def test_train_cli_from_a_port_checkpoint(files, tmp_path, monkeypatch):
    """The student as the port's own pretraining ``state.pt``: the run's
    record holds the student at the saved step, equal tensor for tensor to
    the file, and the losses are finite."""
    monkeypatch.setattr(ttrain, "DistillConfig", TinyConfig)
    record = {}
    save = str(tmp_path / "port")
    state = ttrain.main(_train_argv(files, os.path.join(files["port"],
                                                        "state.pt"),
                                    save, "--device", "cpu"), record)
    assert state.step == 4
    assert [len(e) for e in record["steps"]] == [2, 2]
    assert all(np.isfinite(s[2:]).all() for e in record["steps"] for s in e)
    assert list(record["saved"]) == [2]
    sd, _ = load_pretrain_checkpoint(os.path.join(save, "ckpt", "2",
                                                  "state.pt"),
                                     which="student")
    want = record["saved"][2]
    assert set(sd) == {k[len("encoder."):] for k in want
                       if k.startswith("encoder.")}
    for k, v in sd.items():
        assert torch.equal(v, want[f"encoder.{k}"]), k


def test_train_cli_refuses_orbax_and_needs_a_card(files, tmp_path,
                                                  monkeypatch):
    monkeypatch.setattr(ttrain, "DistillConfig", TinyConfig)
    orbax = tmp_path / "orbax_params"
    orbax.mkdir()
    (orbax / "_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="orbax"):
        ttrain.main(_train_argv(files, str(orbax), str(tmp_path / "o"),
                                "--device", "cpu"))
    if not torch.cuda.is_available():
        for main, argv in (
                (ttrain.main, _train_argv(files, files["student"],
                                          str(tmp_path / "c"))),
                (train_other.main, other_argv(
                    files["spcv2"], files["teacher35"], files["student"],
                    str(tmp_path / "c2"))[:-2])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                main(argv)


def test_train_other_cli_runs_on_cpu(files, tmp_path):
    save = str(tmp_path / "spcv2")
    r = subprocess.run(
        [sys.executable, "-m",
         "audiossl_tpu_torch.methods.distill.train_other",
         *other_argv(files["spcv2"], files["teacher35"], files["student"],
                     save)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(os.path.join(save, "result.json")) as f:
        result = json.load(f)
    assert set(result) == {"dataset", "val", "test"}
    assert result["dataset"] == "spcv2"
    for key in ("val", "test"):
        assert np.isfinite(result[key]) and 0.0 <= result[key] <= 1.0
    assert json.loads(r.stdout.strip().splitlines()[-1]) == result
    assert sorted(os.listdir(os.path.join(save, "ckpt"))) == ["3"]


# ------------------------------------------------------------------ #
# 2 ranks against one process
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_two_rank_distill_steps_match_one_process(ranks, case):
    one, wit = ranks["one"][case], ranks["witness"][case]
    for r, g in enumerate(ranks["got"]):
        g = g[case]
        for m, mo, mw in zip(g["metrics"], one["metrics"], wit["metrics"]):
            assert m["loss"] == pytest.approx(mo["loss"], rel=1e-6), r
            for k in ("loss_d", "loss_c", "gnorm"):
                floor = abs(mw[k] - mo[k]) / abs(mo[k])
                assert m[k] == pytest.approx(mo[k], rel=max(1e-5, 3 * floor)
                                             ), (r, k, floor)
        bad = []
        for name in ("values", "mu"):
            a, b, w = g[name], one[name], wit[name]
            assert a.keys() == b.keys()
            for k in b:
                err, floor = _rel(a[k], b[k]), _rel(w[k], b[k])
                if err >= max(1e-5, 3 * floor):
                    bad.append((name, k, err, floor))
        assert not bad, (r, bad)
    a, b = (g[case] for g in ranks["got"])
    for name in ("values", "mu"):
        for k in a[name]:
            assert torch.equal(a[name][k], b[name][k]), (name, k)
    assert a["metrics"] == b["metrics"]


def test_two_rank_draws_cross_the_ranks(ranks):
    """The chunked case's drop path drops chunk sequences on both ranks,
    and its third chunks (clip-major) go with their clips."""
    dp = ranks["inputs"]["single_central"]["draws"][0].dp
    assert dp.shape == (2, 2, 4 * 3)
    for rows in (slice(0, 6), slice(6, 12)):
        assert bool((dp[1, :, rows] < 0.4).any())


def test_two_rank_train_other_matches_one_process(ranks):
    save = os.path.join(ranks["workdir"], "other")
    r0, r1 = (g["other"] for g in ranks["got"])
    assert r1["writes"] == [] and r1["record"] == {}
    assert os.path.join(save, "result.json") in r0["writes"]
    assert all(w.startswith(save) for w in r0["writes"])
    assert r0["result"] == r1["result"]
    with open(os.path.join(save, "result.json")) as f:
        assert json.load(f) == r0["result"]
    one = ranks["one"]["other"]
    got, want = r0["record"], one["record"]
    assert [len(e) for e in got["steps"]] == [len(e) for e in want["steps"]]
    for a, b in zip((s for e in got["steps"] for s in e),
                    (s for e in want["steps"] for s in e)):
        assert a[0] == b[0] == 4
        for x, y in zip(a[2:], b[2:]):
            assert x == pytest.approx(y, rel=1e-5)
    assert list(got["saved"]) == list(want["saved"]) == [3]
    a, b = got["saved"][3], want["saved"][3]
    keys = sorted(k for k, v in b.items() if v.is_floating_point())
    assert _rel(torch.cat([a[k].flatten() for k in keys]),
                torch.cat([b[k].flatten() for k in keys])) < 1e-4
    for k in ("head.norm.running_mean", "head.norm.running_var"):
        assert _rel(a[k], b[k]) < 1e-4, k
    for k in ("val", "test"):
        assert np.isfinite(r0["result"][k])
        assert r0["result"][k] == pytest.approx(one["result"][k], abs=0.05)
    # the validation split's 5 clips end on a ragged batch of 1
    assert [n for n, _ in got["evals"][0][1]] == [4, 1]
