"""The four downstream drivers at ``--n_devices 2 --device cpu`` on their
synthetic data, against the same run in one process.

``train_finetune`` (clip-tiny, a global batch of 4 on a pack whose
validation split of 7 clips ends on a ragged batch), ``train_freeze``
(clip-tiny), ``train_dcase`` (frame-tiny, 2 strong and 2 weak rows a
batch: rank 0 steps on the strong rows, rank 1 on the weak ones) and
``train_as_strong`` (frame-tiny, layer decay 0.75) run on 2 gloo ranks
spawned once for the file (``parallel.launch.spawn``, a hard limit of
240 s); each driver's ``main`` joins that group (``parallel.launch.
run_cli``). The one-process runs go on here meanwhile. Each rank records
the files it opens for writing: rank 1 writes none, rank 0 the result and
the keepers. The final trained modules (the driver's ``record["final"]``,
the probe's head for ``train_freeze``) are within rel L2 1e-4 of the
one-process run's, and the results are finite and close.
"""
import builtins
import json
import os
import threading

import numpy as np
import pytest
import torch

from audiossl_tpu_torch import datasets as tds
from audiossl_tpu_torch.datasets import sed
from audiossl_tpu_torch.downstream import (train_as_strong, train_dcase,
                                           train_finetune, train_freeze)
from audiossl_tpu_torch.models.atst import ast_tiny, frame_ast_tiny
from audiossl_tpu_torch.parallel import launch
from audiossl_tpu_torch.parallel.mesh import world

N_RANKS = 2
SPAWN_S = 240
DRIVERS = {"finetune": train_finetune, "freeze": train_freeze,
           "dcase": train_dcase, "as_strong": train_as_strong}
AS_LABELS = ["/m/a", "/m/b", "/m/c", "/m/d", "/m/e"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def argvs(root, out):
    """Each driver's flags on the data under ``root``, saving under
    ``out/<driver>``."""
    pack, ckpts = os.path.join(root, "pack"), {
        k: os.path.join(root, f"{k}.ckpt") for k in ("clip", "frame")}
    probe = ["--pretrained_ckpt_path", ckpts["clip"], "--data_path", pack,
             "--dataset_name", "audioset_b", "--model_type", "clip",
             "--arch", "tiny", "--n_last_blocks", "2", "--batch_size", "4",
             "--train_len", "2", "--device", "cpu"]
    sed_common = ["--pretrained_ckpt_path", ckpts["frame"], "--arch", "tiny",
                  "--max_epochs", "2", "--warmup_epochs", "1", "--device",
                  "cpu"]
    return {
        "finetune": probe + ["--max_epochs", "1", "--warmup_epochs", "0",
                             "--save_path", os.path.join(out, "finetune")],
        "freeze": probe + ["--max_epochs", "3",
                           "--save_path", os.path.join(out, "freeze")],
        "dcase": sed_common + [
            "--data_path", os.path.join(root, "dcase"),
            "--batch_size_synth", "2", "--batch_size_weak", "2",
            "--save_path", os.path.join(out, "dcase")],
        "as_strong": sed_common + [
            "--data_path", os.path.join(root, "as_strong"),
            "--batch_size", "4",
            "--save_path", os.path.join(out, "as_strong")],
    }


def run_drivers(root, out, n_devices):
    """Every driver at ``--n_devices n_devices``: -> {driver: (result,
    record, files this process opened for writing)}."""
    res = {}
    for name, argv in argvs(root, out).items():
        writes = []
        save, opened = torch.save, builtins.open

        def record_save(obj, f, *a, **k):
            if isinstance(f, (str, os.PathLike)):
                writes.append(str(f))
            return save(obj, f, *a, **k)

        def record_open(f, mode="r", *a, **k):
            if any(c in mode for c in "wax") and isinstance(
                    f, (str, os.PathLike)):
                writes.append(str(f))
            return opened(f, mode, *a, **k)

        record = {}
        torch.save, builtins.open = record_save, record_open
        try:
            result = DRIVERS[name].main(argv + ["--n_devices",
                                                str(n_devices)], record)
        finally:
            torch.save, builtins.open = save, opened
        if name == "freeze":  # the probe's head; rank 0 alone records
            record = {"final": record.get(0, {}).get("state")}
        res[name] = (result, record.get("final"), writes)
    return res


def ranks_main(root, out):
    res = run_drivers(root, out, N_RANKS)
    torch.save(res, os.path.join(out, f"rank{world().rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ddp_drivers"))
    pack = os.path.join(root, "pack")
    for split, n, seed in (("train", 16, 1), ("valid", 7, 2),
                           ("test", 6, 3)):
        tds.write_synthetic_pack(pack, split, n, min_s=1.0, max_s=3.0,
                                 num_labels=527, multi_label=True,
                                 seed=seed, kind="tones")
    sed.write_synthetic_sed(
        os.path.join(root, "dcase"),
        {"synth_train": 6, "weak_train": 10, "synth_val": 5,
         "strong_val": 5}, sed.DCASE_CLASSES, weak_splits=("weak_train",),
        duration_splits=("strong_val",), seed=3, seconds=2.0)
    sed.write_synthetic_sed(os.path.join(root, "as_strong"),
                            {"train": 8, "val": 5, "eval": 5}, AS_LABELS,
                            seed=4, seconds=2.0)
    for kind, maker in (("clip", ast_tiny), ("frame", frame_ast_tiny)):
        enc = maker(spec_w=1001, device="cpu",
                    generator=torch.Generator().manual_seed(8))
        torch.save({"state_dict": {f"model.teacher.encoder.{k}": v
                                   for k, v in enc.state_dict().items()}},
                   os.path.join(root, f"{kind}.ckpt"))
    two = os.path.join(root, "two")
    os.makedirs(two)
    failed = []

    def spawn():
        try:
            launch.spawn(ranks_main, N_RANKS, (root, two), device="cpu",
                         timeout_s=SPAWN_S)
        except BaseException as e:  # raised below, in the fixture
            failed.append(e)

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        one = run_drivers(root, os.path.join(root, "one"), 1)
    finally:
        thread.join()
    if failed:
        raise failed[0]
    got = [torch.load(os.path.join(two, f"rank{r}.pt"), weights_only=False)
           for r in range(N_RANKS)]
    return dict(one=one, got=got, two=two)


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_rank_zero_alone_writes(runs, name):
    save = os.path.join(runs["two"], name)
    r0, r1 = (g[name][2] for g in runs["got"])
    assert r1 == []
    assert os.path.join(save, "result.json") in r0
    assert all(w.startswith(save) for w in r0)
    assert any(os.sep + "top" + os.sep in w for w in r0)  # the keeper
    with open(os.path.join(save, "result.json")) as f:
        assert json.load(f) == runs["got"][0][name][0]
    assert runs["got"][1][name][0] == runs["got"][0][name][0]


def _flat(final, name):
    if name == "freeze":
        return final
    return {f"{m}.{k}": v for m, sd in final.items() for k, v in sd.items()}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_two_rank_run_ends_near_the_one_process_run(runs, name):
    """Rank 0's record (rank 1 records nothing): the final modules, all
    their values together, rel L2 1e-4, and every BatchNorm running
    statistic rel 1e-4 (reduced where the ranks ran the same rows, its
    unbiased count would be 2x too large); the results finite and within
    0.05."""
    want = _flat(runs["one"][name][1], name)
    got = _flat(runs["got"][0][name][1], name)
    assert runs["got"][1][name][1] is None
    assert got.keys() == want.keys()
    keys = sorted(k for k, v in want.items() if v.is_floating_point())
    assert _rel(torch.cat([got[k].flatten() for k in keys]),
                torch.cat([want[k].flatten() for k in keys])) < 1e-4
    stats = [k for k in keys if "running_" in k]
    assert stats or name in ("dcase", "as_strong")
    for k in stats:
        assert _rel(got[k], want[k]) < 1e-4, k
    result, one = runs["got"][0][name][0], runs["one"][name][0]
    for k, v in one.items():
        if isinstance(v, float):
            assert np.isfinite(result[k]), k
            assert result[k] == pytest.approx(v, abs=0.05), k
