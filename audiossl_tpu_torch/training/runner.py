"""Pretraining run loop: data -> step -> logging -> checkpoints (PyTorch
port of ``audiossl_tpu/training/runner.py``).

Replaces the Lightning Trainer of the reference (``methods/atst/
train.py:11-49``): one Python loop around the method's step, with
TensorBoard logging where ``torch.utils.tensorboard`` imports, periodic
checkpoints (``training/checkpoint.CheckpointManager``) and crash-restart
auto-resume from the latest one.

Data parallel, as the reference's DDP: under a process group of n ranks
(``parallel/``) each rank runs this loop on its card with its own loader,
which reads its contiguous slice of every global batch of
``batch_size_per_device * n`` clips; the step sums the gradients over
ranks. Rank 0 prints, logs, writes the checkpoints and profiles; every
rank restores from the same checkpoint.

One departure from the JAX loop, which steps before it tests the step
count and so takes one more step when resumed at or past ``max_steps``:
this loop tests first and takes none, as Lightning's ``max_steps`` does.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from audiossl_tpu_torch.datasets.packed import PackedAudioDataset
from audiossl_tpu_torch.datasets.pipeline import BatchLoader
from audiossl_tpu_torch.parallel.mesh import world
from audiossl_tpu_torch.training.checkpoint import CheckpointManager
from audiossl_tpu_torch.training.pretrain import shard_optimizer as zero1

LOADER_THREADS = 8  # records a loader reads at once
PROFILE_STEPS = 10  # steps a ``profile_at`` trace covers


class MetricLogger:
    """Scalars to TensorBoard under ``save_path`` when
    ``torch.utils.tensorboard`` imports; otherwise nothing."""

    def __init__(self, save_path: Optional[str]):
        self._tb = None
        if save_path:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                return
            self._tb = SummaryWriter(save_path)

    def log(self, step: int, metrics: dict):
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self):
        if self._tb is not None:
            self._tb.close()


def make_loader(dataset, batch_size: int, pad: int, seed: int, epoch: int,
                wav_dtype):
    """The epoch's loader and its name: the native C++ reader for a
    ``PackedAudioDataset`` when it builds, else the Python
    ``BatchLoader`` (the same batches; the reason is in the name).
    ``batch_size`` is the global batch; under a process group the rank's
    ``BatchLoader`` reads its slice of it (the native reader serves one
    process, as in JAX)."""
    w = world()
    if w.size > 1:
        return BatchLoader(dataset, batch_size, pad, shuffle=True, seed=seed,
                           epoch=epoch, num_threads=LOADER_THREADS,
                           include_labels=False, wav_dtype=wav_dtype,
                           process_index=w.rank, process_count=w.size), \
            f"python BatchLoader (rank {w.rank} of {w.size})"
    if isinstance(dataset, PackedAudioDataset):
        from audiossl_tpu_torch.datasets.native import NativeBatchLoader

        try:
            loader = NativeBatchLoader(dataset, batch_size, pad, seed=seed,
                                       epoch=epoch, n_threads=LOADER_THREADS,
                                       wav_dtype=wav_dtype)
            return loader, (f"native (C++ .ards reader, {LOADER_THREADS} "
                            f"threads)")
        except (RuntimeError, OSError) as e:
            why = f"native reader unavailable: {e}".splitlines()[0]
    else:
        why = f"{type(dataset).__name__} is not a packed dataset"
    return BatchLoader(dataset, batch_size, pad, shuffle=True, seed=seed,
                       epoch=epoch, num_threads=LOADER_THREADS,
                       include_labels=False, wav_dtype=wav_dtype), \
        f"python BatchLoader ({why})"


def run_pretraining(method, dataset, *, batch_size_per_device: int,
                    max_steps: int, save_path: Optional[str] = None,
                    ckpt_interval: int = 5000, log_interval: int = 50,
                    seed: int = 0, n_devices: Optional[int] = None,
                    clip_len_s: Optional[float] = None,
                    profile_at: Optional[int] = None,
                    shard_optimizer: bool = False):
    """Train ``method`` on ``dataset`` until ``max_steps``, on the method's
    device. Returns the final ``PretrainState``. ``method`` is a
    ``ClipMethod``, ``FrameMethod``, ``MAEMethod`` or ``DualMethod``: it
    has a ``device``, a ``cfg`` with ``out_samples`` (the crop the host
    buffer must hold), ``init_state(seed)`` and ``make_step()``, whose
    step takes ``(state, batch)`` and returns the metrics.

    With ``save_path``: TensorBoard scalars there, checkpoints under
    ``{save_path}/ckpt`` every ``ckpt_interval`` steps and at the end, and
    a run that finds one there resumes from the latest (the loader's
    epoch starts again at 0, as in JAX). Every ``log_interval`` steps it
    prints ``step N k=v ...`` with the interval's ``clips_per_sec``.
    ``profile_at``: a ``torch.profiler`` trace of ``PROFILE_STEPS`` steps
    from that step, written to ``{save_path or '.'}/profile``.

    Under a process group the run is data parallel over its ranks:
    ``n_devices`` (None: the group's size) must be that size, the global
    batch is ``batch_size_per_device`` times it (``clips_per_sec`` counts
    it), and only rank 0 prints, logs, saves and profiles.
    ``shard_optimizer``: ZeRO-1, each rank keeping the Adam moments of the
    leaves it owns (``training.pretrain.shard_optimizer``); nothing changes
    in one process."""
    w = world()
    if n_devices not in (None, w.size):
        raise ValueError(f"n_devices={n_devices} but the process group has "
                         f"{w.size} rank(s)")
    say = print if w.is_main else (lambda *a, **k: None)
    global_bs = batch_size_per_device * w.size
    device = method.device
    state = method.init_state(seed)
    mgr = None
    if save_path:
        mgr = CheckpointManager(os.path.join(save_path, "ckpt"),
                                save_interval_steps=ckpt_interval)
        if mgr.restore_latest(state) is not None:
            say(f"resumed from step {state.step}", flush=True)
    if shard_optimizer:
        zero1(state)
    step_fn = method.make_step()
    logger = MetricLogger(save_path if w.is_main else None)

    # the host buffer covers the whole clip (AudioSet clips are 10 s) so
    # the step's random crop sees all of it (reference transform.py:50-60)
    clip_samples = int((10.0 if clip_len_s is None else clip_len_s) * 16000)
    pad = max(clip_samples, method.cfg.out_samples)
    # int16 batches (half the bytes to the device; the step scales them by
    # the exact 1/32768) whenever the pack stores int16
    wav_dtype = (np.int16 if isinstance(dataset, PackedAudioDataset)
                 and dataset.reader.all_int16() else np.float32)
    profile_dir = os.path.join(save_path or ".", "profile")
    prof = None

    start = step = state.step
    epoch = 0
    t0 = time.perf_counter()
    while step < max_steps:
        loader, name = make_loader(dataset, global_bs, pad, seed, epoch,
                                   wav_dtype)
        if epoch == 0:
            say(f"loader: {name}, {len(loader)} batches of {global_bs} an "
                f"epoch, {np.dtype(wav_dtype)} [{batch_size_per_device}, "
                f"{pad}] a rank", flush=True)
        if len(loader) == 0:
            raise ValueError(f"{len(dataset)} clips make no batch of "
                             f"{global_bs}")
        for batch in loader:
            if profile_at is not None and step == profile_at and w.is_main:
                prof = _start_profile(device)
            metrics = step_fn(state, batch)
            step = state.step
            if prof is not None and step >= profile_at + PROFILE_STEPS:
                _stop_profile(prof, device, profile_dir, profile_at)
                prof = None
            if step % log_interval == 0 and w.is_main:
                m = {k: float(v) for k, v in metrics.items()}
                m["clips_per_sec"] = (global_bs * log_interval
                                      / (time.perf_counter() - t0))
                t0 = time.perf_counter()
                logger.log(step, m)
                print(f"step {step} " + " ".join(
                    f"{k}={v:.5g}" for k, v in sorted(m.items())),
                    flush=True)
            if mgr is not None and step % ckpt_interval == 0:
                _save(mgr, step, state)
            if step >= max_steps:
                break
        epoch += 1
    if prof is not None:
        _stop_profile(prof, device, profile_dir, profile_at)
    if mgr is not None:
        _save(mgr, step, state, force=True)
        mgr.wait()
        mgr.close()
    logger.close()
    say(f"run ended at step {step}: {step - start} steps taken", flush=True)
    return state


def _save(mgr, step, state, force=False):
    """A checkpoint: the host copy blocks the loop, the write does not
    (its error surfaces at the next save). Every rank calls it; rank 0
    writes."""
    if mgr.save(step, state, force=force) and mgr.writer:
        print(f"checkpoint step {step}: host copy {mgr.last_copy_ms:.1f} ms",
              flush=True)


def _start_profile(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, device, out_dir, first_step):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace_step{first_step}.json")
    prof.export_chrome_trace(path)
    print(f"profile trace written to {path}", flush=True)
