"""Checkpoints (PyTorch port of ``audiossl_tpu/training/checkpoint.py``):
the pretraining runner's periodic checkpoints with crash-restart resume,
and the downstream drivers' top-k checkpoints. Both save with
``torch.save`` into ``state.pt`` files; the JAX package saves orbax
directories instead.

* :class:`CheckpointManager`: the reference's Lightning
  ``ModelCheckpoint`` + ``last.ckpt`` auto-resume (reference
  ``methods/atst/train.py:25-35``), with the JAX package's orbax
  ``CheckpointManager`` semantics: which steps are saved and kept.
* :class:`TopKKeeper`: Lightning ``ModelCheckpoint(save_top_k=k,
  monitor="val_*", mode="max" or "min")`` in the downstream drivers
  (``methods/atst/downstream/train_freeze.py:117-124``,
  ``train_finetune.py:122``, ``train_as_strong.py:48-61``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from audiossl_tpu_torch.parallel.mesh import broadcast_object, world
from audiossl_tpu_torch.training.pretrain import full_moments

STATE_FILE = "state.pt"
TOP_K = 10  # the keeper's default k, the reference's save_top_k


def host_state(state, copy: bool = True) -> Optional[dict]:
    """A copy on the host of everything a ``PretrainState`` holds: the step
    and Adam's count, both branches' state dicts (BatchNorm statistics
    included), the moments of every parameter by name and the generator's
    state. Synchronous: the step goes on changing the state in place.
    Under ZeRO-1 the moments come from their owners first, a collective
    that every rank enters; ``copy=False`` (a rank that writes nothing)
    takes part in it and returns None. The layout is a one-process run's
    either way."""
    mu, nu = full_moments(state)
    if not copy:
        return None

    def host(t):
        return t.detach().to("cpu", copy=True)

    return {"step": int(state.step), "count": int(state.count),
            "student": {k: host(v) for k, v in
                        state.student.state_dict().items()},
            "teacher": {k: host(v) for k, v in
                        state.teacher.state_dict().items()},
            "mu": {k: host(v) for k, v in mu.items()},
            "nu": {k: host(v) for k, v in nu.items()},
            "generator": state.generator.get_state()}


@torch.no_grad()
def load_host_state(state, saved: Mapping) -> None:
    """Copy ``saved`` (from :func:`host_state`) into ``state`` in place:
    the parameters, buffers and moments keep their tensors, so the state's
    paired leaves and K7's device leaf table stay valid. A ZeRO-1 state
    takes the moments it owns."""
    names = set(state.owners or state.mu)
    if set(saved["mu"]) != names:
        raise KeyError("the checkpoint's moments are not this state's: "
                       f"{sorted(set(saved['mu']) ^ names)[:8]}")
    state.student.load_state_dict(saved["student"])
    state.teacher.load_state_dict(saved["teacher"])
    for k in state.mu:
        state.mu[k].copy_(saved["mu"][k])
        state.nu[k].copy_(saved["nu"][k])
    state.step, state.count = int(saved["step"]), int(saved["count"])
    state.generator.set_state(saved["generator"])


class CheckpointManager:
    """Periodic pretraining checkpoints under ``<dir>/<step>/state.pt``.

    The JAX package's orbax manager decides what is saved and kept, and so
    does this one: the first save of an empty directory is taken at any
    step; after it a save is taken when ``force`` or when its step is past
    the latest and a multiple of ``save_interval_steps``; a step already
    kept is never saved again; the ``max_to_keep`` latest saves are kept.

    ``save`` copies the state to the host before it returns and writes
    the copy on a background thread; an error of that write is raised by
    the next ``save`` or ``wait``. A write goes into ``<step>.tmp`` and is
    renamed into place when complete, so a crash mid-write leaves nothing
    ``restore_latest`` reads; leftover ``.tmp`` directories are removed
    when a manager opens the directory. ``last_copy_ms`` and
    ``write_s`` (step -> seconds) record what the saves took.

    What is saved is ``to_host(state, copy=...)``: by default
    :func:`host_state` of a ``PretrainState``; the distillation drivers
    pass ``methods.distill.method.host_state``. ``restore_latest`` reads
    a ``PretrainState``.

    Under a process group every rank keeps a manager and calls ``save``
    at the same steps, so all take the same decisions (and enter ZeRO-1's
    gather of the moments together), but only the ``writer``, rank 0,
    copies, writes, renames and removes anything: no two
    processes race on a file. Every rank restores from the same file.
    """

    def __init__(self, directory: str, save_interval_steps: int = 1000,
                 max_to_keep: int = 3, to_host: Callable = host_state):
        self.to_host = to_host
        self.dir = os.path.abspath(os.path.expanduser(directory))
        self.save_interval_steps = save_interval_steps
        self.max_to_keep = max_to_keep
        self.writer = world().is_main
        if self.writer:
            os.makedirs(self.dir, exist_ok=True)
        steps = []
        for name in (os.listdir(self.dir) if os.path.isdir(self.dir)
                     else []):
            path = os.path.join(self.dir, name)
            if name.endswith(".tmp"):
                if self.writer:
                    shutil.rmtree(path, ignore_errors=True)
            elif name.isdigit() and os.path.exists(
                    os.path.join(path, STATE_FILE)):
                steps.append(int(name))
        # in the order saved, as orbax keeps them
        self._steps: List[int] = sorted(steps)
        self._thread: Optional[threading.Thread] = None
        self._pending = None  # (step, steps it drops) of the write in flight
        self._error: Optional[BaseException] = None
        self.last_copy_ms: Optional[float] = None
        self.write_s: Dict[int, float] = {}

    def all_steps(self) -> List[int]:
        return list(self._steps)

    @property
    def latest_step(self) -> Optional[int]:
        return self._steps[-1] if self._steps else None

    def should_save(self, step: int) -> bool:
        if not self._steps:
            return True
        return (step > self._steps[-1]
                and step % self.save_interval_steps == 0)

    def save(self, step: int, state, force: bool = False) -> bool:
        """Save ``state`` as ``step`` if the rules above take it; returns
        whether it did. Waits for the previous write first."""
        self.wait()
        if step in self._steps or not (force or self.should_save(step)):
            return False
        t0 = time.perf_counter()
        saved = self.to_host(state, copy=self.writer)
        self.last_copy_ms = (time.perf_counter() - t0) * 1e3
        self._steps.append(step)
        drop = self._steps[:-self.max_to_keep] if self.max_to_keep else []
        del self._steps[:len(drop)]
        if not self.writer:
            return True
        self._pending = (step, drop)
        self._thread = threading.Thread(target=self._write,
                                        args=(step, saved, drop))
        self._thread.start()
        return True

    def _write(self, step: int, saved: dict, drop: List[int]) -> None:
        try:
            t0 = time.perf_counter()
            final = os.path.join(self.dir, str(step))
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(saved, os.path.join(tmp, STATE_FILE))
            os.replace(tmp, final)
            for old in drop:
                shutil.rmtree(os.path.join(self.dir, str(old)),
                              ignore_errors=True)
            self.write_s[step] = time.perf_counter() - t0
            print(f"checkpoint step {step}: written in "
                  f"{self.write_s[step]:.3f} s", flush=True)
        except BaseException as e:  # raised by the next save or wait
            self._error = e

    def restore_latest(self, state):
        """Copy the latest checkpoint into ``state`` in place
        (:func:`load_host_state`) and return it; None when there is none.
        The file is read with ``weights_only=True``."""
        self.wait()
        step = self.latest_step
        if step is None:
            return None
        saved = torch.load(os.path.join(self.dir, str(step), STATE_FILE),
                           map_location="cpu", weights_only=True)
        load_host_state(state, saved)
        return state

    def wait(self) -> None:
        """Wait for the write in flight; raise its error, if it had one
        (the failed step is then not kept, and the steps it would have
        dropped are kept again)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            step, drop = self._pending
            self._steps.remove(step)
            self._steps[:0] = drop
            raise err

    def close(self) -> None:
        self.wait()


class TopKKeeper:
    """The ``k`` saved states ranked best by a validation metric: the
    highest with ``mode="max"``, the lowest with ``mode="min"`` (the
    AudioSet-strong validation loss). The index records the
    mode, so a reader picks the best entry (:func:`read_topk_index`).

    Under a process group every rank keeps a keeper and updates it with
    the same metrics, so all take the same decisions, but only the
    ``writer``, rank 0, writes or removes a file; ``restore_best`` reads
    the best state on rank 0 and sends it to every rank."""

    def __init__(self, directory: str, k: int = TOP_K, mode: str = "max"):
        if mode not in ("max", "min"):
            raise ValueError(f"mode {mode!r} is not 'max' or 'min'")
        self.k = k
        self.mode = mode
        self.writer = world().is_main
        self.dir = os.path.abspath(os.path.expanduser(
            os.path.join(directory, "top")))
        if self.writer:
            os.makedirs(self.dir, exist_ok=True)
        self._index_path = os.path.join(self.dir, "index.json")
        self._index: Dict[int, float] = {}
        if self.writer and os.path.exists(self._index_path):
            self._index = read_topk_index(self._index_path)[0]
        self._index = broadcast_object(self._index)  # rank 0's, everywhere

    def _write_index(self):
        with open(self._index_path, "w") as f:
            json.dump({"mode": self.mode,
                       "scores": {str(k): v
                                  for k, v in self._index.items()}}, f)

    def _rank(self, tag: int) -> float:
        """Higher is better, in either mode."""
        v = self._index[tag]
        return v if self.mode == "max" else -v

    def update(self, metric: float, tag: int,
               state: Mapping[str, torch.Tensor]) -> bool:
        """Save ``state`` under ``tag`` (epoch or step) if it makes the top
        k. Returns True when saved."""
        if len(self._index) >= self.k:
            worst_tag = min(self._index, key=self._rank)
            worst = self._index[worst_tag]
            if metric < worst if self.mode == "max" else metric > worst:
                return False
            if self.writer:
                shutil.rmtree(os.path.join(self.dir, str(worst_tag)),
                              ignore_errors=True)
            del self._index[worst_tag]
        self._index[int(tag)] = float(metric)
        if self.writer:
            target = os.path.join(self.dir, str(tag))
            if os.path.exists(target):  # a re-run of the same epoch
                shutil.rmtree(target, ignore_errors=True)
            os.makedirs(target)
            torch.save(dict(state), os.path.join(target, STATE_FILE))
            self._write_index()
        return True

    @property
    def best_tag(self) -> Optional[int]:
        """The tag of the best state kept, or None."""
        return max(self._index, key=self._rank) if self._index else None

    @property
    def best_metric(self) -> Optional[float]:
        tag = self.best_tag
        return None if tag is None else self._index[tag]

    def restore_best(self):
        """The best state kept, as saved (read with ``weights_only=True``),
        or None when none is; read by rank 0 and the same on every
        rank."""
        tag = self.best_tag
        if tag is None:
            return None
        saved = None
        if self.writer:
            saved = torch.load(os.path.join(self.dir, str(tag), STATE_FILE),
                               map_location="cpu", weights_only=True)
        return broadcast_object(saved)


def read_topk_index(index_path: str) -> Tuple[Dict[int, float], str]:
    """-> ({tag: metric}, mode) of an ``index.json`` the keeper wrote; an
    index with no mode (as the keeper wrote it before it had one) reads as
    "max", as JAX's does."""
    with open(index_path) as f:
        data = json.load(f)
    return ({int(k): float(v) for k, v in data["scores"].items()},
            data.get("mode", "max"))
