"""Faults planted in the measured program, for the tests and the readings
the limits are set from: each patches the program while its context is open
and is never used by a benchmark run.

* ``unchanged``: a training step that returns its state as it found it;
* ``half_batch``: a step (or call) that leaves out the second half of its
  batch, the mean taken over the rest;
* ``altered``: a scene-embedding call whose first two answers trade places;
* ``no_exchange``: a data-parallel step whose ranks do not sum their
  gradients.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _kept(state_tensors, run):
    """Runs ``run()`` and puts every tensor of ``state_tensors`` back."""
    keep = [t.detach().clone() for t in state_tensors]
    out = run()
    with torch.no_grad():
        for t, k in zip(state_tensors, keep):
            t.copy_(k)
    return out


def _frame_unchanged(orig):
    def make_step(self):
        step = orig(self)
        return lambda state, *a: _kept(_frame_tensors(state),
                                       lambda: step(state, *a))
    return make_step


def _finetune_unchanged(orig):
    def train_step(self, state, *a):
        return _kept(_finetune_tensors(state), lambda: orig(self, state, *a))
    return train_step


def _frame_tensors(state):
    ts = list(state.student.parameters()) + list(state.mu.values()) \
        + list(state.nu.values())
    if state.teacher is not None:
        ts += list(state.teacher.parameters())
    return ts


def _finetune_tensors(state):
    return list(state.params.values()) + list(state.mu.values())


def _frame_half(orig):
    from audiossl_tpu_torch.methods.atstframe.method import StepDraws
    from audiossl_tpu_torch.transforms.augment import rows_of, view_major_rows

    def half(self, student, teacher, batch, gen, draws=None):
        # the rank's rows, and the global batch's draws (all ranks' rows)
        B, G = batch["wav"].shape[0], draws.crop.shape[0]
        sl = slice(0, G // 2)
        d = StepDraws(
            crop=draws.crop[sl], mix=tuple(rows_of(m, sl) for m in draws.mix),
            rrc=tuple(rows_of(r, sl) for r in draws.rrc),
            mask={k: v[sl] for k, v in draws.mask.items()},
            student_dp=view_major_rows(draws.student_dp, G, sl),
            teacher_dp=view_major_rows(draws.teacher_dp, G, sl))
        return orig(self, student, teacher,
                    {k: v[:B // 2] for k, v in batch.items()}, gen, d)
    return half


def _finetune_half(orig):
    import dataclasses

    def half(self, state, batch, draws):
        B = len(batch["wav"])
        h = B // 2
        per = draws.dp.shape[-1] // B
        d = dataclasses.replace(draws, lam=draws.lam[:h],
                                dp=draws.dp[..., :h * per])
        return orig(self, state, {k: v[:h] for k, v in batch.items()}, d)
    return half


def _embed(kind):
    def make(orig):
        def broken(audio, model):
            e = orig(audio, model)
            if kind == "half_batch":
                return e[:e.shape[0] // 2]
            return torch.cat([e[1:2], e[0:1], e[2:]])
        return broken
    return make


@contextlib.contextmanager
def planted(mix: str, fault: str):
    """The context in which ``mix``'s timed path carries ``fault``."""
    if mix in ("pretrain_step", "ddp_step"):
        from audiossl_tpu_torch.methods.atstframe.method import FrameMethod
        from audiossl_tpu_torch.training import pretrain
        if fault == "unchanged":
            cm = _patched(FrameMethod, "make_step", _frame_unchanged)
        elif fault == "half_batch":
            cm = _patched(FrameMethod, "forward_loss", _frame_half)
        elif fault == "no_exchange" and mix == "ddp_step":
            cm = _patched(pretrain, "reduce_grads",
                          lambda orig: lambda leaves: None)
        else:
            raise ValueError(fault)
    elif mix == "finetune_step":
        from audiossl_tpu_torch.downstream.finetune import FinetuneTask
        if fault == "unchanged":
            cm = _patched(FinetuneTask, "train_step", _finetune_unchanged)
        elif fault == "half_batch":
            cm = _patched(FinetuneTask, "train_step", _finetune_half)
        else:
            raise ValueError(fault)
    elif mix == "embed_calls":
        import audiossl_tpu_torch.embedding as emb
        if fault not in ("altered", "half_batch"):
            raise ValueError(fault)
        cm = _patched(emb, "get_scene_embedding", _embed(fault))
    else:
        raise ValueError(mix)
    with cm:
        yield
