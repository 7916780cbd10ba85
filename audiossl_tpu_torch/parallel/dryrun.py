"""The data-parallel dry run: the five checks of the JAX package's
``dryrun_multichip`` (``__graft_entry__.py:65``) on n ranks, at its tiny
shapes (frame encoder of width 128, 3 blocks, 4 heads, heads 256 -> 64,
1 s anchors; clip-tiny with 0.5 s crops; 2 clips a rank, f32):

1. one ATST-Frame step: a finite loss, step 1, and the parameters equal
   on every rank, bit for bit;
2. the same step from the same state under ZeRO-1: the parameters
   bit-equal to the replicated step's, each rank holding the moments of
   its own leaves only (every leaf owned once);
3. one ATST-Clip step: a finite loss, the parameters equal on every rank;
4. one downstream finetuning step (the drivers' path: each rank on its
   rows of the global batch): clip-tiny, 0.5 s crops, 5 labels, the last
   2 blocks, no mixup, SpecAugment or RandomResizeCrop; a finite loss and
   the encoder, head and momentum trace equal on every rank, bit for bit;
5. one DCASE SED step on check 1's tiny frame encoder, 10 labels, 1 s
   clips, the rows alternately strong and weak: a finite loss and the
   parameters equal on every rank.

    python -m audiossl_tpu_torch.parallel.dryrun --n_devices 2 --device cpu

runs gloo ranks on the CPU; ``--device cuda`` runs NCCL ranks, one a card.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from audiossl_tpu_torch.methods.atst.method import (ClipMethod,
                                                    ClipPretrainConfig)
from audiossl_tpu_torch.methods.atstframe.method import (FrameMethod,
                                                         FramePretrainConfig)
from audiossl_tpu_torch.models.atst import AudioTransformer
from audiossl_tpu_torch.parallel.launch import run_cli
from audiossl_tpu_torch.parallel.mesh import (all_gather_rows, local_rows,
                                              shard_batch, world)
from audiossl_tpu_torch.training.pretrain import (Branch, OptimizerConfig,
                                                  shard_optimizer)

PER_RANK = 2  # clips a rank, as the JAX dry run's 2 a device
OPT = OptimizerConfig(max_steps=100, warmup_steps=10)


def frame_method(device) -> FrameMethod:
    """The JAX dry run's frame method: the small recipe at 1 s anchors
    with both branches on an encoder of width 128, 3 blocks and 4 heads
    and heads of 256 -> 64, drawn from seed 0."""
    cfg = FramePretrainConfig(arch="tiny", anchor_len=1.0, optimizer=OPT)
    method = FrameMethod(cfg, device=device)
    gen = torch.Generator().manual_seed(0)
    kw = dict(embed_dim=128, depth=3, num_heads=4, spec_h=cfg.mel.n_mels,
              spec_w=cfg.out_frames, device="cpu", pos_type=cfg.pos_type)
    method.student = Branch(AudioTransformer(
        generator=gen, fused_attention=cfg.fused_attention, **kw),
        hidden_dim=256, out_dim=64)
    method.teacher = Branch(AudioTransformer(
        generator=gen, fused_infer=cfg.fused_attention, **kw),
        predictor=False, hidden_dim=256, out_dim=64)
    with torch.no_grad():
        method.student.head.reset_parameters(gen)
    method.student.to(method.device)
    method.teacher.to(method.device).requires_grad_(False)
    method.depth = 3
    return method


def host_batch(samples: int, seed: int) -> dict:
    """A seeded global batch of noise on the host, ``PER_RANK`` clips a
    rank (every fourth clip three quarters valid)."""
    n = PER_RANK * world().size
    rng = np.random.RandomState(seed)
    wav = (rng.randn(n, samples) * 0.1).astype(np.float32)
    valid = np.full(n, samples, np.int32)
    valid[1::4] = samples * 3 // 4
    wav[1::4, samples * 3 // 4:] = 0.0
    return {"wav": wav, "valid": valid}


def local_batch(samples: int, device, seed: int) -> dict:
    """This rank's rows of :func:`host_batch` on ``device``."""
    sl = local_rows(PER_RANK * world().size)
    return {k: torch.from_numpy(v[sl]).to(device)
            for k, v in host_batch(samples, seed).items()}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun check failed: {what}")


def flat_params(state) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in state.params])


def same_on_every_rank(x: torch.Tensor) -> bool:
    rows = all_gather_rows(x[None])
    return all(torch.equal(rows[0], r) for r in rows)


def checks(args) -> None:
    """Checks 1-5 on this rank; raises on a failure."""
    w = world()
    say = print if w.is_main else (lambda *a, **k: None)
    method = frame_method(args.device)
    batch = local_batch(method.cfg.out_samples, method.device, 1)
    state = method.init_state(0)
    out = method.make_step()(state, batch)
    loss = float(out["loss"])
    check(np.isfinite(loss) and state.step == 1,
          f"frame step: loss {loss}, step {state.step}")
    params = flat_params(state)
    check(same_on_every_rank(params), "frame parameters equal on every rank")
    say(f"dryrun [1/5] frame step ok: {w.size} rank(s), loss {loss}",
        flush=True)

    zmethod = frame_method(args.device)
    zstate = zmethod.init_state(0)
    shard_optimizer(zstate)
    zloss = float(zmethod.make_step()(zstate, batch)["loss"])
    check(zloss == loss, f"ZeRO-1 loss {zloss} == replicated {loss}")
    check(torch.equal(flat_params(zstate), params),
          "ZeRO-1 parameters bit-equal to the replicated step's")
    owned = torch.tensor([float(len(zstate.mu))], device=params.device)
    counts = all_gather_rows(owned)
    check(int(counts.sum()) == len(zstate.params),
          f"every leaf's moments on one rank: {counts.tolist()}")
    say(f"dryrun [2/5] ZeRO-1 step ok: parameters bit-equal to the "
        f"replicated step's, moment leaves by rank "
        f"{[int(c) for c in counts.tolist()]} of {len(zstate.params)}",
        flush=True)

    cmethod = ClipMethod(ClipPretrainConfig(
        arch="tiny", anchor_len=(0.5, 0.5), positive_len=(0.5, 0.5),
        optimizer=OPT), device=args.device, seed=1)
    cstate = cmethod.init_state(1)
    closs = float(cmethod.make_step()(
        cstate, local_batch(cmethod.cfg.out_samples, cmethod.device,
                            2))["loss"])
    check(np.isfinite(closs) and cstate.step == 1,
          f"clip step: loss {closs}, step {cstate.step}")
    check(same_on_every_rank(flat_params(cstate)),
          "clip parameters equal on every rank")
    say(f"dryrun [3/5] clip step ok: loss {closs}", flush=True)

    floss, fparams = finetune_check(args.device)
    check(np.isfinite(floss), f"finetune step: loss {floss}")
    check(same_on_every_rank(fparams),
          "finetune parameters and momentum equal on every rank")
    say(f"dryrun [4/5] downstream finetune step ok: loss {floss}",
        flush=True)

    sloss, sparams = sed_check(method.student.encoder, args.device)
    check(np.isfinite(sloss), f"SED step: loss {sloss}")
    check(same_on_every_rank(sparams), "SED parameters equal on every rank")
    say(f"dryrun [5/5] SED finetune step ok: loss {sloss}", flush=True)


def finetune_check(device):
    """Check 4's step on this rank's rows: -> (loss, the encoder, head
    and momentum trace flattened)."""
    from audiossl_tpu_torch.downstream.finetune import (FinetuneConfig,
                                                        FinetuneTask,
                                                        draw_finetune)
    from audiossl_tpu_torch.models.atst import ast_tiny

    enc = ast_tiny(spec_w=1001, device=device,
                   generator=torch.Generator().manual_seed(2))
    cfg = FinetuneConfig(learning_rate=1e-2, max_epochs=1, steps_per_epoch=4,
                         num_labels=5, n_blocks=2, crop_len_s=0.5,
                         mixup=False, specaug=False, rrc=False)
    task = FinetuneTask(enc, cfg, enc.embed_dim * 2 * 2)
    state = task.init_state()
    n = PER_RANK * world().size
    batch = host_batch(8000, 3)
    batch["label"] = np.arange(n, dtype=np.int64) % cfg.num_labels
    draws = draw_finetune(cfg, n, task.rows(n, 8000), enc.depth,
                          torch.Generator().manual_seed(4),
                          np.random.default_rng(4), task.device)
    _, out = task.train_step(state, shard_batch(batch), draws)
    flat = torch.cat([p.detach().reshape(-1) for p in
                      (*state.params.values(), *state.mu.values(),
                       *state.head.buffers())])
    return float(out["loss"]), flat


def sed_check(encoder, device):
    """Check 5's step on this rank's rows (check 1's student encoder, 10
    labels, 1 s clips, rows alternately strong and weak): -> (loss, the
    parameters flattened)."""
    from audiossl_tpu_torch.sed.module import SEDConfig, SEDTask

    task = SEDTask(encoder, SEDConfig(num_labels=10, max_epochs=1,
                                      steps_per_epoch=4, warmup_epochs=0))
    state = task.init_state()
    n = PER_RANK * world().size
    batch = host_batch(16000, 5)
    tokens = task.adapter.token_count(16000)
    rng = np.random.RandomState(6)
    batch["strong"] = (rng.rand(n, tokens, 10) > 0.8).astype(np.float32)
    batch["source"] = np.arange(n, dtype=np.int32) % 2
    dp = task.draw(torch.Generator().manual_seed(7), n)
    _, out = task.train_step(state, shard_batch(batch), dp)
    return float(out["loss"]), torch.cat(
        [p.detach().reshape(-1) for p in state.params.values()])


def main(argv=None):
    p = argparse.ArgumentParser("dryrun")
    p.add_argument("--n_devices", type=int, default=None,
                   help="ranks (default: every visible card; 1 on the CPU)")
    p.add_argument("--device", default="cuda",
                   help="cpu: gloo ranks; cuda: NCCL ranks, one a card")
    run_cli(checks, p.parse_args(argv))


if __name__ == "__main__":
    main()
