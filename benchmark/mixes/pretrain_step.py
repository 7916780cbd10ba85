"""The ATST-Frame pretraining traffic: the recipe's step, closed loop, one
step after another.

Set-up builds one ``FrameMethod`` and its state, copies in the weights the
harness drew, and drives that state through its first three steps on three
batches of distinct clips. Those steps are the warm-up (every shape the
window runs) and what the reference follows: the loss of each, the first
step's teacher frames, each leaf's first gradient (Adam's first moment
after one step over 1 - beta1) and each leaf's change after three, for the
student and the EMA teacher. The same state then runs the window on a pool
of batches and draws.

Traffic keys: ``batch`` (clips a step), ``pool`` (distinct batches the
window cycles through), ``check_steps``, ``profile_steps``.
"""
from __future__ import annotations

import time

import torch

from harness import audio, compare, roofline, trace, weights
from harness.context import (Ctx, Outcome, closed_loop, free, peak_bytes,
                             reset_peak, sync)
from reference import atst as ref


def frame_config(ctx: Ctx):
    from audiossl_tpu_torch.methods.atstframe.method import FramePretrainConfig
    from audiossl_tpu_torch.training.pretrain import OptimizerConfig

    c = ctx.config
    r = c["pretrain"]
    quant = c["control"] if ctx.control else {}
    return FramePretrainConfig(
        arch=c["arch"], anchor_len=c["crop_s"], mask_type=r["mask_type"],
        mask_ratio=r["mask_ratio"], mask_len=r["mask_len"],
        aug_tea=r["aug_teacher"], aug_stu=r["aug_student"],
        mixup_ratio=r["mixup_ratio"], drop_path_rate=r["drop_path_rate"],
        optimizer=OptimizerConfig(
            learning_rate=r["learning_rate"], warmup_steps=r["warmup_steps"],
            max_steps=r["max_steps"], ema=r["ema"]),
        dtype=c["products"], teacher_quant=quant.get("teacher_quant", "none"),
        student_quant=quant.get("student_quant", "none"))


def draw_inputs(gen, c: dict, batch: int, device):
    """One step's clips (int16, as a pack holds them) and every random
    number of the step, as plain tensors."""
    samples = int(c["crop_s"] * 16000)
    wav = audio.to_int16(audio.clips(gen, batch, samples, device))
    valid = torch.full((batch,), samples, device=device, dtype=torch.int64)
    n_tok = (c["n_mels"] // c["patch_freq"]) * (c["crop_frames"]
                                                // c["patch_time"])
    d, r = c["num_layers"], c["pretrain"]

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    draws = {
        "crop": rand(batch),
        "mix": (ref.f32(r["mixup_ratio"]) * rand(batch),
                torch.randint(1, max(batch, 2), (batch,), generator=gen,
                              device=device)),
        "rrc": (rand(batch), rand(batch)),
        "u_round": rand(batch), "u_starts": rand(batch, n_tok),
        "student_dp_u": rand(d, 2, 2 * batch),
        "teacher_dp_u": rand(d, 2, 2 * batch)}
    return {"wav": wav, "valid": valid}, draws


def step_draws(draws: dict, rate: float):
    """The program's draws object from the plain draws."""
    from audiossl_tpu_torch.methods.atstframe.method import StepDraws

    return StepDraws(
        crop=draws["crop"], mix=(None, draws["mix"]), rrc=(None, draws["rrc"]),
        mask={"u_round": draws["u_round"], "u_starts": draws["u_starts"]},
        student_dp=ref.drop_path_keep(draws["student_dp_u"], rate),
        teacher_dp=ref.drop_path_keep(draws["teacher_dp_u"], rate))


def build_state(ctx: Ctx, dev):
    """The program's method, its state at the recipe's ``start_step`` with
    the harness's weights, its step, and those weights."""
    from audiossl_tpu_torch.methods.atstframe.method import FrameMethod

    c = ctx.config
    method = FrameMethod(frame_config(ctx), device=dev, seed=ctx.seed)
    w = weights.draw(weights.frame_branch_shapes(c, predictor=True),
                     ctx.seed, dev)
    weights.load_into(method.student, w)
    state = method.init_state(ctx.seed)
    state.step = c["pretrain"]["start_step"]
    return method, state, method.make_step(), w


def first_steps(state, step, feed, n: int) -> dict:
    """Drives the state through ``n`` steps and reads what the reference
    follows, the first step's teacher frames (its encoder's output) too;
    the snapshots wait on the host, out of the program's memory."""
    s_params = dict(state.student.named_parameters())
    t_params = dict(state.teacher.named_parameters())
    p0 = {k: p.detach().to("cpu", copy=True) for k, p in s_params.items()}
    t0 = {k: p.detach().to("cpu", copy=True) for k, p in t_params.items()}
    frames = []
    hook = state.teacher.encoder.register_forward_hook(
        lambda mod, args, out: frames.append(out[0].detach().float().cpu()))
    losses, g1 = [], None
    for i in range(n):
        m = step(state, *feed[i])
        losses.append(float(m["loss"]))
        if i == 0:  # Adam's first moment after one step: (1 - b1) g
            hook.remove()
            g1 = {k: (state.mu[k] / (1.0 - 0.9)).cpu() for k in s_params
                  if k in state.mu}
    return {"losses": losses, "g1": g1, "t_frames": frames[0],
            "d_student": {k: float((p.detach().cpu() - p0[k]).double().norm())
                          for k, p in s_params.items()},
            "d_teacher": {k: float((p.detach().cpu() - t0[k]).double().norm())
                          for k, p in t_params.items()}}


def bound_context(state) -> dict:
    return {"mel_band": roofline.mel_band(ref.mel_filterbank()),
            "adamw_elements": sum(p.numel() for p in state.leaves),
            "adamw_teacher_elements": sum(
                p.numel() for p in state.teacher_leaves if p is not None)}


def run(ctx: Ctx) -> Outcome:
    c, tr, dev = ctx.config, ctx.traffic, ctx.device
    B = tr["batch"]
    method, state, step, w_student = build_state(ctx, dev)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed + 1)
    pool = [draw_inputs(gen, c, B, dev) for _ in range(tr["pool"])]
    rate = c["pretrain"]["drop_path_rate"]
    feed = [(b, step_draws(d, rate)) for b, d in pool]
    readings = first_steps(state, step, feed, tr["check_steps"])
    sync(dev)
    setup_s = time.perf_counter() - ctx.t0

    loss_t = []

    def one(i):
        loss_t.append(step(state, *feed[i % len(feed)])["loss"])

    out = Outcome(setup_s=setup_s, attempted=0, failed=0, e2e={},
                  memory_peak_bytes=0, numbers={})
    reset_peak(dev)
    n, secs = closed_loop(one, ctx.seconds, dev)
    out.attempted = n
    out.failed = int((~torch.isfinite(torch.stack(loss_t))).sum())
    if ctx.trace:
        out.unit_s = secs / n
        out.unit_flops = roofline.frame_pretrain_step_flops(c, B)
        out.peak_flops = roofline.PEAK_FLOPS[c["peak"]]
        k = [0]

        def traced():
            one(k[0])
            k[0] += 1

        out.traces = [trace.profile_units(traced, tr["profile_steps"])]
        out.bound_ctx = bound_context(state)
    else:
        out.e2e["train_clips_per_s"] = n * B / secs
    out.memory_peak_bytes = peak_bytes(dev)
    inputs = [pool[i] for i in range(tr["check_steps"])]
    del state, method, step, feed, pool, loss_t
    free(dev)
    out.numbers = reference_numbers(ctx, w_student, inputs, readings)
    return out


def reference_numbers(ctx, w_student, inputs, readings):
    """The reference's first steps from the same weights and inputs, and
    the gaps the program's readings (:func:`first_steps`) show against
    them."""
    c, r = ctx.config, ctx.config["pretrain"]
    losses, g1 = readings["losses"], readings["g1"]
    d_student, d_teacher = readings["d_student"], readings["d_teacher"]
    with ref.strict_f32():
        Ps = {k: v.clone().requires_grad_(True) for k, v in w_student.items()}
        Pt = {k: v.detach().clone() for k, v in w_student.items()
              if not k.startswith("head.predictor.")}
        p_init = {k: v.detach().clone() for k, v in Ps.items()}
        t_init = {k: v.clone() for k, v in Pt.items()}
        mu = {k: torch.zeros_like(v) for k, v in Ps.items()}
        nu = {k: torch.zeros_like(v) for k, v in Ps.items()}
        r_losses, r_g1 = [], None
        for i, (b, d) in enumerate(inputs):
            s = r["start_step"] + i
            loss, grads, t_frames = ref.frame_loss_and_grads(
                Ps, Pt, b["wav"], b["valid"], d, c["num_heads"],
                c["num_layers"], r["drop_path_rate"])
            r_losses.append(float(loss.detach()))
            if i == 0:
                r_frames = t_frames.cpu()
                r_g1 = compare.leaf_norms(grads)
                r_g1t = {k: g.cpu() for k, g in grads.items()}
            with torch.no_grad():
                ref.adamw_ema(
                    {k: v.data for k, v in Ps.items()}, grads, mu, nu, Pt,
                    i + 1, ref.cosine(r["learning_rate"], 1e-6, r["max_steps"],
                                      r["warmup_steps"], s),
                    ref.cosine(0.04, 0.4, r["max_steps"], 0, s),
                    ref.cosine(r["ema"], 1.0, r["max_steps"], 0, s))
        r_ds = {k: float((Ps[k].detach() - p_init[k]).double().norm())
                for k in Ps}
        r_dt = {k: float((Pt[k] - t_init[k]).double().norm()) for k in Pt}
    moving = compare.moving_leaves(r_g1)
    t_moving = [k for k in moving if k in r_dt]
    g1n = compare.leaf_norms(g1)
    got = readings["t_frames"].double()
    B = got.shape[0] // 2  # the rows of each view this process ran
    G = r_frames.shape[0] // 2
    want = torch.cat([r_frames[:B], r_frames[G:G + B]]).double()
    diffs = compare.leaf_diffs(g1, r_g1t, moving)
    return {
        "loss_gap": compare.loss_gap(losses, r_losses),
        "grad_gap": compare.worst_leaf_gap(g1n, r_g1, moving)[0],
        "grad_diff": compare.median(diffs),
        "teacher_diff": float((got - want).norm() / want.norm()),
        "change_gap": compare.worst_leaf_gap(d_student, r_ds, moving)[0],
        "ema_gap": compare.worst_leaf_gap(d_teacher, r_dt, t_moving)[0]}
