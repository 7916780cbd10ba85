"""Plain float32 PyTorch reference of the ATST encoders, their front end and
the ATST-Frame pretraining step and ATST-Clip finetuning step.

Written from the published methods (Li et al., TASLP 2024, arXiv:2306.04186;
Li & Li, Interspeech 2022, arXiv:2204.12076) and the reference code's
semantics (torchaudio MelSpectrogram + AmplitudeToDB(top_db=80) + MinMax, a
pre-norm ViT with the additive -10000 key mask, BYOL heads with a masked
BatchNorm, the symmetric frame BYOL loss, AdamW with decoupled weight decay
and an EMA teacher, SGD with momentum and layer-wise LR decay). It imports
nothing of the measured package: every tensor it needs (weights, waveforms,
draws) is handed in as plain tensors by name, and it works out again every
derived quantity (mel, masks, augmentations, drop-path multipliers).

Precision: float32 everywhere, with TF32 off (:func:`strict_f32`). Exact-erf
GELU (``F.gelu``), two-pass LayerNorm (``F.layer_norm``) and
``torch.stft``: the published operators, not the measured program's
approximations of them.
"""
from __future__ import annotations

import contextlib
import math
import re

import numpy as np
import torch
import torch.nn.functional as F

MASK_VALUE = -10000.0  # the reference's additive key mask
MEL_MIN, MEL_MAX = -79.6482, 50.6842  # the recipe's MinMax
EPS32 = float(torch.finfo(torch.float32).eps)


@contextlib.contextmanager
def strict_f32():
    """float32 products with TF32 off, whatever was set before."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def f32(v: float) -> float:
    return float(np.float32(v))


# ------------------------------------------------------------------ front end
def mel_filterbank(n_freqs=513, f_min=60.0, f_max=7800.0, n_mels=64,
                   sr=16000) -> np.ndarray:
    """torchaudio ``melscale_fbanks`` (HTK scale, no norm): [n_freqs, n_mels]."""
    def hz2mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel2hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    f_pts = mel2hz(np.linspace(hz2mel(f_min), hz2mel(f_max), n_mels + 2))
    diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / diff[:-1]
    up = slopes[:, 2:] / diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def log_mel(wav: torch.Tensor, valid: torch.Tensor, n_fft=1024, hop=160,
            top_db=80.0, amin=1e-10) -> torch.Tensor:
    """Per clip, the mel of its first ``valid`` samples as torchaudio computes
    it on the exact-length clip (centred frames, reflect padding, periodic
    Hann, power 2, HTK mel, dB, top-dB over the clip, MinMax to [-1, 1]);
    [B, 64, 1 + L // hop], the frames past a clip's own count set to -1."""
    B, L = wav.shape
    T = 1 + L // hop
    fb = torch.from_numpy(mel_filterbank()).to(wav.device)
    out = wav.new_full((B, fb.shape[1], T), -1.0)
    win = torch.hann_window(n_fft, periodic=True, device=wav.device)
    for n in torch.unique(valid).tolist():
        rows = (valid == n).nonzero().flatten()
        spec = torch.stft(wav[rows, :n].float(), n_fft, hop, n_fft, win,
                          center=True, pad_mode="reflect", return_complex=True)
        power = spec.real ** 2 + spec.imag ** 2  # [b, 513, t]
        mel = torch.einsum("bft,fm->bmt", power, fb)
        db = 10.0 * torch.log10(torch.clamp(mel, min=amin))
        db = torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - top_db)
        db = (db - MEL_MIN) / (MEL_MAX - MEL_MIN) * 2.0 - 1.0
        out[rows, :, :db.shape[-1]] = db
    return out


# -------------------------------------------------------------- augmentation
def uniform(u, lo, hi):
    lo, hi = f32(lo), f32(hi)
    return torch.clamp(u * f32(hi - lo) + lo, min=lo)


def mixup_log(spec, a, shift):
    """BYOL-A log-mixup-exp with the in-batch partner (i + shift) % B."""
    B = spec.shape[0]
    z = spec[(torch.arange(B, device=spec.device) + shift) % B]
    a = a[:, None, None]
    return torch.log((1.0 - a) * torch.exp(spec) + a * torch.exp(z) + EPS32)


def _keys(t):
    """Keys cubic-convolution weights (A = -0.75) at offsets -1, 0, 1, 2."""
    A = -0.75

    def k01(x):
        return ((A + 2.0) * x - (A + 3.0)) * x * x + 1.0

    def k12(x):
        return ((A * x - 5.0 * A) * x + 8.0 * A) * x - 4.0 * A

    return torch.stack([k12(t + 1.0), k01(t), k01(1.0 - t), k12(2.0 - t)], -1)


def freq_warp(spec, h_u, iy_u, scale=(0.6, 1.5)):
    """BYOL-A RandomResizeCrop with no virtual canvas and no time change: a
    band of height U(scale) * F at a random row, bicubically resized to F
    rows (align_corners, taps clamped to the band)."""
    B, Fq, T = spec.shape
    h = torch.clamp((uniform(h_u, *scale) * float(Fq)).int(), 1, Fq)
    iy = (iy_u * (Fq - h + 1).float()).int()
    j = torch.arange(Fq, device=spec.device, dtype=torch.float32)[None, :]
    ys = iy[:, None].float() + j * ((h.float() - 1.0) / max(Fq - 1, 1))[:, None]
    fy = torch.floor(ys)
    w = _keys(ys - fy)
    lo, hi = iy.long()[:, None], (iy + h - 1).long()[:, None]
    out = 0.0
    for m, off in enumerate((-1, 0, 1, 2)):
        idx = torch.minimum(torch.maximum(fy.long() + off, lo), hi)
        out = out + torch.gather(spec, 1, idx[:, :, None].expand(B, Fq, T)) \
            * w[:, :, m][:, :, None]
    return out


def block_mask(u_round, u_starts, valid, ratio=0.65, span=5, min_masks=2):
    """fairseq static block masking (span ``span``, the span count rounded at
    random, starts drawn without replacement in [0, valid - span) with the
    short-sequence fallback, clipped at the valid length) -> [B, T] bool."""
    B, T = u_starts.shape
    dev = u_starts.device
    valid = valid.long()
    K = max(min_masks, int(ratio * T / span) + 1)
    n_spans = torch.clamp(torch.floor(ratio * valid.float() / span + u_round)
                          .long(), min=min_masks)
    hi = valid - span
    hi = torch.clamp(torch.where(hi <= n_spans, n_spans + 1, hi), 1, T)
    pos = torch.arange(T, device=dev)[None, :]
    u = torch.where(pos < hi[:, None], u_starts, 2.0)
    starts = torch.minimum(torch.argsort(u, dim=-1, stable=True)[:, :K],
                           hi[:, None] - 1)
    active = torch.arange(K, device=dev)[None, :] < n_spans[:, None]
    s = starts[:, :, None]
    tok = pos[:, None, :]
    m = ((tok >= s) & (tok < s + torch.where(active, span, 0)[:, :, None])
         ).any(1)
    return m & (pos < valid[:, None])


def drop_path_keep(u, rate):
    """Stochastic-depth keep multipliers floor(keep + u) / keep from uniforms
    u [depth, ...], the rate ramped linearly over depth."""
    depth = u.shape[0]
    keep = torch.tensor([1.0 - rate * i / max(depth - 1, 1)
                         for i in range(depth)], device=u.device)
    keep = keep.reshape((depth,) + (1,) * (u.ndim - 1))
    return torch.floor(keep + u) / keep


# ------------------------------------------------------------------ encoder
def patchify(mel, ph=64, pw=4):
    """[B, F, T] -> [B, (w h), ph * pw]: tokens time-major, features
    frequency-major within a patch ('b (h p1) (w p2) -> b (w h) (p1 p2)')."""
    B, Fq, T = mel.shape
    h, w = Fq // ph, T // pw
    x = mel[:, :h * ph, :w * pw].reshape(B, h, ph, w, pw)
    return x.permute(0, 3, 1, 2, 4).reshape(B, w * h, ph * pw)


def block(P, i, x, key_mask, heads, dp1=None, dp2=None, eps=1e-6):
    pre = f"blocks.{i}."
    B, N, C = x.shape
    d = C // heads
    h = F.layer_norm(x, (C,), P[pre + "norm1.weight"], P[pre + "norm1.bias"],
                     eps)
    qkv = F.linear(h, P[pre + "attn.qkv.weight"], P.get(pre + "attn.qkv.bias"))
    q, k, v = qkv.reshape(B, N, 3, heads, d).unbind(2)
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * d ** -0.5
    if key_mask is not None:
        s = s + key_mask
    o = torch.einsum("bhnm,bmhd->bnhd", s.softmax(-1), v).reshape(B, N, C)
    a = F.linear(o, P[pre + "attn.proj.weight"], P[pre + "attn.proj.bias"])
    x = x + (a if dp1 is None else a * dp1[:, None, None])
    h = F.layer_norm(x, (C,), P[pre + "norm2.weight"], P[pre + "norm2.bias"],
                     eps)
    m = F.linear(F.gelu(F.linear(h, P[pre + "mlp.fc1.weight"],
                                 P[pre + "mlp.fc1.bias"])),
                 P[pre + "mlp.fc2.weight"], P[pre + "mlp.fc2.bias"])
    return x + (m if dp2 is None else m * dp2[:, None, None])


def encode(P, mel, frames, heads, depth, cls=False, token_mask=None,
           dps=None, collect_from=None, checkpoint=False):
    """The encoder over mel [B, F, T] with frame counts [B]: the patch
    projection, masked tokens replaced by ``mask_embed``, a CLS token first
    (``cls``), the position embeddings, the blocks with the key mask of the
    valid tokens and drop path (``dps`` [depth, 2, B] multipliers). Returns
    (last block output, the outputs of blocks >= collect_from, valid token
    counts with the CLS token)."""
    x = F.linear(patchify(mel), P["patch_embed.patch_embed.weight"],
                 P["patch_embed.patch_embed.bias"])
    B, Np, C = x.shape
    if token_mask is not None:
        m = token_mask[:, :, None].float()
        x = (1.0 - m) * x + m * P["mask_embed"]
    pos = P["pos_embed"][:, :Np + 1]
    if cls:
        x = torch.cat([P["cls_token"].expand(B, 1, C), x], 1) + pos
    else:
        x = x + pos[:, 1:]
    n_valid = (mel.shape[1] // 64) * torch.div(frames, 4, rounding_mode="floor")
    n_valid = n_valid + (1 if cls else 0)
    key_mask = ((torch.arange(x.shape[1], device=x.device)[None, :]
                 >= n_valid[:, None]).float() * MASK_VALUE)[:, None, None, :]
    out = []
    for i in range(depth):
        dp1, dp2 = (None, None) if dps is None else (dps[i, 0], dps[i, 1])
        if checkpoint:
            x = torch.utils.checkpoint.checkpoint(
                block, P, i, x, key_mask, heads, dp1, dp2, use_reentrant=False)
        else:
            x = block(P, i, x, key_mask, heads, dp1, dp2)
        if collect_from is not None and i >= collect_from:
            out.append(x)
    return x, out, n_valid


def layer_norm(P, name, x, eps=1e-6):
    return F.layer_norm(x, (x.shape[-1],), P[name + ".weight"],
                        P[name + ".bias"], eps)


# ------------------------------------------------------------- frame method
def masked_bn(P, name, x, mask, eps=1e-5):
    """BatchNorm1d in training mode over the rows ``mask`` selects (biased
    variance), with its scale and bias."""
    w = mask.float()[..., None]
    axes = tuple(range(x.ndim - 1))
    n = w.sum()
    mean = (x * w).sum(axes) / n
    var = (((x - mean) ** 2) * w).sum(axes) / n
    return (x - mean) / torch.sqrt(var + eps) * P[name + ".weight"] \
        + P[name + ".bias"]


def mlp_head(P, name, x, mask):
    h = F.linear(x, P[name + ".fc0.weight"])
    h = torch.relu(masked_bn(P, name + ".bn0", h, mask))
    return F.linear(h, P[name + ".fc1.weight"])


def pair_loss(p, z, mask):
    cos = (F.normalize(p, dim=-1, eps=1e-12)
           * F.normalize(z, dim=-1, eps=1e-12)).sum(-1)
    w = mask.float()
    return 2.0 - 2.0 * (cos * w).sum() / torch.clamp(w.sum(), min=1.0)


def frame_views(wav, valid, draws):
    """The teacher's and the student's mel of one 10 s crop: the crop (the
    clip whole, as every clip fills the crop), its mel, then for the student
    view log-mixup-exp and the freq warp. -> (mel [2B, F, T], frames [2B],
    token mask [2B, Np])."""
    B, L = wav.shape
    if wav.dtype == torch.int16:  # a pack's samples
        wav = wav.float() * (1.0 / 32768.0)
    crop_valid = torch.minimum(valid.long(), torch.full_like(valid.long(), L))
    mel = log_mel(wav.float(), crop_valid)
    frames = crop_valid // 160 + 1
    a, shift = draws["mix"]
    stu = freq_warp(mixup_log(mel, a, shift), *draws["rrc"])
    mask = block_mask(draws["u_round"], draws["u_starts"],
                      torch.div(frames, 4, rounding_mode="floor"))
    return (torch.cat([mel, stu]), torch.cat([frames, frames]),
            torch.cat([mask, mask]))


def frame_loss_and_grads(Ps, Pt, wav, valid, draws, heads, depth,
                         rate=0.1, block=288):
    """The symmetric frame BYOL loss of one step, its gradient with respect
    to every student leaf, and the teacher's frames (its encoder's normed
    output) [2B, Np, D]: the student (with its predictor) on both
    views with the masked tokens replaced, the teacher on both views whole,
    each student view against the other view's teacher output over the
    masked valid frames. The encoders run ``block`` sequences at a time (a
    sequence's encoder output depends on no other); the heads, whose
    BatchNorm statistics span every row, run on all rows at once. The
    student's gradient comes in two passes: the heads' and the loss's down
    to the encoder's output, then each block of sequences' through the
    encoder, recomputed with autograd."""
    mel, frames, mask = frame_views(wav, valid, draws)
    dps = drop_path_keep(draws["student_dp_u"], rate)
    dpt = drop_path_keep(draws["teacher_dp_u"], rate)
    enc_s = {k[8:]: v for k, v in Ps.items() if k.startswith("encoder.")}
    enc_t = {k[8:]: v for k, v in Pt.items() if k.startswith("encoder.")}
    S = mel.shape[0]
    blocks = [slice(i, min(i + block, S)) for i in range(0, S, block)]

    def student_blocks(b):
        return encode(enc_s, mel[b], frames[b], heads, depth,
                      token_mask=mask[b], dps=dps[:, :, b], checkpoint=True)

    with torch.no_grad():
        y = torch.cat([encode(enc_t, mel[b], frames[b], heads, depth,
                              dps=dpt[:, :, b])[0] for b in blocks])
        nv = (mel.shape[1] // 64) * torch.div(frames, 4, rounding_mode="floor")
        Np = y.shape[1]
        sel = mask & (torch.arange(Np, device=y.device)[None, :] < nv[:, None])
        y = layer_norm(enc_t, "norm_frame", y)
        t_out = mlp_head(Pt, "head.projector", y, sel)
        x = torch.cat([student_blocks(b)[0] for b in blocks])
    x.requires_grad_(True)

    def heads_of(z):
        z = layer_norm(enc_s, "norm_frame", z)
        return mlp_head(Ps, "head.predictor",
                        mlp_head(Ps, "head.projector", z, sel), sel)

    s_out = torch.utils.checkpoint.checkpoint(heads_of, x,
                                              use_reentrant=False)
    s_v, t_v, m_v = s_out.chunk(2), t_out.chunk(2), sel.chunk(2)
    loss = (pair_loss(s_v[1], t_v[0], m_v[1])
            + pair_loss(s_v[0], t_v[1], m_v[0])) / 2.0
    top = [k for k in Ps if not k.startswith("encoder.")
           or k.startswith("encoder.norm_frame.")]
    g = torch.autograd.grad(loss, [x] + [Ps[k] for k in top],
                            allow_unused=True)
    dx = g[0]
    grads = {k: v for k, v in zip(top, g[1:])}
    deep = [k for k in Ps if k not in grads]
    acc = {k: torch.zeros_like(Ps[k]) for k in deep}
    for b in blocks:
        xb = student_blocks(b)[0]
        gb = torch.autograd.grad(xb, [Ps[k] for k in deep], grad_outputs=dx[b],
                                 allow_unused=True)
        for k, v in zip(deep, gb):
            if v is not None:
                acc[k] += v
    grads.update(acc)
    return loss.detach(), {k: torch.zeros_like(Ps[k]) if grads[k] is None
                           else grads[k] for k in Ps}, y


def cosine(base, final, max_steps, warmup, step):
    """Linear warm-up from 0, then cosine from ``base`` to ``final``."""
    if step < warmup:
        return step * (base / (warmup - 1)) if warmup > 1 else base
    decay = max_steps - warmup
    i = min(max(step - warmup, 0), max(decay - 1, 1))
    return final + 0.5 * (base - final) * (1.0 + math.cos(math.pi * i / decay))


@torch.no_grad()
def adamw_ema(Ps, grads, mu, nu, Pt, count, lr, wd, m, b1=0.9, b2=0.999,
              eps=1e-6):
    """AdamW (bias-corrected moments of the incremented ``count``, decoupled
    weight decay on leaves of two or more dimensions), then the teacher's
    copy of each leaf it holds moved to m t + (1 - m) p."""
    f = np.float32
    rc1 = float(f(1.0) / (f(1.0) - f(b1) ** f(count)))
    rc2 = float(f(1.0) / (f(1.0) - f(b2) ** f(count)))
    for k, p in Ps.items():
        g = grads[k]
        mu[k].mul_(f32(b1)).add_(g * f32(1.0 - b1))
        nu[k].mul_(f32(b2)).add_((g * g) * f32(1.0 - b2))
        u = (mu[k] * rc1) / (torch.sqrt(nu[k] * rc2) + f32(eps))
        if p.ndim >= 2:
            u = u + p * f32(wd)
        p.sub_(u * f32(lr))
        if k in Pt:
            Pt[k].mul_(f32(m)).add_(p * float(f(1.0) - f(m)))


# --------------------------------------------------------------- finetuning
def clip_scene_layers(P, mel, frames, heads, depth, n_blocks, chunk_len,
                      dps=None):
    """The clip encoder's chunked downstream features: the mel cut into
    ``T // chunk_len + 1`` chunks, each encoded with its own (unclamped)
    frame count, per block of the last ``n_blocks`` the final norm's CLS row
    and the mean of the first valid patches, averaged over the chunks that
    hold audio -> [B, 2 * n_blocks * D] (the CLS rows, then the means)."""
    B, Fq, T = mel.shape
    nc = T // chunk_len + 1
    melp = F.pad(mel, (0, nc * chunk_len - T))
    chunks = melp.reshape(B, Fq, nc, chunk_len).permute(0, 2, 1, 3).reshape(
        B * nc, Fq, chunk_len)
    ks = torch.arange(nc, device=mel.device)
    cur = torch.clamp(frames[:, None] - ks[None, :] * chunk_len, min=0)
    mark = torch.where(ks[None, :] == 0, cur > 0, cur > chunk_len // 2)
    _, outs, nv = encode(P, chunks, cur.reshape(-1), heads, depth, cls=True,
                         dps=dps, collect_from=depth - n_blocks,
                         checkpoint=True)
    plen = nv - 1
    cls_l, avg_l = [], []
    for h in outs:
        hn = layer_norm(P, "norm", h)
        cls_l.append(hn[:, 0])
        body = hn[:, 1:]
        keep = (torch.arange(body.shape[1], device=h.device)[None, :]
                < plen[:, None]).float()
        avg_l.append((body * keep[:, :, None]).sum(1) / (plen[:, None] + 1e-6))
    w = mark.float()[None, :, :, None]
    feats = []
    for t in (torch.stack(cls_l), torch.stack(avg_l)):
        t = (t.reshape(n_blocks, B, nc, -1) * w).sum(2) / w.sum(2)
        feats.append(torch.cat(list(t), -1))
    return torch.cat(feats, -1)


def central_crop(wav, valid, crop):
    B, L = wav.shape
    width = min(crop, L)
    start = torch.clamp(torch.clamp((valid - crop) // 2, min=0),
                        max=max(L - crop, 0))
    pos = torch.arange(width, device=wav.device)
    out = torch.gather(wav, 1, start[:, None] + pos[None, :])
    cv = torch.clamp(valid, max=crop)
    return torch.where(pos[None, :] < cv[:, None], out, 0.0), cv


def finetune_loss(P, wav, valid, label, draws, cfg):
    """The AudioSet finetuning loss of one step: the central crop and its
    mel, label mixup (each clip with the clip ``shift`` rows before it, by
    its Beta weight), the chunked clip features with drop path, the linear
    head (BatchNorm without scale in training mode, then the Linear), the
    sigmoid BCE summed over labels and averaged over the batch."""
    crop, cv = central_crop(wav.float(), valid.long(),
                            int(cfg["crop_s"] * 16000))
    with torch.no_grad():
        mel = log_mel(crop, cv)
        frames = cv // 160 + 1
        lam, shift = draws["lam"], draws["shift"]
        l3 = lam[:, None, None]
        mel = torch.log(l3 * torch.exp(mel) + (1 - l3)
                        * torch.exp(torch.roll(mel, shift, 0)) + 1e-7)
        y = lam[:, None] * label + (1 - lam[:, None]) * torch.roll(label,
                                                                   shift, 0)
    dps = drop_path_keep(draws["dp_u"], cfg["drop_path_rate"])
    enc = {k[8:]: v for k, v in P.items() if k.startswith("encoder.")}
    feat = clip_scene_layers(enc, mel, frames, cfg["heads"], cfg["depth"],
                             cfg["n_blocks"], cfg["chunk_len"], dps)
    mean = feat.mean(0)
    var = ((feat - mean) ** 2).mean(0)
    z = (feat - mean) / torch.sqrt(var + 1e-5)
    logits = F.linear(z, P["head.linear.weight"], P["head.linear.bias"])
    return F.binary_cross_entropy_with_logits(
        logits, y, reduction="none").sum(-1).mean()


def layer_decay(name, depth, decay):
    """LR multiplier of a parameter: block i decay**(depth - i), the patch,
    position, CLS and mask embeddings decay**depth, the final norm decay,
    the head 1."""
    m = re.match(r"encoder\.blocks\.(\d+)\.", name)
    if m:
        return decay ** (depth - int(m.group(1)))
    first = name.split(".")[1] if name.startswith("encoder.") else ""
    if first in ("patch_embed", "pos_embed", "cls_token", "mask_embed"):
        return decay ** depth
    if first == "norm":
        return decay
    return 1.0


@torch.no_grad()
def sgd_clipped(P, grads, mu, lr, cfg):
    """The gradient clipped to a global norm, then the momentum trace
    mu = g + momentum mu, times each parameter's layer-decay factor, times
    the learning rate, taken off the parameter."""
    gnorm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    scale = torch.clamp(cfg["grad_clip"] / (gnorm + 1e-6), max=1.0)
    for k, p in P.items():
        u = mu[k].mul_(cfg["momentum"]).add_(grads[k] * scale).clone()
        u.mul_(layer_decay(k, cfg["depth"], cfg["layer_decay"]))
        p.sub_(u * lr)
    return gnorm


# ---------------------------------------------------------------- embedding
@torch.no_grad()
def scene_embedding(P, wav, heads, depth, n_blocks=12, chunk=1001):
    """The frame encoder's scene embedding of waveforms [B, L] (every sample
    valid): the mel cut into 1001-frame chunks, per chunk and per block of
    the last ``n_blocks`` the final norm's mean over the valid tokens, the
    blocks concatenated, averaged over the chunks that hold audio."""
    B, L = wav.shape
    mel = log_mel(wav.float(), torch.full((B,), L, device=wav.device))
    T = mel.shape[-1]
    nc = max((T + chunk - 1) // chunk, 1)
    melp = F.pad(mel, (0, nc * chunk - T))
    chunks = melp.reshape(B, 64, nc, chunk).permute(0, 2, 1, 3).reshape(
        B * nc, 64, chunk)
    ks = torch.arange(nc, device=wav.device)
    cur = torch.clamp(torch.full((B, 1), T, device=wav.device)
                      - ks[None, :] * chunk, min=0)
    has = cur > 0
    _, outs, nv = encode(P, chunks, torch.clamp(cur.reshape(-1), max=chunk),
                         heads, depth, collect_from=depth - n_blocks)
    feats = []
    for h in outs:
        hn = layer_norm(P, "norm_frame", h)
        keep = (torch.arange(hn.shape[1], device=h.device)[None, :]
                < nv[:, None]).float()
        feats.append((hn * keep[:, :, None]).sum(1) / (nv[:, None] + 1e-6))
    emb = torch.cat(feats, -1).reshape(B, nc, -1)
    w = has.float()[:, :, None]
    return (emb * w).sum(1) / torch.clamp(w.sum(1), min=1.0)
