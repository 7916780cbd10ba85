"""The weights and inputs of a run, made on the device from ``--seed``.

Parameter names and shapes come from the configuration file (the published
widths), not from the measured program: the harness then checks that the
program holds exactly these parameters before it copies the values in.
Values are drawn with one ``torch.Generator`` on the device in one large
call per run: truncated normals (std 0.02) for the encoder's embeddings and
products, LeCun normals for the BYOL heads, N(0, 0.01) for a linear head,
unit norms and zero biases.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

Shapes = Dict[str, Tuple[int, ...]]


def encoder_shapes(cfg: dict, cls: bool) -> Shapes:
    D, M, depth = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_layers"]
    P = cfg["patch_freq"] * cfg["patch_time"]
    n_pos = (cfg["n_mels"] // cfg["patch_freq"]) * (cfg["pos_frames"]
                                                    // cfg["patch_time"]) + 1
    s = {"pos_embed": (1, n_pos, D), "mask_embed": (1, 1, D)}
    if cls:
        s["cls_token"] = (1, 1, D)
    s["patch_embed.patch_embed.weight"] = (D, P)
    s["patch_embed.patch_embed.bias"] = (D,)
    for i in range(depth):
        b = f"blocks.{i}."
        s.update({b + "norm1.weight": (D,), b + "norm1.bias": (D,),
                  b + "attn.qkv.weight": (3 * D, D)})
        if cfg.get("qkv_bias"):
            s[b + "attn.qkv.bias"] = (3 * D,)
        s.update({b + "attn.proj.weight": (D, D), b + "attn.proj.bias": (D,),
                  b + "norm2.weight": (D,), b + "norm2.bias": (D,),
                  b + "mlp.fc1.weight": (M, D), b + "mlp.fc1.bias": (M,),
                  b + "mlp.fc2.weight": (D, M), b + "mlp.fc2.bias": (D,)})
    norm = "norm" if cls else "norm_frame"
    s[norm + ".weight"] = (D,)
    s[norm + ".bias"] = (D,)
    return s


def mlp_head_shapes(prefix: str, d_in: int, hidden: int, out: int) -> Shapes:
    return {prefix + ".fc0.weight": (hidden, d_in),
            prefix + ".bn0.weight": (hidden,), prefix + ".bn0.bias": (hidden,),
            prefix + ".fc1.weight": (out, hidden)}


def frame_branch_shapes(cfg: dict, predictor: bool) -> Shapes:
    s = {"encoder." + k: v for k, v in encoder_shapes(cfg, cls=False).items()}
    hid, out = cfg["head_hidden"], cfg["head_out"]
    s.update(mlp_head_shapes("head.projector", cfg["hidden_size"], hid, out))
    if predictor:
        s.update(mlp_head_shapes("head.predictor", out, hid, out))
    return s


def init_kind(name: str) -> str:
    """'one', 'zero', 'tn' (truncated normal 0.02), 'lecun' or 'probe'."""
    last = name.rsplit(".", 1)[-1]
    if name.startswith("head.linear."):
        return "probe" if last == "weight" else "zero"
    if ".bn0." in name or "norm" in name.rsplit(".", 2)[-2:][0]:
        return "one" if last == "weight" else "zero"
    if last == "bias":
        return "zero"
    if name.startswith("head."):
        return "lecun"
    return "tn"


def draw(shapes: Shapes, seed: int, device, round_bf16: bool = False
         ) -> Dict[str, torch.Tensor]:
    """The parameters ``shapes`` from ``seed``: one normal draw on the device
    for every non-constant one, folded into two standard deviations."""
    gen = torch.Generator(device=device).manual_seed(seed)
    drawn = [k for k in shapes if init_kind(k) in ("tn", "lecun", "probe")]
    sizes = [int(torch.Size(shapes[k]).numel()) for k in drawn]
    z = torch.fmod(torch.randn(sum(sizes), generator=gen, device=device), 2.0)
    out, off = {}, 0
    for k, n in zip(drawn, sizes):
        kind = init_kind(k)
        if kind == "tn":
            std = 0.02
        elif kind == "lecun":
            std = (1.0 / shapes[k][1]) ** 0.5 / 0.87962566103423978
        else:
            std = 0.01
        out[k] = (z[off:off + n] * std).reshape(shapes[k])
        off += n
    for k in shapes:
        if k not in out:
            fill = 1.0 if init_kind(k) == "one" else 0.0
            out[k] = torch.full(shapes[k], fill, device=device)
    if round_bf16:
        out = {k: v.to(torch.bfloat16).float() for k, v in out.items()}
    return {k: out[k].contiguous() for k in shapes}


@torch.no_grad()
def load_into(module: torch.nn.Module, values: Dict[str, torch.Tensor]) -> None:
    """Copies ``values`` into ``module``'s parameters, which must be exactly
    these names and shapes."""
    have = dict(module.named_parameters())
    if set(values) != set(have):
        raise RuntimeError(
            "the program's parameters differ from the configuration's: "
            f"missing {sorted(set(values) - set(have))[:5]}, extra "
            f"{sorted(set(have) - set(values))[:5]}")
    for k, p in have.items():
        if tuple(p.shape) != tuple(values[k].shape):
            raise RuntimeError(f"{k}: the program holds {tuple(p.shape)}, the "
                               f"configuration {tuple(values[k].shape)}")
        p.copy_(values[k])
