"""The ATST-Frame audio transformer encoder (PyTorch port).

Port of the frame-level configuration of ``audiossl_tpu/models/atst.py``
(reference ``audiossl/methods/atstframe/audio_transformer.py`` FrameAST):
no CLS token, no prompt tokens, no block averaging, "cut" position
embeddings. Parameter names are the reference's, so a reference state
dict loads with ``load_state_dict``.

``fused=True`` runs the blocks through the inference block kernels
(``ops/block_infer.py``) with the four matmul weights of every block
held in bf16; ``fused=False`` runs the module path in the weights'
dtype (f32) with the additive -10000 mask.

The pretraining forward (:meth:`AudioTransformer.forward`) keeps f32
master weights and computes in ``dtype``: a student
(``fused_attention=True``) runs each block as the trainable attention and
MLP kernels K4/K5 (``ops/attn_train.py``, ``ops/mlp_train.py``), a
no-grad teacher (``fused_infer=True``) as the inference block kernels
K2/K3 with the weights cast per call; with neither, the module path with
the -10000 mask and autograd. ``plain=True`` runs the kernels' plain
versions on any device.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from audiossl_tpu_torch.models.transformer import (
    Block,
    _layer_norm,
    _linear,
    length_to_attn_mask,
    length_to_token_mask,
)


def num_patches(spec_h, spec_w, patch_h, patch_w):
    return (spec_h // patch_h) * (spec_w // patch_w)


def patchify(mel: torch.Tensor, patch_h: int, patch_w: int) -> torch.Tensor:
    """[B, F, T] -> [B, (w h), patch_h*patch_w] matching the reference
    einops pattern 'b c (h p1) (w p2) -> b (w h) (p1 p2 c)' (channel=1):
    tokens run time-major, features freq-major within a patch."""
    B, F, T = mel.shape
    H = F - F % patch_h
    W = T - T % patch_w
    h, w = H // patch_h, W // patch_w
    x = mel[:, :H, :W].reshape(B, h, patch_h, w, patch_w)
    return x.permute(0, 3, 1, 2, 4).reshape(B, w * h, patch_h * patch_w)


def patch_lengths(length: torch.Tensor, spec_h: int, patch_h: int,
                  patch_w: int) -> torch.Tensor:
    """Frame counts [B] -> valid patch counts [B]
    (reference PatchEmbed_v2: (h//ph) * ((len - len%pw)//pw))."""
    return (spec_h // patch_h) * torch.div(length, patch_w,
                                           rounding_mode="floor")


class PatchEmbed(nn.Module):
    """Holds the reference PatchEmbed_v2's Linear under its state-dict name
    ``patch_embed.patch_embed``; :func:`patchify` cuts the patches."""

    def __init__(self, patch_h: int, patch_w: int, embed_dim: int,
                 device=None):
        super().__init__()
        self.patch_embed = nn.Linear(patch_h * patch_w, embed_dim,
                                     device=device)


class AudioTransformer(nn.Module):
    def __init__(self, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, patch_h: int = 64, patch_w: int = 4,
                 spec_h: int = 64, spec_w: int = 1001, qkv_bias: bool = False,
                 mlp_ratio: float = 4.0, eps: float = 1e-6,
                 fused: bool = False, device="cpu",
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32,
                 fused_attention: bool = False, fused_infer: bool = False,
                 plain: bool = False):
        """Parameters are drawn on the CPU from ``generator`` (seed 0 when
        None) as the reference initializes them, then moved to
        ``device``. ``dtype``, ``fused_attention``, ``fused_infer`` and
        ``plain`` configure the pretraining forward (module docstring)."""
        super().__init__()
        self.dtype = dtype
        self.fused_attention = fused_attention
        self.fused_infer = fused_infer
        self.plain = plain
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.patch_h = patch_h
        self.patch_w = patch_w
        self.eps = eps
        self.fused = fused
        meta = "meta"
        self.patch_embed = PatchEmbed(patch_h, patch_w, embed_dim, meta)
        n = num_patches(spec_h, spec_w, patch_h, patch_w)
        self.pos_embed = nn.Parameter(torch.empty(1, n + 1, embed_dim,
                                                  device=meta))
        self.mask_embed = nn.Parameter(torch.empty(1, 1, embed_dim,
                                                   device=meta))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, eps, meta)
            for _ in range(depth))
        self.norm_frame = nn.LayerNorm(embed_dim, eps=eps, device=meta)
        # built on the meta device, so nothing draws from the global RNG
        self.to_empty(device="cpu")
        self.reset_parameters(generator)
        if fused:
            for blk in self.blocks:
                for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1,
                            blk.mlp.fc2):
                    lin.weight.data = lin.weight.data.to(torch.bfloat16)
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Reference ViT init: truncated normal (std 0.02, cut at 2 std) for
        embeddings and Linear weights, zero biases, unit LayerNorms."""
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)

        def tn(p):
            nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04, generator=gen)

        tn(self.pos_embed)
        tn(self.mask_embed)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                tn(m.weight)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def prepare_tokens(self, mel: torch.Tensor,
                       length: Optional[torch.Tensor] = None):
        """mel [B, F, T] -> (tokens [B, Np, D], valid patch counts [B] or
        None)."""
        B, F, T = mel.shape
        x = self.patch_embed.patch_embed(
            patchify(mel, self.patch_h, self.patch_w))
        Np = x.shape[1]
        plen = None
        if length is not None:
            plen = patch_lengths(length, F - F % self.patch_h, self.patch_h,
                                 self.patch_w)
        return x + self.pos_embed[:, 1: Np + 1], plen

    def run_blocks(self, x, plen, collect_from: Optional[int] = None):
        """Run all blocks; collect the outputs of blocks >= collect_from."""
        if self.fused:
            # imported here: ops.block_infer imports models.transformer
            from audiossl_tpu_torch.ops.block_infer import encoder_blocks_infer

            return encoder_blocks_infer(self.blocks, x, plen, self.num_heads,
                                        self.eps, collect_from)
        mask = None if plen is None else length_to_attn_mask(plen, x.shape[1])
        collected = []
        for i, blk in enumerate(self.blocks):
            x = blk(x, mask)
            if collect_from is not None and i >= collect_from:
                collected.append(x)
        return x, collected

    # ----------------------------- pretrain path -------------------- #
    def forward(self, mel: torch.Tensor, length: Optional[torch.Tensor] = None,
                mask_index: Optional[torch.Tensor] = None,
                apply_mask: bool = True, dps: Optional[torch.Tensor] = None):
        """Pretraining forward (frame level): mel [B, F, T], frame counts
        [B], token mask [B, Np] (bool), dps [depth, 2, B] drop-path keep
        multipliers or None. With ``apply_mask`` the masked tokens are
        replaced by ``mask_embed`` (the student). Returns (frames [B, Np,
        D] in ``dtype``, sel [B, Np] = mask & valid, or the validity when
        there is no mask)."""
        dt = self.dtype
        B, F, T = mel.shape
        x = _linear(self.patch_embed.patch_embed,
                    patchify(mel.to(dt), self.patch_h, self.patch_w))
        Np = x.shape[1]
        plen = None
        if length is not None:
            plen = patch_lengths(length, F - F % self.patch_h, self.patch_h,
                                 self.patch_w)
        if mask_index is not None and apply_mask:
            m = mask_index[:, :, None].to(dt)
            x = (1.0 - m) * x + m * self.mask_embed.to(dt)
        x = x + self.pos_embed[:, 1: Np + 1].to(dt)
        x = self._train_blocks(x, plen, dps)
        frames = _layer_norm(self.norm_frame, x)
        if plen is not None:
            sel = length_to_token_mask(plen, Np)
        else:
            sel = torch.ones(B, Np, dtype=torch.bool, device=x.device)
        if mask_index is not None:
            sel = mask_index & sel
        return frames, sel

    def _train_blocks(self, x, plen, dps):
        B, N, _ = x.shape
        if self.fused_infer:
            # imported here: ops.block_infer imports models.transformer
            from audiossl_tpu_torch.ops.block_infer import encoder_blocks_infer

            return encoder_blocks_infer(self.blocks, x, plen, self.num_heads,
                                        self.eps, dps=dps, dtype=x.dtype,
                                        plain=self.plain)[0]
        if not self.fused_attention:
            mask = None if plen is None else length_to_attn_mask(plen, N)
            for i, blk in enumerate(self.blocks):
                x = blk(x, mask, None if dps is None else (dps[i, 0],
                                                           dps[i, 1]))
            return x
        from audiossl_tpu_torch.ops.attn_train import fused_attn_block
        from audiossl_tpu_torch.ops.mlp_train import fused_mlp_block

        if plen is None:
            valid = torch.ones(B, N, device=x.device)
        else:
            valid = length_to_token_mask(plen, N).float()
        ones = torch.ones(B, device=x.device)
        x = x.contiguous()
        for i, blk in enumerate(self.blocks):
            dp1, dp2 = (ones, ones) if dps is None else (dps[i, 0].clone(),
                                                         dps[i, 1].clone())
            x = fused_attn_block(
                x, valid, dp1, blk.norm1.weight, blk.norm1.bias,
                blk.attn.qkv.weight, blk.attn.qkv.bias, blk.attn.proj.weight,
                blk.attn.proj.bias, self.num_heads, self.eps, self.plain)
            x = fused_mlp_block(
                x, dp2, blk.norm2.weight, blk.norm2.bias, blk.mlp.fc1.weight,
                blk.mlp.fc1.bias, blk.mlp.fc2.weight, blk.mlp.fc2.bias,
                self.eps, self.plain)
        return x

    def get_intermediate_layers(self, mel: torch.Tensor,
                                length: Optional[torch.Tensor] = None,
                                n: int = 1, scene: bool = True):
        """Frame-level downstream/embedding API.

        scene=True: concat of the masked token means of the last-n normed
        block outputs -> [B, n*D]. scene=False: concat of the last-n normed
        frame sequences -> [B, T, n*D]. Outputs are f32."""
        x, plen = self.prepare_tokens(mel, length)
        _, collected = self.run_blocks(x, plen, collect_from=self.depth - n)
        outs = []
        for h in collected:
            norm_h = self.norm_frame(h.float())
            if not scene:
                outs.append(norm_h)
            elif plen is None:
                outs.append(norm_h.mean(dim=1))
            else:
                mask = length_to_token_mask(plen, norm_h.shape[1])
                outs.append((norm_h * mask[:, :, None]).sum(dim=1)
                            / (plen[:, None] + 1e-6))
        return torch.cat(outs, dim=-1)


def frame_ast_tiny(**kw):
    """Tiny tier for CPU tests (not in the reference)."""
    return AudioTransformer(embed_dim=64, depth=2, num_heads=2, **kw)


def frame_ast_small(**kw):
    return AudioTransformer(embed_dim=384, depth=12, num_heads=6, **kw)


def frame_ast_base(**kw):
    return AudioTransformer(embed_dim=768, depth=12, num_heads=12, **kw)
