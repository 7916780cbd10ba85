"""The ATST audio transformer encoders (PyTorch port).

Port of ``audiossl_tpu/models/atst.py`` in two configurations: the
frame-level one (``use_cls=False``, reference
``audiossl/methods/atstframe/audio_transformer.py`` FrameAST: no CLS
token, final norm ``norm_frame``) and the clip-level one (``use_cls=True``,
reference ``audiossl/models/atst/audio_transformer.py`` AST: a CLS token
before the patches, final norm ``norm``, the pretraining forward returns
the normed CLS token, or with ``avg=True`` the mean of the last 8 blocks'
CLS token). A frame encoder's ``nprompt`` learned prompt tokens
(``prompt_embed``) go before the patches after the position embeddings
are added; the blocks count them as valid keys, the frame outputs drop
them, and the scene embedding appends their mean (JAX's ``nprompt``,
``audiossl_tpu/models/atst.py:81``). The frame encoder's ``avg_blocks`` (the
data2vec teacher) replaces the final norm by the mean of the last
``avg_blocks`` block outputs, each instance-normalized over the tokens.
Position embeddings are "cut" (the first tokens' rows) or, with
``pos_type="interpolate"``, the patch grid resized bicubically to the
input's. Parameter names are the reference's, so a reference state dict
loads with ``load_state_dict``.

The inference passes (:meth:`AudioTransformer.get_intermediate_layers`)
compute in ``dtype`` from the patch projection on, as the JAX encoder
does: a clip encoder prepends the CLS token, and the blocks mask keys
with the valid token counts, CLS included. The clip encoder's downstream
API (:meth:`AudioTransformer.cls_avg_layers`,
:meth:`AudioTransformer.get_intermediate_layers_chunks`, as the linear
probe runs it) and :meth:`AudioTransformer.get_last_selfattention` are
JAX's, quirks included. ``fused=True`` runs the blocks
through the inference block kernels (``ops/block_infer.py``) with the four
matmul weights of every block held in ``dtype``, and normalizes with
``LayerNormPG``; with ``dtype=torch.bfloat16`` that is the encoder JAX's
``load_model(fused=True)`` builds (``dtype=bfloat16, fused_attention=True,
fused_infer=True``), rounding where it rounds. ``fused=False`` runs the
module path with the additive -10000 mask.

The pretraining forward (:meth:`AudioTransformer.forward`) keeps f32
master weights and computes in ``dtype``, and picks the blocks' route by
the flags and the dtype, as the JAX encoder does (``run_blocks``):

* bf16 with ``fused_infer`` (a no-grad teacher), or with
  ``fused_attention`` outside training: the inference block kernels K2/K3
  (``ops/block_infer.py``), the weights cast per call;
* bf16 with ``fused_attention`` in training (the student): the trainable
  attention and MLP kernels K4/K5 (``ops/attn_train.py``,
  ``ops/mlp_train.py``);
* any other dtype with either flag: ``Block(fused_attention=True)``, whose
  attention is the standalone MHA kernel K6 and whose norms are
  ``LayerNormPG`` (K8 backward);
* neither flag: the module path with the -10000 mask and autograd.

With either flag the final norm is ``LayerNormPG`` in any dtype, as JAX
picks it by the flag alone (there the teacher carries both flags).

The block kernels need bf16; K6 takes f32 as well. ``plain=True`` runs the
kernels' plain versions on any device.

The int8 options act on the block-kernel route only, as in JAX:
``infer_quant="int8"`` runs the inference block kernels as K2q/K3q (the
teacher under ``teacher_quant``; serving under ``load_model(quant=
"int8")``, where ``fused=True`` then keeps the f32 weights the codes are
made from), ``train_quant`` in {"int8", "int8dx"} the student's K4/K5 as
K4q/K5q. On the module and K6 routes they change nothing.

The encoder is built on the card (``device="cuda"``) unless the caller
asks for another device; without a card that raises.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from audiossl_tpu_torch.kernels.build import resolve_device
from audiossl_tpu_torch.models.transformer import (
    Block,
    LayerNormPG,
    _norm,
    length_to_attn_mask,
    length_to_token_mask,
)
from audiossl_tpu_torch.ops.interpolate import resize_bicubic
from audiossl_tpu_torch.ops.quant import check_quant


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
                 fused: bool = False, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32,
                 fused_attention: bool = False, fused_infer: bool = False,
                 plain: bool = False, use_cls: bool = False,
                 infer_quant: str = "none", train_quant: str = "none",
                 pos_type: str = "cut", avg_blocks: int = 0,
                 nprompt: int = 0):
        """Parameters are drawn on the CPU from ``generator`` (seed 0 when
        None) as the reference initializes them, then moved to
        ``device``; ``device="meta"`` gives the shapes and draws nothing.
        ``dtype`` is the compute dtype of both passes; ``fused`` the
        inference route; ``fused_attention``,
        ``fused_infer``, ``plain`` and the quant options configure the
        pretraining forward (module docstring); ``use_cls`` makes the
        clip-level encoder; ``pos_type`` is "cut" or "interpolate";
        ``avg_blocks`` > 0 makes a frame encoder's pretraining forward
        return the data2vec target (:func:`block_average`); it then holds
        no final norm; ``nprompt`` > 0 gives a frame encoder that many
        prompt tokens (``prompt_embed`` [1, nprompt, D])."""
        super().__init__()
        if pos_type not in ("cut", "interpolate"):
            raise ValueError(f"unknown pos_type {pos_type!r}")
        self.pos_type = pos_type
        self.avg_blocks = avg_blocks
        self.nprompt = nprompt
        self.spec_h, self.spec_w = spec_h, spec_w
        device = resolve_device(device)
        self.infer_quant = check_quant(infer_quant, ("int8",))
        self.train_quant = check_quant(train_quant)
        self.dtype = dtype
        self.use_cls = use_cls
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
        if use_cls:
            self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim,
                                                      device=meta))
        if nprompt > 0:
            self.prompt_embed = nn.Parameter(torch.empty(1, nprompt,
                                                         embed_dim,
                                                         device=meta))
        # the pretraining forward's route for the blocks (module docstring)
        if not (fused_attention or fused_infer):
            self._route = "module"
        elif dtype == torch.bfloat16:
            self._route = "block_kernels"
        else:
            self._route = "k6"
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, eps, meta,
                  fused_attention=self._route == "k6", plain=plain)
            for _ in range(depth))
        norm = (nn.LayerNorm(embed_dim, eps=eps, device=meta)
                if self._route == "module" and not fused
                else LayerNormPG(embed_dim, eps, meta, plain))
        if avg_blocks > 0 and not use_cls:
            # the data2vec target takes the final norm's place: no norm, as
            # JAX's encoder then holds no norm parameters
            norm = None
        # the reference names: AST's final norm is ``norm``, FrameAST's
        # ``norm_frame``
        self._norm_name = "norm" if use_cls else "norm_frame"
        self.add_module(self._norm_name, norm)
        if device.type == "meta":  # shapes only: nothing is drawn
            return
        # built on the meta device, so nothing draws from the global RNG
        self.to_empty(device="cpu")
        self.reset_parameters(generator)
        self.cast_block_weights()
        self.to(device)

    def cast_block_weights(self):
        """On the fused route without int8 (``load_model(fused=True)``),
        hold the blocks' matmul weights in ``dtype``; the rest stays f32."""
        if self.fused and not self.infer_quant:
            for blk in self.blocks:
                for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1,
                            blk.mlp.fc2):
                    lin.weight.data = lin.weight.data.to(self.dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Reference ViT init: truncated normal (std 0.02, cut at 2 std) for
        embeddings and Linear weights, zero biases, unit LayerNorms."""
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)

        def tn(p):
            nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04, generator=gen)

        tn(self.pos_embed)
        if self.use_cls:
            tn(self.cls_token)
        tn(self.mask_embed)
        if self.nprompt > 0:
            tn(self.prompt_embed)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                tn(m.weight)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    @property
    def final_norm(self) -> nn.LayerNorm:
        return getattr(self, self._norm_name)

    def _attn_lengths(self, plen):
        """Valid token counts of the blocks' input: the patches, and the CLS
        token of a clip encoder or a frame encoder's prompt tokens."""
        if plen is None:
            return plen
        return plen + (1 if self.use_cls else self.nprompt)

    def _interpolated_pos(self, h: int, w: int) -> torch.Tensor:
        """pos_type="interpolate": the position embeddings [1, 1 + h0*w0, D]
        with the patch grid resized bicubically from the checkpoint's
        (align_corners=False) to the h x w mel's, in f32 (JAX's
        ``_interpolated_pos``, ``audiossl_tpu/models/atst.py:146``)."""
        H0, W0 = self.spec_h // self.patch_h, self.spec_w // self.patch_w
        h0, w0 = h // self.patch_h, w // self.patch_w
        if h0 * w0 == H0 * W0 and h == self.spec_h and w == self.spec_w:
            return self.pos_embed
        grid = self.pos_embed[:, 1:].reshape(1, H0, W0, self.embed_dim)
        grid = resize_bicubic(grid.permute(0, 3, 1, 2), h0, w0)
        grid = grid.permute(0, 2, 3, 1).reshape(1, -1, self.embed_dim)
        return torch.cat([self.pos_embed[:, :1], grid], dim=1)

    def prepare_tokens(self, mel: torch.Tensor,
                       length: Optional[torch.Tensor] = None,
                       mask_index: Optional[torch.Tensor] = None,
                       apply_mask: bool = True):
        """mel [B, F, T] -> (tokens [B, N, D] in ``dtype``, valid patch
        counts [B] or None), as JAX's ``prepare_tokens``: the patch
        projection (its product, then its bias, each rounded to ``dtype``,
        as flax's ``Dense``), with ``apply_mask`` the tokens of
        ``mask_index`` [B, Np] (bool) replaced by ``mask_embed``, a clip
        encoder's CLS token before the patches (N = Np + 1), and the
        position embeddings of ``pos_type``, then a frame encoder's prompt
        tokens before the patches (N = nprompt + Np). With "cut", more
        patches than the position embeddings hold raise."""
        dt = self.dtype
        B, F, T = mel.shape
        lin = self.patch_embed.patch_embed
        x = (patchify(mel.to(dt), self.patch_h, self.patch_w)
             @ lin.weight.to(dt).t() + lin.bias.to(dt))
        Np = x.shape[1]
        plen = None
        if length is not None:
            plen = patch_lengths(length, F - F % self.patch_h, self.patch_h,
                                 self.patch_w)
        if mask_index is not None and apply_mask:
            m = mask_index[:, :, None].to(dt)
            x = (1.0 - m) * x + m * self.mask_embed.to(dt)
        if self.pos_type == "cut":
            if Np + 1 > self.pos_embed.shape[1]:
                raise ValueError(
                    f"{Np} patches exceed the {self.pos_embed.shape[1] - 1} "
                    f"position embeddings of spec_w={self.spec_w}")
            pos = self.pos_embed[:, :Np + 1]
        else:
            pos = self._interpolated_pos(F, T)
        if self.use_cls:
            cls = self.cls_token.to(dt).expand(B, 1, self.embed_dim)
            return torch.cat([cls, x], dim=1) + pos.to(dt), plen
        x = x + pos[:, 1:].to(dt)
        if self.nprompt > 0:
            pr = self.prompt_embed.to(dt).expand(B, self.nprompt,
                                                  self.embed_dim)
            x = torch.cat([pr, x], dim=1)
        return x, plen

    def run_blocks(self, x, lengths, collect_from: Optional[int] = None,
                   dps: Optional[torch.Tensor] = None):
        """Run all blocks of a downstream pass over tokens x [B, N, D] with
        lengths [B] valid tokens (None: all); collect the outputs of blocks
        >= collect_from. ``dps`` [depth, 2, B]: drop-path keep multipliers
        of each block's attention and MLP branch (training), or None."""
        if self.fused:
            # imported here: ops.block_infer imports models.transformer
            from audiossl_tpu_torch.ops.block_infer import encoder_blocks_infer

            # the int8 codes are made from the f32 weights; the activations
            # are in dtype
            return encoder_blocks_infer(
                self.blocks, x, lengths, self.num_heads, self.eps,
                collect_from, dps=dps, dtype=self.dtype,
                quant=self.infer_quant)
        mask = (None if lengths is None
                else length_to_attn_mask(lengths, x.shape[1]))
        collected = []
        for i, blk in enumerate(self.blocks):
            x = blk(x, mask, None if dps is None else (dps[i, 0], dps[i, 1]))
            if collect_from is not None and i >= collect_from:
                collected.append(x)
        return x, collected

    # ----------------------------- pretrain path -------------------- #
    def forward(self, mel: torch.Tensor, length: Optional[torch.Tensor] = None,
                mask_index: Optional[torch.Tensor] = None,
                apply_mask: bool = True, dps: Optional[torch.Tensor] = None,
                avg: bool = False):
        """Pretraining forward: mel [B, F, T], frame counts [B], token mask
        [B, Np] (bool), dps [depth, 2, B] drop-path keep multipliers or
        None. With ``apply_mask`` the masked tokens are replaced by
        ``mask_embed`` (the student). Frame level: returns (frames [B, Np,
        D] in ``dtype``, sel [B, Np] = mask & valid, or the validity when
        there is no mask). Clip level: returns the final norm of the CLS
        token [B, D] in ``dtype`` (reference AST.forward); with ``avg`` the
        mean of the raw CLS token of the last 8 blocks' outputs (the
        reference's blocks i > depth - 9), not normed. The prompt tokens'
        rows are dropped from the frames. A frame encoder with
        ``avg_blocks`` returns :func:`block_average` of its last
        ``avg_blocks`` block outputs in place of the final norm's."""
        x, plen = self.prepare_tokens(mel, length, mask_index, apply_mask)
        avg = avg and self.use_cls
        collect_from = None
        if avg:
            collect_from = self.depth - 8
        elif not self.use_cls and self.avg_blocks > 0:
            collect_from = self.depth - self.avg_blocks
        x, collected = self._train_blocks(
            x, self._attn_lengths(plen), dps, collect_from)
        if avg:  # jnp.mean: an f32 mean, rounded
            return (torch.stack(collected).float().mean(dim=0)[:, 0]
                    .to(x.dtype))
        if self.use_cls:
            return _norm(self.final_norm, x)[:, 0]
        frames = (block_average(collected) if self.avg_blocks > 0
                  else _norm(self.final_norm, x))[:, self.nprompt:]
        B, Np = frames.shape[:2]
        if plen is not None:
            sel = length_to_token_mask(plen, Np)
        else:
            sel = torch.ones(B, Np, dtype=torch.bool, device=x.device)
        if mask_index is not None:
            sel = mask_index & sel
        return frames, sel

    def _train_blocks(self, x, lengths, dps,
                      collect_from: Optional[int] = None):
        """The blocks of the pretraining forward by the route of the module
        docstring; lengths [B] are the valid token counts or None. Returns
        (x, the outputs of the blocks >= collect_from)."""
        B, N, _ = x.shape
        collected = []

        def collect(i, h):
            if collect_from is not None and i >= collect_from:
                collected.append(h)
        if self._route == "block_kernels" and (
                self.fused_infer or not self.training):
            # imported here: ops.block_infer imports models.transformer
            from audiossl_tpu_torch.ops.block_infer import encoder_blocks_infer

            return encoder_blocks_infer(self.blocks, x, lengths,
                                        self.num_heads, self.eps,
                                        collect_from, dps=dps,
                                        dtype=x.dtype, plain=self.plain,
                                        quant=self.infer_quant)
        if self._route != "block_kernels":
            # module path; Block(fused_attention=True) on the K6/K8 route
            mask = (None if lengths is None
                    else length_to_attn_mask(lengths, N))
            for i, blk in enumerate(self.blocks):
                x = blk(x, mask, None if dps is None else (dps[i, 0],
                                                           dps[i, 1]))
                collect(i, x)
            return x, collected
        from audiossl_tpu_torch.ops.attn_train import fused_attn_block
        from audiossl_tpu_torch.ops.mlp_train import fused_mlp_block

        if lengths is None:
            valid = torch.ones(B, N, device=x.device)
        else:
            valid = length_to_token_mask(lengths, N).float()
        ones = torch.ones(B, device=x.device)
        x = x.contiguous()
        for i, blk in enumerate(self.blocks):
            dp1, dp2 = (ones, ones) if dps is None else (dps[i, 0].clone(),
                                                         dps[i, 1].clone())
            x = fused_attn_block(
                x, valid, dp1, blk.norm1.weight, blk.norm1.bias,
                blk.attn.qkv.weight, blk.attn.qkv.bias, blk.attn.proj.weight,
                blk.attn.proj.bias, self.num_heads, self.eps, self.plain,
                self.train_quant)
            x = fused_mlp_block(
                x, dp2, blk.norm2.weight, blk.norm2.bias, blk.mlp.fc1.weight,
                blk.mlp.fc1.bias, blk.mlp.fc2.weight, blk.mlp.fc2.bias,
                self.eps, self.plain, self.train_quant)
            collect(i, x)
        return x, collected

    def get_last_selfattention(self, mel: torch.Tensor,
                               length: Optional[torch.Tensor] = None):
        """The softmax attention map [B, H, N, N] of the last block (JAX's
        ``get_last_selfattention``, ``audiossl_tpu/models/atst.py:379``):
        the ``Block`` modules with the additive mask, as JAX runs them,
        not the inference block kernels."""
        x, plen = self.prepare_tokens(mel, length, apply_mask=False)
        lengths = self._attn_lengths(plen)
        mask = (None if lengths is None
                else length_to_attn_mask(lengths, x.shape[1]))
        for blk in self.blocks[:-1]:
            x = blk(x, mask)
        return self.blocks[-1](x, mask, return_attention=True)

    def get_intermediate_layers(self, mel: torch.Tensor,
                                length: Optional[torch.Tensor] = None,
                                n: int = 1, scene: bool = True,
                                dps: Optional[torch.Tensor] = None):
        """Downstream/embedding API, token for token JAX's
        ``get_intermediate_layers`` (``audiossl_tpu/models/atst.py:392``).

        The last-n block outputs are normed by the final norm in the
        blocks' dtype. scene=True: concat of their masked token means ->
        [B, n*D], the first ``plen`` tokens summed (in f32, rounded to the
        blocks' dtype) and divided by ``plen + 1e-6`` in the blocks' dtype
        (without lengths, the mean rounded to it); for a clip
        encoder those tokens are the CLS token and the first plen - 1
        patches, as in JAX. scene=False: concat of the normed token
        sequences, a clip encoder's CLS row first -> [B, N, n*D]. A frame
        encoder's prompt rows are left out of both, and with ``scene`` each
        block's mean of its raw (not normed) prompt tokens follows its
        token mean (-> [B, 2*n*D]). Outputs
        are f32, an exact cast of the blocks' dtype where it is not f32
        (the bf16 values JAX returns under ``load_model(fused=True)``).
        ``dps`` [depth, 2, B]: drop-path keep multipliers (training), or
        None."""
        x, plen = self.prepare_tokens(mel, length, apply_mask=False)
        _, collected = self.run_blocks(x, self._attn_lengths(plen),
                                       collect_from=self.depth - n, dps=dps)
        outs = []
        P = self.nprompt
        for h in collected:
            norm_h = _norm(self.final_norm, h)[:, P:]
            if not scene:
                outs.append(norm_h.float())
                continue
            if plen is None:  # jnp.mean: an f32 mean, rounded
                outs.append(norm_h.float().mean(dim=1).to(norm_h.dtype)
                            .float())
            else:
                # JAX divides by a weakly typed f32 count: in the blocks'
                # dtype
                mask = length_to_token_mask(plen, norm_h.shape[1])
                total = (norm_h.float() * mask[:, :, None]).sum(dim=1)
                count = (plen[:, None] + 1e-6).to(norm_h.dtype)
                outs.append((total.to(norm_h.dtype) / count).float())
            if P > 0:  # the raw prompt tokens' mean, rounded
                outs.append(h[:, :P].float().mean(dim=1).to(h.dtype)
                            .float())
        return torch.cat(outs, dim=-1)


    def cls_avg_layers(self, mel: torch.Tensor,
                       length: Optional[torch.Tensor] = None, n: int = 1,
                       dps: Optional[torch.Tensor] = None):
        """Per block of the last n, the final norm's CLS token and the mean
        of the patch tokens after it (JAX's ``cls_avg_layers``,
        ``audiossl_tpu/models/atst.py:422``; reference ``get_cls_avg``) ->
        (cls [n, B, D], avg [n, B, D]) in the blocks' dtype. The mean sums
        the first ``plen`` patches and divides by ``plen + 1e-6``, so a
        ``length`` beyond the mel's frames divides by more patches than it
        holds, as in JAX; a frame encoder's cls is zero.
        ``dps`` [depth, 2, B]: drop-path keep multipliers, or None."""
        x, plen = self.prepare_tokens(mel, length, apply_mask=False)
        _, collected = self.run_blocks(x, self._attn_lengths(plen),
                                       collect_from=self.depth - n, dps=dps)
        cls_list, avg_list = [], []
        for h in collected:
            norm_h = _norm(self.final_norm, h)
            if self.use_cls:
                cls_list.append(norm_h[:, 0])
                body = norm_h[:, 1:]
            else:
                cls_list.append(torch.zeros_like(norm_h[:, 0]))
                body = norm_h
            if plen is None:  # jnp.mean: an f32 mean, rounded
                avg_list.append(body.float().mean(dim=1).to(body.dtype))
                continue
            mask = length_to_token_mask(plen, body.shape[1])
            total = (body.float() * mask[:, :, None]).sum(dim=1)
            count = plen[:, None].to(body.dtype) + 1e-6
            avg_list.append(total.to(body.dtype) / count)
        return torch.stack(cls_list), torch.stack(avg_list)

    def get_intermediate_layers_chunks(self, mel: torch.Tensor,
                                       length: Optional[torch.Tensor] = None,
                                       n: int = 1, chunk_len: int = 601,
                                       avgpool: bool = True,
                                       dps: Optional[torch.Tensor] = None):
        """Clip-level inference over long audio (JAX's
        ``get_intermediate_layers_chunks``, ``audiossl_tpu/models/atst.py:
        447``): the mel [B, F, T] cut into ``T // chunk_len + 1`` chunks of
        ``chunk_len`` frames (so T a multiple of ``chunk_len`` gives an
        all-padding last chunk), all encoded in one batch by
        :meth:`cls_avg_layers`, then each block's CLS and mean averaged over
        the chunks a clip marks: the first when it holds a frame, a later
        one when it holds more than ``chunk_len // 2``. Each chunk's length
        ``max(length - k * chunk_len, 0)`` is not clamped to the chunk, as
        in the reference, so the first chunk of a clip longer than one
        chunk divides its mean by more patches than it holds. Returns
        [B, 2*n*D] (the CLS of each block, then the means) with
        ``avgpool``, else [B, n*D]. ``dps`` [depth, 2, B * nc]: drop-path
        keep multipliers of the chunk sequences, clip-major (training), or
        None."""
        B, F, T = mel.shape
        nc = T // chunk_len + 1
        if length is None:
            length = torch.full((B,), T, dtype=torch.int64)
        length = torch.as_tensor(length, device=mel.device).long()
        melp = torch.nn.functional.pad(mel, (0, nc * chunk_len - T))
        chunks = melp.reshape(B, F, nc, chunk_len).permute(0, 2, 1, 3)
        ks = torch.arange(nc, device=mel.device)
        cur = torch.clamp(length[:, None] - ks[None, :] * chunk_len, min=0)
        mark = torch.where(ks[None, :] == 0, cur > 0, cur > chunk_len // 2)
        cls, avg = self.cls_avg_layers(
            chunks.reshape(B * nc, F, chunk_len), cur.reshape(-1), n=n,
            dps=dps)
        w = mark.to(cls.dtype)[None, :, :, None]
        denom = w.sum(dim=2)
        outs = []
        for t in (cls, avg) if avgpool else (cls,):
            t = (t.reshape(n, B, nc, -1) * w).sum(dim=2) / denom  # [n, B, D]
            outs.append(torch.cat(list(t), dim=-1))
        return torch.cat(outs, dim=-1)


def block_average(collected) -> torch.Tensor:
    """The data2vec teacher's target (JAX ``models/atst.py:352-361``): each
    block output [B, N, D] instance-normalized over all N tokens (biased
    variance, eps 1e-5), then their mean. Rounded where JAX rounds: each
    output's mean and variance taken in f32 (the variance about the f32
    mean) and rounded to the blocks' dtype, the normalization in that
    dtype, the mean of the normalized outputs taken in f32 and rounded."""
    outs = []
    for h in collected:
        hf = h.float()
        mu = hf.mean(dim=1, keepdim=True)
        var = (hf - mu).square().mean(dim=1, keepdim=True).to(h.dtype)
        eps = torch.tensor(1e-5, dtype=h.dtype)
        outs.append((h - mu.to(h.dtype)) / torch.sqrt(var + eps))
    return torch.stack(outs).float().mean(dim=0).to(collected[0].dtype)


def _arch(embed_dim, depth, num_heads, use_cls, **kw):
    return AudioTransformer(embed_dim=embed_dim, depth=depth,
                            num_heads=num_heads, use_cls=use_cls, **kw)


def ast_tiny(**kw):
    """Tiny clip tier for CPU tests (not in the reference)."""
    return _arch(64, 2, 2, True, **kw)


def ast_small(**kw):
    return _arch(384, 12, 6, True, **kw)


def ast_base(**kw):
    return _arch(768, 12, 12, True, **kw)


def ast_large(**kw):
    return _arch(1024, 24, 16, True, **kw)


def frame_ast_tiny(**kw):
    """Tiny tier for CPU tests (not in the reference)."""
    return _arch(64, 2, 2, False, **kw)


def frame_ast_small(**kw):
    return _arch(384, 12, 6, False, **kw)


def frame_ast_base(**kw):
    return _arch(768, 12, 12, False, **kw)


def frame_ast_large(**kw):
    return _arch(1024, 24, 16, False, **kw)
