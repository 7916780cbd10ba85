"""Weights into the port: reference checkpoints and the JAX package's params.

* :func:`load_pretrain_checkpoint` reads a reference pretraining
  Lightning ``.ckpt`` and returns the encoder's state dict as stored
  (counterpart of ``audiossl_tpu/compat/torch_import.py:201``), or the
  port's own pretraining checkpoint (``<save>/ckpt/<step>/state.pt`` of
  ``training.checkpoint.CheckpointManager``, or its step directory), whose
  encoder is already in the port's layout and whose arch is inferred from
  its shapes (:func:`infer_arch`);
* :func:`encoder_state_from_torch` maps such a state dict onto the port's
  encoder as JAX's importer reads it (``torch_import.py:48
  encoder_params_from_torch``): either patch-embed layout, optional
  ``cls_token`` / ``prompt_embed``, unknown keys ignored; and
  :func:`load_encoder_state` loads it into an encoder;
* :func:`state_dict_from_flax` turns the JAX package's
  ``AudioTransformer`` param tree (numpy arrays) into the port's state
  dict, the inverse of ``torch_import.encoder_params_from_torch``;
* :func:`branch_state_from_flax`, :func:`opt_state_from_flax` and
  :func:`pretrain_state_from_flax` carry a whole pretraining state of the
  JAX package (``training/pretrain.py:69 PretrainState``: both branches,
  BatchNorm statistics, Adam's moments and count) into the port, so both
  start a step from the same state; :func:`finetune_state_from_flax` does
  the same for a finetuning state (``downstream/finetune.py:
  FinetuneState``: the encoder, the linear head and its BatchNorm
  statistics, the momentum trace), and :func:`sed_state_from_flax` turns
  an SED state's encoder and head params (``sed/module.py SEDState``) into
  the port's state dicts; :func:`distill_state_from_flax` carries a
  distillation state (``methods/distill/method.py DistillState``: the
  student encoder, its head and statistics, the momentum trace);
  :func:`mae_state_from_flax` and :func:`dual_state_from_flax` map the
  MAE and dual models' params, and :func:`model_state_from_flax` carries
  their whole state (params and Adam's moments; no teacher);
* :func:`linear_head_state_from_torch` reads a reference ``LinearHead``
  (the distillation teacher's head) into the port's.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def strip_prefixes(sd: Mapping[str, object], prefixes=("module.", "backbone.")):
    out = {}
    for k, v in sd.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


def subtree(sd: Mapping[str, object], prefix: str) -> Dict[str, object]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _t(a, transpose=False) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(np.array(a.T if transpose else a))  # a copy


def _dense(p, prefix, out):
    """flax Dense {kernel [in, out], bias} -> torch Linear [out, in]."""
    out[prefix + ".weight"] = _t(p["kernel"], transpose=True)
    if "bias" in p:
        out[prefix + ".bias"] = _t(p["bias"])


def _norm(p, prefix, out):
    out[prefix + ".weight"] = _t(p["scale"])
    out[prefix + ".bias"] = _t(p["bias"])


def _block(p, prefix, out):
    """A flax ``Block`` -> ``prefix.norm1.weight`` etc."""
    _norm(p["norm1"], prefix + ".norm1", out)
    _norm(p["norm2"], prefix + ".norm2", out)
    _dense(p["attn"]["qkv"], prefix + ".attn.qkv", out)
    _dense(p["attn"]["proj"], prefix + ".attn.proj", out)
    _dense(p["mlp"]["fc1"], prefix + ".mlp.fc1", out)
    _dense(p["mlp"]["fc2"], prefix + ".mlp.fc2", out)


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Frame or clip ``AudioTransformer`` flax params -> the port's state
    dict.

    Dense kernels are transposed to torch's ``[out, in]``; a qkv Dense
    without bias (``qkv_bias=False``) gives no ``qkv.bias`` key, as in
    the reference. A clip encoder (one with a ``cls_token``) keeps it and
    its final norm is ``norm`` (the reference AST's name); a frame
    encoder's is ``norm_frame``. Raises on param groups neither encoder
    holds, so nothing is dropped unnoticed."""
    out: Dict[str, torch.Tensor] = {}
    clip = "cls_token" in params
    for name, p in params.items():
        if name == "patch_proj":
            _dense(p, "patch_embed.patch_embed", out)
        elif name in ("pos_embed", "mask_embed", "cls_token"):
            out[name] = _t(p)
        elif name == "norm":
            _norm(p, "norm" if clip else "norm_frame", out)
        elif name.startswith("blocks_"):
            _block(p, "blocks." + name[len("blocks_"):], out)
        else:
            raise KeyError(f"param group {name!r} has no place in the "
                           "port's encoder")
    return out


def _head_from_flax(p: Mapping, stats: Mapping, prefix: str, out) -> None:
    """MLPHead {fc0, bn0, fc1} or LinearHead {linear} ->
    ``prefix.fc0.weight`` etc.; BatchNorm statistics ``mean``/``var`` ->
    ``running_mean``/``running_var``."""
    for name, q in p.items():
        if name in ("fc0", "fc1", "linear"):
            _dense(q, f"{prefix}.{name}", out)
        elif name == "bn0":
            out[f"{prefix}.bn0.weight"] = _t(q["scale"])
            out[f"{prefix}.bn0.bias"] = _t(q["bias"])
        else:
            raise KeyError(f"param group {name!r} has no place in a head")
    for name, q in stats.items():
        out[f"{prefix}.{name}.running_mean"] = _t(q["mean"])
        out[f"{prefix}.{name}.running_var"] = _t(q["var"])


def branch_state_from_flax(params: Mapping,
                           batch_stats: Mapping = None
                           ) -> Dict[str, torch.Tensor]:
    """A JAX ``Branch`` (encoder + projector [+ predictor]) param
    tree and its ``batch_stats`` -> the port's ``Branch`` state dict:
    ``encoder.*`` under the serving names, ``head.projector.*`` (or the
    data2vec student's ``head.projector_linear.*``) and
    ``head.predictor.*``. With ``batch_stats`` None only the parameters
    are mapped (a tree of Adam moments has the params' structure)."""
    out = {f"encoder.{k}": v
           for k, v in state_dict_from_flax(params["encoder"]).items()}
    stats = (batch_stats or {}).get("head", {})
    for name, p in params.get("head", {}).items():
        if name == "projector_linear":
            _dense(p, "head.projector_linear", out)
        elif name in ("projector", "predictor"):
            _head_from_flax(p, stats.get(name, {}), f"head.{name}", out)
        else:
            raise KeyError(f"head group {name!r} is not ported")
    return out


def opt_state_from_flax(opt_state) -> Tuple[Dict[str, torch.Tensor],
                                            Dict[str, torch.Tensor], int]:
    """optax ``ScaleByAdamState`` of a ``Branch`` -> (mu, nu, count) keyed
    by the port's parameter names, in torch's layouts."""
    return (branch_state_from_flax(opt_state.mu),
            branch_state_from_flax(opt_state.nu), int(opt_state.count))


def pretrain_state_from_flax(state, method, generator: torch.Generator):
    """The JAX package's ``PretrainState`` -> the port's, loaded into the
    branches of ``method`` (a ``FrameMethod`` or a ``ClipMethod``);
    ``generator`` becomes the state's generator (JAX keys do not carry
    over)."""
    from audiossl_tpu_torch.training.pretrain import PretrainState

    dev = method.device
    method.student.load_state_dict(branch_state_from_flax(
        _tree_np(state.params), _tree_np(state.batch_stats)))
    method.teacher.load_state_dict(branch_state_from_flax(
        _tree_np(state.teacher_params), _tree_np(state.teacher_batch_stats)))
    mu, nu, count = opt_state_from_flax(state.opt_state._replace(
        mu=_tree_np(state.opt_state.mu), nu=_tree_np(state.opt_state.nu)))
    names = [k for k, _ in method.student.named_parameters()]
    return PretrainState(
        step=int(np.asarray(state.step)), student=method.student,
        teacher=method.teacher,
        mu={k: mu[k].to(dev) for k in names},
        nu={k: nu[k].to(dev) for k in names},
        count=count, generator=generator)


def mae_state_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``MAEModel`` params (``methods/mae/method.py``)
    -> the state dict of the port's ``MAEModel``: the Dense layers
    transposed, ``blocks_i`` / ``dec_blocks_i`` as ``blocks.i`` /
    ``dec_blocks.i``. Raises on a group the model has no place for."""
    out: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        if name in ("patch_proj", "middle", "dec_head"):
            _dense(p, name, out)
        elif name in ("pos_embed", "cls_token", "dec_pos_embed",
                      "mask_embed"):
            out[name] = _t(p)
        elif name in ("norm", "dec_norm"):
            _norm(p, name, out)
        elif name.startswith(("blocks_", "dec_blocks_")):
            head, i = name.rsplit("_", 1)
            _block(p, f"{head}.{i}", out)
        else:
            raise KeyError(f"param group {name!r} has no place in the "
                           "port's MAEModel")
    return out


def dual_state_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``DualModel`` params (``methods/dual/method.py``)
    -> the state dict of the port's ``DualModel``: each encoder through
    :func:`state_dict_from_flax` (the frame encoder's final norm
    ``norm_frame``), the reconstructions and each expander's ``fc0``,
    ``ln0``, ``fc1``, ``ln1``, ``fc2``. Raises on a group the model has no
    place for."""
    out: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        if name in ("patchnet", "framenet"):
            out.update({f"{name}.{k}": v for k, v in
                        state_dict_from_flax(p).items()})
        elif name in ("patch_recon", "frame_recon"):
            _dense(p, name, out)
        elif name in ("patch_expander", "frame_expander"):
            for sub, q in p.items():
                if sub in ("fc0", "fc1", "fc2"):
                    _dense(q, f"{name}.{sub}", out)
                elif sub in ("ln0", "ln1"):
                    _norm(q, f"{name}.{sub}", out)
                else:
                    raise KeyError(f"param group {name}/{sub} has no place "
                                   "in the port's expander")
        else:
            raise KeyError(f"param group {name!r} has no place in the "
                           "port's DualModel")
    return out


def model_state_from_flax(state, method, generator: torch.Generator):
    """The JAX package's ``MAEState`` or ``DualState`` (params and optax's
    ``ScaleByAdamState``) -> the port's ``PretrainState`` without a
    teacher, loaded into ``method.model`` (an ``MAEMethod`` or a
    ``DualMethod`` built alike); ``generator`` becomes the state's
    generator (JAX keys do not carry over)."""
    from audiossl_tpu_torch.training.pretrain import PretrainState

    to_sd = (dual_state_from_flax if "patchnet" in state.params
             else mae_state_from_flax)
    dev = method.device
    method.model.load_state_dict(to_sd(_tree_np(state.params)))
    mu = to_sd(_tree_np(state.opt_state.mu))
    nu = to_sd(_tree_np(state.opt_state.nu))
    names = [k for k, _ in method.model.named_parameters()]
    if set(mu) != set(names):
        raise KeyError("Adam's moments are not the model's parameters: "
                       f"{sorted(set(mu) ^ set(names))[:8]}")
    return PretrainState(
        step=int(np.asarray(state.step)), student=method.model, teacher=None,
        mu={k: mu[k].to(dev) for k in names},
        nu={k: nu[k].to(dev) for k in names},
        count=int(np.asarray(state.opt_state.count)), generator=generator)


def finetune_state_from_flax(state, task):
    """The JAX package's ``FinetuneState`` (``downstream/finetune.py``)
    -> the port's, loaded into ``task``'s encoder and head (a
    ``downstream.finetune.FinetuneTask`` built alike): the encoder, the
    LinearHead with its BatchNorm statistics, and ``optax.trace``'s
    momentum trace by the port's parameter names; the step carries over,
    JAX's key does not."""
    return _trained_from_flax(
        state.enc_params, state.head_params, state.head_stats,
        state.opt_state.trace, state.step, task.encoder, task.head,
        task.init_state)


def distill_state_from_flax(state, method, generator: torch.Generator):
    """The JAX package's ``DistillState`` (``methods/distill/method.py``)
    -> the port's, loaded into ``method``'s student and its head (a
    ``methods.distill.method.DistillMethod`` built alike): the student
    encoder, its LinearHead with the BatchNorm statistics, and
    ``optax.trace``'s momentum trace by the port's parameter names; the
    step carries over, JAX's key does not: ``generator`` draws the port's
    steps."""
    return _trained_from_flax(
        state.student_params, state.head_params, state.head_stats,
        state.opt_state.trace, state.step, method.student, method.head,
        lambda: method.init_state(generator))


def _trained_from_flax(enc_params, head_params, head_stats, trace, step,
                       encoder, head, init_state):
    """An encoder and LinearHead trained with ``optax.trace``: their JAX
    params (and the head's statistics) loaded into ``encoder`` and
    ``head``, then ``init_state()``'s state with JAX's step and trace."""
    encoder.load_state_dict(state_dict_from_flax(_tree_np(enc_params)))
    sd = {}
    _head_from_flax(_tree_np(head_params), _tree_np(head_stats), "head", sd)
    head.load_state_dict({k[len("head."):]: v for k, v in sd.items()})
    out = init_state()
    out.step = int(np.asarray(step))
    got = {f"encoder.{k}": v for k, v in
           state_dict_from_flax(_tree_np(trace["enc"])).items()}
    _head_from_flax(_tree_np(trace["head"]), {}, "head", got)
    if set(got) != set(out.mu):
        raise KeyError("the momentum trace's leaves are not the state's: "
                       f"{sorted(set(got) ^ set(out.mu))[:8]}")
    for k, v in got.items():
        out.mu[k].copy_(v)
    return out


def linear_head_state_from_torch(sd: Mapping[str, object]
                                 ) -> Dict[str, torch.Tensor]:
    """A reference ``LinearHead`` state dict (``modules/head.py``:
    ``linear.weight``, ``linear.bias``, ``norm.running_mean``,
    ``norm.running_var``) -> the port's ``models.heads.LinearHead`` state
    dict, whose names are the reference's: the counterpart of JAX's
    ``compat/torch_import.py linear_head_from_torch``. Copies in f32. A
    head without a norm gives no statistics (loading it into a LinearHead,
    which has one, then raises). ``norm.num_batches_tracked`` is dropped,
    and so are ``norm.weight`` / ``norm.bias`` of a head built with an
    affine norm: JAX's importer carries them, but its
    ``LinearHead(affine=False)`` never reads them, and the port's head
    holds no place for them."""
    keys = ["linear.weight", "linear.bias"]
    if "norm.running_mean" in sd:
        keys += ["norm.running_mean", "norm.running_var"]
    return {k: torch.as_tensor(np.asarray(sd[k], np.float32)).clone()
            for k in keys}


def sed_state_from_flax(enc_params, head_params):
    """The JAX package's SED state (``sed/module.py`` ``SEDState``'s
    ``enc_params`` and ``head_params``, arrays of any kind) -> (the
    encoder's state dict, the ``SEDHead``'s state dict). ``enc_params``
    None (a comparison encoder, which starts from its authors' file on
    both sides) gives None for the encoder."""
    head: Dict[str, torch.Tensor] = {}
    for name, p in _tree_np(head_params).items():
        if name not in ("linear", "linear_softmax"):
            raise KeyError(f"param group {name!r} has no place in SEDHead")
        _dense(p, name, head)
    if enc_params is None:
        return None, head
    return state_dict_from_flax(_tree_np(enc_params)), head


def _tree_np(tree):
    """Nested mappings of arrays -> the same nesting of numpy arrays."""
    if isinstance(tree, Mapping):
        return {k: _tree_np(v) for k, v in tree.items()}
    return np.asarray(tree)


def encoder_state_from_torch(sd: Mapping[str, torch.Tensor], depth: int,
                             use_cls: bool) -> Dict[str, torch.Tensor]:
    """A reference AST / FrameAST state dict (scoped to the encoder) -> the
    port's encoder state dict, reading the keys JAX's
    ``encoder_params_from_torch`` reads and no others:

    * the patch embedding from the Linear layout
      (``patch_embed.patch_embed.*``) or the Conv2d one with kernel =
      stride (``patch_embed.proj.*``, weight [D, 1, ph, pw] reshaped to
      [D, ph*pw]: features in (ph, pw) order, the port's patch order);
    * ``pos_embed``, ``mask_embed``, and ``cls_token`` / ``prompt_embed``
      when present;
    * blocks 0..depth-1 (``qkv.bias`` when present);
    * the final norm from ``norm.*`` or ``norm_frame.*``, under the name
      the port's encoder gives it (``norm`` when ``use_cls``, else
      ``norm_frame``).

    Other keys are ignored, as JAX ignores them. A missing patch
    embedding, embedding or block key raises ``KeyError``."""
    g = dict(sd)
    out: Dict[str, torch.Tensor] = {}
    if "patch_embed.patch_embed.weight" in g:
        out["patch_embed.patch_embed.weight"] = g[
            "patch_embed.patch_embed.weight"]
        out["patch_embed.patch_embed.bias"] = g["patch_embed.patch_embed.bias"]
    elif "patch_embed.proj.weight" in g:  # Conv2d, kernel == stride
        w = g["patch_embed.proj.weight"]
        out["patch_embed.patch_embed.weight"] = w.reshape(w.shape[0], -1)
        out["patch_embed.patch_embed.bias"] = g["patch_embed.proj.bias"]
    else:
        raise KeyError("no patch embed weights found")
    out["pos_embed"] = g["pos_embed"]
    out["mask_embed"] = g["mask_embed"]
    for name in ("cls_token", "prompt_embed"):
        if name in g:
            out[name] = g[name]
    names = ["norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias",
             "attn.qkv.weight", "attn.proj.weight", "attn.proj.bias",
             "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight",
             "mlp.fc2.bias"]
    for i in range(depth):
        b = f"blocks.{i}."
        for name in names:
            out[b + name] = g[b + name]
        if b + "attn.qkv.bias" in g:
            out[b + "attn.qkv.bias"] = g[b + "attn.qkv.bias"]
    norm = "norm" if use_cls else "norm_frame"
    for src in ("norm", "norm_frame"):
        if src + ".weight" in g:
            out[norm + ".weight"] = g[src + ".weight"]
            out[norm + ".bias"] = g[src + ".bias"]
            break
    return out


def load_encoder_state(encoder: torch.nn.Module,
                       sd: Mapping[str, torch.Tensor],
                       assign: bool = False, layout: str = "reference"
                       ) -> None:
    """Load a reference encoder state dict into the port's
    ``AudioTransformer`` through :func:`encoder_state_from_torch`. Mapped
    keys the encoder has no place for (``prompt_embed``, which the port's
    encoder does not hold, or a clip checkpoint's ``cls_token`` in a
    frame encoder) are dropped, as flax leaves unused params alone; a key
    the encoder needs and the file lacks raises. ``assign=True`` takes the
    tensors themselves (an encoder built on the meta device).
    ``layout="port"`` (the ``layout`` :func:`load_pretrain_checkpoint`
    reports for the port's own checkpoints) loads ``sd`` as it is, every
    key of the encoder and no other."""
    if layout == "port":
        encoder.load_state_dict(sd, assign=assign)
        return
    mapped = encoder_state_from_torch(sd, encoder.depth, encoder.use_cls)
    own = encoder.state_dict()
    encoder.load_state_dict({k: v for k, v in mapped.items() if k in own},
                            assign=assign)


PORT_STATE_FILE = "state.pt"  # training.checkpoint.STATE_FILE
# (width, blocks) -> the size tier; the clip and frame encoders share them
ARCHS = {(64, 2): "tiny", (384, 12): "small", (768, 12): "base"}


def port_state_path(path: str) -> Optional[str]:
    """The ``state.pt`` a path names, if it names one of the port's own
    checkpoints: the file itself, or a directory holding it (a step
    directory); else None."""
    if os.path.isdir(path):
        path = os.path.join(path, PORT_STATE_FILE)
        return path if os.path.isfile(path) else None
    return path if os.path.basename(path) == PORT_STATE_FILE else None


def infer_arch(sd: Mapping[str, torch.Tensor]) -> Tuple[str, str]:
    """(model type, size tier) of a port-layout encoder state dict: the
    type by its CLS token ("clip") or its absence ("frame"), the tier by
    its width and block count. A shape no tier has raises ValueError."""
    width = int(sd["pos_embed"].shape[-1])
    depth = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    arch = ARCHS.get((width, depth))
    if arch is None:
        tiers = ", ".join(f"{a} {w} x {d}" for (w, d), a in ARCHS.items())
        raise ValueError(f"an encoder of width {width} and {depth} blocks "
                         f"is no arch the port builds ({tiers})")
    return ("clip" if "cls_token" in sd else "frame"), arch


def load_pretrain_checkpoint(path: str, which: str = "teacher"):
    """Reference pretraining ``.ckpt`` (Lightning) -> (encoder state dict of
    ``which`` in {'teacher', 'student'}, hyper_parameters dict).

    The encoder is found under ``model.{which}.encoder.``, then
    ``{which}.encoder.``, else the dict is taken as a raw encoder state
    dict; ``module.``/``backbone.`` prefixes are stripped first. The file
    is read with ``weights_only=True``: tensors and plain containers.

    A port pretraining checkpoint (:func:`port_state_path`: a
    ``state.pt`` of the pretraining CLIs, or its step directory) gives
    ``which`` branch's ``encoder.`` entries as they are, in the port's
    layout, and as hyper-parameters the ``arch`` and ``model_type``
    :func:`infer_arch` reads off them and ``layout`` "port" (load them
    with ``load_encoder_state(..., layout="port")``)."""
    port = port_state_path(path)
    if port is not None:
        saved = torch.load(port, map_location="cpu", weights_only=True)
        if not isinstance(saved.get(which), Mapping):
            raise KeyError(f"{port} holds no {which!r} branch: it is not a "
                           "pretraining checkpoint of the port")
        enc = subtree(saved[which], "encoder.")
        model_type, arch = infer_arch(enc)
        return enc, {"arch": arch, "model_type": model_type,
                     "layout": "port", "step": saved.get("step")}
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = strip_prefixes(ckpt.get("state_dict", ckpt))
    enc = subtree(sd, f"model.{which}.encoder.")
    if not enc:
        enc = subtree(sd, f"{which}.encoder.")
    if not enc:
        enc = sd
    return enc, dict(ckpt.get("hyper_parameters", {}))
