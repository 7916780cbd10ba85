"""The comparison encoders of ``audiossl_tpu_torch/compat/`` against the JAX
package's flax ports (CPU).

Each family starts from one seeded random checkpoint in its authors'
layout (``compat.synthetic.authors_checkpoint``, at a small width: 128
wide with 2 heads of 64, 2 layers; BYOL-A's fixed CNN at d = 3072),
written with ``torch.save``: JAX's ``load_*_checkpoint`` turns the file
into flax params and the port's into its module, so both start from the
same weights without a flax-to-torch map.

* the encoders' forwards, f32 rel L2 <= 1e-5 (MAE-AST's attention through
  K6's plain version on the port's side);
* each front end (``kaldi_fbank`` with the povey and hanning windows,
  ``audiomae_fbank``, ``maeast_fbank``, ``byola_logmel``, ``m2d_logmel``)
  on 1.3 s of seeded noise, rel L2 <= 1e-4;
* the weight gradients of a summed loss for MAE-AST (through K6's plain
  backward) and BEATs, each leaf rel L2 <= 1e-4;
* BYOL-A in ``.train()`` still on its running statistics: the same output
  as in eval mode, and the statistics unchanged.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from audiossl_tpu_torch.compat import synthetic  # noqa: E402

WIDTH, DEPTH = 128, 2
SMALL = dict(width=WIDTH, depth=DEPTH, beats_embed=64, conv_pos=16,
             conv_pos_groups=4)

# encoder inputs [B, T, 128] fbanks or [B, mels, T] log-mels; T chosen so
# every grid slices its position embedding (SSAST's by column)
INPUTS = {"audioMAE": (2, 160, 128), "ssast": (2, 100, 128),
          "patchssast": (2, 160, 128), "maeast": (2, 100, 128),
          "patchmaeast": (2, 160, 128), "beats": (2, 160, 128),
          "mmd": (2, 80, 300), "byola": (2, 64, 100)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_load(arch, path):
    from audiossl_tpu.compat import audiomae, beats, byola, m2d, maeast, ssast

    variant = "patch" if arch.startswith("patch") else "frame"
    fam = synthetic.FAMILY[arch]
    if fam == "audiomae":
        enc, p = audiomae.load_audiomae_checkpoint(path)
    elif fam == "m2d":
        enc, p = m2d.load_m2d_checkpoint(path)
    elif fam == "ssast":
        enc, p = ssast.load_ssast_checkpoint(path, variant=variant)
    elif fam == "maeast":
        enc, p = maeast.load_maeast_checkpoint(path, variant=variant)
    elif fam == "beats":
        enc, p = beats.load_beats_checkpoint(path)
    else:
        enc, v = byola.load_byola_checkpoint(path)
        return enc, v
    return enc, {"params": p}


def _port_load(arch, path):
    from audiossl_tpu_torch.compat import (audiomae, beats, byola, m2d,
                                           maeast, ssast)

    variant = "patch" if arch.startswith("patch") else "frame"
    fam = synthetic.FAMILY[arch]
    load = {"audiomae": lambda: audiomae.load_audiomae_checkpoint(
                path, device="cpu"),
            "m2d": lambda: m2d.load_m2d_checkpoint(path, device="cpu"),
            "ssast": lambda: ssast.load_ssast_checkpoint(path, variant,
                                                         device="cpu"),
            "maeast": lambda: maeast.load_maeast_checkpoint(path, variant,
                                                            device="cpu"),
            "beats": lambda: beats.load_beats_checkpoint(path, device="cpu"),
            "byola": lambda: byola.load_byola_checkpoint(path, device="cpu")}
    return load[fam]()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("authors")
    out = {}
    for i, arch in enumerate(synthetic.ARCHS):
        path = str(root / f"{arch}.pt")
        torch.save(synthetic.authors_checkpoint(arch, seed=10 + i, **SMALL),
                   path)
        out[arch] = path
    return out


def _input(arch, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*INPUTS[arch]).astype(np.float32)
    if arch in ("maeast", "patchmaeast"):
        x = x * 3.0 - 4.0  # a raw log fbank's range
    return x


def _apply(jenc, variables, arch, x, vf=None):
    if arch == "beats":
        return jenc.apply(variables, jnp.asarray(x),
                          valid_frames=None if vf is None
                          else jnp.asarray(vf))
    return jenc.apply(variables, jnp.asarray(x))


@pytest.mark.parametrize("arch", synthetic.ARCHS)
def test_forward_matches_jax(files, arch):
    jenc, variables = _jax_load(arch, files[arch])
    enc = _port_load(arch, files[arch])
    x = _input(arch)
    vf = np.asarray([160, 96]) if arch == "beats" else None
    want = np.asarray(_apply(jenc, variables, arch, x, vf))
    with torch.no_grad():
        got = (enc(torch.from_numpy(x), valid_frames=torch.from_numpy(vf))
               if arch == "beats" else enc(torch.from_numpy(x)))
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(want).all()
    assert _rel(got.numpy(), want) <= 1e-5, _rel(got.numpy(), want)
    # what SED finetuning trains: every parameter, MAE-AST's BatchNorm
    # statistics among them
    names = {k for k, _ in enc.named_parameters()}
    if synthetic.FAMILY[arch] == "maeast":
        assert {"bn_mean", "bn_var"} <= names


def _front_ends():
    from audiossl_tpu.compat import audiomae as jam
    from audiossl_tpu.compat import beats as jb
    from audiossl_tpu.compat import byola as jby
    from audiossl_tpu.compat import m2d as jm2d
    from audiossl_tpu.compat import maeast as jma
    from audiossl_tpu_torch.compat import audiomae, beats, byola, m2d, maeast

    return {
        "kaldi_povey": (lambda w: jb.kaldi_fbank(w * 2.0 ** 15),
                        lambda w: beats.kaldi_fbank(w * 2.0 ** 15)),
        "kaldi_hanning": (
            lambda w: jb.kaldi_fbank(w, window_type="hanning"),
            lambda w: beats.kaldi_fbank(w, window_type="hanning")),
        "audiomae_fbank": (jam.audiomae_fbank, audiomae.audiomae_fbank),
        "maeast_fbank": (jma.maeast_fbank, maeast.maeast_fbank),
        "byola_logmel": (jby.byola_logmel, byola.byola_logmel),
        "m2d_logmel": (jm2d.m2d_logmel, m2d.m2d_logmel)}


@pytest.mark.parametrize("name", sorted(_front_ends()))
def test_front_end_matches_jax(name):
    jfn, fn = _front_ends()[name]
    rng = np.random.RandomState(1)
    wav = (rng.randn(2, 20800) * 0.1).astype(np.float32)
    wav[1, 12000:] = 0.0  # a padded clip
    want = np.asarray(jfn(jnp.asarray(wav)))
    got = fn(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(want).all()
    assert _rel(got, want) <= 1e-4, _rel(got, want)


def flax_to_port(tree, prefix=()):
    """A flax param tree -> {the port's parameter name: array}: ``layers_3``
    as ``layers.3``, a Dense kernel transposed to ``weight``, a Conv
    kernel to torch's [out, in, ...], ``scale`` as ``weight``, BYOL-A's
    ``conv0`` / ``bn0`` as ``convs.0`` / ``bns.0``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flax_to_port(v, prefix + (k,)))
            continue
        parts = []
        for p in prefix:
            head, _, idx = p.rpartition("_")
            if p[:-1] in ("conv", "bn") and p[-1].isdigit():
                parts.append(("convs." if p[:-1] == "conv" else "bns.")
                             + p[-1])
            elif head and idx.isdigit() and head in ("layers", "blocks"):
                parts.append(f"{head}.{idx}")
            else:
                parts.append(p)
        a = np.asarray(v)
        if k == "kernel":
            a = a.T if a.ndim == 2 else np.transpose(
                a, (a.ndim - 1, a.ndim - 2) + tuple(range(a.ndim - 2)))
            k = "weight"
        elif k == "scale":
            k = "weight"
        out[".".join(parts + [k])] = a
    return out


@pytest.mark.parametrize("arch", ["maeast", "beats"])
def test_weight_gradients_match_jax(files, arch):
    """d(sum(out * c))/d(every weight), c a fixed random tensor."""
    jenc, variables = _jax_load(arch, files[arch])
    enc = _port_load(arch, files[arch]).train()
    x = _input(arch, seed=2)
    vf = np.asarray([160, 112]) if arch == "beats" else None
    c = np.random.RandomState(3).randn(
        *np.asarray(_apply(jenc, variables, arch, x, vf)).shape).astype(
        np.float32)

    def loss(p):
        out = _apply(jenc, {"params": p}, arch, x, vf)
        return jnp.sum(out * jnp.asarray(c))

    jgrads = flax_to_port(jax.grad(loss)(variables["params"]))
    out = (enc(torch.from_numpy(x), valid_frames=torch.from_numpy(vf))
           if arch == "beats" else enc(torch.from_numpy(x)))
    (out * torch.from_numpy(c)).sum().backward()
    grads = {k: p.grad.numpy() for k, p in enc.named_parameters()}
    assert set(grads) == set(jgrads), set(grads) ^ set(jgrads)
    # a key bias shifts every score of a row alike, which the softmax
    # cancels: its gradient is 0 in exact arithmetic and rounding noise on
    # both sides, held to a vanishing norm beside the key weight's
    # (MAE-AST packs it into qkv.bias between q's and v's, which dominate)
    zero = [k for k in grads if k.endswith("k_proj.bias")]
    for k in zero:
        scale = np.linalg.norm(jgrads[k.replace("bias", "weight")])
        assert max(np.linalg.norm(grads[k]),
                   np.linalg.norm(jgrads[k])) <= 1e-5 * scale, k
    worst = max((_rel(grads[k], jgrads[k]), k) for k in grads
                if k not in zero)
    assert worst[0] <= 1e-4, worst


def test_byola_train_mode_keeps_running_statistics(files):
    enc = _port_load("byola", files["byola"])
    stats = {k: v.clone() for k, v in enc.state_dict().items()
             if "running" in k}
    x = torch.from_numpy(_input("byola"))
    with torch.no_grad():
        want = enc.eval()(x)
        got = enc.train()(x)
    assert torch.equal(got, want)
    for k, v in enc.state_dict().items():
        if "running" in k:
            assert torch.equal(v, stats[k]), k
