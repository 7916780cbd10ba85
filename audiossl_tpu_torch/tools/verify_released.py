"""Released-checkpoint parity verification (port of
``scripts/verify_released.py``).

The north star asks that embeddings from the released ATST-Frame
checkpoints (reference methods/atst/README.md:45-47,
methods/atstframe/README.md:15-17) match the PyTorch reference within
1e-3. This tool makes that check one command on the port, on the card:

1. In a torch environment with the reference installed, record golden
   embeddings for a wav (the exact snippet is printed by
   ``--print-torch-recipe``) -> ``golden.npz``.
2. Then::

       python -m audiossl_tpu_torch.tools.verify_released \\
           --ckpt atstframe_base.ckpt --wav clip.wav --golden golden.npz

   prints one JSON line with the scene/timestamp max-abs diffs against
   the recorded outputs and exits 1 above ``--tol`` (1e-3).

Without ``--golden`` it writes the port's embeddings to ``--out`` (the
same ``.npz`` keys: ``scene``, ``timestamp``, ``timestamps_ms``); the JAX
script's ``.npz`` and this tool's stand in for each other.

``probe`` mode checks the linear-probe score (frozen-encoder evaluation,
the reference's shell/downtream/freeze/eval_*.sh runs)::

    python -m audiossl_tpu_torch.tools.verify_released probe \\
        --ckpt atst_small.ckpt --dataset_name spcv2 \\
        --data_path /data/spcv2 --model_type clip --arch small \\
        --expect 0.958 --tol 0.01

runs ``python -m audiossl_tpu_torch.downstream.train_freeze`` at its
recipe defaults on one rank (``--n_devices 1``: the score is read from
this process) and exits 1 if the test score differs from ``--expect`` by
more than ``--tol``.

Both modes take ``--device`` (the card by default; without one it
raises, and ``--device cpu`` runs the kernels' plain versions). The
embedding mode loads the plain f32 model (``load_model(fused=False)``),
whose mel runs the mel kernel (K1) on the card. Exit code 1 means only
"beyond ``--tol``" (or a shape mismatch): a checkpoint that cannot be
read, a kernel that fails to build or launch, raises.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from audiossl_tpu_torch.tools import add_device_flag, device_of

TORCH_RECIPE = '''\
# Run in a torch environment with the reference audiossl installed to
# record the golden embeddings this script compares against:
import numpy as np, torch, torchaudio
from audiossl.methods.atstframe.embedding import (
    load_model, get_scene_embedding, get_timestamp_embedding)
CKPT, WAV, OUT = "atstframe_base.ckpt", "clip.wav", "golden.npz"
model = load_model(CKPT)
wav, sr = torchaudio.load(WAV)   # float32 in [-1, 1]
assert sr == 16000, "resample to 16 kHz first"
wav = wav[:1]                    # mono [1, T]
with torch.no_grad():
    scene = get_scene_embedding(wav, model)
    ts, t_ms = get_timestamp_embedding(wav, model)
np.savez(OUT, scene=scene.cpu().numpy(),
         timestamp=ts.cpu().numpy(), timestamps_ms=t_ms.cpu().numpy())
'''


def load_wav(path: str) -> np.ndarray:
    """wav file -> float32 [1, T] in [-1, 1] (torchaudio.load
    normalization semantics for integer PCM): the first channel, 16 kHz
    only, nothing resampled."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if sr != 16000:
        raise SystemExit(f"expected 16 kHz wav, got {sr}")
    if data.ndim > 1:
        data = data[:, 0]
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    else:
        data = data.astype(np.float32)
    return data[None, :]


def probe_main(argv):
    """Linear-probe score parity (see the module docstring)."""
    p = argparse.ArgumentParser("verify_released probe")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--dataset_name", required=True)
    p.add_argument("--data_path", required=True)
    p.add_argument("--model_type", default="clip",
                   choices=["clip", "frame"])
    p.add_argument("--arch", default="small",
                   choices=["tiny", "small", "base"])
    p.add_argument("--expect", type=float, required=True,
                   help="test score of the reference's eval_*.sh run "
                        "(or the paper's published number)")
    p.add_argument("--tol", type=float, default=0.01)
    p.add_argument("--max_epochs", type=int, default=None,
                   help="override the recipe's probe epochs")
    add_device_flag(p)
    args = p.parse_args(argv)
    device_of(args)

    from audiossl_tpu_torch.downstream import train_freeze

    drv = ["--pretrained_ckpt_path", args.ckpt,
           "--data_path", args.data_path,
           "--dataset_name", args.dataset_name,
           "--model_type", args.model_type, "--arch", args.arch]
    if args.max_epochs is not None:
        drv += ["--max_epochs", str(args.max_epochs)]
    result = train_freeze.main(drv + ["--device", args.device,
                                      "--n_devices", "1"])
    score = float(result["test"])
    diff = abs(score - args.expect)
    out = {"dataset": args.dataset_name, "test_score": score,
           "expect": args.expect, "abs_diff": diff, "tol": args.tol,
           "ok": diff <= args.tol}
    print(json.dumps(out))
    return 0 if out["ok"] else 1


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    if argv[:1] == ["probe"]:
        return probe_main(argv[1:])
    p = argparse.ArgumentParser("verify_released")
    p.add_argument("--ckpt", help="reference .ckpt, or the port's "
                                  "pretraining state.pt")
    p.add_argument("--wav", help="16 kHz wav file")
    p.add_argument("--arch", default=None,
                   help="override arch (else from ckpt hparams)")
    p.add_argument("--golden", default=None,
                   help=".npz recorded on the torch side")
    p.add_argument("--out", default=None,
                   help="write our embeddings to this .npz")
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--print-torch-recipe", action="store_true")
    add_device_flag(p)
    args = p.parse_args(argv)

    if args.print_torch_recipe:
        print(TORCH_RECIPE)
        return 0
    if not args.ckpt or not args.wav:
        p.error("--ckpt and --wav are required (or --print-torch-recipe)")
    device = device_of(args)

    from audiossl_tpu_torch.embedding import (
        get_scene_embedding,
        get_timestamp_embedding,
        load_model,
    )

    model = load_model(args.ckpt, arch=args.arch, device=device)
    wav = load_wav(args.wav)
    scene = get_scene_embedding(wav, model).cpu().numpy()
    ts, t_ms = get_timestamp_embedding(wav, model)
    ts, t_ms = ts.cpu().numpy(), t_ms.cpu().numpy()

    if args.out:
        np.savez(args.out, scene=scene, timestamp=ts,
                 timestamps_ms=t_ms)

    result = {"scene_shape": list(scene.shape),
              "timestamp_shape": list(ts.shape)}
    ok = True
    if args.golden:
        g = np.load(args.golden)
        for key, ours in (("scene", scene), ("timestamp", ts)):
            want = np.asarray(g[key])
            if want.shape != ours.shape:
                result[f"{key}_shape_mismatch"] = list(want.shape)
                ok = False
                continue
            d = float(np.abs(ours - want).max())
            result[f"{key}_max_abs_diff"] = d
            ok = ok and d <= args.tol
        result["tol"] = args.tol
    result["ok"] = ok
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
