"""The port's recipes (``recipes/torch_<name>.sh``) against the JAX
package's (``recipes/<name>.sh``), on the CPU:

* every JAX recipe has its torch recipe;
* its lines other than comments equal the JAX recipe's after two
  changes: ``python -m audiossl_tpu.`` becomes ``python -m
  audiossl_tpu_torch.``, and its own name stands in the usage string
  (``finetune_task.sh`` also escapes the ``}`` of ``{clip|frame}`` in its
  usage message: unescaped, it ends the ``${1:?...}`` expansion, so the
  JAX recipe runs ``CKPT`` as a command and exits 127 before Python; its
  arguments are compared with the JAX recipe's under the same repair);
* run by bash with a stand-in ``python`` that records its arguments, each
  recipe calls a module of the port whose ``build_parser()`` parses them,
  and the arguments are the JAX recipe's, for every choice its
  placeholders take (``clip`` and ``frame``, every dataset of
  ``finetune_task.sh``'s table, with and without its LR override).
"""
import importlib
import os
import re
import subprocess
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
RECIPES = ROOT / "recipes"
JAX_RECIPES = sorted(p.name for p in RECIPES.glob("*.sh")
                     if not p.name.startswith("torch_"))

# a stand-in for python: writes its arguments, one a line, and exits
FAKE_PYTHON = '#!/bin/bash\nprintf "%s\\n" "$@" > "$ARGV_OUT"\n'


# the usage message's brace, escaped in the torch recipe (see above)
BRACE = ("{clip|frame} CKPT DATA_DIR [LR]}",
         "{clip|frame\\} CKPT DATA_DIR [LR]}")


def repaired(line):
    return line.replace(*BRACE) if line.startswith("DS=${1:?usage:") else line


def code_lines(path):
    return [ln for ln in path.read_text().splitlines()
            if not ln.lstrip().startswith("#")]


def usage_words(name):
    """The positional arguments a recipe's usage string names."""
    text = (RECIPES / name).read_text()
    words = re.search(r"usage: \S+\.sh ([^}\n]*)\}", text)
    return words.group(1).split()


def placeholder_runs(name):
    """Every argument list to run the recipe with: a path-like stand-in
    for each argument, and each valid choice where it takes one."""
    text = (RECIPES / name).read_text()
    if name == "finetune_task.sh":
        cases = re.findall(r"^\s+(\w+):(clip|frame)\)", text, re.M)
        assert len(cases) == 14
        return [[ds, kind, "CKPT", "DATA", *lr]
                for ds, kind in cases for lr in ([], ["3e-2"])]
    runs = [[]]
    for w in usage_words(name):
        if "clip|frame" in w:
            choices = ["clip", "frame"]
        elif w == "ARCH":
            choices = ["frameatst"]
        elif w == "[LR]":
            choices = ["3e-2"]
        else:
            choices = [w.strip("[]")]
        runs = [r + [c] for r in runs for c in choices]
    return runs


def recorded_argv(script, args, tmp_path):
    """The arguments ``script`` hands ``python``, run by bash with
    ``args``."""
    bindir = tmp_path / "bin"
    bindir.mkdir(exist_ok=True)
    fake = bindir / "python"
    fake.write_text(FAKE_PYTHON)
    fake.chmod(0o755)
    out = tmp_path / "argv.txt"
    r = subprocess.run(
        ["bash", str(script), *args], capture_output=True, text=True,
        timeout=30, env={**os.environ, "ARGV_OUT": str(out),
                         "PATH": f"{bindir}:{os.environ['PATH']}"})
    assert r.returncode == 0, r.stderr
    return out.read_text().splitlines()


@pytest.mark.parametrize("name", JAX_RECIPES)
def test_torch_recipe_follows_jaxs(name, tmp_path):
    jax_path, torch_path = RECIPES / name, RECIPES / f"torch_{name}"
    assert torch_path.is_file(), f"no torch recipe for {name}"
    assert os.access(torch_path, os.X_OK)
    want = [ln.replace("python -m audiossl_tpu.",
                       "python -m audiossl_tpu_torch.")
            .replace(f"usage: {name}", f"usage: torch_{name}")
            for ln in map(repaired, code_lines(jax_path))]
    assert code_lines(torch_path) == want
    assert any("python -m audiossl_tpu_torch." in ln for ln in want)

    text = jax_path.read_text()
    fixed = "\n".join(map(repaired, text.splitlines())) + "\n"
    if fixed != text:  # the JAX recipe as it stands stops before Python
        bad = subprocess.run(["bash", str(jax_path), *placeholder_runs(
            name)[0]], capture_output=True, text=True, timeout=30)
        assert bad.returncode == 127 and "CKPT: command not found" in \
            bad.stderr
        jax_path = tmp_path / name
        jax_path.write_text(fixed)
    runs = placeholder_runs(name)
    assert runs and all(runs)
    for args in runs:
        jax_argv = recorded_argv(jax_path, args, tmp_path)
        argv = recorded_argv(torch_path, args, tmp_path)
        assert argv[0] == "-m" and argv[1].startswith("audiossl_tpu_torch.")
        assert argv[2:] == jax_argv[2:] and \
            jax_argv[1] == argv[1].replace("audiossl_tpu_torch.",
                                           "audiossl_tpu.", 1)
        parsed = importlib.import_module(argv[1]).build_parser().parse_args(
            argv[2:])
        assert parsed.device == "cuda", (name, args)
        if "--model_type" in argv:
            assert parsed.model_type == argv[argv.index("--model_type") + 1]
