"""The port stands alone: it imports no JAX, nothing of the JAX package and no
PIL (the machine with the card has none),
and its entry points need CUDA unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "a_pytorch_tutorial_to_class_incremental_learning_tpu_torch"
JAX_PKG = "a_pytorch_tutorial_to_class_incremental_learning_tpu"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", JAX_PKG, "cil_tpu", "PIL")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO, PORT)):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    tree = ast.parse(open(path).read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call):  # importlib.import_module("jax"), __import__
            for arg in node.args:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
                        and _forbidden(arg.value):
                    bad.append(arg.value)
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        f"import {PORT} as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith(p.__name__)]))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


def test_default_platform_without_cuda_raises(monkeypatch):
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import CilTrainer
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.config import CilConfig
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = CilConfig(data_set="synthetic10", aa=None, color_jitter=0.0)
    for device in (None, "default", "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            CilTrainer(cfg, device=device)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_trainer(["--data_set", "synthetic10", "--aa", "none", "--color_jitter", "0"])

    # The serving entry points: the server and the replica load their
    # artifacts on the card unless --platform cpu is given.
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.serving import (
        replica,
        server,
    )

    for argv in (["--export_dir", "nowhere"], ["--export_dir", "nowhere", "--platform", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            server.main(argv)
        with pytest.raises(RuntimeError, match="CUDA"):
            replica.main([*argv, "--replica_id", "0", "--port", "0"])
    # With --platform cpu they get past the device and stop at the empty
    # export dir instead.
    with pytest.raises(FileNotFoundError, match="no artifact published"):
        server.main(["--export_dir", "nowhere", "--platform", "cpu"])
    with pytest.raises(FileNotFoundError, match="no artifact published"):
        replica.main(["--export_dir", "nowhere", "--platform", "cpu", "--replica_id", "0",
                      "--port", "0"])


def test_chip_smoke_fails_without_cuda_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    for cwd, script in ((REPO, "chip_smoke.py"), (str(tmp_path), str(alone))):
        proc = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_image_folder_decodes_without_pil_or_jax():
    """Building the ``imagenet1000`` dataset from the committed fixtures and
    decoding a batch, train and eval, leaves PIL and JAX unimported."""
    fixtures = os.path.join(REPO, "tests", "fixtures", "images")
    code = (
        "import os, shutil, sys, tempfile\n"
        f"from {PORT}.data import build_raw_dataset, datasets\n"
        "root = tempfile.mkdtemp()\n"
        "for split in ('train', 'val'):\n"
        "    for c in ('a', 'b'):\n"
        "        d = os.path.join(root, split, c)\n"
        "        os.makedirs(d)\n"
        f"        for f in sorted(os.listdir({fixtures!r}))[:4]:\n"
        f"            os.symlink(os.path.join({fixtures!r}, f), os.path.join(d, f))\n"
        "(x, y), n = build_raw_dataset('imagenet1000', root, True)\n"
        "assert x.dtype == object and n == 2\n"
        "paths = x[[p.endswith(('.jpg', '.png', '.JPEG')) for p in x]]\n"
        "for train in (True, False):\n"
        "    b = datasets.decode_image_batch(paths, 64, train, 0)\n"
        "    assert b.shape == (len(paths), 64, 64, 3), b.shape\n"
        "shutil.rmtree(root)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok', len(paths))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")
