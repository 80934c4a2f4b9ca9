"""PyTorch port: it imports neither JAX nor the JAX package (nor flax,
msgpack or optax, which the card's machine lacks), its entry points never
drop to the CPU on their own, and its kernel modules import on a host with
no CUDA compiler and no Triton."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "deer_vla_tpu_torch"


def port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def run_python(code: str, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax_and_no_jax_package():
    mods = port_modules()
    for name in ("eval.scan_policy", "eval.policy", "eval.caching",
                 "eval.batched_policy", "eval.batched_rollout", "ops.tome",
                 "models.llama", "models.alt_heads", "models.diffusion",
                 "models.normalizer", "eval.diffusion_policy"):
        assert f"deer_vla_tpu_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                    'msgpack', 'optax',\n"
        "                                    'deer_vla_tpu'))\n"
        "print('BAD', bad)\n")
    out = run_python(code)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_kernel_modules_import_without_nvcc_or_triton(tmp_path):
    """No compiler on PATH and a CUDA_HOME without one: the kernel modules
    still import, run their plain versions on CPU tensors, and only the
    build itself reports the missing compiler."""
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    code = (
        "import sys, torch\n"
        "from deer_vla_tpu_torch.ops.kernels import build\n"
        "from deer_vla_tpu_torch.ops.kernels.flash_attention import "
        "flash_attention\n"
        "from deer_vla_tpu_torch.ops.kernels.indexed_matmul import "
        "indexed_matmul, indexed_matmul_q4, indexed_matmul_q8\n"
        "assert 'triton' not in sys.modules\n"
        "q = torch.randn(1, 2, 130, 16)\n"
        "assert flash_attention(q, q, q).shape == q.shape\n"
        "w = torch.randn(3, 16, 8)\n"
        "assert indexed_matmul(q[0, 0], w, 1).shape == (130, 8)\n"
        "wq = torch.ones(3, 16, 8, dtype=torch.int8)\n"
        "s = torch.ones(3, 8)\n"
        "assert indexed_matmul_q8(q[0, 0], wq, s, 1).shape == (130, 8)\n"
        "assert indexed_matmul_q4(q[0, 0], wq[:, :8], s, 1).shape == (130, 8)\n"
        "assert flash_attention.launches == indexed_matmul.launches == 0\n"
        "assert indexed_matmul_q8.launches == indexed_matmul_q4.launches == 0\n"
        "try:\n"
        "    build.find_nvcc()\n"
        "except RuntimeError:\n"
        "    print('NO_NVCC')\n")
    out = run_python(code, env)
    assert out.returncode == 0, out.stderr
    assert "NO_NVCC" in out.stdout


def test_policy_without_device_raises_when_no_card(monkeypatch):
    from deer_vla_tpu_torch.core.config import deer_tiny
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    from deer_vla_tpu_torch.models.flamingo import init_deer

    cfg = deer_tiny()
    params = init_deer(cfg, seed=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScanDeerPolicy(params, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_deer(cfg, seed=0)
    pol = ScanDeerPolicy(params, cfg, device="cpu")
    assert pol.device == torch.device("cpu")
    assert all(b.device.type == "cpu" for b in pol.buffers())
    r = np.random.RandomState(0)
    img = r.randn(1, 1, 1, 3, 28, 28).astype(np.float32)
    ids = np.full((1, cfg.text_len), 7, np.int32)
    ids[0, 0] = cfg.media_token_id
    act = pol.step(img, img, ids, np.ones_like(ids))
    assert act.shape == (7,) and np.isfinite(act).all()
    assert pol.last_exit_layer in cfg.all_exit_ids()


def test_eval_cli_without_device_raises_when_no_card(monkeypatch):
    from deer_vla_tpu_torch.cli import eval as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--debug", "--model", "tiny", "--calib_batches", "1",
                  "--num_sequences_override", "1"])


def test_train_cli_without_device_raises_when_no_card(monkeypatch,
                                                     tmp_path):
    from deer_vla_tpu_torch.cli import train as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--debug", "--model", "tiny", "--run_name",
                  str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_new_eval_modules_are_walked():
    mods = port_modules()
    for m in ("cli.eval", "eval.calibrate", "eval.rollout",
              "eval.batched_rollout", "data.preprocess", "train.checkpoint"):
        assert f"deer_vla_tpu_torch.{m}" in mods


def test_new_train_modules_are_walked():
    mods = port_modules()
    for m in ("cli.train", "train.losses", "train.optimizer",
              "train.train_step", "train.trainer", "train.msgpack_io",
              "utils.heartbeat", "ops.dropout", "ops.kernels.guard"):
        assert f"deer_vla_tpu_torch.{m}" in mods


def test_new_data_modules_are_walked_and_build_nothing_at_import():
    """The CALVIN data layer is walked by the import check above; importing
    it builds no native library and imports no h5py (real_hdf5 imports it
    inside the functions that open a file)."""
    import ast
    mods = port_modules()
    for m in ("data.calvin", "data.native_loader", "data.real_hdf5",
              "data.debug_data"):
        assert f"deer_vla_tpu_torch.{m}" in mods
    code = (
        "import sys\n"
        "from deer_vla_tpu_torch.data import calvin, native_loader, "
        "real_hdf5\n"
        "assert native_loader._lib is None and native_loader._error is None\n"
        "print('H5PY', 'h5py' in sys.modules)\n")
    out = run_python(code)
    assert out.returncode == 0, out.stderr
    assert "H5PY False" in out.stdout
    tree = ast.parse((PORT / "data" / "real_hdf5.py").read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    assert not any(a.name == "h5py" for n in top for a in n.names)
    inner = [n for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)
             for n in ast.walk(f) if isinstance(n, ast.Import)]
    assert sum(a.name == "h5py" for n in inner for a in n.names) == 2
