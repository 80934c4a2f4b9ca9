"""PyTorch port, the package surface: the lazy public API of
``deer_vla_tpu_torch/__init__.py`` against the JAX package's, and the
compile cache (``utils/compile_cache.py``, DEER_COMPILE_CACHE) as the
directory the kernel library is built into and loaded from, enabled by
``utils/errors.record`` as every CLI main is, with no CUDA compiler."""

import subprocess
import sys
from pathlib import Path

import pytest

import deer_vla_tpu
import deer_vla_tpu_torch
from deer_vla_tpu_torch.ops.kernels import build
from deer_vla_tpu_torch.utils import compile_cache
from deer_vla_tpu_torch.utils.errors import record

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]


def test_lazy_api_names_and_modules_mirror_jax():
    assert list(deer_vla_tpu_torch._LAZY) == list(deer_vla_tpu._LAZY)
    assert deer_vla_tpu_torch.__all__ == deer_vla_tpu.__all__
    for name, mod in deer_vla_tpu_torch._LAZY.items():
        assert mod == deer_vla_tpu._LAZY[name].replace(
            "deer_vla_tpu", "deer_vla_tpu_torch", 1), name


@pytest.mark.parametrize("name", list(deer_vla_tpu._LAZY))
def test_lazy_api_name_resolves_in_the_port(name):
    obj = getattr(deer_vla_tpu_torch, name)
    mod = sys.modules[deer_vla_tpu_torch._LAZY[name]]
    assert obj is getattr(mod, name)
    if callable(obj) and hasattr(obj, "__module__"):
        assert obj.__module__.startswith("deer_vla_tpu_torch."), obj
    if name == "FusedDeerPolicy":
        assert mod.__name__ == "deer_vla_tpu_torch.eval.fused_policy"


def test_package_import_stays_cheap():
    """``import deer_vla_tpu_torch`` loads none of its modules (nor torch);
    an unknown name raises AttributeError."""
    code = ("import sys, deer_vla_tpu_torch as p\n"
            "assert 'torch' not in sys.modules\n"
            "assert not [m for m in sys.modules\n"
            "            if m.startswith(p.__name__ + '.')]\n"
            "try:\n"
            "    p.no_such_name\n"
            "except AttributeError:\n"
            "    print('OK')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr


@pytest.fixture
def no_cache(monkeypatch):
    """The cache unset for the test, restored after it."""
    monkeypatch.setattr(compile_cache._Cache, "path", None)
    monkeypatch.delenv("DEER_COMPILE_CACHE", raising=False)


def test_compile_cache_is_the_build_directory(tmp_path, monkeypatch,
                                              no_cache):
    assert build.build_dir() == build.DEFAULT_BUILD_DIR
    assert build.DEFAULT_BUILD_DIR.parts[-2:] == ("build", "torch_kernels")
    assert compile_cache.maybe_enable_compile_cache() is None
    assert build.build_dir() == build.DEFAULT_BUILD_DIR
    path = tmp_path / "a" / "cache"
    got = compile_cache.enable_compile_cache(str(path), min_compile_secs=5)
    assert got == str(path) and path.is_dir()
    assert build.build_dir() == path
    assert build.build_info()["dir"] == str(path)
    monkeypatch.setenv("DEER_COMPILE_CACHE", str(tmp_path / "env"))
    assert compile_cache.maybe_enable_compile_cache() == str(tmp_path / "env")
    assert build.build_dir() == tmp_path / "env"


def test_record_enables_the_cache_and_a_cached_library_needs_no_nvcc(
        tmp_path, monkeypatch, no_cache):
    """A CLI main (through ``record``) with DEER_COMPILE_CACHE set looks
    the library up in that directory; one already there for the sources'
    digest is taken as it is, with no compiler on PATH or CUDA_HOME."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    cache = tmp_path / "cache"
    monkeypatch.setenv("DEER_COMPILE_CACHE", str(cache))

    @record(error_file=str(tmp_path / "crash.jsonl"))
    def main():
        assert build.build_dir() == cache
        (cache / build.library_name()).write_bytes(b"built elsewhere")
        return build.build_library()

    assert main() == cache / build.library_name()
    assert not list(cache.glob("*.o"))  # nothing was compiled
