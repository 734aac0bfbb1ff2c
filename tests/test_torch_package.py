"""Package rules of the port: it imports nothing of JAX and nothing of the
JAX package, builds nothing at import time, and keeps the build helpers'
contracts (rebuild on a changed source, raise on a failed launch)."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"import jax|from jax|from repro[. ]|import repro[. ]")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_no_jax_and_no_reference_package():
    hits = [f"{p.relative_to(ROOT)}:{i}: {line.strip()}"
            for p in _port_files()
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if FORBIDDEN.search(line)]
    assert hits == []


def test_importing_every_module_builds_and_loads_nothing():
    """In a fresh interpreter: import all modules, then no library is
    loaded and no nvcc ran (the CPU hosts have none)."""
    mods = []
    for p in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        rel = p.relative_to(ROOT / "src").with_suffix("")
        mods.append(".".join(rel.parts).replace(".__init__", ""))
    assert {"repro_torch.serving", "repro_torch.serving.engine",
            "repro_torch.serving.pool", "repro_torch.serving.paging",
            "repro_torch.serving.scheduler",
            "repro_torch.kernels.paged_attn",
            "repro_torch.kernels.slstm_cell",
            "repro_torch.kernels.go_topk",
            "repro_torch.models.xlstm"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from repro_torch.kernels import build\n"
            "assert build._LIBS == {} and build.BUILD_LOG == {}\n"
            "assert 'jax' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=300)


def test_library_name_follows_the_source_hash(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = build._lib_path(src)
    src.write_text("// two\n")
    assert build._lib_path(src) != first
    assert first.name.startswith("libk_") and first.suffix == ".so"


def test_build_dir_is_inside_the_checkout_unless_overridden(monkeypatch,
                                                            tmp_path):
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    assert build.build_dir() == ROOT / "build" / "repro_torch_kernels"
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert build.build_dir() == tmp_path


def test_installed_package_builds_into_the_user_cache(monkeypatch, tmp_path):
    """Outside a checkout (site-packages) the libraries go to the per-user
    cache, never next to the interpreter's prefix."""
    site = tmp_path / "lib" / "python3" / "site-packages"
    monkeypatch.setattr(build, "__file__",
                        str(site / "repro_torch" / "kernels" / "build.py"))
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert build.build_dir() == tmp_path / "cache" / "repro_torch_kernels"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert build.build_dir() == (tmp_path / "home" / ".cache"
                                 / "repro_torch_kernels")


def test_failed_launch_raises():
    build.check(0, "ok")
    with pytest.raises(RuntimeError, match="cudaError 9"):
        build.check(9, "gmm_swiglu")


def test_kernel_sources_ship_with_the_package():
    assert (build.CSRC / "moe_gmm.cu").is_file()
    assert (build.CSRC / "paged_attn.cu").is_file()
    assert (build.CSRC / "slstm_cell.cu").is_file()
    assert (build.CSRC / "go_topk.cu").is_file()
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
