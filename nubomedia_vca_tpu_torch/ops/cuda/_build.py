"""Build the port's CUDA C++ sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, ``lib<name>_<digest>.so``, where the digest covers the sources and
the flags, so an edited source is rebuilt and an unchanged one is reused.
The library goes to the first of:

* ``$NUBOMEDIA_VCA_KERNEL_DIR``, when set;
* ``build/torch_kernels/`` of the checkout, when the package sits in one
  (its parent directory holds ``pyproject.toml``);
* ``~/.cache/nubomedia_vca_tpu_torch/kernels/`` for an installed package.

Building happens at first use, never at import: hosts without ``nvcc``
import the port and run its plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

PKG_DIR = pathlib.Path(__file__).resolve().parents[2]
SRC_DIR = PKG_DIR / "csrc"

# -fmad=false: no multiply-add contraction, so float32 results round like
# the reference's separate multiply and add (the sources also spell the
# rounding out with __fmul_rn/__fadd_rn). No --use_fast_math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of nubomedia_vca_tpu_torch build only on a host with the CUDA "
            "toolkit")
    return nvcc


def build_dir() -> pathlib.Path:
    """Where the built libraries go (see the module docstring)."""
    env = os.environ.get("NUBOMEDIA_VCA_KERNEL_DIR")
    if env:
        return pathlib.Path(env)
    root = PKG_DIR.parent
    if (root / "pyproject.toml").is_file():
        return root / "build" / "torch_kernels"
    return (pathlib.Path.home() / ".cache" / "nubomedia_vca_tpu_torch"
            / "kernels")


def _library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_library(name: str) -> tuple[pathlib.Path, str, float]:
    """Compile ``csrc/<name>.cu`` unless its library exists →
    (path, compiler log, build seconds; 0.0 when reused). The log holds
    ptxas's register and shared-memory report."""
    out = _library_path(name)
    if out.exists():
        return out, "", 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr, seconds


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (building it if needed)."""
    path, _, _ = build_library(name)
    return ctypes.CDLL(str(path))
