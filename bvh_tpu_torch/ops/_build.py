"""Builds the port's native code from the checkout at first use.

Two kinds of shared library, both loaded with ``ctypes`` through a plain C
interface:

* the CUDA kernels (``bvh_tpu_torch/csrc/*.cu``), compiled by ``nvcc`` for
  Hopper (``sm_90a``) with ``-fmad=false`` so that every product is rounded
  on its own, exactly as the kernels' plain PyTorch versions round it;
* the host scene builder (``csrc/*.cpp`` of the repository), compiled by
  ``g++`` with the flags of ``csrc/Makefile``.

Libraries land in ``bvh_tpu_torch/_build/`` (git-ignored) under a name that
carries a hash of the sources and the command, so an edited source is
rebuilt and an unchanged one is loaded as it is. A build writes a temporary
file and renames it into place, so concurrent processes never load a half
written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from .. import obs

PKG_DIR = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG_DIR / "_build"
CUDA_SRC_DIR = PKG_DIR / "csrc"
HOST_SRC_DIR = PKG_DIR.parent / "csrc"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]
# csrc/Makefile's flags: -ffp-contract=off keeps the float32 arithmetic
# bit-identical to the numpy builder.
GXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-ffp-contract=off",
             "-Wall", "-shared", "-pthread"]


def _nvcc() -> str:
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def build_library(name: str, sources: list[Path], cmd: list[str],
                  headers: list[Path] = ()) -> Path:
    """Compiles ``sources`` with ``cmd`` (compiler and flags, no output
    flag) into ``_build/lib<name>-<hash>.so`` unless it already exists.
    ``headers`` are hashed with the sources but not passed to the
    compiler. Keeps the build's seconds in the counter
    ``lib_build_s.<name>`` (0 for a library that was already built)."""
    h = hashlib.sha256(" ".join(cmd[1:]).encode())
    for src in [*sources, *headers]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        obs.count(f"lib_build_s.{name}", 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd + [str(s) for s in sources] + ["-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {name} failed ({cmd[0]} exit "
                           f"{proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    obs.count(f"lib_build_s.{name}", time.perf_counter() - t0)
    return out


def load_cuda_library(name: str, source: str) -> ctypes.CDLL:
    """Builds (if needed) and loads one ``csrc/*.cu`` kernel library (every
    ``csrc/*.cuh`` counts as its header)."""
    path = build_library(name, [CUDA_SRC_DIR / source], [_nvcc()] + NVCC_FLAGS,
                         headers=sorted(CUDA_SRC_DIR.glob("*.cuh")))
    return ctypes.CDLL(str(path))


def load_host_library() -> ctypes.CDLL:
    """Builds (if needed) and loads the host scene builder from ``csrc/``."""
    sources = [HOST_SRC_DIR / f for f in
               ("sah_builder.cpp", "collapse.cpp", "pack.cpp")]
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native scene builder needs it "
                           "(build with use_native=False for the numpy path)")
    path = build_library("bvhbuild", sources, [cxx] + GXX_FLAGS)
    return ctypes.CDLL(str(path))
