"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so`` next
to the sources, then loaded with ``ctypes`` (``build_library`` also builds
the native host code of ``utils/native.py`` with ``g++``). The hash covers
the sources and the flags, so an edited source rebuilds and an unchanged one
is reused. The build directory is listed in ``.gitignore``;
``MMTPU_TORCH_BUILD_DIR`` moves it.

``refuse_grad`` is the guard of every kernel wrapper without a backward:
on the card such a kernel's output has no ``grad_fn``, so a gradient that
would have to pass through it is refused instead of dropped.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_name_locks: dict = {}
_loaded: dict = {}


class BuildInfo:
    """What one build did: library path, seconds spent in nvcc (0 when the
    cached library was reused) and the compiler's report (ptxas registers,
    shared memory and spills)."""

    def __init__(self, path: Path, seconds: float, log: str):
        self.path = path
        self.seconds = seconds
        self.log = log


def build_dir() -> Path:
    return Path(os.environ.get("MMTPU_TORCH_BUILD_DIR", PKG_DIR / "_build"))


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are "
        "compiled on the machine with the card"
    )


def build_library(name: str, sources, flags, compiler) -> BuildInfo:
    """Compile ``sources`` into ``_build/lib<name>-<hash>.so`` unless a
    library of the same sources and flags is already built; ``compiler()``
    names the compiler. Raises with the compiler's output on failure."""
    digest = hashlib.sha1(b"".join(Path(s).read_bytes() for s in sources)
                          + " ".join(flags).encode())
    out_dir = build_dir()
    lib = out_dir / f"lib{name}-{digest.hexdigest()[:12]}.so"
    if lib.exists():
        return BuildInfo(lib, 0.0, "")
    out_dir.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent process never sees
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [compiler(), *flags, "-o", tmp, *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"build failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    return BuildInfo(lib, seconds, proc.stdout + proc.stderr)


def build(name: str) -> BuildInfo:
    """Compile ``csrc/<name>.cu`` with nvcc unless a library of the same
    source and flags is already built; raises with nvcc's output on
    failure."""
    return build_library(name, [CSRC_DIR / f"{name}.cu"], NVCC_FLAGS, find_nvcc)


def load(name: str):
    """The loaded library of ``csrc/<name>.cu`` and its ``BuildInfo``,
    built on the first call in the process. Different sources build
    concurrently when loaded from several threads."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name not in _loaded:
            info = build(name)
            _loaded[name] = (ctypes.CDLL(str(info.path)), info)
        return _loaded[name]


def refuse_grad(wrapper: str, *tensors) -> None:
    """Raise if autograd would need a gradient through ``wrapper``'s kernel,
    which has none: grad mode is on and an input (None is skipped) requires
    a gradient. Called on the CUDA branch only: on the CPU the plain version
    carries the gradient. Under ``torch.no_grad()`` or
    ``torch.inference_mode()`` it passes."""
    import torch

    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{wrapper}: its CUDA kernel has no backward and an input requires a gradient; "
            "run it under torch.no_grad() or torch.inference_mode(), or on CPU tensors"
        )
