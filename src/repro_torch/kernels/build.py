"""Build and load the port's CUDA kernels.

Each kernel is one ``.cu`` file (and the ``.cuh`` headers beside it
that it includes) with plain C entry points, compiled by ``nvcc`` for
``sm_90a`` into its own shared library and called through ``ctypes`` (no
PyTorch headers: such a build takes seconds, where one that includes
``torch/extension.h`` takes minutes). Builds happen at first use on the
card, never at import, into ``_build/`` beside this file; the library
name carries a hash of the kernel directory's sources and the flags, so
an edited source or header rebuilds. ``build`` starts one ``nvcc`` per
kernel, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR / "_build"
SOURCES = {
    "histogram": KERNEL_DIR / "histogram" / "histogram.cu",
    "gf2_rank": KERNEL_DIR / "gf2_rank" / "gf2_rank.cu",
    "flash_attention": KERNEL_DIR / "flash_attention" / "flash_attention.cu",
    "mwc": KERNEL_DIR / "mwc" / "mwc.cu",
}
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where kernel ``name``'s shared library is built: the name carries a
    hash of every ``*.cu`` and ``*.cuh`` in the kernel's directory (names
    and contents, in sorted order) and of the flags, so an edit to an
    included header rebuilds too."""
    h = hashlib.sha256()
    src_dir = SOURCES[name].parent
    for path in sorted([*src_dir.glob("*.cu"), *src_dir.glob("*.cuh")]):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, dict]:
    """Compile every named kernel that is not built yet, one ``nvcc``
    each, all started together. Returns ``{name: {"seconds", "ptxas"}}``
    for the kernels compiled here (``ptxas`` is the compiler's register
    and shared-memory report). Raises with the compiler's output when a
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    report = {}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def call_on(device, fn, *args) -> int:
    """``fn(*args)`` with ``device`` the current CUDA device, entering its
    context only when it is not current already (host time per launch);
    returns what ``fn`` returns, a CUDA error code."""
    import torch
    if device.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
