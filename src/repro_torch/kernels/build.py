"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C interface (``csrc/*.cuh`` are
headers they share).  It is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``<repo>/build/kernels/`` at first
use and loaded with ``ctypes``; nothing links against PyTorch, so a
build takes seconds.  The library's file name carries a hash of its
source and flags, so an edited source is rebuilt and never confused with
an old build; a variant built with extra flags (a ``-D`` macro) gets a
file of its own.  Callers set ``argtypes`` (``c_void_p`` for every
pointer and the stream) on the functions they call.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def sources() -> list:
    """Names of every kernel source (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def lib_path(name: str, flags: Tuple[str, ...] = ()) -> Path:
    """The library of ``csrc/<name>.cu`` built with ``flags`` on top of
    ``NVCC_FLAGS``."""
    # the hash covers the shared headers too: a source includes them
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    cmd = " ".join((*NVCC_FLAGS, *flags)).encode()
    digest = hashlib.sha256(src + cmd).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build(names: Optional[Iterable[str]] = None,
          flags: Tuple[str, ...] = ()) -> Dict[str, str]:
    """Compile every named source (default: all) that has no current
    library, with ``flags`` on top of ``NVCC_FLAGS``, one ``nvcc`` per
    source, all started together.  Returns each built source's compiler
    output (``-Xptxas -v``: registers, shared memory, spills); raises
    with that output if a build fails."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name, flags)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)       # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: cudaError {code} "
                           f"({msg})")
