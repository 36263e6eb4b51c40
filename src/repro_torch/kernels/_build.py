"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface.  It
is compiled for Hopper into a shared library,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so csrc/<name>.cu

and loaded with ``ctypes``.  Libraries land in ``build/repro_torch_kernels/``
at the root of the checkout, in a directory named by a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
not.  Only the checkout's own sources go in.  ``ptxas``'s report of each
kernel's registers and shared memory is kept beside the library
(``ptxas.log``) for ``chip_smoke.py`` to print.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError("nvcc not found on PATH or under /usr/local/cuda/bin")


def build_dir(name: str) -> Path:
    """Where ``name``'s library goes: keyed by its source and flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / f"{name}-{digest}"


def _tmp_path(name: str) -> Path:
    return build_dir(name) / f"lib{name}.so.tmp{os.getpid()}"


def _start(name: str) -> "subprocess.Popen[bytes] | None":
    out = build_dir(name)
    if (out / f"lib{name}.so").exists():
        return None
    out.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(_tmp_path(name)), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _finish(name: str, proc: "subprocess.Popen[bytes]") -> None:
    log, _ = proc.communicate()
    out = build_dir(name)
    text = log.decode(errors="replace")
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed for {name} (rc {proc.returncode}):\n{text}")
    (out / "ptxas.log").write_text(text)
    os.replace(_tmp_path(name), out / f"lib{name}.so")


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, all ``nvcc``
    processes started together; return each library's path."""
    with _lock:
        procs = {n: _start(n) for n in names}
        for n, p in procs.items():
            if p is not None:
                _finish(n, p)
    return {n: build_dir(n) / f"lib{n}.so" for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if need be."""
    lib = _loaded.get(name)
    if lib is None:
        path = build([name])[name]
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(path))
                _loaded[name] = lib
    return lib


def ptxas_report(name: str) -> str:
    """``ptxas -v``'s lines for a built kernel (registers, shared memory,
    spills); empty if it was built by an earlier process without a log."""
    log = build_dir(name) / "ptxas.log"
    return log.read_text() if log.exists() else ""
