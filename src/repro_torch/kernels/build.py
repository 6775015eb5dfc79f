"""Builds and loads the port's hand-written CUDA kernels; the checks every
wrapper shares.

Each kernel is one CUDA C++ source under ``csrc/`` with a plain C interface.
It is compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/repro_torch/`` at the repo root (listed in .gitignore) and loaded
through ``ctypes``. The library is named by the source's stem and a hash of
its bytes and of the headers it shares (``csrc/*.cuh``), so an edited
kernel is rebuilt and an unchanged one is reused.
Nothing here runs when a module is imported; without ``nvcc`` a build
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.obs import ranges

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_libs: dict = {}


def _nvcc(what: str) -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found: {what} cannot be built")
    return found


def library_path(source: str) -> Path:
    """Where ``csrc/<source>`` is built: its stem and a hash of its bytes
    and of the headers beside it."""
    src = CSRC / source
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}_{digest}.so"


def build_all(sources) -> dict:
    """Compile every ``csrc/<source>`` not built yet, one nvcc process each,
    all started together. Returns {source: (library path, compiler output)}
    and raises on the first source that fails to build."""
    todo, done = {}, {}
    for source in sources:
        out = library_path(source)
        if out.exists():
            done[source] = (out, "")
        else:
            todo[source] = out
    if not todo:
        return done
    with ranges.span(ranges.KERNELS_BUILD):
        nvcc = _nvcc(", ".join(todo))
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for source, out in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[source] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for source, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(
                    f"nvcc failed to build {CSRC / source}:\n{log}")
                continue
            os.replace(tmp, todo[source])
            done[source] = (todo[source], log)
        if failed:
            raise RuntimeError("\n".join(failed))
    return done


def build(source: str) -> tuple:
    """Compile ``csrc/<source>`` unless that exact source is built already.
    Returns (library path, compiler output)."""
    return build_all([source])[source]


def load(source: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>`` once per process.

    ``signatures`` maps each exported function to (argtypes, restype); every
    source also exports ``<stem>_error_string(int) -> const char*``."""
    lib = _libs.get(source)
    if lib is None:
        with ranges.span(ranges.KERNELS_LOAD):
            path, _ = build(source)
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            err = getattr(lib, f"{Path(source).stem}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[source] = lib
    return lib


def refuse_grad(what: str, *tensors) -> None:
    """Raise if autograd would record a call to a raw launcher.

    A launcher fills its output through ctypes, so autograd sees no graph
    through it: under grad mode an input that requires grad would get no
    gradient, silently. The way in under grad is the kernel's
    ``torch.autograd.Function`` (``Function.forward`` runs with grad mode
    off, so this check passes there)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} was called on a tensor that requires grad with grad "
            "mode on; its output would carry no gradient. Call it through "
            "its autograd Function (kernels/ops.py does) or under "
            "torch.no_grad()")


def check(lib: ctypes.CDLL, source: str, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = getattr(lib, f"{Path(source).stem}_error_string")(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")
