"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use into ``build/lib<name>-<hash>.so`` inside the package (a directory that
``.gitignore`` lists); the hash covers the source, every shared header
``csrc/*.cuh`` (which any source may include), the flags and the header
generated for it, so an edit never loads a stale library.  A source whose
instantiations Python decides (``flash_attention``: the attention tiles,
``gemm``: the GEMM tiles and ring depths, ``rwkv6``: the chunk, the
sub-chunk and the built head sizes, ``ssm_scan``: the chunk, the block
size and the built (N, states a thread) pairs of
:mod:`repro_torch.kernels.autotile`) gets that header written beside its
library and included before it (``-include``).  No PyTorch header is
compiled, which keeps a build to seconds.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}   # one loaded library per source


def refuse_autograd(what: str, *tensors) -> None:
    """Raise if autograd would record a kernel call: no kernel has a
    backward pass, so its output would carry no ``grad_fn`` and a training
    step would silently lose the gradients of everything upstream (the
    reference never differentiates a ``pallas_call`` either: it trains on
    its plain path).  Train with ``backend="ref"``; run the kernels under
    ``torch.no_grad()`` / ``torch.inference_mode()`` or on tensors that do
    not require grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {what} kernel has no backward pass, and an input requires "
            "grad: train with backend='ref' (the plain path, which autograd "
            "differentiates), or call it under torch.no_grad()")


def sources() -> list[str]:
    """Names of every CUDA source of the port."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of repro_torch are built on the machine "
                       "with the card")


def header(name: str) -> str:
    """Text of the header generated for ``csrc/<name>.cu`` ("" if none)."""
    if name == "flash_attention":
        from .autotile import attention_tiles_header
        return attention_tiles_header()
    if name == "gemm":
        from .autotile import gemm_tiles_header
        return gemm_tiles_header()
    if name == "rwkv6":
        from .autotile import rwkv6_tiles_header
        return rwkv6_tiles_header()
    if name == "ssm_scan":
        from .autotile import ssm_tiles_header
        return ssm_tiles_header()
    return ""


def lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for shared in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(shared.name.encode() + shared.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode() + header(name).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Compile every source not yet built, one ``nvcc`` per source, all
    started together.  Returns ``{name: compiler log}`` (``-Xptxas -v``
    prints registers, shared memory and spills per kernel) for the sources
    it compiled, and keeps each log beside its library as ``.log``; raises
    with the compiler's output if any build fails."""
    names = sources() if names is None else names
    todo = [n for n in names if not lib_path(n).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
        if header(n):
            h = lib_path(n).with_suffix(".h")
            h.with_suffix(f".{os.getpid()}.h").write_text(header(n))
            os.replace(h.with_suffix(f".{os.getpid()}.h"), h)
            cmd[1:1] = ["-include", str(h)]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    logs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        logs[n] = proc.communicate()[0]
        lib_path(n).with_suffix(".log").write_text(logs[n])
        if proc.returncode == 0:
            os.replace(tmp, lib_path(n))
        else:
            failed.append(n)
    if failed:
        raise RuntimeError("nvcc failed for "
                           + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str, prototypes: dict) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` (building it if needed),
    with ``argtypes``/``restype`` set from ``{symbol: (restype, argtypes)}``."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        for sym, (restype, argtypes) in prototypes.items():
            fn = getattr(lib, sym)
            fn.restype = restype
            fn.argtypes = argtypes
        _LOADED[name] = lib
    return lib
