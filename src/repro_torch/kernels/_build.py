"""Build the CUDA kernels at first use and bind them with ``ctypes``.

Every ``kernels/csrc/*.cu`` file compiles to its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu

All sources build in parallel, one ``nvcc`` each, into
``build/repro_torch_kernels/<hash>/`` at the repository root, where the hash
covers every source and header and the flags; ``ptxas``'s register and spill
report goes to ``<name>.log`` beside each library.  A build failure raises with
the compiler's output.  Nothing is built or loaded when this module is
imported: the first kernel launch does it.

Each C entry point returns ``cudaGetLastError()``; :func:`check` raises when
that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                       "the CUDA kernels need the CUDA toolkit")


def build_all() -> Path:
    """Compile every source whose library is missing, all in parallel."""
    out = build_dir()
    todo = [s for s in sources() if not (out / f"lib{s.stem}.so").exists()]
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        tmp = out / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        (out / f"{src.stem}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {src.name} (exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out / f"lib{src.stem}.so")   # atomic for concurrent builds
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str, signatures: dict[str, tuple[list, object]]) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` with ``argtypes``/``restype``
    set from ``signatures`` ({function: (argtypes, restype)})."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
        for fn, (argtypes, restype) in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        _LIBS[name] = lib
    return lib


def slots(n: int, kernel: str, run: int) -> int:
    """The partial slots a ``*_partials`` entry point reported for ``run``;
    it reports -1 for a run with no kernel instance, which raises."""
    if n < 0:
        raise ValueError(f"{kernel}: no kernel instance marches runs of {run} planes")
    return n


#: the C entry points' suffix for each dtype a solver kernel takes
_SUFFIX = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16"}
SUFFIXES = tuple(_SUFFIX.values())


def suffix(dtype: torch.dtype) -> str:
    """``f64``, ``f32`` or ``bf16``: the suffix of a solver kernel's C entry
    point for operands of ``dtype``."""
    return _SUFFIX[dtype]


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of a kernel's partial slots and dots: ``dtype``, float32
    for bfloat16 (the reference's accumulation rule)."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def check(err: int, kernel: str) -> None:
    """Raise when a C entry point reports a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} (cudaError_t) at launch")
