"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``qpth_tpu_torch/csrc/*.cu`` becomes its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds, not
minutes). On first use every source is compiled at once, one ``nvcc`` per
source, into ``build/qpth_tpu_torch/`` beside the package. A library is
named after the hash of its sources and flags, so an edited source is
rebuilt and an unchanged one is reused. A failed build raises with nvcc's
output; a successful one keeps it beside the library (``.log``: ptxas's
registers, stack and spills per kernel).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "qpth_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_all() -> list[Path]:
    """Compile every source whose library is missing, all in parallel.
    Returns the library paths."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = [(src, _lib_path(src)) for src in sources()]
    procs = []
    for src, out in targets:
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name} "
                          f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
            out.with_suffix(".log").write_text(log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [out for _, out in targets]


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``, building all
    sources first if needed."""
    lib = _libs.get(stem)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_lib_path(CSRC / f"{stem}.cu")))
        _libs[stem] = lib
    return lib
