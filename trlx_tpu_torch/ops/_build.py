"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` compiles with `nvcc` into its own shared library with a
plain C interface, which `ctypes` loads. Builds land in
`<repo>/build/kernels/<hash>/`, keyed by a hash of the sources and flags,
so an unchanged tree never builds twice and an edited source never loads
a stale library. All sources compile in parallel (one `nvcc` each).

Nothing here runs at import: the wrappers call `load()` from their CUDA
branch, so the package imports on machines without `nvcc` or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "decode_int8.cu", "paged_attention.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH); the CUDA kernels cannot be built"
        )
    return found


def _build_dir(nvcc: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join((nvcc,) + NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh")):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Dict[str, Path]:
    """Compile every missing kernel library (in parallel) and return
    {source name: library path}. Raises with nvcc's stderr on failure.
    The compiler's register/shared-memory report for each source is kept
    beside its library as `<name>.log`."""
    nvcc = nvcc_path()
    out_dir = _build_dir(nvcc)
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: out_dir / (Path(name).stem + ".so") for name in SOURCES}
    procs = []
    for name, lib in libs.items():
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / name)]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )))
    failures: List[str] = []
    for name, lib, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        (out_dir / (Path(name).stem + ".log")).write_text(stdout + stderr)
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed on {name} (exit {proc.returncode}):\n{stderr}")
        else:
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError("\n".join(failures))
    return libs


def build_log() -> str:
    """The compiler reports (`-Xptxas -v`) of the current build."""
    out_dir = _build_dir(nvcc_path())
    return "\n".join(
        (out_dir / (Path(name).stem + ".log")).read_text()
        for name in SOURCES
        if (out_dir / (Path(name).stem + ".log")).exists()
    )


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>`, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build()[name]))
        _LIBS[name] = lib
    return lib
