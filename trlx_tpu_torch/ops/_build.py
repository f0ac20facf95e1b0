"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` compiles with `nvcc` into its own shared library with a
plain C interface, which `ctypes` loads. Builds land in
`<repo>/build/kernels/<hash>/`, keyed by a hash of the sources and flags,
so an unchanged tree never builds twice and an edited source never loads
a stale library. All sources compile in parallel (one `nvcc` each, each
spreading its optimiser over the free cores: `--split-compile`); the
slowest, `paged_attention.cu`, compiles as two libraries side by side,
one a head width (`-DKERNEL_HEAD_DIM=64` / `128`).

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
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = (
    "flash_fwd.cu", "flash_bwd.cu", "flash_bias_fwd.cu", "flash_bias_bwd.cu",
    "decode_int8.cu", "paged_attention.cu", "adam8bit.cu", "int8_weight_matmul.cu",
)
HEAD_DIMS = (64, 128)  # the head widths the attention kernels are instantiated for (the bias ones: 64)
# sources built once a head width, each into a library of its own
SPLIT_BY_HEAD_DIM = ("paged_attention.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    # optimise each library's kernels on every free core: the sources finish
    # at different times, and the slowest would otherwise run on one
    "--split-compile=0",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_SECONDS: Dict[str, float] = {}  # each library's nvcc wall seconds in this process's build


def _units() -> Dict[str, tuple]:
    """{library stem: (source, extra nvcc flags)}: a library a source, or
    one a head width for SPLIT_BY_HEAD_DIM."""
    units = {}
    for name in SOURCES:
        stem = Path(name).stem
        if name in SPLIT_BY_HEAD_DIM:
            for d in HEAD_DIMS:
                units[f"{stem}_d{d}"] = (name, (f"-DKERNEL_HEAD_DIM={d}",))
        else:
            units[stem] = (name, ())
    return units


def library_stem(source: str, head_dim: Optional[int] = None) -> str:
    """The library that holds `source`'s kernels (for `head_dim`, when the
    source is built once a head width)."""
    stem = Path(source).stem
    if source in SPLIT_BY_HEAD_DIM:
        if head_dim not in HEAD_DIMS:
            raise ValueError(f"{source} is built for head widths {HEAD_DIMS}, not {head_dim}")
        return f"{stem}_d{head_dim}"
    return stem


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
    {library stem: library path}. Raises with nvcc's stderr on failure.
    The compiler's register/shared-memory report for each library is kept
    beside it as `<stem>.log`."""
    nvcc = nvcc_path()
    out_dir = _build_dir(nvcc)
    out_dir.mkdir(parents=True, exist_ok=True)
    units = _units()
    libs = {stem: out_dir / (stem + ".so") for stem in units}
    procs = []
    for name, lib in libs.items():
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        source, flags = units[name]
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", tmp, str(CSRC / source)]
        procs.append((name, lib, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )))
    # each compiler's output is drained by its own thread, which also
    # notes when that compiler finished
    outputs: Dict[str, tuple] = {}

    def drain(name, t0, proc):
        outputs[name] = proc.communicate()
        _SECONDS[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=drain, args=(name, t0, proc)) for name, _, _, t0, proc in procs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failures: List[str] = []
    for name, lib, tmp, _, proc in procs:
        stdout, stderr = outputs[name]
        (out_dir / (name + ".log")).write_text(stdout + stderr)
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed on {name} (exit {proc.returncode}):\n{stderr}")
        else:
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError("\n".join(failures))
    return libs


def build_seconds() -> Dict[str, float]:
    """Each source's nvcc wall seconds in this process's `build` (empty
    when every library was already built)."""
    return dict(_SECONDS)


def build_log() -> str:
    """The compiler reports (`-Xptxas -v`) of the current build."""
    out_dir = _build_dir(nvcc_path())
    return "\n".join(
        (out_dir / (stem + ".log")).read_text()
        for stem in _units()
        if (out_dir / (stem + ".log")).exists()
    )


def load(name: str, head_dim: Optional[int] = None) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>` (its `head_dim` one for a source
    built once a head width), building it first if needed."""
    stem = library_stem(name, head_dim)
    lib = _LIBS.get(stem)
    if lib is None:
        lib = ctypes.CDLL(str(build()[stem]))
        _LIBS[stem] = lib
    return lib
