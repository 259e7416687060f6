"""Build the port's hand-written CUDA kernels at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled by
``nvcc`` for ``sm_90a`` into ``build/torch_kernels/lib<name>-<hash>.so``
(the hash covers the source and the flags, so an edited source rebuilds)
and loaded with ``ctypes``. Nothing includes PyTorch's headers: a build
takes seconds. The ``-Xptxas -v`` report (registers, shared memory,
spills) is kept beside the library and returned with it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass
class Built:
    name: str
    path: Path
    seconds: float  # nvcc wall time (0.0 when an existing build was reused)
    ptxas: str  # the -Xptxas -v report


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_built: dict[str, Built] = {}


def nvcc_path() -> str:
    """nvcc from PATH, else from $CUDA_HOME (default /usr/local/cuda)."""
    exe = shutil.which("nvcc")
    if exe is None:
        home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        cand = os.path.join(home, "bin", "nvcc")
        exe = cand if os.path.exists(cand) else None
    if exe is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from csrc/ at first "
            "use and need the CUDA toolkit on PATH or under $CUDA_HOME")
    return exe


def _target(name: str) -> tuple[Path, Path, Path]:
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"kernel source missing: {src}")
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    tag = h.hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}-{tag}.so"
    return src, so, so.with_suffix(".ptxas.txt")


def build_all(names: list[str]) -> dict[str, Built]:
    """Compile every named kernel that has no current build, one nvcc per
    source, all started together; raise if any build fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = {}
        for name in names:
            if name in _built:
                continue
            src, so, log = _target(name)
            if so.exists() and log.exists():
                _built[name] = Built(name, so, 0.0, log.read_text())
                continue
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, so, log, tmp, time.perf_counter())
        errors = []
        for name, (proc, so, log, tmp, t0) in jobs.items():
            out, _ = proc.communicate()
            dt = time.perf_counter() - t0
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name} "
                              f"(rc {proc.returncode}):\n{out}")
                continue
            os.replace(tmp, so)
            log.write_text(out)
            _built[name] = Built(name, so, dt, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        return {n: _built[n] for n in names}


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The kernel library, built on first use. ``declare`` sets the
    ``argtypes``/``restype`` of its C functions once, when it is loaded."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    built = build_all([name])[name]
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(built.path))
            declare(lib)
            _libs[name] = lib
    return lib
