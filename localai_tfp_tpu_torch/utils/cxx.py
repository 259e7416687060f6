"""Build a host C++ source of ``csrc/`` into a shared library at first use.

``build(src)`` compiles ``src`` with ``g++ -O3 -std=c++17 -fPIC -shared``
into ``build/torch_kernels/lib<stem>-<hash>.so``, beside the CUDA kernels
of ops/_build.py; the hash covers the source and the flags, so an edited
source rebuilds and an unchanged one is reused. A failed compile raises
``RuntimeError`` with the compiler's error. The native grammar engine
(``grammars/native.py``) and the vector store (``store/native.py``) load
their libraries through it.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..ops._build import BUILD_DIR

CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")


def library_path(src: Path, build_dir: Path = BUILD_DIR) -> Path:
    """Where the library built from ``src`` lives."""
    src = Path(src)
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return Path(build_dir) / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build(src: Path, what: str, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``src`` into ``build_dir`` unless a current build exists;
    raise RuntimeError (naming ``what``) when the source is missing or the
    compiler fails."""
    src = Path(src)
    if not src.is_file():
        raise RuntimeError(f"{what} source missing: {src}")
    so = library_path(src, build_dir)
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    Path(build_dir).mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{what} build: {cxx}: {e}") from None
    if proc.returncode != 0:
        raise RuntimeError(f"{what} build failed "
                           f"(rc {proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    return so
