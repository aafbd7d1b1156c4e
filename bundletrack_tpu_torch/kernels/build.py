"""Build and load the hand-written CUDA kernels and the host C helpers.

Each kernel source in `csrc/` (`.cu`) compiles with `nvcc` into a shared
library with a plain C interface, which is loaded with `ctypes`; a host
source (`.c`) compiles the same way with the host C compiler (`$CC`, else
`cc`).  The build happens at first use, never at import, into
`bundletrack_tpu_torch/_build/` (listed in .gitignore), keyed by a hash of
the flags, the source and every local header it includes from `csrc/`
(recursively), and for a host source the compiler too: a checkout builds
its own libraries on its first call, and a changed source, header, flag or
compiler rebuilds.  A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

HOST_FLAGS = ("-O3", "-shared", "-fPIC")

_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_lock = threading.Lock()
_loaded: dict = {}


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, else PATH, else the toolkit's usual place."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def host_compiler() -> str:
    """The host C compiler: $CC, else cc."""
    return os.environ.get("CC") or "cc"


def local_files(source: str) -> list:
    """`source` (a path relative to csrc/) and every file it includes with
    `#include "..."` that exists under csrc/, recursively, source first."""
    found, todo = [], [source]
    while todo:
        name = todo.pop(0)
        if name in found:
            continue
        found.append(name)
        with open(os.path.join(CSRC_DIR, name)) as f:
            text = f.read()
        for inc in _LOCAL_INCLUDE.findall(text):
            rel = os.path.normpath(os.path.join(os.path.dirname(name), inc))
            if os.path.isfile(os.path.join(CSRC_DIR, rel)):
                todo.append(rel)
    return found


def library_path(source: str, flags=None) -> str:
    """Where the library built from `source` (a file name in csrc/) with
    `flags` (nvcc's by default) lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS if flags is None else flags).encode())
    for name in local_files(source):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f"\0{name}\0".encode() + f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def _compile(compiler: str, flags, source: str, key) -> str:
    out = library_path(source, key)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [compiler, *flags, "-o", tmp, os.path.join(CSRC_DIR, source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{compiler} could not run on {source}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"{compiler} failed on {source} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def build(source: str) -> str:
    """Compile the kernel csrc/<source> with nvcc if its library is not
    built yet; returns its path."""
    return _compile(find_nvcc(), NVCC_FLAGS, source, NVCC_FLAGS)


def build_host(source: str) -> str:
    """Compile the host source csrc/<source> with the host C compiler if its
    library is not built yet; returns its path."""
    cc = host_compiler()
    return _compile(cc, HOST_FLAGS, source, (cc, *HOST_FLAGS))


def load(source: str) -> ctypes.CDLL:
    """The loaded library for csrc/<source>, built on first use (a `.c`
    source with the host compiler, a kernel with nvcc)."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(build_host(source) if source.endswith(".c") else build(source))
            _loaded[source] = lib
        return lib
