"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (pointers, ints and the
stream as ``void*``; the return value is ``cudaGetLastError()``). It is
compiled on its own by ``nvcc`` for ``sm_90a`` into
``csrc/build/<name>-<hash>.so``, where the hash covers the source, every
header it includes from ``csrc/`` (``#include "..."``, followed through
headers) and the flags, so an edited source or header rebuilds the
libraries that include it and an unchanged one loads the library already
built. No PyTorch headers are included, so a build takes seconds.

Threads: the host parameter-server path launches kernels from one thread
per worker, so :func:`load` builds and loads each library once under a
lock, and every wrapper counts its launches through :func:`count_launch`,
which takes a lock of its own (a bare ``fn.launches += 1`` can lose a
count between threads).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()
_count_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(src: Path) -> List[Path]:
    """``src`` and every header it includes with quotes, followed through
    the headers, each once, in the order first met."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / m.decode() for m in _INCLUDE.findall(path.read_bytes())]
    return seen


def _target(name: str, src: Optional[Path] = None) -> Tuple[Path, Path]:
    src = src or CSRC / f"{name}.cu"
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(src):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return src, BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str, src: Optional[Path] = None):
    """Start ``nvcc`` for one source into a temporary file; ``None`` when the
    library for this source hash is already built."""
    src, out = _target(name, src)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing


def build(names: Iterable[str]) -> List[str]:
    """Compile every named kernel whose library is missing, one ``nvcc`` per
    source, all started together; returns the names that were compiled."""
    names = list(names)
    jobs = {n: _start(n) for n in names}
    built = []
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)
            built.append(n)
    return built


def load(name: str, signatures: Dict[str, list], src: Optional[Path] = None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (or for the source ``src``,
    which must export ``error_string`` too), built first if needed.
    ``signatures`` maps each C entry point to its ``argtypes``; every entry
    returns ``int`` (a ``cudaError_t``)."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _load_lock:    # threads that arrive together build and load it once
        lib = _loaded.get(name)
        if lib is None:
            job = _start(name, src)
            if job is not None:
                _finish(name, job)
            lib = ctypes.CDLL(str(_target(name, src)[1]))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
    return lib


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, exactly, whichever thread launched."""
    with _count_lock:
        wrapper.launches += 1


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point: a
    refused launch never runs, and no later synchronise would report it."""
    if err:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
