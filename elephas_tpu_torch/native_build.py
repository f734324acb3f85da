"""Shared build/load plumbing for the native (C++) runtime components (a
copy of ``elephas_tpu/native_build.py``: both packages build the same
unchanged ``native/`` sources into the same ``native/build/``).

One home for the compile-on-first-use logic the parameter server and the
data loader both need: ``make`` the shared library under ``native/build/``
if absent, ``ctypes.CDLL`` it, run the component's signature-configuration
hook, and cache per library name (double-checked under one lock).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Callable, Dict

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def load_native_library(lib_name: str,
                        configure: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Load ``native/build/<lib_name>`` (building via ``make`` if needed),
    apply ``configure(lib)`` to declare restype/argtypes, and cache."""
    lib = _libs.get(lib_name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(lib_name)
        if lib is not None:
            return lib
        path = os.path.join(NATIVE_DIR, "build", lib_name)
        # Always invoke make (a no-op when up to date): gating on the .so's
        # existence would keep serving a stale library after source changes.
        # An fcntl lock serializes concurrent PROCESSES (the module lock only
        # covers threads); the Makefile also renames atomically, so a reader
        # can never CDLL a half-written library.
        import fcntl

        build_dir = os.path.join(NATIVE_DIR, "build")
        try:
            os.makedirs(build_dir, exist_ok=True)
            with open(os.path.join(build_dir, ".lock"), "w") as lockf:
                fcntl.flock(lockf, fcntl.LOCK_EX)
                proc = subprocess.run(
                    ["make", "-C", NATIVE_DIR], capture_output=True, text=True
                )
            rc, err = proc.returncode, proc.stderr
        except OSError as e:
            # Read-only install (prebuilt .so shipped, tree unwritable):
            # fall through to loading the existing library.
            rc, err = -1, f"cannot write {build_dir}: {e}"
        if rc != 0:
            if not os.path.exists(path) or _stale(path):
                # No library, or one older than the sources: loading would
                # run code that no longer matches the tree. Fail loudly.
                raise RuntimeError(
                    f"native build failed (make -C {NATIVE_DIR}):\n"
                    f"{err[-2000:]}"
                )
            # Up-to-date .so + failed/impossible make (missing toolchain or
            # read-only install): usable, but say so.
            import warnings

            warnings.warn(
                f"make -C {NATIVE_DIR} failed (rc={rc}); "
                f"loading existing up-to-date {lib_name}",
                RuntimeWarning,
                stacklevel=2,
            )
        lib = ctypes.CDLL(path)
        configure(lib)
        _libs[lib_name] = lib
        return lib


def _stale(lib_path: str) -> bool:
    """Is any native source newer than the built library?"""
    lib_mtime = os.path.getmtime(lib_path)
    for name in os.listdir(NATIVE_DIR):
        if name.endswith((".cpp", ".h", ".cc")) or name == "Makefile":
            if os.path.getmtime(os.path.join(NATIVE_DIR, name)) > lib_mtime:
                return True
    return False
