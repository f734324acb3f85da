"""ctypes bindings for the native (C++) parameter server.

A copy of ``elephas_tpu/parameter/native.py``, over the same unchanged
``native/ps_server.cpp``. The reference's parameter server is pure Python
behind the GIL; this is its native runtime equivalent: contiguous
float32 weight buffers, a binary wire protocol (no pickle), one C++ thread per
connection, mutex vs lock-free (hogwild) delta application.

Selected with ``SparkModel(parameter_server_mode='native')``. The shared
library is compiled on first use with the system ``g++`` (pybind11 is not in
this environment — plain ``ctypes`` over an ``extern "C"`` API instead) and
cached under ``native/build/``.

Weights are handled as float32 on the wire and in the store. Dtypes whose
round-trip through float32 is lossless (float32, float16, bfloat16) are cast
in and restored on the way out; precision-losing dtypes (float64, integers,
bool) are rejected loudly at construction — silent f32 truncation of an
optimizer's f64 state is exactly the class of bug a cast would hide.

Exactly-once retry: the server implements the same R/T/C attempt extension
as the Python servers, so :class:`NativeClient` supports ``register_attempt``
/ ``update_parameters_tagged`` / ``commit_attempt`` and async task retry is
rollback-safe on every backend (see ``parameter/server.py`` for semantics).
"""

from __future__ import annotations

import ctypes
import socket
import struct
import threading
from typing import List, Optional

import numpy as np

from .client import BaseParameterClient

from ..native_build import load_native_library


def check_f32_safe(dtypes) -> None:
    """Reject dtypes the f32 store would silently truncate."""
    for i, dt in enumerate(dtypes):
        dt = np.dtype(dt) if not str(dt) == "bfloat16" else dt
        name = str(dt)
        if name in ("float32", "float16", "bfloat16"):
            continue
        raise ValueError(
            f"native parameter server stores float32: array {i} has dtype "
            f"{name}, whose values would be silently truncated — use "
            "parameter_server_mode='http'/'socket' for non-f32 weights"
        )


def _configure(lib: ctypes.CDLL) -> None:
    lib.eps_create.restype = ctypes.c_void_p
    lib.eps_create.argtypes = [ctypes.c_int]
    lib.eps_start.restype = ctypes.c_int
    lib.eps_start.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.eps_set_weights.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
    ]
    lib.eps_num_arrays.restype = ctypes.c_int
    lib.eps_num_arrays.argtypes = [ctypes.c_void_p]
    lib.eps_attempt_count.restype = ctypes.c_int
    lib.eps_attempt_count.argtypes = [ctypes.c_void_p]
    lib.eps_array_size.restype = ctypes.c_int64
    lib.eps_array_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.eps_get_array.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float)
    ]
    lib.eps_stop.argtypes = [ctypes.c_void_p]
    lib.eps_destroy.argtypes = [ctypes.c_void_p]


def _load_library() -> ctypes.CDLL:
    return load_native_library("libeps.so", _configure)


def native_available() -> bool:
    try:
        _load_library()
        return True
    except Exception:
        return False


class NativeServer:
    """Lifecycle wrapper over the C++ server; API-compatible with
    :class:`~elephas_tpu_torch.parameter.server.BaseParameterServer`."""

    def __init__(self, weights: List[np.ndarray], mode: str = "asynchronous",
                 port: int = 4000, **_kwargs):
        self._lib = _load_library()
        self._handle = self._lib.eps_create(1 if mode == "hogwild" else 0)
        self.mode = mode
        self.port = int(port)
        self._shapes = [np.asarray(w).shape for w in weights]
        self._dtypes = [np.asarray(w).dtype for w in weights]
        check_f32_safe(self._dtypes)
        self._set_weights(weights)
        self._running = False

    def _set_weights(self, weights: List[np.ndarray]) -> None:
        flat = [np.ascontiguousarray(np.asarray(w), dtype=np.float32).ravel()
                for w in weights]
        n = len(flat)
        sizes = (ctypes.c_int64 * n)(*[a.size for a in flat])
        ptrs = (ctypes.POINTER(ctypes.c_float) * n)(
            *[a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for a in flat]
        )
        self._lib.eps_set_weights(self._handle, n, sizes, ptrs)

    def start(self) -> None:
        bound = self._lib.eps_start(self._handle, self.port)
        if bound < 0:
            raise OSError(f"native parameter server failed to bind port {self.port}")
        self.port = bound
        self._running = True

    def get_weights(self) -> List[np.ndarray]:
        n = self._lib.eps_num_arrays(self._handle)
        out = []
        for i in range(n):
            size = self._lib.eps_array_size(self._handle, i)
            buf = np.empty(size, dtype=np.float32)
            self._lib.eps_get_array(
                self._handle, i, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            )
            out.append(buf.reshape(self._shapes[i]).astype(self._dtypes[i]))
        return out

    def attempt_count(self) -> int:
        """Live exactly-once attempt records (bounded; see ps_server.cpp)."""
        return int(self._lib.eps_attempt_count(self._handle))

    def stop(self) -> None:
        if self._handle is not None and self._running:
            self._lib.eps_stop(self._handle)
            self._running = False

    def __del__(self):
        try:
            self.stop()
            if self._handle is not None:
                self._lib.eps_destroy(self._handle)
                self._handle = None
        except Exception:
            pass


class NativeClient(BaseParameterClient):
    """Binary-protocol client for :class:`NativeServer`.

    Python-side framing is just ``struct`` + raw ``ndarray`` bytes — no
    pickle. Shapes/dtypes are fixed at construction (the weight schema of one
    model), as the wire carries flat float32 buffers only.
    """

    def __init__(self, shapes, dtypes, port: int, host: str = "127.0.0.1",
                 codec=None):
        self.shapes = list(shapes)
        self.dtypes = list(dtypes)
        check_f32_safe(self.dtypes)
        self.host = host
        self.port = int(port)
        # Delta compression (parameter/compression.py codec object, one per
        # client — top-k error-feedback residual is per-worker state). The
        # codec's dict form is re-framed onto the binary wire (V/W opcodes)
        # and decoded to dense f32 server-side.
        self.codec = codec
        self._tagged = False  # set once the attempt API is in use
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def _ensure(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection((self.host, self.port),
                                                  timeout=60)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return self._sock

    @staticmethod
    def _read_exact(sock: socket.socket, n: int) -> bytes:
        chunks = []
        while n > 0:
            chunk = sock.recv(min(n, 1 << 20))
            if not chunk:
                raise ConnectionError("native PS closed connection")
            chunks.append(chunk)
            n -= len(chunk)
        return b"".join(chunks)

    def _reset_socket(self) -> None:
        """Drop a possibly-desynced connection so the next call reconnects.

        A timed-out or half-read exchange leaves unread bytes in the stream;
        reusing the socket would let a stale ack byte be parsed as part of a
        later length field, producing confusing failures far from the cause.
        """
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def get_parameters(self) -> List[np.ndarray]:
        with self._lock:
            sock = self._ensure()
            try:
                sock.sendall(b"G")
                (n_arrays,) = struct.unpack("<I", self._read_exact(sock, 4))
                out = []
                for i in range(n_arrays):
                    (nelem,) = struct.unpack("<Q", self._read_exact(sock, 8))
                    buf = np.frombuffer(
                        self._read_exact(sock, int(nelem) * 4), dtype="<f4"
                    )
                    out.append(
                        buf.reshape(self.shapes[i]).astype(self.dtypes[i]))
                return out
            except Exception:
                self._reset_socket()
                raise

    @staticmethod
    def _delta_payload(delta: List[np.ndarray]) -> List[bytes]:
        parts = [struct.pack("<I", len(delta))]
        for d in delta:
            flat = np.ascontiguousarray(d, dtype="<f4").ravel()
            parts.append(struct.pack("<Q", flat.size))
            parts.append(flat.tobytes())
        return parts

    def _compressed_payload(self, delta: List[np.ndarray]) -> List[bytes]:
        """Codec dict → the binary V/W frame set (see ps_server.cpp)."""
        enc = self.codec.encode(delta)
        arrays = enc["arrays"]
        parts = [struct.pack("<I", len(arrays))]
        if enc["__elephas_codec__"] == "int8":
            for a in arrays:
                q = np.ascontiguousarray(a["q"], dtype=np.int8).ravel()
                parts.append(struct.pack("<BQf", 1, q.size, a["scale"]))
                parts.append(q.tobytes())
        else:  # topk
            for a in arrays:
                idx = np.ascontiguousarray(a["idx"], dtype="<i8").ravel()
                vals = np.ascontiguousarray(a["vals"], dtype="<f4").ravel()
                nelem = int(np.prod(a["shape"])) if a["shape"] else 1
                parts.append(struct.pack("<BQQ", 2, nelem, idx.size))
                parts.append(idx.tobytes())
                parts.append(vals.tobytes())
        return parts

    def _push(self, header: List[bytes], payload: List[bytes]) -> None:
        with self._lock:
            sock = self._ensure()
            try:
                sock.sendall(b"".join(header + payload))
                ack = self._read_exact(sock, 1)
            except Exception:
                self._reset_socket()
                raise
            if ack != b"A":
                self._reset_socket()
                raise ConnectionError(f"native PS bad ack: {ack!r}")

    def update_parameters(self, delta: List[np.ndarray]) -> None:
        if self.codec is not None:
            self._push([b"V"], self._compressed_payload(delta))
        else:
            self._push([b"U"], self._delta_payload(delta))

    @staticmethod
    def _task_id_frame(task_id: str) -> List[bytes]:
        raw = task_id.encode("utf-8")
        return [struct.pack("<I", len(raw)), raw]

    def register_attempt(self, task_id: str, attempt: int) -> bool:
        with self._lock:
            sock = self._ensure()
            try:
                sock.sendall(b"".join(
                    [b"R"] + self._task_id_frame(task_id)
                    + [struct.pack("<I", int(attempt))]
                ))
                ack = self._read_exact(sock, 1)
            except socket.timeout:
                # Slow server ≠ missing attempt API (it may have registered
                # the attempt) — degrading to untagged pushes would reopen
                # the double-apply hole. Let task retry handle it.
                raise
            except ConnectionError:
                # A pre-extension server dropping the unknown 'R' opcode is
                # indistinguishable on this binary protocol from a transient
                # reset on a CURRENT server — which may already have created
                # the attempt record with the ack lost. Degrading to
                # untagged pushes in that second case silently reopens the
                # double-apply hole the extension closes, so the safe
                # direction is to fail the attempt (task retry handles it).
                # Every shipped native server implements the extension;
                # pre-extension servers are not supported for degradation.
                self._reset_socket()
                raise
            if ack != b"k":
                self._reset_socket()
                return False
        self._tagged = True
        return True

    def update_parameters_tagged(self, task_id: str,
                                 delta: List[np.ndarray],
                                 attempt=None) -> None:
        # ``attempt`` is accepted for wrapper-stack compatibility but not
        # carried on the native binary protocol: the native server fences by
        # rollback-on-register only (no per-push zombie fencing). get_version
        # likewise stays at the base -1 ("cannot bound staleness").
        if self.codec is not None:
            self._push([b"W"] + self._task_id_frame(task_id),
                       self._compressed_payload(delta))
        else:
            self._push([b"T"] + self._task_id_frame(task_id),
                       self._delta_payload(delta))

    def _push_raw(self, delta: List[np.ndarray]) -> None:
        """Exact f32 push, bypassing the codec (residual flushes)."""
        self._push([b"U"], self._delta_payload(delta))

    def _push_raw_tagged(self, task_id: str, delta: List[np.ndarray]) -> None:
        self._push([b"T"] + self._task_id_frame(task_id),
                   self._delta_payload(delta))

    def commit_attempt(self, task_id: str) -> None:
        from .compression import flush_residual

        # flush BEFORE committing, tagged: a failed flush fails the task
        # pre-commit and rollback erases everything (exactly-once holds)
        flush_residual(self.codec, self._push_raw, self._push_raw_tagged,
                       task_id)
        with self._lock:
            sock = self._ensure()
            sock.sendall(b"".join([b"C"] + self._task_id_frame(task_id)))
            ack = self._read_exact(sock, 1)
            if ack != b"A":
                raise ConnectionError(f"native PS bad ack: {ack!r}")

    def close(self) -> None:
        # Untagged workflow only (see CompressingClient.close): a tagged
        # client's nonzero residual at close means the attempt FAILED — an
        # untagged flush would escape the retry's rollback (double-apply).
        if not self._tagged:
            from .compression import flush_residual

            try:
                flush_residual(self.codec, self._push_raw,
                               self._push_raw_tagged)  # best-effort
            except Exception:
                pass
        with self._lock:
            if self._sock is not None:
                self._sock.close()
                self._sock = None
