"""Parameter-server clients.

Rebuild of reference ``elephas/parameter/client.py:~1``:
``BaseParameterClient.get_client`` factory, ``HttpClient`` (urllib + pickle
against ``GET /parameters`` / ``POST /update``) and ``SocketClient`` (raw TCP,
``'g'``/``'u'`` opcodes). Wire format matches
:mod:`elephas_tpu_torch.parameter.server`.

A copy of ``elephas_tpu/parameter/client.py``: the wire carries pickled
numpy arrays only (a torch tensor handed to a push is sent as its numpy
copy), so a client of either package talks to a server of either package.
"""

from __future__ import annotations

import pickle
import socket
import threading
import urllib.error
import urllib.request
from typing import List, Optional

import numpy as np

from ..utils import sockets as socket_utils
from ..utils.sockets import determine_master


def _to_wire(delta):
    """A push as it goes on the wire: a list of numpy arrays, never torch
    tensors (read duck-typed, so this module imports no torch); a codec's
    encoded dict passes through."""
    if isinstance(delta, (list, tuple)):
        return [d.detach().cpu().numpy() if hasattr(d, "detach") else d
                for d in delta]
    return delta


class BaseParameterClient:
    @staticmethod
    def get_client(client_mode: str = "http", port: int = 4000,
                   host: Optional[str] = None,
                   timeout: float = 60.0,
                   fault_plan=None,
                   max_frame_bytes: Optional[int] = None,
                   stall_timeout_s: Optional[float] = None,
                   wire_version: Optional[int] = None
                   ) -> "BaseParameterClient":
        """Factory mirroring the reference's client selection
        (``parameter/client.py:~15``). ``timeout`` bounds every wire
        operation (the reference hard-codes 60s at each call site).
        The wire knobs (``fault_plan``'s byte-level sites,
        ``max_frame_bytes``, ``stall_timeout_s``, ``wire_version``) apply
        to the raw-TCP transport only; HTTP rides urllib's own framing."""
        if client_mode == "http":
            return HttpClient(port=port, host=host, timeout=timeout)
        if client_mode == "socket":
            return SocketClient(port=port, host=host, timeout=timeout,
                                fault_plan=fault_plan,
                                max_frame_bytes=max_frame_bytes,
                                stall_timeout_s=stall_timeout_s,
                                wire_version=wire_version)
        raise ValueError(f"Unknown parameter server mode: {client_mode}")

    #: highest server weight-version this client has observed (piggybacked
    #: on pulls where the transport allows; -1 = none yet / unsupported).
    #: FailoverClient uses it to bound staleness when re-targeting a standby.
    last_seen_version: int = -1

    def get_parameters(self) -> List[np.ndarray]:
        raise NotImplementedError

    def update_parameters(self, delta: List[np.ndarray]) -> None:
        raise NotImplementedError

    def get_version(self) -> int:
        """The server's monotonic weight version (+1 per applied delta).
        Returns -1 when the backend doesn't expose one — callers must treat
        that as "cannot bound staleness", not as version zero."""
        return -1

    def register_attempt(self, task_id: str, attempt: int) -> bool:
        """Announce a task attempt to the server (exactly-once retry support).

        Returns True if the server acknowledged the attempt API — callers
        should then push with :meth:`update_parameters_tagged`. The default
        (and any client talking to a server that predates the extension)
        returns False: pushes stay untagged and retry semantics degrade to
        the reference's (documented) at-least-once behavior. All three
        shipped backends (http, socket, native) implement the extension.
        """
        return False

    def update_parameters_tagged(self, task_id: str,
                                 delta: List[np.ndarray],
                                 attempt: Optional[int] = None) -> None:
        """Tagged push; ``attempt`` additionally lets the server fence
        pushes from superseded (zombie) attempts — see
        ``BaseParameterServer.apply_delta``."""
        self.update_parameters(delta)

    def commit_attempt(self, task_id: str) -> None:
        """Tell the server the task finished cleanly (frees its accumulator)."""

    def close(self) -> None:
        pass


class HttpClient(BaseParameterClient):
    """Pull/push pickled weight lists over HTTP."""

    def __init__(self, port: int = 4000, host: Optional[str] = None,
                 timeout: float = 60.0):
        if host is None:
            self.master_url = determine_master(port)
        else:
            self.master_url = f"{host}:{port}"
        self.timeout = float(timeout)
        self.last_seen_version = -1

    def get_parameters(self) -> List[np.ndarray]:
        with urllib.request.urlopen(
            f"http://{self.master_url}/parameters", timeout=self.timeout
        ) as resp:
            version = resp.headers.get("X-Elephas-Version")
            if version is not None:
                self.last_seen_version = int(version)
            return pickle.loads(resp.read())

    def get_version(self) -> int:
        try:
            with urllib.request.urlopen(
                f"http://{self.master_url}/version", timeout=self.timeout
            ) as resp:
                version = int(resp.read().decode().strip())
        except urllib.error.HTTPError as err:
            if err.code == 404:
                return -1  # pre-versioning server: staleness unbounded
            raise
        self.last_seen_version = max(self.last_seen_version, version)
        return version

    def update_parameters(self, delta: List[np.ndarray],
                          _extra_headers: Optional[dict] = None) -> None:
        payload = pickle.dumps(_to_wire(delta), protocol=pickle.HIGHEST_PROTOCOL)
        headers = {"Content-Type": "application/octet-stream"}
        headers.update(_extra_headers or {})
        req = urllib.request.Request(
            f"http://{self.master_url}/update",
            data=payload,
            headers=headers,
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            resp.read()

    def register_attempt(self, task_id: str, attempt: int) -> bool:
        req = urllib.request.Request(
            f"http://{self.master_url}/register",
            data=b"",
            headers={"X-Elephas-Task": task_id,
                     "X-Elephas-Attempt": str(int(attempt))},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                resp.read()
            return True
        except urllib.error.HTTPError as err:
            if err.code == 404:
                # A reference-shaped server has no /register route: degrade
                # to untagged at-least-once pushes.
                return False
            # Anything else (500/503/...) is a transient server fault, NOT
            # "no attempt API" — the server may have registered the attempt,
            # so degrading here would silently reopen the double-apply hole.
            # Surface it; the task-retry machinery handles it.
            raise

    def update_parameters_tagged(self, task_id: str,
                                 delta: List[np.ndarray],
                                 attempt: Optional[int] = None) -> None:
        headers = {"X-Elephas-Task": task_id}
        if attempt is not None:
            headers["X-Elephas-Attempt"] = str(int(attempt))
        self.update_parameters(delta, _extra_headers=headers)

    def commit_attempt(self, task_id: str) -> None:
        req = urllib.request.Request(
            f"http://{self.master_url}/commit",
            data=b"",
            headers={"X-Elephas-Task": task_id},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            resp.read()


class SocketClient(BaseParameterClient):
    """Persistent-connection TCP client (one connection per client instance).

    Thread-safe: pull/push pairs are serialized per client with a lock so the
    opcode stream cannot interleave across threads sharing a client.

    Broken-pipe recovery: a persistent socket goes stale whenever the peer
    resets (server restart, failover, idle LB reap). Every operation retries
    ONCE on a fresh connection after a ``ConnectionError``/``OSError`` —
    without this, the first op after a reset failed the whole worker task
    even though the server was back. Typed frame errors (corrupt/truncated/
    oversize/stalled — ``utils.sockets.FrameError``) are connection errors
    by design and take the same reconnect-and-retry path, counted in
    ``wire_errors``. ``socket.timeout`` is never blindly retried: a
    timed-out push may have been applied, and re-sending it is exactly the
    double-apply the attempt machinery exists to prevent (the retry
    decision belongs to the policy layer, which knows the semantics).

    Wire negotiation: with ``wire_version=None`` each fresh connection
    opens with the ``b"W"`` hello; a v2 server acks and the connection
    speaks checksummed v2 frames both ways, a legacy server closes on the
    unknown opcode and the client silently redials speaking legacy
    (``wire_version=1`` skips the probe; ``wire_version=2`` makes a
    missing ack a hard typed error).
    """

    def __init__(self, port: int = 4000, host: Optional[str] = None,
                 timeout: float = 60.0, *,
                 fault_plan=None,
                 max_frame_bytes: Optional[int] = None,
                 stall_timeout_s: Optional[float] = None,
                 wire_version: Optional[int] = None):
        if host is None:
            host = determine_master(port).rsplit(":", 1)[0]
        self.host = host
        self.port = int(port)
        self.timeout = float(timeout)
        self.fault_plan = fault_plan
        self.max_frame_bytes = (socket_utils.DEFAULT_MAX_FRAME_BYTES
                                if max_frame_bytes is None
                                else int(max_frame_bytes))
        # Mid-frame progress deadline (slow-loris defense): None keeps the
        # socket's own 60s op timeout as the only bound.
        self.stall_timeout_s = (None if stall_timeout_s is None
                                else float(stall_timeout_s))
        if wire_version not in (None, socket_utils.WIRE_V1,
                                socket_utils.WIRE_V2):
            raise ValueError(f"unknown wire_version {wire_version!r}")
        self._forced_wire = wire_version
        #: framing of the CURRENT connection (set per connect by the hello)
        self._conn_wire = socket_utils.WIRE_V1
        #: typed frame errors observed (corrupt replies, stalls, oversize)
        self.wire_errors = 0
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        # per-client receive buffer: weight pulls land in one reused
        # allocation instead of re-allocating a multi-MB payload per sync
        # round (safe: all receives happen under _lock, and sockets.receive
        # deserializes before returning)
        self._rxbuf = socket_utils.ReusableBuffer()
        self.last_seen_version = -1
        # Versioned-pull capability (opcode b"G" → (version, weights)).
        # Probed optimistically on the first pull; a legacy server closes
        # the connection on the unknown opcode, which degrades this client
        # to plain b"g" pulls (version piggyback off, like pre-header HTTP).
        self._versioned_pull = True

    @property
    def negotiated_wire_version(self) -> int:
        """Framing of the current (or most recent) connection."""
        return self._conn_wire

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout
        )
        plan = self.fault_plan
        if plan is not None and getattr(plan, "has_wire_faults",
                                        lambda: False)():
            sock = plan.wrap_socket(sock, site="client")
        return sock

    @staticmethod
    def _handshake(sock) -> bool:
        """Send the v2 hello; True iff the server acks it. A legacy server
        closes on the unknown opcode (recv returns b"") → False."""
        try:
            sock.sendall(socket_utils.NEGOTIATE_REQUEST)
            ack = b""
            while len(ack) < len(socket_utils.NEGOTIATE_ACK):
                chunk = sock.recv(len(socket_utils.NEGOTIATE_ACK) - len(ack))
                if not chunk:
                    return False
                ack += chunk
            return ack == socket_utils.NEGOTIATE_ACK
        except (ConnectionError, OSError):
            return False

    def _ensure(self) -> socket.socket:
        if self._sock is None:
            sock = self._connect()
            if self._forced_wire == socket_utils.WIRE_V1:
                self._conn_wire = socket_utils.WIRE_V1
            elif self._handshake(sock):
                self._conn_wire = socket_utils.WIRE_V2
            else:
                try:
                    sock.close()
                except OSError:
                    pass
                if self._forced_wire == socket_utils.WIRE_V2:
                    raise socket_utils.CorruptFrameError(
                        f"server {self.host}:{self.port} did not acknowledge "
                        "v2 framing (wire_version=2 was forced)"
                    )
                # Legacy peer: it closed our probe connection — redial and
                # speak the reference framing. Re-probed on every fresh
                # connection, so a later server upgrade is picked up.
                sock = self._connect()
                self._conn_wire = socket_utils.WIRE_V1
            self._sock = sock
        return self._sock

    def _send_frame(self, sock, obj) -> None:
        socket_utils.send(sock, obj, version=self._conn_wire)

    def _receive(self, sock):
        return socket_utils.receive(
            sock, buf=self._rxbuf, max_frame_bytes=self.max_frame_bytes,
            stall_timeout_s=self.stall_timeout_s, mid_message=True,
        )

    def _reset(self) -> None:
        # caller holds the lock
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _note_wire_error(self, err: BaseException) -> None:
        if isinstance(err, socket_utils.FrameError):
            self.wire_errors += 1
            plan = self.fault_plan
            if plan is not None and hasattr(plan, "note_wire_caught"):
                plan.note_wire_caught("client", err)

    def _roundtrip(self, op):
        """Run ``op(sock)`` with one reconnect on a stale connection.
        Caller holds the lock."""
        try:
            return op(self._ensure())
        except socket.timeout:
            raise
        except (ConnectionError, OSError) as err:
            self._note_wire_error(err)
            self._reset()
            try:
                return op(self._ensure())
            except socket.timeout:
                raise
            except (ConnectionError, OSError) as err2:
                # the fresh connection failed too: the server is genuinely
                # gone — drop the socket so a future call reconnects cleanly
                self._note_wire_error(err2)
                self._reset()
                raise

    @staticmethod
    def _expect_shape(reply, check: bool, what: str):
        """Reply-shape validation: a frame that decodes but has the wrong
        structure for the request (a duplicated/replayed reply desyncing
        the stream) is wire damage, typed so the reconnect path resyncs —
        not a bare TypeError deep in the caller."""
        if not check:
            raise socket_utils.CorruptFrameError(
                f"expected {what} reply, got {type(reply).__name__} "
                "(reply stream desynchronized?)"
            )
        return reply

    def get_parameters(self) -> List[np.ndarray]:
        def op_versioned(sock):
            sock.sendall(b"G")
            reply = self._receive(sock)
            return self._expect_shape(
                reply,
                isinstance(reply, tuple) and len(reply) == 2
                and isinstance(reply[0], (int, np.integer)),
                "(version, weights)",
            )

        def op_legacy(sock):
            sock.sendall(b"g")
            reply = self._receive(sock)
            return self._expect_shape(reply, isinstance(reply, list),
                                      "weight-list")

        with self._lock:
            if self._versioned_pull:
                try:
                    version, weights = self._roundtrip(op_versioned)
                except socket.timeout:
                    raise
                except socket_utils.FrameError:
                    # The server SPOKE (a frame arrived, just broken): this
                    # is wire damage, not a missing versioned-pull API —
                    # keep the capability and let the policy layer retry.
                    raise
                except (ConnectionError, OSError):
                    # Either a legacy server closed on the unknown opcode
                    # (no versioned-pull API) or the server is down — the
                    # plain pull distinguishes: it succeeds against a
                    # legacy server (stay degraded) and fails against a
                    # dead one (restore the probe so a recovered modern
                    # server gets its version piggyback back).
                    self._versioned_pull = False
                    self._reset()
                    try:
                        return self._roundtrip(op_legacy)
                    except (ConnectionError, OSError):
                        self._versioned_pull = True
                        raise
                self.last_seen_version = max(self.last_seen_version,
                                             int(version))
                return weights
            return self._roundtrip(op_legacy)

    def get_version(self) -> int:
        def op(sock):
            sock.sendall(b"v")
            reply = self._receive(sock)
            return int(self._expect_shape(
                reply, isinstance(reply, (int, np.integer)), "version-int"))

        with self._lock:
            version = self._roundtrip(op)
            self.last_seen_version = max(self.last_seen_version, version)
            return version

    def update_parameters(self, delta: List[np.ndarray]) -> None:
        def op(sock):
            sock.sendall(b"u")
            self._send_frame(sock, _to_wire(delta))

        with self._lock:
            self._roundtrip(op)

    def register_attempt(self, task_id: str, attempt: int) -> bool:
        with self._lock:
            ack = b""
            for retry in (False, True):
                sock = self._ensure()
                try:
                    sock.sendall(b"r")
                    self._send_frame(sock, (task_id, int(attempt)))
                    ack = sock.recv(1)
                except socket.timeout:
                    # Slow server ≠ missing attempt API: it may have
                    # registered the attempt, so degrading to untagged
                    # pushes here would reopen the double-apply hole. Let
                    # task retry handle it.
                    raise
                except (ConnectionError, OSError):
                    # A stale persistent socket dies on the FIRST write after
                    # a peer reset: reconnect once and re-ask. Registration
                    # is idempotent server-side, so the re-ask is safe.
                    self._reset()
                    if retry:
                        raise
                    continue
                break
            if ack == b"x":
                # The server answered "administratively down" (injected kill
                # / draining for failover) — unlike a legacy server's silent
                # close, this is an outage, not a missing attempt API.
                self._reset()
                raise ConnectionError(
                    "parameter server reports itself down"
                )
            if ack != b"k":
                # No-attempt-API server closed the connection (clean EOF) —
                # drop the dead socket so later plain pulls/pushes
                # reconnect, and degrade to untagged pushes.
                self._reset()
                return False
        return True

    def update_parameters_tagged(self, task_id: str,
                                 delta: List[np.ndarray],
                                 attempt: Optional[int] = None) -> None:
        def op(sock):
            if attempt is None:
                sock.sendall(b"t")
                self._send_frame(sock, (task_id, _to_wire(delta)))
            else:
                sock.sendall(b"a")
                self._send_frame(sock, (task_id, int(attempt), _to_wire(delta)))

        with self._lock:
            self._roundtrip(op)

    def commit_attempt(self, task_id: str) -> None:
        def op(sock):
            sock.sendall(b"c")
            self._send_frame(sock, task_id)

        with self._lock:
            self._roundtrip(op)

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                self._sock.close()
                self._sock = None
