"""Parameter servers: HTTP and raw-TCP, interoperable with the reference
via per-connection wire negotiation.

A copy of ``elephas_tpu/parameter/server.py`` (standard library and numpy
only): the same routes, opcodes and pickled numpy payloads, so a client of
either package talks to a server of either package. Beyond the copy each
server counts the pulls it answered (``pulls``) beside its applied pushes
(``version``).

Rebuild of reference ``elephas/parameter/server.py:~1`` (``BaseParameterServer``,
``HttpServer`` — Flask ``GET /parameters`` / ``POST /update`` under a
``threading.Lock`` skipped for hogwild — and ``SocketServer`` — raw TCP with
``'g'``/``'u'`` opcodes and per-connection threads).

These servers are the host path: the compiled path merges the replicas on
the device (``elephas_tpu_torch/parallel/engine.py``) and never touches a
server. The host servers serve (a) behavioral parity with the reference's
asynchronous/hogwild semantics, including genuine interleaving races, and
(b) deployments where workers span hosts.

Differences from the reference, deliberate:
- Flask is not in this environment; ``http.server.ThreadingHTTPServer`` serves
  the same two routes with the same pickle payloads.
- The server runs in a daemon *thread*, not a forked ``multiprocessing``
  process — workers here are threads in the same process (local mesh), so a
  fork would only add IPC latency. The lock/hogwild distinction is unchanged.

Wire formats (SocketServer): connections open speaking the reference's
ASCII-header framing; a client that sends the ``b"W"`` hello
(``utils.sockets.NEGOTIATE_REQUEST``) is acked and the connection switches
to checksummed v2 frames both ways — so reference-shaped clients and v2
clients share one port. Frame decode failures (corrupt/garbage/truncated/
oversize — ``utils.sockets.FrameError``) quarantine THAT connection only
(closed, counted in ``wire_errors``); other connections are untouched and
the rejected payload is never applied.

Security note: payloads are pickled Python objects, exactly like the
reference — only ever bind these servers on trusted networks. They listen
on ``host`` (default ``127.0.0.1``, the address every client of the port
dials; the reference binds ``0.0.0.0``): widen it only where workers run on
other machines of a trusted network.
``max_frame_bytes`` bounds what a hostile peer can make the server
allocate, but unpickling itself is code execution: the frame layer is a
corruption detector, not an authentication boundary.
"""

from __future__ import annotations

import http.server
import pickle
import socket
import threading
from typing import Any, List, Optional, Tuple

import numpy as np

from ..utils import sockets as socket_utils
from ..utils.functional_utils import subtract_params_np


class BaseParameterServer:
    """Common state: the master weight list, a lock, lifecycle flags.

    ``mode='hogwild'`` skips lock acquisition on update, accepting races by
    design (reference ``parameter/server.py:~70``).
    """

    def __init__(self, weights: List[np.ndarray], mode: str = "asynchronous",
                 port: int = 4000, fault_plan: Any = None,
                 name: str = "primary", **_kwargs):
        self.weights = [np.array(w) for w in weights]
        self.mode = mode
        self.port = int(port)
        # the address the server listens on (keyword ``host``)
        self.host = str(_kwargs.get("host", "127.0.0.1"))
        # Injection hook (resilience.FaultPlan, duck-typed so this module
        # never imports the resilience package): lets chaos tests lose
        # deltas server-side — the push "arrived" but its application is
        # dropped — and stall reads, independent of any client wrapper.
        # crash_sites={"kill-<name>": k} kills THIS server at its k-th
        # request: every subsequent operation raises ConnectionError
        # (fail-stop for new traffic; already-accepted work, including the
        # replication queue, drains normally).
        self.fault_plan = fault_plan
        self.name = str(name)
        self.lock = threading.Lock()
        self._running = False
        self._dead = False
        # task_id -> {"attempt": int, "delta": accumulated delta or None}.
        # Supports exactly-once retry semantics: see register_attempt.
        # Insertion-ordered; bounded by _MAX_ATTEMPT_RECORDS (below).
        self._attempts: dict = {}
        # task_id -> highest attempt ever registered. A push tagged with a
        # LOWER attempt is a zombie (its task was superseded by a backup or
        # retry): rejected outright, even after the winner committed and
        # dropped its accumulator — the fence is what makes first-finish-wins
        # exactly-once against the straggler that eventually wakes up.
        # Bounded like _attempts; kept on commit (that is the point).
        self._fence: dict = {}
        # Monotonic weight version: +1 per applied delta. Lets clients bound
        # staleness across failover (FailoverClient compares counters) and
        # makes "no committed update lost" checkable: after replication
        # drains, standby.version >= primary.version.
        self.version = 0
        # Pulls answered (plain and versioned), counted under their own
        # lock so concurrent pulls never lose a count.
        self.pulls = 0
        self._pulls_lock = threading.Lock()
        self.applied_tagged: dict = {}   # task_id -> applied tagged deltas
        self.rejected_stale = 0          # pushes refused by attempt fence
        # Hot-standby replication: an ordered queue of (op, args) applied to
        # the standby by a daemon thread — asynchronous, so the primary's
        # request path never blocks on the standby.
        self._standby = None
        self._repl_queue: Any = None
        self._repl_thread: Any = None
        self.replication_errors = 0
        # Typed frame errors caught on this server's connections (corrupt /
        # truncated / oversize / stalled frames, unknown opcodes). Each one
        # quarantined its connection; none of them touched the weights.
        self.wire_errors = 0

    # -- liveness (injected kill) ----------------------------------------
    def _check_alive(self) -> None:
        """Raise ConnectionError if this server has been killed (or dies
        right now: its fault plan fires ``kill-<name>`` at this request)."""
        if self._dead:
            raise ConnectionError(
                f"parameter server {self.name!r} is down (injected kill)"
            )
        if self.fault_plan is not None:
            try:
                self.fault_plan.tick(f"kill-{self.name}")
            except Exception as err:
                self._dead = True
                raise ConnectionError(
                    f"parameter server {self.name!r} killed (injected)"
                ) from err

    # -- hot-standby replication -----------------------------------------
    def attach_standby(self, standby: "BaseParameterServer") -> None:
        """Stream every applied delta / register / commit to ``standby``,
        in order, asynchronously. The standby applies the same operations
        through its own ``apply_delta``/``register_attempt``/
        ``commit_attempt``, so its version counter advances comparably and
        its attempt table mirrors the primary's."""
        import queue as queue_mod

        self._standby = standby
        self._repl_queue = queue_mod.Queue()
        self._repl_thread = threading.Thread(
            target=self._replication_loop, daemon=True,
            name=f"ps-replication-{self.name}",
        )
        self._repl_thread.start()

    def _replication_loop(self) -> None:
        while True:
            item = self._repl_queue.get()
            try:
                if item is None:
                    return
                op, args = item
                try:
                    if op == "delta":
                        self._standby.apply_delta(*args)
                    elif op == "register":
                        self._standby.register_attempt(*args)
                    elif op == "commit":
                        self._standby.commit_attempt(*args)
                except Exception:
                    # A sick standby must not take the primary down with it.
                    self.replication_errors += 1
            finally:
                self._repl_queue.task_done()

    def _replicate(self, op: str, *args: Any) -> None:
        if self._repl_queue is not None:
            self._repl_queue.put((op, args))

    def flush_replication(self) -> None:
        """Block until every queued replication op has been applied."""
        if self._repl_queue is not None:
            self._repl_queue.join()

    # Abandoned-record bound: task ids are stage-scoped (worker.py), so on a
    # LONG-LIVED server every job that dies with retries exhausted leaves an
    # uncommitted record pinning a model-sized accumulator forever. Evicting
    # the oldest record past this cap bounds that growth. In-flight tasks of
    # one fit never exceed the partition count, so a cap this size is only
    # ever hit by garbage from dead jobs; an evicted task that nonetheless
    # retries later just loses rollback (it re-registers from scratch).
    _MAX_ATTEMPT_RECORDS = 512

    # -- weight ops ------------------------------------------------------
    def apply_delta(self, delta: List[np.ndarray],
                    task_id: Optional[str] = None,
                    attempt: Optional[int] = None) -> None:
        from .compression import maybe_decode

        self._check_alive()
        if self.fault_plan is not None and self.fault_plan.drop_server_push():
            return  # injected server-side loss: the delta is never applied
        delta = maybe_decode(delta)  # transparent: plain lists pass through

        def _apply() -> bool:
            if (task_id is not None and attempt is not None
                    and int(attempt) < self._fence.get(task_id, 0)):
                # Zombie push: a newer attempt of this task registered (a
                # backup won, or a retry superseded it). Applying it would
                # double-count work the live attempt redoes — refuse.
                self.rejected_stale += 1
                return False
            self.weights = subtract_params_np(self.weights, delta)
            self.version += 1
            if task_id is not None:
                self.applied_tagged[task_id] = (
                    self.applied_tagged.get(task_id, 0) + 1
                )
                if task_id in self._attempts:
                    acc = self._attempts[task_id]["delta"]
                    self._attempts[task_id]["delta"] = (
                        [np.array(d) for d in delta] if acc is None
                        else [a + d for a, d in zip(acc, delta)]
                    )
            return True

        if self.mode == "hogwild":
            # Lock-free by design: concurrent updates may interleave
            # per-array — HOGWILD! semantics. (Attempt accumulation shares
            # that best-effort contract.)
            applied = _apply()
        else:
            with self.lock:
                applied = _apply()
        if applied:
            self._replicate("delta", delta, task_id, attempt)

    def register_attempt(self, task_id: str, attempt: int) -> None:
        """Announce that ``(task_id, attempt)`` is starting.

        Fixes the reference's documented design hole (SURVEY.md §5.3): its
        async path is not idempotent under Spark task retry — a retried task
        re-pushes deltas on top of the ones its failed attempt already
        applied. Here every tagged update is accumulated per task; when a
        *newer* attempt of the same task registers, the failed attempt's whole
        accumulated contribution is rolled back (weights += accumulated delta,
        the inverse of the ``weights -= delta`` update rule) before the retry
        pushes anything, restoring exactly-once per task. A stale or duplicate
        register (attempt <= the live one, e.g. a zombie executor's replay) is
        ignored — it must not undo the live attempt's work; any pushes the
        zombie still makes accumulate under the live record, so a later retry
        rolls them back with it. Registration is control-plane and always
        takes the lock, even under hogwild.

        Scope: the exactly-once guarantee holds for the LOCKED update modes
        (``asynchronous``). Under ``hogwild`` pushes bypass the lock by
        design, so a concurrent unlocked push can interleave with (and clobber
        part of) the rollback's weight write — rollback there is best-effort,
        exactly like every other hogwild write. That is the mode's contract:
        it trades consistency for lock-free throughput.
        """
        self._check_alive()
        with self.lock:
            prev = self._attempts.get(task_id)
            if prev is None:
                while len(self._attempts) >= self._MAX_ATTEMPT_RECORDS:
                    evicted_id = next(iter(self._attempts))
                    evicted = self._attempts.pop(evicted_id)
                    if evicted["delta"] is not None:
                        # The evicted task is abandoned as far as we know —
                        # roll its uncommitted contribution back, exactly as
                        # a re-register would. If it IS still alive and
                        # later retries, the retry re-pushes from scratch
                        # and nothing double-applies; if it commits, it
                        # under-counts one slow worker's delta (async SGD
                        # absorbs that; double-apply it cannot absorb).
                        self.weights = [
                            w + d
                            for w, d in zip(self.weights, evicted["delta"])
                        ]
                self._attempts[task_id] = {"attempt": int(attempt), "delta": None}
            elif int(attempt) > prev["attempt"]:
                if prev["delta"] is not None:
                    self.weights = [
                        w + d for w, d in zip(self.weights, prev["delta"])
                    ]
                self._attempts[task_id] = {"attempt": int(attempt), "delta": None}
            # else: stale/duplicate — keep the live attempt record
            if int(attempt) > self._fence.get(task_id, 0):
                while len(self._fence) >= self._MAX_ATTEMPT_RECORDS:
                    self._fence.pop(next(iter(self._fence)))
                self._fence[task_id] = int(attempt)
        self._replicate("register", task_id, attempt)

    def commit_attempt(self, task_id: str) -> None:
        """A task finished cleanly: drop its accumulator.

        Bounds server memory to in-flight tasks only — without this, each of
        P partitions would pin a model-sized accumulated delta for the whole
        fit. A committed task that somehow still retries (shouldn't happen:
        the facade only retries on exception) re-registers from scratch.
        """
        self._check_alive()
        with self.lock:
            self._attempts.pop(task_id, None)
            # the fence survives the commit: a zombie attempt of this task
            # waking up later must still be refused
        self._replicate("commit", task_id)

    def _count_pull(self) -> None:
        with self._pulls_lock:
            self.pulls += 1

    def get_weights(self) -> List[np.ndarray]:
        self._check_alive()
        if self.fault_plan is not None:
            self.fault_plan.delay_server_pull()  # injected slow read
        self._count_pull()
        return self.weights

    def get_versioned_weights(self) -> Tuple[int, List[np.ndarray]]:
        """Atomic ``(version, weights)`` pair for a versioned pull. Read
        under the same lock ``apply_delta`` mutates under, so the stamp
        can never be off-by-one from the weights it describes (hogwild
        mode reads lock-free, exactly as its plain pulls always have —
        racy by that mode's contract)."""
        self._check_alive()
        if self.fault_plan is not None:
            self.fault_plan.delay_server_pull()  # injected slow read
        self._count_pull()
        if self.mode == "hogwild":
            return self.version, self.weights
        with self.lock:
            return self.version, self.weights

    def start(self) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        raise NotImplementedError

    def stop_replication(self) -> None:
        """Drain and stop the replication stream (no-op if never attached)."""
        if self._repl_thread is not None:
            self._repl_queue.join()
            self._repl_queue.put(None)
            self._repl_thread.join(timeout=5)
            self._repl_thread = None


class HttpServer(BaseParameterServer):
    """``GET /parameters`` → pickled weights; ``POST /update`` → apply delta.

    Same routes and payloads as the reference's Flask service
    (``parameter/server.py:~30``).
    """

    def __init__(self, weights: List[np.ndarray], mode: str = "asynchronous",
                 port: int = 4000, debug: bool = False, **kwargs):
        super().__init__(weights, mode=mode, port=port, **kwargs)
        self.debug = debug
        self._httpd: Optional[http.server.ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet unless debug
                if server.debug:
                    http.server.BaseHTTPRequestHandler.log_message(self, *args)

            def do_GET(self):
                try:
                    path = self.path.rstrip("/")
                    if path == "/parameters" or self.path == "/":
                        payload = pickle.dumps(
                            server.get_weights(),
                            protocol=pickle.HIGHEST_PROTOCOL,
                        )
                        self.send_response(200)
                        self.send_header(
                            "Content-Type", "application/octet-stream"
                        )
                        self.send_header("Content-Length", str(len(payload)))
                        # piggyback the version so pulls track staleness for
                        # free (FailoverClient's bound across failover)
                        self.send_header(
                            "X-Elephas-Version", str(server.version)
                        )
                        self.end_headers()
                        self.wfile.write(payload)
                    elif path == "/version":
                        server._check_alive()
                        payload = str(server.version).encode()
                        self.send_response(200)
                        self.send_header("Content-Type", "text/plain")
                        self.send_header("Content-Length", str(len(payload)))
                        self.end_headers()
                        self.wfile.write(payload)
                    else:
                        self.send_error(404)
                except ConnectionError:
                    # injected kill: the service is down, the process isn't —
                    # 503 surfaces as a transient URLError client-side
                    self.send_error(503)

            def do_POST(self):
                try:
                    path = self.path.rstrip("/")
                    if path == "/update":
                        length = int(self.headers.get("Content-Length", 0))
                        delta = pickle.loads(self.rfile.read(length))
                        # Optional task/attempt tags (exactly-once retry +
                        # zombie fencing); plain reference-shaped clients
                        # omit them and behave as before.
                        attempt = self.headers.get("X-Elephas-Attempt")
                        server.apply_delta(
                            delta,
                            task_id=self.headers.get("X-Elephas-Task"),
                            attempt=None if attempt is None else int(attempt),
                        )
                        self._ok()
                    elif path == "/register":
                        length = int(self.headers.get("Content-Length", 0))
                        if length:
                            self.rfile.read(length)
                        server.register_attempt(
                            self.headers.get("X-Elephas-Task", ""),
                            int(self.headers.get("X-Elephas-Attempt", 0)),
                        )
                        self._ok()
                    elif path == "/commit":
                        length = int(self.headers.get("Content-Length", 0))
                        if length:
                            self.rfile.read(length)
                        server.commit_attempt(
                            self.headers.get("X-Elephas-Task", "")
                        )
                        self._ok()
                    else:
                        self.send_error(404)
                except ConnectionError:
                    self.send_error(503)

            def _ok(self):
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"ok")

        self._httpd = http.server.ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]  # resolves port=0 → OS port
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        self._running = True

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.stop_replication()
        self._running = False


class SocketServer(BaseParameterServer):
    """Raw-TCP server: 1-byte opcodes ``b'g'`` (get) / ``b'u'`` (update),
    pickle framing from ``elephas_tpu_torch.utils.sockets`` (legacy ASCII header
    or checksummed v2, negotiated per connection via the ``b'W'`` hello).

    Reference: ``parameter/server.py:~100`` (``action_listener`` thread per
    accepted connection). Extension opcodes beyond the reference protocol:
    ``b't'`` (task-tagged update) and ``b'r'`` (register task attempt) for
    exactly-once retry semantics — see ``register_attempt`` — and ``b'W'``
    (wire negotiation). Receives are bilingual regardless of negotiation;
    REPLIES use the dialect the connection negotiated (legacy until a
    ``b'W'`` hello lands), so a reference client never sees a v2 frame.

    ``max_frame_bytes`` bounds any declared frame length before allocation
    (hostile-header defense); ``stall_timeout_s`` (optional) is the
    mid-frame progress deadline that disconnects a slow-loris peer without
    touching idle-between-requests connections.
    """

    def __init__(self, weights: List[np.ndarray], mode: str = "asynchronous",
                 port: int = 4000, *,
                 max_frame_bytes: Optional[int] = None,
                 stall_timeout_s: Optional[float] = None, **kwargs):
        super().__init__(weights, mode=mode, port=port, **kwargs)
        self.max_frame_bytes = (socket_utils.DEFAULT_MAX_FRAME_BYTES
                                if max_frame_bytes is None
                                else int(max_frame_bytes))
        self.stall_timeout_s = (None if stall_timeout_s is None
                                else float(stall_timeout_s))
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self._conn_threads: List[threading.Thread] = []

    def start(self) -> None:
        self._stop_event.clear()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self.port = self._sock.getsockname()[1]  # resolves port=0 → OS port
        self._sock.listen(16)
        self._sock.settimeout(0.2)
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()
        self._running = True

    def _accept_loop(self) -> None:
        while not self._stop_event.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            plan = self.fault_plan
            if plan is not None and getattr(plan, "has_wire_faults",
                                            lambda: False)():
                # wire-level chaos: the server's REPLIES pass through the
                # shim (the client's own shim covers the other direction)
                conn = plan.wrap_socket(conn, site="server")
            t = threading.Thread(target=self._action_listener, args=(conn,), daemon=True)
            t.start()
            self._conn_threads.append(t)

    def _action_listener(self, conn: socket.socket) -> None:
        # one receive buffer per connection (each connection is serviced by
        # exactly this thread): every push's multi-MB delta lands in the
        # same reused allocation instead of a fresh one per round
        rxbuf = socket_utils.ReusableBuffer()
        # replies speak legacy until the connection negotiates v2 (b"W")
        wire_version = socket_utils.WIRE_V1

        def recv_frame(buf=None):
            # the opcode already arrived, so this read is mid-message: the
            # stall deadline (if configured) applies from the first byte
            return socket_utils.receive(
                conn, buf=buf, max_frame_bytes=self.max_frame_bytes,
                stall_timeout_s=self.stall_timeout_s, mid_message=True,
            )

        def reply(obj):
            socket_utils.send(conn, obj, version=wire_version)

        try:
            while not self._stop_event.is_set():
                op = conn.recv(1)
                if not op:
                    break
                if op == socket_utils.NEGOTIATE_OP:
                    hello = socket_utils.receive_all(
                        conn, len(socket_utils.NEGOTIATE_REQUEST) - 1,
                        stall_timeout_s=self.stall_timeout_s,
                    )
                    if bytes(hello) != socket_utils.MAGIC:
                        raise socket_utils.CorruptFrameError(
                            f"bad negotiation hello {bytes(hello)!r} from "
                            "peer"
                        )
                    conn.sendall(socket_utils.NEGOTIATE_ACK)
                    wire_version = socket_utils.WIRE_V2
                elif op == b"g":
                    reply(self.get_weights())
                elif op == b"G":
                    # versioned pull: one atomic (version, weights) pair —
                    # the socket transport's answer to HTTP's
                    # X-Elephas-Version header (a legacy server hits the
                    # unknown-opcode close below, which the client
                    # reads as "no versioned-pull API" and degrades)
                    reply(self.get_versioned_weights())
                elif op == b"u":
                    delta = recv_frame(buf=rxbuf)
                    self.apply_delta(delta)
                elif op == b"t":
                    # tagged update: (task_id, delta) — exactly-once retries
                    task_id, delta = recv_frame(buf=rxbuf)
                    self.apply_delta(delta, task_id=task_id)
                elif op == b"a":
                    # attempt-tagged update: (task_id, attempt, delta) —
                    # lets the server fence zombie attempts' pushes
                    task_id, attempt, delta = recv_frame(buf=rxbuf)
                    self.apply_delta(delta, task_id=task_id, attempt=attempt)
                elif op == b"r":
                    # register (task_id, attempt); ack so the client can
                    # order its first pull after the rollback. A dead server
                    # acks b'x' (distinguishable from a legacy server's
                    # silent close, which means "no attempt API").
                    task_id, attempt = recv_frame()
                    try:
                        self.register_attempt(task_id, attempt)
                    except ConnectionError:
                        conn.sendall(b"x")
                        break
                    conn.sendall(b"k")
                elif op == b"c":
                    # commit: task finished cleanly, drop its accumulator
                    task_id = recv_frame()
                    self.commit_attempt(task_id)
                elif op == b"v":
                    # monotonic weight version (staleness bound on failover)
                    self._check_alive()
                    reply(self.version)
                else:
                    # Unknown opcode: either a legacy-probe close (the
                    # client reads the close as "API absent") or stream
                    # garbage — either way, quarantine this connection.
                    raise socket_utils.CorruptFrameError(
                        f"unknown opcode {op!r} on parameter-server "
                        "connection"
                    )
        except socket_utils.FrameError as err:
            # Corrupt / truncated / oversize / stalled frame: the payload
            # was rejected BEFORE any apply. Quarantine = close just this
            # connection; every other client keeps its own untouched.
            self.wire_errors += 1
            plan = self.fault_plan
            if plan is not None and hasattr(plan, "note_wire_caught"):
                plan.note_wire_caught("server", err)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def stop(self) -> None:
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._sock is not None:
            self._sock.close()
            self._sock = None
        self.stop_replication()
        self._running = False
