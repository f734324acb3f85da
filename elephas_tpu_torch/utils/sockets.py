"""Socket helpers + master discovery + checksummed wire framing.

A copy of ``elephas_tpu/utils/sockets.py`` (standard library only, so the
port keeps its own copy instead of importing the JAX package); the bytes
it writes are the JAX package's, so either package's peers interoperate.

- ``determine_master(port)`` — reads ``SPARK_LOCAL_IP`` else resolves the
  local hostname (as the reference elephas does); the address is baked
  into the worker closure so workers can find the parameter server that
  the fitting process hosts. The ``ELEPHAS_MASTER`` env var wins over
  both, and a coordinator address can be passed explicitly.
- ``send`` / ``receive`` / ``receive_all`` — the framing the Socket parameter
  server, streaming piggyback, and elastic emulation workers speak.

Two frame formats coexist on the wire, negotiated per connection:

- **legacy (v1)** — the reference's fixed-width ASCII decimal length header
  followed by a pickled payload (reference ``utils/sockets.py:~25``). No
  integrity check; kept so a reference-shaped peer still interoperates.
- **v2** — ``MAGIC | version | flags | length(u64) | crc(u32)`` then the
  payload. The declared length is bounded (``max_frame_bytes``) BEFORE any
  allocation, and the checksum is verified before unpickling, so a flipped
  bit or garbage injection surfaces as a typed :class:`CorruptFrameError`
  instead of silent weight corruption or an unpickling crash. The checksum
  is CRC32C (Castagnoli) via ``google_crc32c`` — hardware-accelerated,
  ~12x the throughput of stdlib ``zlib.crc32`` on this image — falling
  back to ``zlib.crc32`` where the module is missing. The algorithm is
  chosen once at import: both ends of a deployment run the same build, and
  a heterogeneous pair fails CLOSED (typed checksum mismatch -> reconnect
  -> typed again), never silently. Large v2 payloads set ``FLAG_OOB`` and
  carry their array buffers out of band (pickle protocol 5): the bulk
  bytes are never copied into or out of a pickle blob, which saves a
  memcpy pass per direction and pays for the checksum pass — v2 framing
  stays inside bench_wire's <=5% overhead budget against the uncheck-
  summed legacy dialect.

:func:`receive` is bilingual: it sniffs the first byte (v2 magic starts
``0x89``, a legacy header is all ASCII digits) and accepts either format,
which is what lets a v2 server answer legacy clients on the same port.
Explicit negotiation for the opcode protocol lives in
``parameter/client.py`` / ``parameter/server.py`` (the ``b"W"`` hello).

Every decode failure raises a :class:`FrameError` subclass. They subclass
``ConnectionError`` on purpose: the retry/reconnect machinery
(``resilience/policy.py``, ``SocketClient._roundtrip``, the elastic reader
threads) already treats connection errors as retryable, so corruption is
absorbed by reconnect + re-request with no policy changes — the payload a
checksum rejected is LOST, never APPLIED.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import time
import zlib
from typing import Any, Optional, Tuple

#: Fixed width of the legacy ASCII length header (reference uses a
#: fixed-width decimal header; 20 digits comfortably covers any payload).
HEADER_WIDTH = 20

#: Wire protocol versions. v1 = reference ASCII framing, v2 = checksummed.
WIRE_V1 = 1
WIRE_V2 = 2

#: v2 frame magic. First byte 0x89 (non-ASCII, like PNG's) so one received
#: byte distinguishes a v2 frame from a legacy all-digit header.
MAGIC = b"\x89EL2"

#: v2 header: magic(4) | version(1) | flags(1) | length(u64, big-endian) |
#: crc(u32, big-endian), then ``length`` payload bytes.
_V2_HEADER = struct.Struct(">4sBBQI")
V2_HEADER_BYTES = _V2_HEADER.size  # 18

#: v2 flags bit: the payload section is a pickle-protocol-5 body with its
#: large buffers carried OUT OF BAND after it (see :func:`send`). All
#: other flag bits are reserved and refused.
FLAG_OOB = 0x01

#: Minimum total out-of-band buffer bytes before :func:`send` bothers with
#: the scattered layout — below this one contiguous frame is cheaper.
OOB_MIN_BYTES = 1 << 16

#: Hard bound on the buffer count an OOB frame may declare (a hostile
#: table must not drive allocations; real frames carry one buffer per
#: weight/delta array).
OOB_MAX_BUFFERS = 4096

#: Ceiling on a declared frame length, enforced BEFORE allocating. 1 GiB
#: comfortably covers any weight list this stack ships while turning a
#: hostile/corrupt length into a typed error instead of an OOM.
DEFAULT_MAX_FRAME_BYTES = 1 << 30

#: Connect-time negotiation for the opcode protocol (client → server):
#: opcode ``b"W"`` + the magic. A v2 server acks with the magic and speaks
#: v2 frames on that connection; a legacy server closes on the unknown
#: opcode, which the client reads as "speak legacy".
NEGOTIATE_OP = b"W"
NEGOTIATE_REQUEST = NEGOTIATE_OP + MAGIC
NEGOTIATE_ACK = MAGIC


class FrameError(ConnectionError):
    """A wire frame could not be decoded. Subclasses ``ConnectionError``
    so every existing reconnect/retry path treats it as transient: the
    connection is torn down and the request sent again on a fresh one."""


class CorruptFrameError(FrameError):
    """Checksum mismatch, bad magic/version, or a garbage header."""


class FrameTooLargeError(FrameError):
    """Declared length exceeds ``max_frame_bytes`` — refused pre-alloc."""


class TruncatedFrameError(FrameError):
    """The peer closed mid-frame (EOF before the declared length)."""


class FrameStalledError(FrameError):
    """No progress inside a frame within the stall deadline (slow-loris)."""


def _peer(sock: socket.socket) -> str:
    """Best-effort peer name for error messages."""
    try:
        return str(sock.getpeername())
    except OSError:
        return "<unknown peer>"


try:
    import google_crc32c as _crc32c_mod
except ImportError:  # pragma: no cover - the image ships the module
    _crc32c_mod = None

# The cext's value()/extend() reject memoryview objects outright (they
# demand real read-only bytes), but the receive path hands us a writable
# view over the reused receive buffer — copying it to bytes just to hash
# would cost a full memcpy pass per frame. The wheel bundles the crc32c C
# library; its ``crc32c_extend(crc, ptr, len)`` entry point takes a raw
# pointer, so ctypes lets us hash the buffer in place. Verified against
# the cext at import; any surprise falls back to the cext (bytes copy).
_crc32c_raw = None
if _crc32c_mod is not None:
    try:
        import ctypes as _ctypes
        import glob as _glob

        _libs = _glob.glob(os.path.join(
            os.path.dirname(os.path.dirname(_crc32c_mod.__file__)),
            "google_crc32c.libs", "libcrc32c*.so*"))
        _fn = _ctypes.CDLL(sorted(_libs)[0]).crc32c_extend
        _fn.restype = _ctypes.c_uint32
        _fn.argtypes = [_ctypes.c_uint32, _ctypes.c_void_p, _ctypes.c_size_t]
        _probe = (_ctypes.c_char * 4).from_buffer(bytearray(b"wire"))
        if _fn(0, _ctypes.addressof(_probe), 4) != _crc32c_mod.value(b"wire"):
            raise OSError("bundled crc32c_extend disagrees with the cext")
        _crc32c_raw = _fn
    except (OSError, IndexError, AttributeError):  # pragma: no cover
        _crc32c_raw = None

#: Name of the active checksum algorithm (surfaced in docs/diagnostics).
CHECKSUM_ALGORITHM = "crc32c" if _crc32c_mod is not None else "crc32"


def frame_checksum(payload, crc: int = 0) -> int:
    """The v2 payload checksum, masked to u32.

    CRC32C (hardware-accelerated via ``google_crc32c``) when the module is
    importable, else stdlib ``zlib.crc32``. Chosen once at import — see
    the module docstring for the heterogeneous-build story. Accepts
    ``bytes`` or a memoryview (hashed in place, no copy); ``crc`` chains a
    running checksum across the scattered parts of an out-of-band frame.
    """
    if _crc32c_mod is not None:
        if isinstance(payload, memoryview):
            if _crc32c_raw is not None and not payload.readonly:
                buf = (_ctypes.c_char * payload.nbytes).from_buffer(payload)
                return _crc32c_raw(crc, _ctypes.addressof(buf),
                                   payload.nbytes)
            payload = bytes(payload)
        return _crc32c_mod.extend(crc, payload) & 0xFFFFFFFF
    return zlib.crc32(payload, crc) & 0xFFFFFFFF


def determine_master(port: int = 4000) -> str:
    """Return ``host:port`` of the parameter-server endpoint."""
    if os.environ.get("ELEPHAS_MASTER"):
        host = os.environ["ELEPHAS_MASTER"]
        if ":" in host:
            return host
        return f"{host}:{port}"
    if os.environ.get("SPARK_LOCAL_IP"):
        return f"{os.environ['SPARK_LOCAL_IP']}:{port}"
    try:
        host = socket.gethostbyname(socket.gethostname())
    except socket.gaierror:
        host = "127.0.0.1"
    return f"{host}:{port}"


def parse_address(address: str, default_port: int = 4000) -> "tuple[str, int]":
    """``host[:port]`` → ``(host, port)``."""
    if ":" in address:
        host, port = address.rsplit(":", 1)
        return host, int(port)
    return address, int(default_port)


def connect_with_retry(address: str, *, timeout_s: float = 20.0,
                       base_delay_s: float = 0.05,
                       connect_timeout_s: float = 2.0,
                       sleep=time.sleep,
                       clock=time.monotonic) -> socket.socket:
    """Dial ``host:port`` with bounded exponential-backoff retries.

    The failure mode this exists for: a worker (or a multi-host JAX process)
    dialing a coordinator that is still binding, briefly partitioned, or
    simply gone. A bare ``connect`` either fails instantly (refused while the
    peer races its ``bind``) or hangs at the OS default (~2 min SYN retries)
    — both wrong for a control plane that must make a liveness decision.
    Retries double from ``base_delay_s`` up to 1s between attempts; once
    ``timeout_s`` elapses a ``RuntimeError`` NAMING THE ADDRESS is raised so
    the operator knows which endpoint was unreachable.
    """
    host, port = parse_address(address)
    deadline = clock() + float(timeout_s)
    delay = float(base_delay_s)
    last_err: Exception | None = None
    while True:
        budget = deadline - clock()
        if budget <= 0:
            raise RuntimeError(
                f"could not reach {host}:{port} within {timeout_s:.1f}s "
                f"(last error: {last_err!r})"
            )
        try:
            sock = socket.create_connection(
                (host, port), timeout=min(connect_timeout_s, max(budget, 0.01))
            )
            # The timeout above bounds the CONNECT only. Left on the socket
            # it would poison every later blocking recv (a worker idling at
            # a round boundary longer than connect_timeout_s would see a
            # spurious TimeoutError and tear itself down). Mid-frame stalls
            # are bounded separately by receive()'s stall_timeout_s.
            sock.settimeout(None)
            return sock
        except OSError as err:
            last_err = err
            sleep(min(delay, max(deadline - clock(), 0.0)))
            delay = min(delay * 2.0, 1.0)


class ReusableBuffer:
    """A grow-only receive buffer for :func:`receive_all` / :func:`receive`.

    A weight pull deserializes a multi-MB payload every sync round; the
    naive ``recv``-chunks-then-``join`` path allocates the payload twice
    (chunk list + joined bytes) per round. Holding one of these per
    connection lets ``recv_into`` land every round's payload in the SAME
    allocation — it only grows, to the largest payload seen.

    NOT thread-safe, and the memoryview handed out is only valid until the
    next ``reserve`` — callers must finish deserializing before reusing.
    ``SocketClient`` satisfies both by keeping one buffer per client under
    its per-client lock.
    """

    def __init__(self, initial: int = 1 << 16):
        self._buf = bytearray(initial)

    def reserve(self, num_bytes: int) -> memoryview:
        """A writable view of at least ``num_bytes`` (amortized growth)."""
        if len(self._buf) < num_bytes:
            self._buf = bytearray(max(num_bytes, 2 * len(self._buf)))
        return memoryview(self._buf)


def receive_all(sock: socket.socket, num_bytes: int,
                buf: "ReusableBuffer | None" = None, *,
                stall_timeout_s: Optional[float] = None) -> bytes:
    """Read exactly ``num_bytes`` from ``sock`` (reference ``receive_all``).

    With ``buf`` the payload lands in the caller's reused allocation via
    ``recv_into`` and a memoryview over it is returned (valid until the
    buffer's next use); without, a fresh ``bytes`` is returned.

    ``stall_timeout_s`` is a PROGRESS deadline, not a total-transfer bound:
    each ``recv`` must deliver at least one byte within it, else
    :class:`FrameStalledError` — the slow-loris defense for reads known to
    be mid-frame. ``None`` preserves whatever blocking/timeout behavior the
    socket already has. A peer close mid-read raises
    :class:`TruncatedFrameError` naming the peer and the shortfall.
    """
    view = (memoryview(bytearray(num_bytes)) if buf is None
            else buf.reserve(num_bytes)[:num_bytes])
    receive_into(sock, view, stall_timeout_s=stall_timeout_s)
    return bytes(view) if buf is None else view


def receive_into(sock: socket.socket, view: memoryview, *,
                 stall_timeout_s: Optional[float] = None) -> None:
    """Fill a writable ``view`` exactly from ``sock``.

    The core of :func:`receive_all`, exposed so out-of-band frame buffers
    can land DIRECTLY in their final allocation (no staging copy). Same
    stall/truncation typing as :func:`receive_all`.
    """
    num_bytes = view.nbytes
    got = 0
    prev_timeout: Any = None
    if stall_timeout_s is not None:
        prev_timeout = sock.gettimeout()
        sock.settimeout(float(stall_timeout_s))
    try:
        while got < num_bytes:
            try:
                n = sock.recv_into(view[got:], min(num_bytes - got, 1 << 20))
            except socket.timeout:
                if stall_timeout_s is None:
                    raise  # the caller's own socket timeout: not ours to type
                raise FrameStalledError(
                    f"peer {_peer(sock)} stalled mid-frame: no progress in "
                    f"{float(stall_timeout_s):.1f}s with {got}/{num_bytes} "
                    "bytes received"
                ) from None
            if n == 0:
                raise TruncatedFrameError(
                    f"peer {_peer(sock)} closed mid-frame: got {got} of "
                    f"{num_bytes} expected bytes"
                )
            got += n
    finally:
        if stall_timeout_s is not None:
            sock.settimeout(prev_timeout)


def send(sock: socket.socket, data: Any, *, version: int = WIRE_V2) -> None:
    """Pickle ``data`` and send one frame.

    ``version=WIRE_V2`` (default) writes the checksummed v2 frame;
    ``version=WIRE_V1`` writes the reference's ASCII-header frame for
    negotiated-legacy peers.

    Large v2 payloads go out with the ``FLAG_OOB`` layout: the pickle body
    is produced with protocol 5 and a ``buffer_callback``, so the bulk
    array data is NEVER copied into the pickle — the frame carries the
    small body, a buffer-length table, then the raw buffers straight from
    the arrays' own memory. That saves a full memcpy pass per direction,
    which is what pays for the checksum pass and keeps the v2 framing tax
    inside bench_wire's <=5% budget. Legacy peers can't speak this (their
    ``pickle.loads`` has no out-of-band buffers), which is fine: the
    layout only rides connections that negotiated v2.
    """
    if version == WIRE_V1:
        payload = pickle.dumps(data, protocol=pickle.HIGHEST_PROTOCOL)
        header = str(len(payload)).zfill(HEADER_WIDTH).encode("ascii")
        sock.sendall(header + payload)
        return
    if version != WIRE_V2:
        raise ValueError(f"unknown wire version {version!r}")
    buffers: list = []
    body = pickle.dumps(data, protocol=5, buffer_callback=buffers.append)
    raws = [b.raw() for b in buffers]
    if sum(r.nbytes for r in raws) < OOB_MIN_BYTES:
        # Small frame: one contiguous payload is cheaper than scatter. If
        # the protocol-5 dump emitted out-of-band buffers anyway, re-dump
        # in-band — ``body`` alone is not loadable without its buffers.
        payload = (pickle.dumps(data, protocol=pickle.HIGHEST_PROTOCOL)
                   if raws else body)
        header = _V2_HEADER.pack(MAGIC, WIRE_V2, 0, len(payload),
                                 frame_checksum(payload))
        sock.sendall(header + payload)
        return
    meta = b"".join((
        struct.pack(">I", len(body)), body,
        struct.pack(">I", len(raws)),
        struct.pack(f">{len(raws)}Q", *(r.nbytes for r in raws)),
    ))
    crc = frame_checksum(meta)
    for r in raws:
        crc = frame_checksum(r, crc)
    length = len(meta) + sum(r.nbytes for r in raws)
    header = _V2_HEADER.pack(MAGIC, WIRE_V2, FLAG_OOB, length, crc)
    sock.sendall(header + meta)
    for r in raws:
        sock.sendall(r)


def _receive_oob(sock: socket.socket, length: int, crc: int, *,
                 stall_timeout_s: Optional[float]) -> Any:
    """Receive the payload section of a ``FLAG_OOB`` v2 frame.

    Layout: ``u32 body_len | pickle body | u32 nbufs | nbufs x u64 buflen |
    raw buffers``. Every declared size is validated against the header's
    ``length`` (already bounded by ``max_frame_bytes``) BEFORE its
    allocation, and each buffer lands directly in a fresh exactly-sized
    ``bytearray`` the unpickled arrays then view — no staging copy. The
    running CRC covers the whole section; nothing is returned (applied)
    until it matches.
    """
    def _typed(what: str) -> CorruptFrameError:
        return CorruptFrameError(
            f"out-of-band frame from peer {_peer(sock)}: {what} "
            "(table/length mismatch) — payload discarded"
        )

    head = receive_all(sock, 4, stall_timeout_s=stall_timeout_s)
    body_len = struct.unpack(">I", head)[0]
    if body_len + 8 > length:
        raise _typed(f"pickle body declares {body_len} bytes")
    body = receive_all(sock, body_len, stall_timeout_s=stall_timeout_s)
    nbufs_raw = receive_all(sock, 4, stall_timeout_s=stall_timeout_s)
    nbufs = struct.unpack(">I", nbufs_raw)[0]
    if nbufs > OOB_MAX_BUFFERS or 8 + body_len + 8 * nbufs > length:
        raise _typed(f"{nbufs} out-of-band buffers declared")
    table = receive_all(sock, 8 * nbufs, stall_timeout_s=stall_timeout_s)
    lens = struct.unpack(f">{nbufs}Q", table)
    if 8 + body_len + 8 * nbufs + sum(lens) != length:
        raise _typed(f"buffer table sums to {sum(lens)} bytes")
    running = frame_checksum(head)
    running = frame_checksum(body, running)
    running = frame_checksum(nbufs_raw, running)
    running = frame_checksum(table, running)
    bufs = []
    for n in lens:
        ba = bytearray(n)
        receive_into(sock, memoryview(ba), stall_timeout_s=stall_timeout_s)
        running = frame_checksum(memoryview(ba), running)
        bufs.append(ba)
    if running != crc:
        raise CorruptFrameError(
            f"frame checksum mismatch from peer {_peer(sock)}: payload "
            f"crc 0x{running:08x} != declared 0x{crc:08x} ({length} bytes, "
            "out-of-band) — payload discarded"
        )
    try:
        return pickle.loads(body, buffers=bufs)
    except Exception as err:
        raise CorruptFrameError(
            f"checksummed out-of-band frame from peer {_peer(sock)} is not "
            f"a pickle: {err!r}"
        ) from err


def receive_frame(sock: socket.socket, buf: "ReusableBuffer | None" = None, *,
                  max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
                  stall_timeout_s: Optional[float] = None,
                  mid_message: bool = False) -> Tuple[Any, int]:
    """Receive one frame in EITHER format; returns ``(obj, wire_version)``.

    The first byte decides the dialect: ``0x89`` → v2, an ASCII digit →
    legacy, anything else → :class:`CorruptFrameError`. Callers that track
    a peer's dialect (the servers' reply-in-kind) use the returned version.

    ``stall_timeout_s`` applies from the SECOND byte on: waiting for a frame
    to start is idle (fine, blocks per the socket's own settings), but once
    a frame has begun arriving, progress is owed. ``mid_message=True``
    applies it from the first byte too — for reads that follow an opcode,
    where the message has already begun.

    ``max_frame_bytes`` bounds the DECLARED length before any allocation,
    on both dialects — a hostile or bit-flipped length field is a typed
    :class:`FrameTooLargeError`, not an OOM.
    """
    try:
        lead = receive_all(sock, 1,
                           stall_timeout_s=stall_timeout_s if mid_message
                           else None)
    except TruncatedFrameError:
        # EOF with ZERO bytes of the frame on the wire is an orderly close,
        # not wire damage — it is exactly how a legacy peer refuses an
        # unknown opcode (silent close), and the capability-degrade paths
        # must see a ConnectionError, not a FrameError, to tell "no such
        # API" apart from "frame arrived broken". Damage typing starts with
        # the first received byte.
        raise ConnectionError(
            f"peer {_peer(sock)} closed with no frame on the wire"
        ) from None
    if lead == MAGIC[:1]:
        head = lead + receive_all(sock, V2_HEADER_BYTES - 1,
                                  stall_timeout_s=stall_timeout_s)
        magic, version, flags, length, crc = _V2_HEADER.unpack(head)
        if magic != MAGIC:
            raise CorruptFrameError(
                f"bad frame magic {magic!r} from peer {_peer(sock)}"
            )
        if version != WIRE_V2:
            raise CorruptFrameError(
                f"unsupported wire version {version} from peer {_peer(sock)}"
            )
        if flags & ~FLAG_OOB:
            raise CorruptFrameError(
                f"reserved frame flags 0x{flags:02x} set by peer "
                f"{_peer(sock)}"
            )
        if length > max_frame_bytes:
            raise FrameTooLargeError(
                f"peer {_peer(sock)} declared a {length}-byte frame "
                f"(max_frame_bytes={max_frame_bytes})"
            )
        if flags & FLAG_OOB:
            return _receive_oob(sock, length, crc,
                                stall_timeout_s=stall_timeout_s), WIRE_V2
        payload = receive_all(sock, length, buf=buf,
                              stall_timeout_s=stall_timeout_s)
        if frame_checksum(payload) != crc:
            raise CorruptFrameError(
                f"frame checksum mismatch from peer {_peer(sock)}: payload "
                f"crc32 0x{frame_checksum(payload):08x} != declared "
                f"0x{crc:08x} ({length} bytes) — payload discarded"
            )
        try:
            return pickle.loads(payload), WIRE_V2
        except Exception as err:
            # CRC passed, so these bytes are what the peer sent — a peer
            # that checksums garbage is still sending garbage.
            raise CorruptFrameError(
                f"checksummed frame from peer {_peer(sock)} is not a "
                f"pickle: {err!r}"
            ) from err
    if lead.isdigit():
        header = lead + receive_all(sock, HEADER_WIDTH - 1,
                                    stall_timeout_s=stall_timeout_s)
        if not header.isdigit():
            raise CorruptFrameError(
                f"garbage legacy header {header[:8]!r}... from peer "
                f"{_peer(sock)}"
            )
        length = int(header.decode("ascii"))
        if length > max_frame_bytes:
            raise FrameTooLargeError(
                f"peer {_peer(sock)} declared a {length}-byte legacy frame "
                f"(max_frame_bytes={max_frame_bytes})"
            )
        payload = receive_all(sock, length, buf=buf,
                              stall_timeout_s=stall_timeout_s)
        try:
            return pickle.loads(payload), WIRE_V1
        except Exception as err:
            # No checksum on the legacy path: an unpicklable payload IS the
            # corruption signal (this is exactly why v2 exists).
            raise CorruptFrameError(
                f"legacy frame from peer {_peer(sock)} failed to unpickle: "
                f"{err!r}"
            ) from err
    raise CorruptFrameError(
        f"unrecognized frame start {lead!r} from peer {_peer(sock)} "
        "(neither v2 magic nor a legacy digit header)"
    )


def receive(sock: socket.socket, buf: "ReusableBuffer | None" = None, *,
            max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
            stall_timeout_s: Optional[float] = None,
            mid_message: bool = False) -> Any:
    """Receive one framed pickled message (inverse of :func:`send`),
    accepting either wire dialect — see :func:`receive_frame`.

    ``buf`` (a :class:`ReusableBuffer`) receives the payload in place —
    the deserialized object is built before returning, so the buffer is
    immediately reusable."""
    obj, _version = receive_frame(sock, buf,
                                  max_frame_bytes=max_frame_bytes,
                                  stall_timeout_s=stall_timeout_s,
                                  mid_message=mid_message)
    return obj
