"""The port's wire framing (``elephas_tpu_torch/utils/sockets.py``) against
the JAX package's: the bytes ``send`` writes for the same payloads (legacy
v1, v2 in-band and v2 with out-of-band buffers), each package receiving
the other's frames, and the cheap cases of ``tests/utils/test_wire_fuzz.py``
— corrupt, truncated and oversized frames — raising the same error
classes in both; and the port's socket server quarantining a garbage
connection. Every receive has a 10 s socket timeout."""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import pickle
import socket
import struct
import threading

import numpy as np
import pytest

from elephas_tpu.utils import sockets as J
from elephas_tpu_torch.parameter import BaseParameterClient, SocketServer
from elephas_tpu_torch.utils import sockets as T

TIMEOUT = 10.0

PAYLOADS = {
    "weights": [np.arange(12, dtype=np.float32).reshape(4, 3), np.zeros(3, np.float32)],
    "tagged": ("stage-0-partition-1", 2, [np.ones((2, 2), np.float64)]),
    "version": 7,
    "large": [np.linspace(0, 1, 40000, dtype=np.float32),
              np.arange(30000, dtype=np.int64)],
}


def _pair():
    a, b = socket.socketpair()
    a.settimeout(TIMEOUT)
    b.settimeout(TIMEOUT)
    return a, b


def _wire_bytes(send, obj, version):
    """Everything ``send`` writes for ``obj``, read from the other end."""
    a, b = _pair()
    out = bytearray()

    def drain():
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return
            out.extend(chunk)

    reader = threading.Thread(target=drain)
    reader.start()
    send(a, obj, version=version)
    a.shutdown(socket.SHUT_WR)
    reader.join(TIMEOUT)
    a.close()
    b.close()
    return bytes(out)


def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("version", [T.WIRE_V1, T.WIRE_V2])
@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_send_writes_the_reference_bytes(name, version):
    obj = PAYLOADS[name]
    got = _wire_bytes(T.send, obj, version)
    assert got == _wire_bytes(J.send, obj, version)
    if version == T.WIRE_V2:
        flags = got[5]
        assert flags == (T.FLAG_OOB if name == "large" else 0)
    # each package reads the other's frame
    for send, receive in ((T.send, J.receive), (J.send, T.receive)):
        a, b = _pair()
        reader = threading.Thread(target=lambda: send(a, obj, version=version))
        reader.start()
        _same(receive(b), obj)
        reader.join(TIMEOUT)
        a.close()
        b.close()
    assert (T.MAGIC, T.HEADER_WIDTH, T.CHECKSUM_ALGORITHM) == \
        (J.MAGIC, J.HEADER_WIDTH, J.CHECKSUM_ALGORITHM)


def _v2_frame(obj):
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return struct.pack(">4sBBQI", T.MAGIC, T.WIRE_V2, 0, len(payload),
                       T.frame_checksum(payload)) + payload


def _flipped():
    frame = bytearray(_v2_frame([np.full((4,), 3.0, np.float32)]))
    frame[25] ^= 0x10                      # one bit, inside the payload
    return bytes(frame)


def _oversize_v2():
    frame = bytearray(_v2_frame([np.zeros((2,), np.float32)]))
    struct.pack_into(">Q", frame, 6, 1 << 50)
    return bytes(frame)


BAD_FRAMES = {
    "garbage": (b"\xff\x00garbage-bytes" * 4, True, "CorruptFrameError"),
    "bit_flip": (_flipped(), True, "CorruptFrameError"),
    "truncated_v2": (_v2_frame([np.arange(8, dtype=np.float32)])[:30], True,
                     "TruncatedFrameError"),
    "truncated_v1": (b"00000000000000000100" + b"\x80\x05", True, "TruncatedFrameError"),
    "oversize_v1": (str(1 << 50).zfill(T.HEADER_WIDTH).encode(), False,
                    "FrameTooLargeError"),
    "oversize_v2": (_oversize_v2(), False, "FrameTooLargeError"),
}


@pytest.mark.parametrize("case", sorted(BAD_FRAMES))
def test_bad_frames_raise_the_reference_classes(case):
    data, close, want = BAD_FRAMES[case]
    raised = []
    for mod in (T, J):
        a, b = _pair()
        a.sendall(data)
        if close:
            a.shutdown(socket.SHUT_WR)
        with pytest.raises(mod.FrameError) as err:
            mod.receive(b, max_frame_bytes=1 << 20)
        raised.append(type(err.value).__name__)
        assert isinstance(err.value, ConnectionError)
        a.close()
        b.close()
    assert raised == [want, want]


def test_server_quarantines_a_garbage_connection():
    """A connection that sends garbage is closed and counted; another
    client's connection keeps working and its pushes apply."""
    server = SocketServer([np.zeros((4,), np.float32)], port=0)
    server.start()
    good = BaseParameterClient.get_client("socket", port=server.port, host="127.0.0.1",
                                          timeout=TIMEOUT)
    try:
        np.testing.assert_array_equal(good.get_parameters()[0], 0.0)
        assert good.negotiated_wire_version == T.WIRE_V2
        bad = socket.create_connection(("127.0.0.1", server.port), timeout=TIMEOUT)
        bad.sendall(b"\xff\x00garbage-bytes" * 4)
        try:
            assert bad.recv(1) == b""
        except (ConnectionError, OSError):
            pass
        bad.close()
        good.update_parameters([np.full((4,), -1.0, np.float32)])
        np.testing.assert_array_equal(good.get_parameters()[0], 1.0)
        assert server.wire_errors == 1
    finally:
        good.close()
        server.stop()
