"""The port's parameter servers, clients and codecs
(``elephas_tpu_torch/parameter``) against the JAX package's.

- Round trips over http, socket and native (native skipped when the C++
  toolchain is missing, as ``tests/parameter/test_native.py`` does):
  pull, push (``weights -= delta``), the version and pull counters, torch
  tensors pushed as numpy.
- The attempt API: a retry's register rolls the failed attempt's tagged
  pushes back, a zombie's push is fenced, commit drops the accumulator.
- The codecs equal the reference's bit for bit on seeded arrays.
- Wire interop both ways: a port client against a reference server and a
  reference client against a port server, over http and socket, each
  getting the same weights back after the same pushes.

Every server binds port 0; every client operation has a 10 s timeout.
"""

import time

import numpy as np
import pytest
import torch

from elephas_tpu.parameter import BaseParameterClient as JClient
from elephas_tpu.parameter import HttpServer as JHttpServer
from elephas_tpu.parameter import SocketServer as JSocketServer
from elephas_tpu.parameter import compression as jcomp
from elephas_tpu_torch.parameter import (BaseParameterClient, HttpServer,
                                         SocketServer)
from elephas_tpu_torch.parameter import compression as tcomp
from elephas_tpu_torch.parameter.native import (NativeClient, NativeServer,
                                                check_f32_safe, native_available)

TIMEOUT = 10.0


def _weights():
    return [np.ones((4, 3), np.float32), np.arange(3, dtype=np.float32)]


def _delta(scale=0.25):
    return [np.full((4, 3), scale, np.float32), np.full((3,), -1.0, np.float32)]


def _server(cls, **kw):
    server = cls(_weights(), mode="asynchronous", port=0, **kw)
    server.start()
    return server


def _wait(cond, timeout_s=TIMEOUT):
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


@pytest.mark.parametrize("backend", ["http", "socket"])
def test_round_trip(backend):
    server = _server(HttpServer if backend == "http" else SocketServer)
    client = BaseParameterClient.get_client(backend, server.port, host="127.0.0.1",
                                            timeout=TIMEOUT)
    try:
        w = client.get_parameters()
        np.testing.assert_array_equal(w[0], 1.0)
        client.update_parameters(_delta())
        # a push of torch tensors goes on the wire as numpy
        client.update_parameters([torch.full((4, 3), 0.25), torch.zeros(3)])
        assert _wait(lambda: server.version == 2)
        w2 = client.get_parameters()
        assert all(isinstance(a, np.ndarray) for a in w2)
        np.testing.assert_allclose(w2[0], 0.5)
        np.testing.assert_allclose(w2[1], np.arange(3) + 1.0)
        assert server.pulls == 2
        assert client.get_version() == 2
    finally:
        client.close()
        server.stop()


@pytest.mark.skipif(not native_available(), reason="native parameter server "
                    "unavailable (no C++ toolchain)")
@pytest.mark.parametrize("codec", [None, "int8"])
def test_native_round_trip(codec):
    server = NativeServer(_weights(), mode="asynchronous", port=0)
    server.start()
    w0 = _weights()
    client = NativeClient([w.shape for w in w0], [w.dtype for w in w0], server.port,
                          codec=tcomp.make_codec(codec))
    try:
        client.update_parameters(_delta())
        got = client.get_parameters()
        np.testing.assert_allclose(got[0], 0.75, atol=0.25 / 127 if codec else 0)
        assert client.register_attempt("stage-0-partition-0", 0)
        client.update_parameters_tagged("stage-0-partition-0", _delta())
        assert client.register_attempt("stage-0-partition-0", 1)   # rolls it back
        np.testing.assert_allclose(client.get_parameters()[0], got[0])
        client.commit_attempt("stage-0-partition-0")
        assert server.attempt_count() == 0
    finally:
        client.close()
        server.stop()
    with pytest.raises(ValueError, match="float64"):
        check_f32_safe([np.float32, np.float64])


@pytest.mark.parametrize("backend", ["http", "socket"])
def test_attempt_rollback_and_fence(backend):
    server = _server(HttpServer if backend == "http" else SocketServer)
    client = BaseParameterClient.get_client(backend, server.port, host="127.0.0.1",
                                            timeout=TIMEOUT)
    task = "stage-3-partition-1"
    try:
        assert client.register_attempt(task, 0)
        client.update_parameters_tagged(task, _delta(), attempt=0)
        client.update_parameters_tagged(task, _delta(), attempt=0)
        assert _wait(lambda: server.version == 2)
        np.testing.assert_allclose(client.get_parameters()[0], 0.5)
        # the retry's register rolls both pushes back
        assert client.register_attempt(task, 1)
        np.testing.assert_allclose(client.get_parameters()[0], 1.0)
        # a zombie push of attempt 0 is fenced, the live attempt's applies
        client.update_parameters_tagged(task, _delta(), attempt=0)
        client.update_parameters_tagged(task, _delta(), attempt=1)
        assert _wait(lambda: server.rejected_stale == 1 and server.version == 3)
        np.testing.assert_allclose(client.get_parameters()[0], 0.75)
        client.commit_attempt(task)
        assert _wait(lambda: task not in server._attempts)
        assert server.applied_tagged[task] == 3
    finally:
        client.close()
        server.stop()


def _seeded_deltas(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(33, 7)).astype(np.float32),
            rng.normal(size=(5,)).astype(np.float32),
            np.zeros((0,), np.float32), np.zeros((2, 2), np.float32)]


def _same_payload(a, b):
    assert a[tcomp._MARKER] == b[jcomp._MARKER]
    assert len(a["arrays"]) == len(b["arrays"])
    for x, y in zip(a["arrays"], b["arrays"]):
        assert set(x) == set(y)
        for k in x:
            if isinstance(x[k], np.ndarray):
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k])
            else:
                assert x[k] == y[k]


@pytest.mark.parametrize("spec", ["int8", "topk:0.1", "topk:1.0"])
def test_codecs_equal_the_reference_bit_for_bit(spec):
    port, ref = tcomp.make_codec(spec), jcomp.make_codec(spec)
    for seed in range(3):   # top-k carries its residual across pushes
        d = _seeded_deltas(seed)
        enc_t, enc_j = port.encode(d), ref.encode(d)
        _same_payload(enc_t, enc_j)
        for a, b in zip(tcomp.maybe_decode(enc_t), jcomp.maybe_decode(enc_j)):
            np.testing.assert_array_equal(a, b)
        # each package decodes the other's payload
        for a, b in zip(tcomp.maybe_decode(enc_j), jcomp.maybe_decode(enc_t)):
            np.testing.assert_array_equal(a, b)
    if spec.startswith("topk"):
        for a, b in zip(port.residual, ref.residual):
            np.testing.assert_array_equal(a, b)
    assert tcomp.make_codec(None) is None
    with pytest.raises(ValueError):
        tcomp.make_codec("topk:0")


SERVERS = {"http": (HttpServer, JHttpServer), "socket": (SocketServer, JSocketServer)}


@pytest.mark.parametrize("backend", ["http", "socket"])
@pytest.mark.parametrize("direction", ["port-client", "reference-client"])
def test_wire_interop(backend, direction):
    """The port's client against the reference's server, and the other way
    round: pulls, plain and attempt-tagged pushes and compressed pushes give
    the same weights as the same traffic within one package."""
    port_cls, ref_cls = SERVERS[backend]
    if direction == "port-client":
        server_cls, make_client, codec = ref_cls, BaseParameterClient.get_client, tcomp
        wrap = tcomp.CompressingClient
    else:
        server_cls, make_client, codec = port_cls, JClient.get_client, jcomp
        wrap = jcomp.CompressingClient
    results = []
    for cls, mk in ((server_cls, make_client), (port_cls, BaseParameterClient.get_client)):
        server = _server(cls)
        client = mk(backend, server.port, host="127.0.0.1", timeout=TIMEOUT)
        try:
            client.update_parameters(_delta(0.5))
            assert client.register_attempt("stage-0-partition-0", 0)
            client.update_parameters_tagged("stage-0-partition-0", _delta(0.125),
                                            attempt=0)
            client.commit_attempt("stage-0-partition-0")
            wrap(client, codec.make_codec("int8")).update_parameters(
                [np.random.default_rng(1).normal(size=(4, 3)).astype(np.float32),
                 np.full((3,), 0.5, np.float32)])
            assert _wait(lambda: server.version == 3)
            results.append([np.array(w) for w in client.get_parameters()])
        finally:
            client.close()
            server.stop()
    for a, b in zip(*results):
        np.testing.assert_array_equal(a, b)
