"""The port's streaming train-to-serve loop (``elephas_tpu_torch/streaming``,
``SparkModel.fit_stream``) against the JAX package's on the CPU.

- The params bridge: ``params_to_list`` is the reference's wire list (sorted
  keys, numpy); ``list_to_params`` rebuilds tensors of the template's dtype
  and device after the reference's shape check, and a wire list
  round-trips bit for bit (float32 and bfloat16 leaves).
- ``StreamTrainer`` + ``WeightPublisher`` against real http and socket
  servers, each package against its own: the same commits (index, version,
  loss), publish and rollback history (the poisoned update of
  ``tests/streaming/test_stream_pipeline.py`` included), ring and JSON
  state; the time leg on a fake clock.
- The supervised stream: a crash at batch 5 resumes from the checkpointed
  cursor and replays the uninterrupted run's history, as the reference's
  does, with the same supervisor events.
- ``SparkModel.fit_stream`` into a live engine: the same summary and
  publish history as the reference's ``fit_stream`` on the same stream;
  and, with the port's LM train step as ``train_fn``, a paged engine that
  keeps serving between commits emits after each swap exactly the tokens of
  a fresh engine on the published weights (its prefix cache flushed by each
  swap).
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu import streaming as JS
from elephas_tpu.parameter.client import BaseParameterClient as JClient
from elephas_tpu.parameter.server import HttpServer as JHttp
from elephas_tpu.parameter.server import SocketServer as JSocket
from elephas_tpu.resilience import TrainingSupervisor as JSupervisor
from elephas_tpu_torch import streaming as TS
from elephas_tpu_torch.models import TransformerLM, adam, build_lm_train_step
from elephas_tpu_torch.parameter.client import BaseParameterClient as TClient
from elephas_tpu_torch.parameter.server import HttpServer as THttp
from elephas_tpu_torch.parameter.server import SocketServer as TSocket
from elephas_tpu_torch.resilience import TrainingSupervisor as TSupervisor
from elephas_tpu_torch.serving import ServingEngine

CFG = dict(vocab=17, d_model=16, n_heads=4, n_layers=2, d_ff=32, max_len=48)
PACKAGES = {"reference": (JS, JClient, {"http": JHttp, "socket": JSocket}, JSupervisor),
            "port": (TS, TClient, {"http": THttp, "socket": TSocket}, TSupervisor)}


def _weights():
    return [np.zeros((3,), np.float32), np.ones((2, 2), np.float32)]


def _server_client(pkg, kind, weights=None):
    _, client_cls, servers, _ = PACKAGES[pkg]
    server = servers[kind](weights or _weights(), port=0)
    server.start()
    return server, client_cls.get_client(kind, port=server.port, host="127.0.0.1",
                                         timeout=10.0)


def _train_fn(weights, batch):
    return [w + np.float32(batch) for w in weights], float(batch)


def _eval_fn(weights, batch):
    return float(np.mean([np.abs(w).mean() for w in weights]))


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# -- the bridge ----------------------------------------------------------------


def test_bridge_matches_reference_and_round_trips_bit_for_bit():
    model = TransformerLM(**CFG, device="cpu")
    params = model.init(3)
    wire = TS.params_to_list(params)
    want = JS.params_to_list({k: v.numpy() for k, v in params.items()})
    assert len(wire) == len(want)
    for a, b in zip(wire, want):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    back = TS.list_to_params(wire, params)
    assert list(back) == sorted(params)
    for k, v in params.items():
        assert back[k].dtype == v.dtype and back[k].device == v.device
        assert torch.equal(back[k], v), k
    # a bfloat16 template: the wire carries exact float32 values, the
    # rebuilt leaves are bfloat16 again, the same bits
    half = {k: v.to(torch.bfloat16) for k, v in params.items()}
    wire16 = TS.params_to_list(half)
    assert all(w.dtype == np.float32 for w in wire16)
    again = TS.list_to_params(wire16, half)
    assert all(again[k].dtype == torch.bfloat16 and torch.equal(again[k], half[k])
               for k in half)
    # a numpy template gets the wire arrays back, as the reference's
    np_back = TS.list_to_params(want, {k: v.numpy() for k, v in params.items()})
    assert all(isinstance(v, np.ndarray) for v in np_back.values())
    with pytest.raises(ValueError, match="shape mismatch"):
        TS.list_to_params([w.T if w.ndim == 2 else w for w in wire], params)
    with pytest.raises(ValueError, match="arrays but the params"):
        TS.list_to_params(wire[:-1], params)


# -- trainer and publisher -----------------------------------------------------


def _stream(pkg, kind):
    """The stream contract and the publisher's gate on one server: ordered
    commits, a poisoned commit refused and rolled back, a cold sink re-fed,
    the ring, and the JSON state."""
    S = PACKAGES[pkg][0]
    server, client = _server_client(pkg, kind)
    try:
        seen = []
        pub = S.WeightPublisher(client, lambda w, v: seen.append((v, float(w[0][0]))),
                                publish_every=2, eval_fn=_eval_fn,
                                regression_margin=1e-6, ring_size=2)
        trainer = S.StreamTrainer(client, _train_fn)
        commits = trainer.run([-0.25, -0.5, 100.0, 0.0, -100.0, -1.0, 0.5, 0.25],
                              publisher=pub)
        pub.serving_version = -1                  # a sink that came back cold
        pub.offer(trainer.step(100.0, index=8))
        pub.offer(trainer.step(100.0, index=9))
        state = json.loads(json.dumps(pub.state_dict()))
        return ([(c.index, c.version, c.loss) for c in commits], seen, state,
                [(v, [w.tolist() for w in ws]) for v, ws, _ in pub.ring],
                trainer._tagged, [w.tolist() for w in server.get_weights()])
    finally:
        client.close()
        server.stop()


@pytest.mark.parametrize("kind", ["http", "socket"])
def test_trainer_and_publisher_match_reference(kind):
    got, want = _stream("port", kind), _stream("reference", kind)
    assert got == want
    commits, seen, state = got[:3]
    assert [c[1] for c in commits] == list(range(1, 9))
    # v2 publishes; the poison (v4) and the gate's stricter baseline refuse
    # v4 and v6; v8 recovers; the cold sink is re-fed v8 when v10 regresses
    assert [r["event"] for r in state["history"]] == [
        "publish", "rollback", "rollback", "publish", "rollback"]
    assert state["rollbacks"] == 3 and seen == [(2, -0.75), (8, -1.0), (8, -1.0)]


def test_publisher_time_leg_matches_reference():
    out = []
    for pkg in ("reference", "port"):
        S = PACKAGES[pkg][0]
        server, client = _server_client(pkg, "http")
        try:
            clock, seen = FakeClock(), []
            pub = S.WeightPublisher(client, lambda w, v: seen.append(v), publish_every=5,
                                    max_interval_s=2.0, clock=clock)
            trainer = S.StreamTrainer(client, _train_fn)
            for i, dt in enumerate([0.5, 0.5, 1.5, 0.1, 3.0, 0.2]):
                clock.t += dt
                pub.offer(trainer.step(1.0, index=i))
            out.append((seen, pub.state_dict()))
        finally:
            client.close()
            server.stop()
    assert out[1] == out[0] and out[1][0] == [3, 5]


# -- the supervised stream -----------------------------------------------------


class CrashingTrainFn:
    def __init__(self, crash_at):
        self.crash_at, self.calls = crash_at, 0

    def __call__(self, weights, batch):
        self.calls += 1
        if self.calls == self.crash_at:
            self.crash_at = None
            raise RuntimeError("injected stream crash")
        return _train_fn(weights, batch)


def _supervised(pkg, tmpdir, train_fn, crash):
    S, _, _, Supervisor = PACKAGES[pkg]
    server, client = _server_client(pkg, "socket", [np.zeros((3,), np.float32)])
    try:
        published = []
        pub = S.WeightPublisher(client, lambda w, v: published.append((v, float(w[0][0]))),
                                publish_every=2,
                                eval_fn=lambda w, b: float(np.abs(w[0]).mean()),
                                regression_margin=0.5)
        trainer = S.StreamTrainer(client, train_fn)
        sup = Supervisor(None, str(tmpdir), checkpoint_frequency=1,
                         max_restarts=2 if crash else 0)
        batches = [float(x) for x in np.random.default_rng(42).normal(size=8)]
        sup.fit_stream(batches, trainer, publisher=pub)
        return ([dict(e.__dict__) for e in pub.history], published,
                server.get_weights()[0].tolist(), [e.kind for e in sup.events])
    finally:
        client.close()
        server.stop()


def test_supervised_stream_crash_resume_matches_reference(tmp_path):
    clean = _supervised("port", tmp_path / "clean", _train_fn, False)
    crashed = _supervised("port", tmp_path / "crashed", CrashingTrainFn(5), True)
    want = _supervised("reference", tmp_path / "ref", CrashingTrainFn(5), True)
    assert crashed == want
    assert crashed[3] == ["start", "crash", "resume", "complete"]
    assert crashed[0] == clean[0] and crashed[2] == clean[2]


# -- fit_stream ----------------------------------------------------------------


class _LMShim:
    """The LM's params as a SparkModel master network (PS wire order =
    sorted keys), as in the reference's test."""

    def __init__(self, bridge, params):
        self.bridge, self.params = bridge, dict(params)

    def get_weights(self):
        return self.bridge.params_to_list(self.params)

    def set_weights(self, weights):
        self.params = self.bridge.list_to_params(weights, self.params)


def _toy_fit_stream(pkg):
    from elephas_tpu import SparkModel as JSparkModel
    from elephas_tpu.models.transformer import TransformerLM as JaxLM
    from elephas_tpu_torch import SparkModel as TSparkModel

    S = PACKAGES[pkg][0]
    np_params = {k: np.asarray(v) for k, v in JaxLM(**CFG).init(seed=1).items()}
    if pkg == "reference":
        shim = _LMShim(S, {k: jnp.asarray(v) for k, v in np_params.items()})
        sm = JSparkModel(shim, mode="asynchronous", parameter_server_mode="socket",
                         port=0)
    else:
        shim = _LMShim(S, {k: torch.from_numpy(v) for k, v in np_params.items()})
        sm = TSparkModel(shim, mode="asynchronous", parameter_server_mode="socket",
                         port=0, device="cpu")
    seen = []

    def train_fn(weights, batch):
        return [w + np.float32(batch) * 1e-3 for w in weights], float(batch)

    summary = sm.fit_stream([1.0, 2.0, 3.0, 4.0, 5.0], train_fn,
                            sink=lambda w, v: seen.append(v), publish_every=2,
                            eval_fn=lambda w, b: float(np.abs(w[0]).mean()),
                            regression_margin=0.01)
    return summary, seen, np.asarray(shim.params["tok"])


def test_fit_stream_summary_matches_reference():
    got, want = _toy_fit_stream("port"), _toy_fit_stream("reference")
    assert got[0] == want[0] and got[1] == want[1]
    assert got[0]["commits"] == 5 and got[0]["last_version"] == 5
    np.testing.assert_array_equal(got[2], want[2])


def test_fit_stream_rejects_modes_without_live_ps():
    from elephas_tpu_torch import SparkModel

    model = TransformerLM(**CFG, device="cpu")
    sm = SparkModel(_LMShim(TS, model.init(1)), mode="synchronous", device="cpu")
    with pytest.raises(ValueError, match="fit_stream"):
        sm.fit_stream([1.0], _train_fn)
    sm = SparkModel(_LMShim(TS, model.init(1)), mode="asynchronous",
                    parameter_server_mode="jax", device="cpu")
    with pytest.raises(ValueError, match="host parameter servers"):
        sm.fit_stream([1.0], _train_fn)


def test_fit_stream_lm_step_publishes_into_live_paged_engine():
    """The port's LM train step as ``train_fn`` over a socket server,
    publishing every commit into a live paged engine that decodes a round
    between commits: the weights version follows each publish, the prefix
    cache is flushed by each swap, and a request admitted after each swap
    emits exactly what a fresh engine on the published weights emits."""
    from elephas_tpu_torch import SparkModel

    model = TransformerLM(**CFG, device="cpu")
    p0 = model.init(1)
    step, opt_init = build_lm_train_step(model, None, adam(5e-2), attn="flash")
    state = {"opt": None}

    def train_fn(weights, batch):
        params = TS.list_to_params(weights, p0)
        if state["opt"] is None:
            state["opt"] = opt_init(params)
        new, state["opt"], loss = step(params, state["opt"], *batch)
        return TS.params_to_list(new), float(loss)

    rng = np.random.default_rng(0)
    batches = [tuple(torch.from_numpy(a) for a in _lm_batch(rng)) for _ in range(3)]
    eng = ServingEngine(model, p0, n_slots=2, paged=True, page_size=8, device="cpu")
    empty_tree = eng.kv.memory_stats()["prefix"]["nodes"]
    shared = rng.integers(0, 17, size=(16,)).astype(np.int32)
    live = eng.submit(np.concatenate([shared, [1, 2]]).astype(np.int32), 12, seed=0)
    eng.step()
    checks = []

    def sink(weights, version):
        TS.engine_sink(eng, p0)(weights, version)
        assert eng.weights_version == version
        assert eng.kv.memory_stats()["prefix"]["nodes"] == empty_tree   # flushed
        rid = eng.submit(np.concatenate([shared, [version % 17]]).astype(np.int32), 4)
        eng.drain(max_steps=200)
        fresh = ServingEngine(model, TS.list_to_params(weights, p0), n_slots=1,
                              device="cpu")
        fid = fresh.submit(np.concatenate([shared, [version % 17]]).astype(np.int32), 4)
        checks.append((version, eng.result(rid).tokens == fresh.drain()[fid].tokens))

    shim = _LMShim(TS, p0)
    sm = SparkModel(shim, mode="asynchronous", parameter_server_mode="socket", port=0,
                    device="cpu")
    summary = sm.fit_stream(batches, train_fn, sink=sink, publish_every=1)
    assert summary["commits"] == 3 and summary["publisher"]["published"] == 3
    assert checks == [(1, True), (2, True), (3, True)]
    rec = eng.result(live)
    assert rec is not None and rec.version_first == 0 and rec.version_last >= 1
    for k, v in shim.params.items():
        assert v.dtype == p0[k].dtype and torch.isfinite(v).all()
    assert not torch.equal(shim.params["tok"], p0["tok"])


def _lm_batch(rng):
    from elephas_tpu_torch.models import make_lm_batches

    return make_lm_batches(rng.integers(0, 17, size=(2, 13)).astype(np.int32))
