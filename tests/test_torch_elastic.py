"""The port's elastic host pool (``elephas_tpu_torch/parallel/elastic.py``,
``emulation.py``) against the JAX package's, over real host processes.

Every pool here spawns real subprocesses that speak the sockets framing to
the fitting process. The same ``ElasticConfig``, data and initial weights go
through the reference's pool and the port's, both with the numpy
``sgd_task`` (the hosts import neither JAX nor PyTorch), and the two must
leave the same membership trace, mesh history, commit log (without its
times), stats, server version and fence count, and the same final weights
bit for bit: both packages run the same float64 numpy arithmetic. The
port's pools also meet the reference's literal pins
(``tests/elastic/test_pool.py``).

Also here: the ``EmulationBackend`` cases of
``tests/elastic/test_cluster_bootstrap.py`` (spawn, kill and reap;
``stop_all`` reaps stragglers; the worker script boots with
``PYTHONPATH=/nonexistent``), a ``{"file", "fn"}`` task showing that an
``sgd_task`` host never imports ``torch`` or the package, and a two-host
fit of the Keras-replica task in both packages (the reference's Keras
``model.fit`` against the port's ``KerasReplica`` on the CPU) held to the
host path's pin. The chaos scenarios are in ``test_torch_elastic_chaos.py``.

The hosts run with ``OMP_NUM_THREADS=2``.
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import json
import os
import random
import socket
import subprocess
import sys

import numpy as np
import pytest

from elephas_tpu.parallel.elastic import ElasticConfig as JElasticConfig
from elephas_tpu.parallel.elastic import ElasticHostPool as JElasticHostPool
from elephas_tpu.parallel.emulation import EmulationBackend as JEmulationBackend
from elephas_tpu_torch.parallel import ElasticConfig, ElasticHostPool, EmulationBackend

HOST_ENV = {"OMP_NUM_THREADS": "2"}
ATOL, RTOL = 1e-6, 1e-5     # the host path's pin (tests/test_torch_host_fit.py)


def lsq_problem(seed=0, n=300, d=3):
    rng = np.random.default_rng(seed)
    w_true = np.array([1.0, -2.0, 3.0])[:d]
    x = rng.normal(size=(n, d))
    return x, x @ w_true, w_true


def run_pool(pkg, cfg_kw, x, y, *, plan=None, task=None, task_config=None,
             weights=None):
    """One fit of ``pkg``'s pool ("ref" or "port") over fresh host
    processes; returns ``(pool, final weights)``."""
    config_cls, pool_cls, backend_cls = {
        "ref": (JElasticConfig, JElasticHostPool, JEmulationBackend),
        "port": (ElasticConfig, ElasticHostPool, EmulationBackend)}[pkg]
    cfg = config_cls(**cfg_kw)
    pool = pool_cls(
        [np.zeros(x.shape[1])] if weights is None else weights, cfg,
        task=task or {"builtin": "sgd_task"},
        task_config={"lr": 0.5} if task_config is None else task_config,
        fault_plan=plan,
        backend=backend_cls(devices_per_host=cfg.devices_per_host, env=HOST_ENV))
    return pool, pool.fit(x, y)


def commits(pool):
    return [{k: v for k, v in c.items() if k != "at"} for c in pool.commit_log]


def assert_same_run(port, ref, port_w, ref_w):
    """The two pools' control planes and weights agree exactly."""
    assert port.membership_trace == ref.membership_trace
    assert port.mesh_history == ref.mesh_history
    assert commits(port) == commits(ref)
    assert port.stats == ref.stats
    assert port.history == ref.history
    assert (port.ps.version, port.ps.rejected_stale) == (ref.ps.version,
                                                         ref.ps.rejected_stale)
    assert len(port_w) == len(ref_w)
    for a, b in zip(port_w, ref_w):
        np.testing.assert_array_equal(a, np.asarray(b))


def both(cfg_kw, n=300, **kw):
    x, y, w_true = lsq_problem(n=n)
    ref, ref_w = run_pool("ref", cfg_kw, x, y, **kw)
    port, port_w = run_pool("port", cfg_kw, x, y, **kw)
    assert_same_run(port, ref, port_w, ref_w)
    return port, port_w, w_true


# -- test_pool.py ----------------------------------------------------------------


def test_static_pool_converges():
    pool, weights, w_true = both(dict(initial_hosts=2, rounds=5, lease_s=2.0,
                                      beat_interval_s=0.1))
    losses = pool.history["loss"]
    assert len(losses) == 5
    assert losses[-1] < 0.1 * losses[0]
    assert np.allclose(weights[0], w_true, atol=0.5)
    assert [c["version"] for c in pool.commit_log] == [1, 2, 3, 4, 5]
    assert pool.stats["reformations"] == 0
    assert pool.membership_trace == [("join", "host-0"), ("join", "host-1")]


def test_scale_up_recuts_mesh():
    pool, _, _ = both(dict(initial_hosts=2, rounds=4, lease_s=2.0,
                           beat_interval_s=0.1, scale_schedule={2: 4}))
    assert [m["num_hosts"] for m in pool.mesh_history] == [2, 4]
    assert [len(c["contributors"]) for c in pool.commit_log] == [2, 2, 4, 4]
    assert pool.membership_trace == [
        ("join", "host-0"), ("join", "host-1"),
        ("join", "host-2"), ("join", "host-3"),
    ]
    epochs = [c["epoch"] for c in pool.commit_log]
    assert epochs == sorted(epochs) and epochs[2] > epochs[1]


def test_scale_down_retires_gracefully():
    pool, _, _ = both(dict(initial_hosts=3, rounds=4, lease_s=2.0,
                           beat_interval_s=0.1, scale_schedule={2: 2}))
    assert [len(c["contributors"]) for c in pool.commit_log] == [3, 3, 2, 2]
    assert ("leave", "host-2") in pool.membership_trace
    assert not any(kind == "expire" for kind, _ in pool.membership_trace)


def test_device_weighted_sharding_and_snapshot():
    """Two devices a host weight the shards (the reference's
    ``test_device_weighted_sharding``, 200 rows), and the snapshot
    round-trips through JSON with the reference's counters
    (``test_snapshot_json_round_trips``)."""
    pool, _, _ = both(dict(initial_hosts=2, rounds=2, lease_s=2.0,
                           beat_interval_s=0.1, devices_per_host=2), n=200)
    assert pool.mesh_history[0]["total_devices"] == 4
    assert pool.mesh_history[0]["hosts"] == [(0, 2), (1, 2)]
    snap = json.loads(json.dumps(pool.snapshot()))
    assert snap["stats"]["rounds_committed"] == 2
    assert snap["parameter_server"]["version"] == 2
    assert [c["version"] for c in snap["commit_log"]] == [1, 2]
    assert snap["registry"]["membership"]["epoch"] >= 2


def test_jax_backend_waits_for_item_6():
    with pytest.raises(NotImplementedError, match="item 6"):
        ElasticHostPool([np.zeros(3)], ElasticConfig(backend="jax"))


# -- the worker script and the backend (test_cluster_bootstrap.py) ----------------


def test_emulation_backend_spawns_kills_and_reaps():
    backend = EmulationBackend(devices_per_host=1, env=HOST_ENV)
    with socket.socket() as srv:
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", 0))
        srv.listen(4)
        backend.spawn(0, f"127.0.0.1:{srv.getsockname()[1]}")
        srv.settimeout(30)
        peer, _ = srv.accept()            # the worker process really dialed
        assert backend.alive(0)
        backend.kill(0)                   # a real SIGKILL, already reaped
        assert not backend.alive(0)
        assert backend.procs[0].returncode == -9
        peer.close()
    backend.stop_all()
    assert all(p.returncode is not None for p in backend.procs.values())


def test_emulation_backend_stop_all_reaps_stragglers():
    backend = EmulationBackend(devices_per_host=1, env=HOST_ENV)
    with socket.socket() as srv:          # never accepts: the worker retries
        srv.bind(("127.0.0.1", 0))
        backend.spawn(0, f"127.0.0.1:{srv.getsockname()[1]}")
        assert backend.alive(0)
        backend.stop_all(grace_s=0.2)     # grace expires -> SIGKILL + wait
    assert backend.procs[0].returncode is not None


def test_worker_script_runs_standalone_without_package_import():
    """The port's worker boots with the package unimportable: a driver that
    closes at once makes it exit 1 through its connection-lost path, not
    an ImportError."""
    import elephas_tpu_torch.parallel.emulation as emulation

    with socket.socket() as srv:
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = "/nonexistent"
        proc = subprocess.Popen(
            [sys.executable, emulation.__file__,
             "--driver", f"127.0.0.1:{srv.getsockname()[1]}", "--host-id", "0"],
            env=env, stderr=subprocess.PIPE, text=True, cwd="/")
        peer, _ = srv.accept()
        peer.close()                      # the driver vanishes mid-handshake
        _, stderr = proc.communicate(timeout=60)
    assert proc.returncode == 1, stderr[-2000:]
    assert "ImportError" not in stderr and "ModuleNotFoundError" not in stderr
    assert "connection lost" in stderr


PROBE_TASK = '''
import sys

def probe_task(weights, shard, config):
    import numpy as np
    seen = sorted({m.split(".")[0] for m in sys.modules} & {"torch", "elephas_tpu_torch", "jax"})
    (w,) = weights
    return [np.zeros_like(w)], {"loss": 0.0, "samples": len(shard[0]), "seen": seen}
'''


def test_sgd_hosts_import_neither_torch_nor_the_package(tmp_path):
    """A ``{"file", "fn"}`` task loaded by path in each host reports the
    host's modules: an ``sgd_task``-style host runs without ``torch``, the
    port's package or JAX, and the pool commits its rounds."""
    path = tmp_path / "probe_task.py"
    path.write_text(PROBE_TASK)
    x, y, _ = lsq_problem(n=64)
    pool = ElasticHostPool([np.zeros(3)],
                           ElasticConfig(initial_hosts=2, rounds=1, beat_interval_s=0.1),
                           task={"file": str(path), "fn": "probe_task"},
                           backend=EmulationBackend(env=HOST_ENV))
    seen, handle = [], pool._handle_contrib
    # read the metrics where contributions arrive (the commit keeps only
    # the loss and the sample count)
    pool._handle_contrib = lambda host, msg: (seen.append(msg["metrics"]["seen"]),
                                              handle(host, msg))
    pool.fit(x, y)
    assert [c["contributors"] for c in pool.commit_log] == [[0, 1]]
    assert seen == [[], []]


# -- the Keras-replica task ------------------------------------------------------


@pytest.fixture
def seeded_classifier():
    """The reference's toy classifier factory (``tests/conftest.py``
    ``make_classifier``) after a fixed Keras seed; every global generator
    is put back afterwards."""
    import keras
    from keras.src.backend.common import global_state
    from keras.src.random import seed_generator
    from keras.src.utils import rng_utils

    keys = (rng_utils.GLOBAL_RANDOM_SEED, seed_generator.GLOBAL_SEED_GENERATOR)
    saved = [global_state.get_global_attribute(k) for k in keys]
    np_state, py_state = np.random.get_state(), random.getstate()
    keras.utils.set_random_seed(0)
    from .conftest import make_classifier

    yield make_classifier
    np.random.set_state(np_state)
    random.setstate(py_state)
    for k, v in zip(keys, saved):
        global_state.set_global_attribute(k, v)


def test_keras_task_two_hosts_matches_reference(seeded_classifier, toy_classification):
    """Two hosts, two rounds, no chaos: the reference's ``keras_fit_task``
    (Keras ``model.fit`` in each host) and the port's (``KerasReplica`` on
    the CPU), from the same weights and shards, end at the same weights
    within the host path's pin, with the same control plane."""
    x, y = toy_classification
    keras_model = seeded_classifier(hidden=8, optimizer="adam")
    w0 = [np.array(w) for w in keras_model.get_weights()]
    task_config = {"model_json": keras_model.to_json(), "optimizer": "adam",
                   "loss": "categorical_crossentropy", "metrics": [],
                   "local_epochs": 1, "batch_size": 32, "device": "cpu"}
    cfg = dict(initial_hosts=2, rounds=2, lease_s=30.0, beat_interval_s=0.2,
               round_timeout_s=120.0)
    task = {"builtin": "keras_fit_task"}
    ref, ref_w = run_pool("ref", cfg, x, y, task=task, task_config=task_config,
                          weights=w0)
    port, port_w = run_pool("port", cfg, x, y, task=task, task_config=task_config,
                            weights=w0)
    assert port.membership_trace == ref.membership_trace
    assert port.mesh_history == ref.mesh_history
    assert [(c["version"], c["epoch"], c["round"], c["contributors"])
            for c in port.commit_log] == [
        (c["version"], c["epoch"], c["round"], c["contributors"]) for c in ref.commit_log]
    np.testing.assert_allclose(port.history["loss"], ref.history["loss"],
                               atol=ATOL, rtol=RTOL)
    for got, want in zip(port_w, ref_w):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)
    assert np.abs(port_w[0] - w0[0]).max() > 1e-3       # it trained
