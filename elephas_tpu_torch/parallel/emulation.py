"""Host emulation for elastic multi-host training (port of
``elephas_tpu/parallel/emulation.py``).

Every "host" is a real OS **process** (spawned here, killed with a real
``SIGKILL``), and hosts talk to the driver over real TCP with the
parameter-server framing of :mod:`elephas_tpu_torch.utils.sockets`
(checksummed v2 frames; the driver answers in the dialect the worker
speaks). The cross-host gradient exchange is a **proxy collective**: each
host sends its round delta to the driver, which reduces over the
membership epoch's live set and commits through the versioned parameter
store (:class:`~elephas_tpu_torch.parallel.elastic.ElasticHostPool`).

The worker half of this file is **standalone**: run as a script
(``python .../emulation.py --driver host:port --host-id N``) it loads only
``utils/sockets.py`` by file path, so an ``sgd_task`` host imports neither
``torch`` nor the package and boots in well under a second.
:func:`keras_fit_task` (the ``SparkModel(elastic=...)`` task) puts the
repository root on ``sys.path`` itself and trains the port's
:class:`~elephas_tpu_torch.worker.KerasReplica` on the task config's
``device`` (``"cuda"`` by default; a host asked for CUDA without it raises,
as every entry point of the port does).

Worker lifecycle (one TCP connection, full duplex):

1. connect (bounded-backoff retry) → send ``hello`` (host id, pid, device
   count);
2. receive ``adopt`` (task spec + config + heartbeat interval) → start the
   beat thread (beats flow even while a round is computing, so a *live*
   slow host never loses its lease, only dead or partitioned ones do);
3. loop: ``round`` → run the task on the shard → send ``contrib`` stamped
   with the round's membership **epoch**; ``sync`` → informational;
   ``stop`` → ``goodbye`` and exit.

A worker never decides liveness or epochs: the driver's registry does.

The reference's ``JaxPodBackend`` (``jax.distributed`` geometry) has no
counterpart here yet: it comes with the multi-process sharding slice.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

if __package__:  # imported as elephas_tpu_torch.parallel.emulation
    from ..utils import sockets as _sockets
else:  # run as a standalone worker script: load sockets.py by path
    import importlib.util

    _sockets_path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "utils", "sockets.py",
    )
    _spec = importlib.util.spec_from_file_location("_elephas_sockets",
                                                   _sockets_path)
    _sockets = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_sockets)

# the directory holding the ``elephas_tpu_torch`` package
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# --------------------------------------------------------------------------
# Round tasks. Referenced by NAME over the wire ({"builtin": "sgd_task"}) so
# nothing closure-shaped is pickled across the process boundary; a custom
# task ships as {"file": "/abs/path.py", "fn": "name"} and is loaded by path.
# Every task maps (weights, shard, config) -> (delta, metrics) where the
# driver applies ``weights -= delta`` (the parameter-server update rule).
# --------------------------------------------------------------------------

def sgd_task(weights: List[Any], shard: Any, config: Dict[str, Any]):
    """One least-squares SGD round on ``shard = (x, y)``: cheap and exactly
    deterministic, numpy only: the workhorse of the membership and fencing
    tests, where what is under test is the control plane, not the model."""
    import numpy as np

    (w,) = weights
    x, y = shard
    # A fixed sleep makes a kill land mid-compute deterministically; a
    # per-sample sleep emulates compute proportional to the shard.
    pause = float(config.get("sleep_s", 0.0))
    pause += float(config.get("sleep_per_sample_s", 0.0)) * len(x)
    if pause:
        time.sleep(pause)
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    resid = x @ w - y
    grad = x.T @ resid / max(1, x.shape[0])
    lr = float(config.get("lr", 0.1))
    loss = float(np.mean(resid ** 2))
    return [lr * grad], {"loss": loss, "samples": int(x.shape[0])}


_KERAS_CACHE: Dict[Any, Any] = {}


def keras_fit_task(weights: List[Any], shard: Any, config: Dict[str, Any]):
    """One local fit round: the ``SparkModel.fit`` elastic worker.

    The replica is the port's :class:`~elephas_tpu_torch.worker.KerasReplica`
    over the config's ``model_json`` on the config's ``device``, trained
    with Keras ``model.fit``'s contract and Keras's optimizer rule, cached
    per (JSON, optimizer, loss, device) so each host process builds it once
    and keeps it, optimizer state included, across rounds and mesh
    re-formations (only the shard changes)."""
    import numpy as np

    if _REPO_ROOT not in sys.path:
        sys.path.insert(0, _REPO_ROOT)
    from elephas_tpu_torch.worker import KerasReplica

    device = config.get("device", "cuda")
    key = (config["model_json"], repr(config.get("optimizer")),
           repr(config.get("loss")), str(device))
    x, y = shard
    before = [np.array(w) for w in weights]
    model = _KERAS_CACHE.get(key)
    if model is None:
        model = KerasReplica(config["model_json"], before,
                             config.get("optimizer") or "sgd", config.get("loss"),
                             list(config.get("metrics") or []), device=device)
        _KERAS_CACHE[key] = model
    model.set_weights(before)
    history = model.fit(
        np.asarray(x), np.asarray(y),
        epochs=int(config.get("local_epochs", 1)),
        batch_size=int(config.get("batch_size", 32)),
        verbose=0, validation_split=0.0, shuffle=False,
    )
    after = model.get_weights()
    delta = [b - np.asarray(a) for b, a in zip(before, after)]
    losses = history.history.get("loss", [])
    return delta, {
        "loss": float(losses[-1]) if losses else float("nan"),
        "samples": int(np.asarray(x).shape[0]),
    }


def _resolve_task(spec: Dict[str, Any]):
    if "builtin" in spec:
        fn = globals().get(spec["builtin"])
        if fn is None:
            raise ValueError(f"unknown builtin task {spec['builtin']!r}")
        return fn
    import importlib.util

    mod_spec = importlib.util.spec_from_file_location("_elastic_task",
                                                      spec["file"])
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return getattr(module, spec["fn"])


# --------------------------------------------------------------------------
# Worker main
# --------------------------------------------------------------------------

def worker_main(driver: str, host_id: int, devices: int = 1,
                connect_timeout_s: float = 30.0,
                max_frame_bytes: Optional[int] = None) -> int:
    sock = _sockets.connect_with_retry(driver, timeout_s=connect_timeout_s)
    send_lock = threading.Lock()
    rxbuf = _sockets.ReusableBuffer()
    max_frame = (_sockets.DEFAULT_MAX_FRAME_BYTES if max_frame_bytes is None
                 else int(max_frame_bytes))

    def send(msg: Dict[str, Any]) -> None:
        # workers speak checksummed v2 frames (sockets.send default); the
        # driver's bilingual reader answers in kind
        with send_lock:
            _sockets.send(sock, msg)

    send({"op": "hello", "host": host_id, "pid": os.getpid(),
          "devices": int(devices)})
    task_fn = None
    task_config: Dict[str, Any] = {}
    stop_beats = threading.Event()

    def beat_loop(interval_s: float) -> None:
        while not stop_beats.wait(interval_s):
            try:
                send({"op": "beat", "host": host_id})
            except OSError:
                return

    try:
        while True:
            msg = _sockets.receive(sock, rxbuf, max_frame_bytes=max_frame)
            op = msg.get("op")
            if op == "adopt":
                task_fn = _resolve_task(msg["task"])
                task_config = dict(msg.get("config") or {})
                beat = threading.Thread(
                    target=beat_loop,
                    args=(float(msg.get("beat_interval_s", 0.25)),),
                    daemon=True, name=f"beat-host-{host_id}",
                )
                beat.start()
            elif op == "round":
                delta, metrics = task_fn(msg["weights"], msg["shard"],
                                         {**task_config,
                                          **(msg.get("config") or {})})
                send({"op": "contrib", "host": host_id,
                      "epoch": int(msg["epoch"]), "round": int(msg["round"]),
                      "version": int(msg.get("version", -1)),
                      "delta": delta, "metrics": metrics})
            elif op == "sync":
                pass  # informational: carried state arrives with each round
            elif op == "stop":
                send({"op": "goodbye", "host": host_id})
                return 0
            else:
                raise ValueError(f"unknown driver op {op!r}")
    except (ConnectionError, EOFError, OSError) as err:
        # The driver went away: name the cause on stderr so a dead worker
        # is never a silent mystery.
        print(f"[elastic-worker host-{host_id}] connection lost: {err!r}",
              file=sys.stderr)
        traceback.print_exc(file=sys.stderr)
        return 1
    finally:
        stop_beats.set()
        try:
            sock.close()
        except OSError:
            pass


# --------------------------------------------------------------------------
# Emulation backend: spawn/kill real host processes
# --------------------------------------------------------------------------

class EmulationBackend:
    """Launches one worker **process** per emulated host and owns its
    lifecycle: spawn, SIGKILL (chaos), and reaping; no orphan ``Popen``
    survives :meth:`stop_all`, even on the timeout path.

    The children inherit the calling process's environment plus ``env``;
    nothing else is set (the reference pins each child's JAX platform and
    virtual device count, which a PyTorch host has no use for)."""

    name = "emulation"

    def __init__(self, *, devices_per_host: int = 1,
                 python: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None,
                 quiet: bool = True):
        self.devices_per_host = int(devices_per_host)
        self.python = python or sys.executable
        self.extra_env = dict(env or {})
        self.quiet = quiet
        self.procs: Dict[int, subprocess.Popen] = {}

    def _worker_env(self) -> Dict[str, str]:
        env = dict(os.environ)
        env.update(self.extra_env)
        return env

    def spawn(self, host_id: int, driver_address: str) -> None:
        if host_id in self.procs and self.procs[host_id].poll() is None:
            raise RuntimeError(f"host {host_id} is already running")
        script = os.path.abspath(__file__)
        self.procs[host_id] = subprocess.Popen(
            [self.python, script, "--driver", driver_address,
             "--host-id", str(host_id),
             "--devices", str(self.devices_per_host)],
            env=self._worker_env(),
            stdout=subprocess.DEVNULL if self.quiet else None,
            stderr=subprocess.DEVNULL if self.quiet else None,
        )

    def kill(self, host_id: int) -> None:
        """SIGKILL: real, unhandleable process death (and reap it, so a
        chaos run leaks no zombies)."""
        proc = self.procs.get(host_id)
        if proc is None or proc.poll() is not None:
            return
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)

    def alive(self, host_id: int) -> bool:
        proc = self.procs.get(host_id)
        return proc is not None and proc.poll() is None

    def stop_all(self, grace_s: float = 5.0) -> None:
        """Reap every spawned process: wait out the grace period for workers
        told to stop, then SIGKILL stragglers and ``wait()`` them all."""
        deadline = time.monotonic() + float(grace_s)
        for proc in self.procs.values():
            if proc.poll() is None:
                try:
                    proc.wait(timeout=max(0.05, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    proc.send_signal(signal.SIGKILL)
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.wait(timeout=30)


def _main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="elastic emulation worker")
    parser.add_argument("--driver", required=True, help="driver host:port")
    parser.add_argument("--host-id", type=int, required=True)
    parser.add_argument("--devices", type=int, default=1)
    args = parser.parse_args(argv)
    return worker_main(args.driver, args.host_id, devices=args.devices)


if __name__ == "__main__":
    sys.exit(_main())
