"""Distributed hyperparameter search: ``HyperParamModel`` (port of
``elephas_tpu/hyperparam.py``).

The reference templates the *source code* of user-supplied
``data()``/``model()`` functions hyperas-style — ``{{choice([...])}}``
markers inside the model function — fans the templated source out over a
dummy RDD, and runs an independent TPE search per partition with a
partition-derived seed. The markers, :class:`TPESampler`,
:func:`get_hyperopt_model_string`, ``HyperasWorker._run_trials`` and
:class:`VotingModel` are copies of the reference's (framework-free): the
same seed and losses give the same draws.

- ``data()`` returns ``x_train, y_train, x_test, y_test`` and is called on
  every worker;
- ``model(x_train, y_train, x_test, y_test)`` returns
  ``{'loss': ..., 'status': STATUS_OK, 'model': model}``, where ``model``
  has ``to_json()`` and ``get_weights()``: the port's
  :class:`~elephas_tpu_torch.models.adapters.KerasModelAdapter`
  (``SparkModel.master_network``) or a Keras model.

What the port does otherwise: each worker thread is pinned to
``torch.cuda.device(partitionId % torch.cuda.device_count())`` when the
search runs on CUDA (the reference pins it to a JAX device), each trial
records the device its worker ran on, and ``minimize`` / ``best_models``
rebuild the best trials as the port's adapter on ``device``, not as Keras
models.
"""

from __future__ import annotations

import contextlib
import inspect
import math
import random as _random
import re
import textwrap
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from . import DeviceLike, resolve_device
from .data.rdd import SparkContext
from .models.adapters import KerasModelAdapter

STATUS_OK = "ok"


# -- hyperas-style distribution markers --------------------------------------
# These exist so user files importing them parse; inside ``{{...}}`` they are
# re-parsed textually into Space objects at template time.


class _Space:
    def sample(self, rng: _random.Random):
        raise NotImplementedError


class _Choice(_Space):
    def __init__(self, options):
        self.options = list(options)

    def sample(self, rng):
        return rng.choice(self.options)


class _Uniform(_Space):
    def __init__(self, low, high):
        self.low, self.high = float(low), float(high)

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class _QUniform(_Space):
    def __init__(self, low, high, q):
        self.low, self.high, self.q = float(low), float(high), float(q)

    def sample(self, rng):
        return round(rng.uniform(self.low, self.high) / self.q) * self.q


class _LogUniform(_Space):
    def __init__(self, low, high):
        self.low, self.high = math.log(low), math.log(high)

    def sample(self, rng):
        return math.exp(rng.uniform(self.low, self.high))


def choice(options):  # noqa: D103 — hyperas-parity marker
    return _Choice(options)


def uniform(low, high):  # noqa: D103
    return _Uniform(low, high)


def quniform(low, high, q):  # noqa: D103
    return _QUniform(low, high, q)


def loguniform(low, high):  # noqa: D103
    return _LogUniform(low, high)


# -- TPE sampler --------------------------------------------------------------


class TPESampler:
    """Independent-dimension Tree-structured Parzen Estimator.

    For each dimension the observed values from the best γ-fraction of
    trials form the "good" density ``g`` and the rest the "bad" density
    ``b``; proposals are drawn from ``g`` and ranked by ``g(x)/b(x)``.
    Continuous dims use Parzen windows (equal-weight Gaussians at the
    observations, bandwidth from the neighbour spacing) in the TRANSFORMED
    coordinate — log-space for ``loguniform`` — mixed with the uniform prior
    so no region's density ever hits zero; ``choice``/``quniform`` dims use
    add-one-smoothed categoricals. Deterministic given the ``random.Random``
    passed in.
    """

    def __init__(self, spaces: List[_Space], gamma: float = 0.25,
                 n_candidates: int = 24, n_startup: int = 5):
        self.spaces = spaces
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.n_startup = n_startup

    # -- per-dimension transforms ---------------------------------------
    @staticmethod
    def _fwd(space: _Space, v):
        if isinstance(space, _LogUniform):
            return math.log(v)
        return float(v)

    @staticmethod
    def _bounds(space: _Space):
        if isinstance(space, _Uniform):  # quniform routes to the
            return space.low, space.high  # discrete branch, never here
        if isinstance(space, _LogUniform):
            return space.low, space.high  # already log-space
        return None

    def _parzen(self, space: _Space, obs: List[float]):
        """(means, sigmas, lo, hi) for a continuous dim's Parzen windows."""
        lo, hi = self._bounds(space)
        pts = sorted(self._fwd(space, v) for v in obs)
        span = max(hi - lo, 1e-12)
        sigmas = []
        for i, m in enumerate(pts):
            left = pts[i - 1] if i > 0 else lo
            right = pts[i + 1] if i + 1 < len(pts) else hi
            s = max(right - left, span / 100.0) / 2.0
            sigmas.append(min(s, span))
        return pts, sigmas, lo, hi

    @staticmethod
    def _parzen_pdf(x, means, sigmas, lo, hi, prior_w=0.1):
        span = max(hi - lo, 1e-12)
        p = prior_w / span
        if means:
            k = (1.0 - prior_w) / len(means)
            for m, s in zip(means, sigmas):
                p += k * math.exp(-0.5 * ((x - m) / s) ** 2) / (
                    s * math.sqrt(2 * math.pi)
                )
        return p

    def _dim_models(self, space: _Space, good: List, bad: List):
        """Return (sample_good(rng), score(value)) for one dimension."""
        if isinstance(space, (_Choice, _QUniform)):
            # discrete: smoothed categorical over the observed support
            def key(v):
                return repr(v)

            support: List = []
            seen = set()
            for v in good + bad:
                if key(v) not in seen:
                    seen.add(key(v))
                    support.append(v)
            if isinstance(space, _Choice):
                for v in space.options:
                    if key(v) not in seen:
                        seen.add(key(v))
                        support.append(v)

            def probs(obs):
                counts = {key(v): 1.0 for v in support}  # add-one smoothing
                for v in obs:
                    counts[key(v)] += 1.0
                tot = sum(counts.values()) + 1.0  # +1: unseen-value mass
                return {k_: c / tot for k_, c in counts.items()}, 1.0 / tot

            (pg, floor_g), (pb, floor_b) = probs(good), probs(bad)

            def sample_good(rng):
                if rng.random() < 0.1:  # keep the prior alive — quniform
                    return space.sample(rng)  # support lists only observed
                r = rng.random()
                acc = 0.0
                for v in support:
                    acc += pg[key(v)]
                    if r <= acc:
                        return v
                return support[-1]

            def score(v):
                return math.log(pg.get(key(v), floor_g)) - math.log(
                    pb.get(key(v), floor_b)
                )

            return sample_good, score

        g_m, g_s, lo, hi = self._parzen(space, good)
        b_m, b_s, _, _ = self._parzen(space, bad)

        def sample_good(rng):
            if not g_m or rng.random() < 0.1:  # keep the prior alive
                return space.sample(rng)
            i = rng.randrange(len(g_m))
            for _ in range(16):
                x = rng.gauss(g_m[i], g_s[i])
                if lo <= x <= hi:
                    break
            else:
                x = min(max(x, lo), hi)
            if isinstance(space, _LogUniform):
                return math.exp(x)
            return x

        def score(v):
            x = self._fwd(space, v)
            return math.log(self._parzen_pdf(x, g_m, g_s, lo, hi)) - math.log(
                self._parzen_pdf(x, b_m, b_s, lo, hi)
            )

        return sample_good, score

    def suggest(self, trials: List[Dict[str, Any]],
                rng: _random.Random) -> List[Any]:
        """Propose the next parameter vector given past ``trials`` (each
        with ``"loss"`` and ``"params"``)."""
        ok = [t for t in trials if t.get("status", STATUS_OK) == STATUS_OK]
        if len(ok) < self.n_startup:
            return [s.sample(rng) for s in self.spaces]
        ok = sorted(ok, key=lambda t: t["loss"])
        n_good = max(1, int(round(self.gamma * len(ok))))
        good, bad = ok[:n_good], ok[n_good:] or ok[:1]

        dims = [
            self._dim_models(s, [t["params"][d] for t in good],
                             [t["params"][d] for t in bad])
            for d, s in enumerate(self.spaces)
        ]
        best_cand, best_score = None, None
        for _ in range(self.n_candidates):
            cand = [sample(rng) for sample, _ in dims]
            sc = sum(score(v) for (_, score), v in zip(dims, cand))
            if best_score is None or sc > best_score:
                best_cand, best_score = cand, sc
        return best_cand


_MARKER = re.compile(r"\{\{(.+?)\}\}", re.DOTALL)


def get_hyperopt_model_string(model_fn: Callable) -> Dict[str, Any]:
    """Template the model function's source (reference: hyperas
    ``get_hyperopt_model_string``, ``hyperparam.py:~30``).

    Returns ``{'source', 'spaces', 'name'}`` where each ``{{...}}`` marker has
    been replaced by ``__hp__[i]`` and ``spaces[i]`` is the parsed Space.
    """
    src = textwrap.dedent(inspect.getsource(model_fn))
    # Drop decorators if any, keep the def.
    spaces: List[_Space] = []

    def repl(match):
        expr = match.group(1)
        space = eval(  # noqa: S307 — expression comes from the user's own file
            expr,
            {"choice": choice, "uniform": uniform, "quniform": quniform,
             "loguniform": loguniform},
        )
        if not isinstance(space, _Space):
            raise ValueError(f"{{{{{expr}}}}} is not a search-space expression")
        spaces.append(space)
        return f"__hp__[{len(spaces) - 1}]"

    templated = _MARKER.sub(repl, src)
    return {"source": templated, "spaces": spaces, "name": model_fn.__name__,
            "globals": model_fn.__globals__}


class HyperasWorker:
    """Per-partition search worker (reference ``HyperasWorker._minimize``).

    ``keep_weights_top`` bounds driver memory: only each worker's best-k
    trials ship their full weight lists back; the rest carry
    ``weights=None`` (loss/params always recorded). ``device`` is where
    the trials run: on CUDA each worker pins its thread's current device
    (``partitionId % device_count``, or the index asked for)."""

    def __init__(self, model_spec: Dict[str, Any], data_fn: Callable,
                 max_evals: int, keep_weights_top: Optional[int] = None,
                 device: DeviceLike = "cuda"):
        self.model_spec = model_spec
        self.data_fn = data_fn
        self.max_evals = int(max_evals)
        self.keep_weights_top = keep_weights_top
        self.device = torch.device(device)

    def _minimize(self, data_iterator):
        """Run ``max_evals`` evaluations seeded from the partition contents,
        the worker's thread pinned to its own card: the CUDA current device
        is per thread, so concurrent workers on a machine with several
        cards train on disjoint ones, and ``resolve_device("cuda")`` in
        the user's model function gives the pinned card."""
        from .data import TaskContext

        ctx = TaskContext.get()
        if self.device.type == "cuda":
            index = self.device.index
            if index is None:
                part = ctx.partitionId() if ctx is not None else 0
                index = part % torch.cuda.device_count()
            pin = torch.cuda.device(index)
        else:
            pin = contextlib.nullcontext()
        with pin:
            yield self._run_trials(data_iterator)

    def _run_trials(self, data_iterator):
        elements = list(data_iterator)
        seed = int(elements[0]) if elements else 0
        rng = _random.Random(seed)
        data = self.data_fn()

        spaces = self.model_spec["spaces"]
        exec_globals = dict(self.model_spec["globals"])
        exec_globals["STATUS_OK"] = STATUS_OK
        local_ns: Dict[str, Any] = {}
        exec(compile(self.model_spec["source"], "<hyperparam-template>", "exec"),
             exec_globals, local_ns)
        fn = local_ns[self.model_spec["name"]]

        # where this worker's computation lands (the pinned card)
        device = str(resolve_device(self.device))

        sampler = TPESampler(spaces)
        trials: List[Dict[str, Any]] = []
        for i in range(self.max_evals):
            params = sampler.suggest(trials, rng)
            exec_globals["__hp__"] = params
            result = fn(*data)
            model = result["model"]
            trial = {
                "loss": float(result["loss"]),
                "status": result.get("status", STATUS_OK),
                "params": params,
                "model_json": model.to_json(),
                "weights": model.get_weights(),
                "device": device,
            }
            trials.append(trial)
        if self.keep_weights_top is not None:
            ok = sorted(
                (t for t in trials if t["status"] == STATUS_OK),
                key=lambda t: t["loss"],
            )
            keep = {id(t) for t in ok[: self.keep_weights_top]}
            for t in trials:
                if id(t) not in keep:
                    t["weights"] = None
        return trials


class HyperParamModel:
    """Driver-side distributed search (reference ``HyperParamModel``), its
    trials and rebuilt models on ``device``."""

    def __init__(self, sc: SparkContext, num_workers: int = 4,
                 device: DeviceLike = "cuda"):
        self.spark_context = sc
        self.num_workers = int(num_workers)
        resolve_device(device)      # no CUDA: raise now, unless the CPU is asked for
        self.device = torch.device(device)

    def compute_trials(self, model: Callable, data: Callable, max_evals: int,
                       keep_weights_top: Optional[int] = None
                       ) -> List[Dict[str, Any]]:
        """All trials from all workers (reference ``compute_trials``)."""
        model_spec = get_hyperopt_model_string(model)
        worker = HyperasWorker(model_spec, data, max_evals, keep_weights_top,
                               device=self.device)
        # Dummy RDD fan-out: partition contents only seed the per-worker RNG
        # (reference ``hyperparam.py:~40``).
        dummy_rdd = self.spark_context.parallelize(range(1, 1000), 50)
        dummy_rdd = dummy_rdd.repartition(self.num_workers)
        trial_lists = dummy_rdd.mapPartitions(worker._minimize).collect()
        return [t for trials in trial_lists for t in trials]

    def _rebuild(self, trial: Dict[str, Any]) -> KerasModelAdapter:
        return KerasModelAdapter.from_json(trial["model_json"], trial["weights"],
                                           device=self.device)

    def minimize(self, model: Callable, data: Callable, max_evals: int = 5):
        """Best model across the distributed search (reference
        ``minimize``), as the port's adapter on ``device``."""
        trials = self.compute_trials(model, data, max_evals, keep_weights_top=1)
        ok = [t for t in trials if t["status"] == STATUS_OK and t["weights"]]
        if not ok:
            raise ValueError("Search produced no successful trials")
        best = min(ok, key=lambda t: t["loss"])
        return self._rebuild(best)

    def best_models(self, nb_models: int, model: Callable, data: Callable,
                    max_evals: int) -> "VotingModel":
        """Top-k ensemble (reference ``best_models`` → hyperas VotingModel)."""
        trials = self.compute_trials(
            model, data, max_evals, keep_weights_top=nb_models
        )
        ok = sorted(
            (t for t in trials if t["status"] == STATUS_OK and t["weights"]),
            key=lambda t: t["loss"],
        )
        members = [self._rebuild(t) for t in ok[:nb_models]]
        if not members:
            raise ValueError("Search produced no successful trials")
        return VotingModel(members)


class VotingModel:
    """Prediction-averaging ensemble (hyperas ``VotingModel`` parity)."""

    def __init__(self, models: List):
        self.models = list(models)

    def predict(self, x, **kwargs):
        preds = [m.predict(x, verbose=0) for m in self.models]
        return np.mean(np.stack(preds), axis=0)

    def predict_classes(self, x, **kwargs):
        return self.predict(x).argmax(axis=-1)
