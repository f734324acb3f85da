"""The data-parallel training engine (port of ``elephas_tpu/parallel/engine.py``
``CompiledTrainer``).

The reference compiles every elephas training mode into one XLA program
over a device mesh: per-worker model replicas train locally (``vmap`` over
the workers, ``lax.scan`` over shuffled batches) and merge through
``psum``. The port runs the same schedules eagerly on one device: the
``W`` worker replicas are one stack of parameters ``[W, ...]`` (the
reference's ``vmap`` written out), a step trains all of them at once
(``torch.bmm`` per Dense layer, one K1 launch for the loss of every
replica), and a merge is a weighted sum over the stack. The data stays on
the device for the whole fit; the host reads back one number per metric
and epoch.

Mode → schedule (as in the reference):

- ``synchronous``, ``frequency='epoch'``: train ``epochs`` locally, ONE
  merge at the end (each worker's delta ``w0 - w_final``, averaged).
- ``synchronous``, ``frequency='batch'``: gradient-synchronous DP-SGD, one
  shared set of parameters; per batch the workers' gradients of their
  sample-weighted loss sums are summed and divided by the global weight
  sum, and one optimizer step is taken.
- ``asynchronous`` / ``hogwild``, ``frequency='epoch'``: merge after every
  local epoch; ``frequency='batch'``: merge after every batch.

``merge='sum'`` applies the sum of the deltas (the parameter server's
semantics, default for the asynchronous modes), ``merge='mean'`` their
mean over the valid workers (default for synchronous). Padding as in the
reference: samples by zero sample-weight, masked out of losses and
updates; ``worker_valid`` takes workers out of the merges.

Randomness: each worker's epoch order comes from :func:`epoch_permutation`,
drawn on the host from the seed, so the card and the CPU see the same
order (the reference's ``jax.random`` order depends on its device count
and cannot be reproduced by a torch generator; tests put it in by
replacing that one function). Dropout masks come from a device generator
reseeded each epoch from (seed, global epoch) (:func:`epoch_seed`), drawn
over the whole replica stack; so a fit cut into chunks (``epoch_offset``)
draws the uninterrupted fit's orders and masks.

Non-trainable state (BatchNormalization's moving statistics, the
adapter's ``ntv``) travels beside the parameters as the reference's does:
each replica keeps its own stack (``ntv_stack``), merged with the
parameters at every epoch or batch merge by the same rule (the valid
workers' summed deltas, averaged for ``merge='mean'``); the
gradient-synchronous schedule keeps each replica's statistics for the
whole fit and averages them once at its end. Each replica's validation
runs with its own statistics.

``remat=True`` builds every training step with the adapter's
recomputation (the reference's ``jax.checkpoint`` around the model and
the loss): the backward runs the forward again instead of keeping its
activations, so K1's forward launches twice a training step.

Merge-faithful chunking (synchronous + epoch only, as in the reference):
``keep_worker_state=True`` returns the replica stacks un-merged
(``FitResult.worker_state``: ``tv_stack`` and ``ntv_stack`` and the
``base_tv`` and ``base_ntv`` they started from), with the installed
weights the merge a preview would give;
the next chunk continues them through ``worker_state=`` with
``epoch_offset`` at the global epoch, and the one real merge is the last
chunk's preview.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.adapters import KerasModelAdapter
from ..models.optimizers import _lead, _tree_map
from .mesh import DeviceMesh, build_mesh

def _pad_block(arr: np.ndarray, target_rows: int) -> np.ndarray:
    """Zero-pad ``arr`` along axis 0 to ``target_rows``."""
    n = arr.shape[0]
    if n == target_rows:
        return arr
    pad = np.zeros((target_rows - n,) + arr.shape[1:], dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def epoch_permutation(seed: int, n_workers: int, epoch: int, n_rows: int) -> np.ndarray:
    """Every worker's order of its ``n_rows`` (padded) rows in one epoch,
    ``[n_workers, n_rows]``: worker ``w`` draws from a numpy generator
    keyed by ``(seed, w, epoch)``, so its order does not depend on the
    worker count or the device."""
    return np.stack([np.random.default_rng((seed, w, epoch)).permutation(n_rows)
                     for w in range(n_workers)])


def epoch_seed(seed: int, epoch: int) -> int:
    """The dropout generator's seed for global epoch ``epoch`` of a fit
    seeded ``seed``."""
    return int(np.random.SeedSequence((int(seed), int(epoch)))
               .generate_state(1, np.uint64)[0])


def _as_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A staged host block on the device; floating data as float32, as the
    reference's JAX arrays (no float64) hold it."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.is_floating_point():
        t = t.to(torch.float32)
    return t.to(device)


def _tile(tv: Dict[str, torch.Tensor], n: int) -> Dict[str, torch.Tensor]:
    """Replica stacks ``[n, ...]`` of the parameters ``tv``."""
    return {k: v[None].expand((n,) + tuple(v.shape)).clone() for k, v in tv.items()}


class FitResult:
    """Final weights + Keras-``History``-shaped metrics (+ optimizer state).

    ``weights`` materializes lazily: host numpy copies are only pulled when
    the attribute is read."""

    def __init__(self, weights, history: Dict[str, List[float]],
                 opt_state: Any = None, timings: Optional[Dict[str, float]] = None,
                 worker_state: Any = None):
        self._weights = weights  # list OR zero-arg thunk
        self.history = history
        self.opt_state = opt_state
        self.timings = timings or {}
        self.worker_state = worker_state

    @property
    def weights(self) -> List[np.ndarray]:
        if callable(self._weights):
            self._weights = self._weights()
        return self._weights


class CompiledTrainer:
    """Run the elephas training modes over a replica stack on one device.

    The name is the reference's; nothing is compiled here. One instance
    per (adapter, mesh); repeated ``fit`` calls on the same blocks reuse
    the data already staged on the device."""

    def __init__(self, adapter: KerasModelAdapter, mesh: Optional[DeviceMesh] = None,
                 mode: str = "synchronous", frequency: str = "epoch",
                 merge: str = "auto", remat: bool = False):
        if mode not in ("synchronous", "asynchronous", "hogwild"):
            raise ValueError(f"Unknown mode: {mode}")
        if frequency not in ("epoch", "batch"):
            raise ValueError(f"Unknown frequency: {frequency}")
        self.adapter = adapter
        self.mesh = mesh if mesh is not None else build_mesh(device=adapter.device)
        if self.mesh.device != adapter.device:
            raise ValueError(f"the adapter's weights are on {adapter.device}, the "
                             f"mesh on {self.mesh.device}")
        self.mode = mode
        self.frequency = frequency
        self.remat = remat
        if mode == "synchronous" and frequency == "batch" and merge == "sum":
            raise ValueError(
                "mode='synchronous', frequency='batch' is the gradient-"
                "synchronous schedule: gradients are weight-averaged per "
                "batch and there is no delta merge, so merge='sum' has no "
                "meaning here (use merge='auto')."
            )
        if merge == "auto":
            merge = "mean" if mode == "synchronous" else "sum"
        if merge not in ("mean", "sum"):
            raise ValueError(f"Unknown merge: {merge}")
        self.merge = merge
        self.optimizer = adapter.make_optimizer()
        self._staged = None

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    # ------------------------------------------------------------------
    def fit(self, blocks: Sequence[Tuple[np.ndarray, np.ndarray]], epochs: int,
            batch_size: int, validation_split: float = 0.0,
            seed: int = 0, verbose: int = 0, opt_state: Any = None,
            keep_opt_state: bool = False, worker_state: Any = None,
            keep_worker_state: bool = False, epoch_offset: int = 0,
            worker_valid: Optional[Sequence[float]] = None) -> FitResult:
        """Train over per-worker data ``blocks`` ``[(x_w, y_w), ...]``.

        ``worker_valid`` (one float per block, 1.0 = live, 0.0 = excluded)
        overrides the merge validity mask: an excluded worker still trains
        but contributes nothing to any merge. ``opt_state`` continues from
        a previous ``FitResult`` (``keep_opt_state=True`` returns it).
        ``epoch_offset`` is the global index of this call's first epoch
        (orders and dropout masks follow it); ``worker_state`` /
        ``keep_worker_state`` carry the synchronous+epoch replica stacks
        across chunks (module docstring).

        Returns merged weights in ``get_weights()`` order plus per-epoch
        history (``loss``[, ``accuracy``, ``val_loss``, ``val_accuracy``]).
        """
        if keep_worker_state or worker_state is not None:
            if not (self.mode == "synchronous" and self.frequency == "epoch"):
                raise ValueError(
                    "worker_state carrying applies to synchronous+epoch mode "
                    f"only (got {self.mode}/{self.frequency}); the other "
                    "schedules merge within each chunk and are already "
                    "cadence-faithful under chunking"
                )
        W = len(blocks)
        if W == 0:
            raise ValueError("No worker data blocks (all partitions skipped?)")
        B = int(batch_size)
        E = int(epochs)

        # -- split train/val per worker (Keras semantics: validation data is
        # the LAST fraction of each worker's block, taken before shuffling)
        n_trains, n_vals = [], []
        for x_w, _ in blocks:
            n = np.asarray(x_w).shape[0]
            n_val = int(n * validation_split) if validation_split else 0
            n_trains.append(n - n_val)
            n_vals.append(n_val)
        S = max(1, max(int(math.ceil(nt / B)) for nt in n_trains))
        N = S * B
        has_val = any(nv > 0 for nv in n_vals)
        Sv = max(1, max(int(math.ceil(nv / B)) for nv in n_vals)) if has_val else 1
        Nv = Sv * B

        if worker_valid is None:
            wvalid = np.ones((W,), np.float32)
        else:
            if len(worker_valid) != W:
                raise ValueError(
                    f"worker_valid has {len(worker_valid)} entries for "
                    f"{W} worker blocks"
                )
            wvalid = np.array([float(v) for v in worker_valid], np.float32)
            if wvalid.sum() <= 0.0:
                raise ValueError("worker_valid excludes every worker")

        # Device staging cache: the same block arrays and geometry reuse the
        # tensors already on the device.
        stage_key = (tuple((id(bx), id(by)) for bx, by in blocks),
                     validation_split, N, Nv, tuple(wvalid.tolist()))
        if self._staged is not None and self._staged[0] == stage_key:
            data = self._staged[1]
        else:
            parts = {k: [] for k in ("x", "y", "sw", "xv", "yv", "sv")}
            for (x_w, y_w), nt, nv in zip(blocks, n_trains, n_vals):
                x_w, y_w = np.asarray(x_w), np.asarray(y_w)
                parts["x"].append(_pad_block(x_w[:nt], N))
                parts["y"].append(_pad_block(y_w[:nt], N))
                parts["sw"].append(_pad_block(np.ones((nt,), np.float32), N))
                if has_val:
                    parts["xv"].append(_pad_block(x_w[nt:], Nv))
                    parts["yv"].append(_pad_block(y_w[nt:], Nv))
                    parts["sv"].append(_pad_block(np.ones((nv,), np.float32), Nv))
            data = {k: _as_device(np.stack(v), self.device) for k, v in parts.items() if v}
            data["wvalid"] = _as_device(wvalid, self.device)
            self._staged = (stage_key, data)

        gen = torch.Generator(device=self.device)
        tv0, ntv0 = self.adapter.state_values()
        if opt_state is not None:        # a resumed state arrives on the CPU
            opt_state = _tree_map(lambda t: t.to(self.device), opt_state)
        if worker_state is not None:
            worker_state = _tree_map(lambda t: t.to(self.device), worker_state)
        ws_out = None
        t_start = time.perf_counter()
        epochs_at = range(int(epoch_offset), int(epoch_offset) + E)
        if self.mode == "synchronous" and self.frequency == "batch":
            tv, ntv, opt_state, stats = self._fit_gradsync(
                tv0, ntv0, opt_state, data, W, S, B, epochs_at, Sv, has_val, seed, gen)
        else:
            tv, ntv, opt_state, stats, ws_out = self._fit_local(
                tv0, ntv0, opt_state, data, W, S, B, epochs_at, Sv, has_val, seed, gen,
                worker_state)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t_run = time.perf_counter() - t_start

        self.adapter.install_state(tv, ntv)
        flat_dev = self.adapter.state_to_weights(tv, ntv)
        weights_thunk = lambda: [w.detach().cpu().numpy() for w in flat_dev]  # noqa: E731

        # one transfer for every metric of every epoch
        rows = torch.stack([torch.stack(s) for s in stats]).cpu().tolist() if stats else []
        history: Dict[str, List[float]] = {"loss": [r[0] for r in rows]}
        if self.adapter.wants_accuracy:
            history["accuracy"] = [r[1] for r in rows]
        if has_val:
            history["val_loss"] = [r[2] for r in rows]
            if self.adapter.wants_accuracy:
                history["val_accuracy"] = [r[3] for r in rows]
        if verbose:
            for e in range(E):
                line = f"epoch {e + 1}/{E} - loss: {history['loss'][e]:.4f}"
                if "val_loss" in history:
                    line += f" - val_loss: {history['val_loss'][e]:.4f}"
                print(line)
        return FitResult(
            weights_thunk, history,
            opt_state=opt_state if keep_opt_state else None,
            timings={"run_seconds": t_run,
                     "samples_per_sec": sum(n_trains) * E / max(t_run, 1e-9)},
            worker_state=ws_out if keep_worker_state else None,
        )

    # ------------------------------------------------------------------
    def _epoch_batches(self, data, seed: int, W: int, epoch: int, S: int, B: int):
        """The epoch's shuffled batches: ``x [W, S, B, ...]``, ``y``, ``sw``."""
        N = S * B
        perm = torch.as_tensor(epoch_permutation(seed, W, epoch, N)).to(self.device)
        rows = torch.arange(W, device=self.device)[:, None]
        return tuple(data[k][rows, perm].reshape((W, S, B) + tuple(data[k].shape[2:]))
                     for k in ("x", "y", "sw"))

    def _epoch_metrics(self, eval_step, stats, tv_stack, ntv_stack, data, Sv: int,
                       B: int, has_val: bool):
        """``[loss, accuracy, val_loss, val_accuracy]`` of one epoch as 0-d
        device tensors (the validation pair 0 without validation data); each
        replica validates with its own parameters and statistics."""
        loss_ws, acc_ws, wsum = stats
        w = torch.clamp(wsum, min=1e-9)
        out = [loss_ws / w, acc_ws / w]
        zero = torch.zeros((), device=self.device)
        if not has_val:
            return out + [zero, zero]
        vl, va, vw = zero, zero, zero
        for s in range(Sv):
            sl = slice(s * B, (s + 1) * B)
            l_, a_, w_ = eval_step(tv_stack, ntv_stack, data["xv"][:, sl],
                                   data["yv"][:, sl], data["sv"][:, sl])
            vl, va, vw = vl + l_.sum(), va + a_.sum(), vw + w_.sum()
        vw = torch.clamp(vw, min=1e-9)
        return out + [vl / vw, va / vw]

    def _merge(self, stack, base, wvalid, denom, kind: Optional[str] = None):
        """Apply the valid workers' summed (or, for ``kind`` ``"mean"``,
        averaged) deltas to ``base``; ``kind`` defaults to the trainer's
        ``merge``."""
        out = {}
        for k, b in base.items():
            delta = b[None] - stack[k]
            total = (delta * _lead(wvalid, delta)).sum(dim=0)
            if (kind or self.merge) == "mean":
                total = total / denom
            out[k] = b - total
        return out

    def _fit_local(self, tv0, ntv0, opt_state, data, W, S, B, epochs_at, Sv, has_val,
                   seed, gen, worker_state=None):
        """The local-training schedules: synchronous+epoch, and the
        asynchronous/hogwild merges at epoch or batch frequency, over the
        global epochs ``epochs_at``. ``(merged tv, merged ntv, opt_state,
        history, worker_state)``; synchronous+epoch continues
        ``worker_state``'s stacks when given, and its merge is then a
        preview against their base."""
        train_step = self.adapter.build_train_step(self.optimizer, self.remat)
        eval_step = self.adapter.build_eval_step()
        merge_every_epoch = self.mode != "synchronous" and self.frequency == "epoch"
        merge_every_batch = self.mode != "synchronous" and self.frequency == "batch"
        wvalid = data["wvalid"]
        denom = torch.clamp(wvalid.sum(), min=1.0)
        if worker_state is not None:
            base = dict(worker_state["base_tv"])
            tv_stack = dict(worker_state["tv_stack"])
            # a stack saved before the statistics travelled holds none
            base_ntv = dict(worker_state.get("base_ntv", {}))
            ntv_stack = dict(worker_state.get("ntv_stack", {}))
        else:
            base, base_ntv = dict(tv0), dict(ntv0)
            tv_stack, ntv_stack = _tile(base, W), _tile(base_ntv, W)
        opt = opt_state if opt_state is not None else \
            self.optimizer.init(tv_stack, count_shape=(W,))
        history = []
        with torch.no_grad():
            for e in epochs_at:
                gen.manual_seed(epoch_seed(seed, e))
                xb, yb, swb = self._epoch_batches(data, seed, W, e, S, B)
                tot = [torch.zeros((), device=self.device) for _ in range(3)]
                for s in range(S):
                    tv_stack, ntv_stack, opt, st = train_step(
                        tv_stack, ntv_stack, opt, xb[:, s], yb[:, s], swb[:, s], gen)
                    tot = [t + v.sum() for t, v in zip(tot, st)]
                    if merge_every_batch:
                        base = self._merge(tv_stack, base, wvalid, denom)
                        base_ntv = self._merge(ntv_stack, base_ntv, wvalid, denom)
                        tv_stack, ntv_stack = _tile(base, W), _tile(base_ntv, W)
                if merge_every_epoch:
                    base = self._merge(tv_stack, base, wvalid, denom)
                    base_ntv = self._merge(ntv_stack, base_ntv, wvalid, denom)
                    tv_stack, ntv_stack = _tile(base, W), _tile(base_ntv, W)
                history.append(self._epoch_metrics(eval_step, tot, tv_stack, ntv_stack,
                                                   data, Sv, B, has_val))
            ws = None
            if not (merge_every_epoch or merge_every_batch):
                ws = {"tv_stack": tv_stack, "ntv_stack": ntv_stack, "base_tv": base,
                      "base_ntv": base_ntv}
                # the one merge
                base = self._merge(tv_stack, base, wvalid, denom)
                base_ntv = self._merge(ntv_stack, base_ntv, wvalid, denom)
        return base, base_ntv, opt, history, ws

    def _fit_gradsync(self, tv0, ntv0, opt_state, data, W, S, B, epochs_at, Sv,
                      has_val, seed, gen):
        """Gradient-synchronous DP-SGD (``mode='synchronous',
        frequency='batch'``): one shared set of parameters and one
        optimizer state; per batch the summed gradients of every worker's
        weighted loss sum over the global weight sum, one step. Each
        worker keeps its own statistics through the fit; they are averaged
        over the valid workers once at its end."""
        grad_step = self.adapter.build_grad_step(self.remat)
        eval_step = self.adapter.build_eval_step()
        tv = dict(tv0)
        ntv_stack = _tile(ntv0, W)
        opt = opt_state if opt_state is not None else self.optimizer.init(tv)
        history = []
        for e in epochs_at:
            gen.manual_seed(epoch_seed(seed, e))
            xb, yb, swb = self._epoch_batches(data, seed, W, e, S, B)
            tot = [torch.zeros((), device=self.device) for _ in range(3)]
            for s in range(S):
                grads, ntv_stack, st = grad_step(tv, ntv_stack, xb[:, s], yb[:, s],
                                                 swb[:, s], gen)
                with torch.no_grad():
                    wtot = torch.clamp(st[2].sum(), min=1e-9)
                    ghat = {k: g / wtot for k, g in grads.items()}
                    updates, opt = self.optimizer.update(ghat, opt, tv)
                    tv = {k: tv[k] + updates[k] for k in tv}
                    tot = [t + v.sum() for t, v in zip(tot, st)]
            with torch.no_grad():
                stacked = {k: v[None].expand((W,) + tuple(v.shape)) for k, v in tv.items()}
                history.append(self._epoch_metrics(eval_step, tot, stacked, ntv_stack, data,
                                                   Sv, B, has_val))
        wvalid = data["wvalid"]
        with torch.no_grad():
            ntv = self._merge(ntv_stack, dict(ntv0), wvalid,
                              torch.clamp(wvalid.sum(), min=1.0), "mean")
        return tv, ntv, opt, history

    # ------------------------------------------------------------------
    def predict(self, x: np.ndarray, batch_size: int = 32) -> np.ndarray:
        """Batched inference with the current weights on the device."""
        return self.adapter.predict(np.asarray(x), batch_size=batch_size)

    def evaluate(self, x: np.ndarray, y: np.ndarray,
                 batch_size: int = 32) -> Dict[str, float]:
        """Loss (and accuracy) on held-out data → ``{"loss": ...,
        ["accuracy": ...]}``, the weighted means over every row."""
        eval_step = self.adapter.build_eval_step()
        tv, ntv = ({k: v[None] for k, v in d.items()} for d in self.adapter.state_values())
        x, y = np.asarray(x), np.asarray(y)
        B = int(batch_size)
        tot = [torch.zeros((), device=self.device) for _ in range(3)]
        for i in range(0, x.shape[0], B):
            xb = _as_device(x[i:i + B], self.device)[None]
            yb = _as_device(y[i:i + B], self.device)[None]
            sw = torch.ones((1, xb.shape[1]), device=self.device)
            tot = [t + v.sum() for t, v in zip(tot, eval_step(tv, ntv, xb, yb, sw))]
        w = torch.clamp(tot[2], min=1e-9)
        out = {"loss": float(tot[0] / w)}
        if self.adapter.wants_accuracy:
            out["accuracy"] = float(tot[1] / w)
        return out
