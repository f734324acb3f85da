"""The signature diff of the port against the reference: names, order and
defaults of every parameter equal the reference's.

- The public entries outside ``ops`` whose trailing parameters the port
  had dropped (fault 3 of ROADMAP §3), each restored parameter then called
  by position the reference's way: Pallas knobs (``interpret``) are
  accepted and ignored; the others take effect or raise where they ask for
  what is not ported yet.
- ``ops`` (fault 4): every name of ``elephas_tpu.ops.__all__``, and every
  public function of each reference module that a kernel source's
  ``Replaces:`` header names, against the port module that builds that
  source; the reference's ``ops/pallas_ops.py`` and ``ops/pallas_flash.py``
  names import from the port's modules of the same path. The absences are
  the ones ROADMAP queues (``ring_attention``, ``ulysses_attention``: item
  6) or logs as departures (``is_tpu_backend``, ``tileable``).
- The resilience, streaming and fleet packages (every public function and
  class of their modules, each public method, the soak runners' trailing
  ``device="cuda"`` taken out), ``ServingEngine.__init__``'s ``fault_plan``
  and ``SparkModel``'s resilience options and ``fit_stream``.
- The host path's modules (PR 14) and the API skins' (``ml_model``,
  ``ml/*``, ``data/dataframe``, ``hyperparam``, ``dl4j``): every public
  function and class, and each public method of a class, with the
  reference's parameters but for the port's trailing ``device="cuda"``.

The kernel entries of ``ops`` have their positional tests beside their
modules' other tests."""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import importlib
import inspect
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import elephas_tpu.ops as JO
import elephas_tpu_torch.ops as TO
from elephas_tpu.models import adapters as ja
from elephas_tpu.models import transformer as jt
from elephas_tpu.parallel import expert as JE
from elephas_tpu.serving import cache as jc
from elephas_tpu_torch.models import TransformerLM, from_jax_params
from elephas_tpu_torch.models import adapters as ta
from elephas_tpu_torch.parallel import expert as TE
from elephas_tpu_torch.serving import cache as tc


def _default(d):
    """A default as compared across the packages: a dtype by its name
    (``jnp.float32`` and ``torch.float32`` are both ``"float32"``), a
    function by its qualified name."""
    if isinstance(d, torch.dtype):
        return str(d).removeprefix("torch.")
    if inspect.isfunction(d):     # a default function: each package has its own
        return d.__qualname__
    if isinstance(d, type) and hasattr(d, "dtype"):   # a jnp scalar type
        return d.__name__
    return d


def _params(fn):
    fn = getattr(fn, "fun", fn)   # a jax.custom_vjp: its wrapped function
    return [(p.name, _default(p.default))
            for p in inspect.signature(fn).parameters.values()]


REPAIRED = [
    (TE.MoEFeedForward.apply_gmm, JE.MoEFeedForward.apply_gmm),
    (TransformerLM.prefill, jt.TransformerLM.prefill),
    (tc.SlotKVCache.__init__, jc.SlotKVCache.__init__),
    (ta.KerasModelAdapter.build_train_step, ja.KerasModelAdapter.build_train_step),
    (ta.KerasModelAdapter.build_grad_step, ja.KerasModelAdapter.build_grad_step),
]


@pytest.mark.parametrize("port,ref", REPAIRED, ids=lambda f: f.__qualname__)
def test_repaired_signature_matches_reference(port, ref):
    assert _params(port) == _params(ref)


def test_apply_gmm_positional_interpret():
    """``apply_gmm(params, x, ep, tm, interpret)`` by position: ``interpret``
    is ignored, the result equals the reference's ``apply_gmm``."""
    jm = JE.MoEFeedForward(128, 128, 4, k=2, capacity_factor=1.25, activation="swiglu")
    np_params = jm.init(0)
    tm = TE.MoEFeedForward(128, 128, 4, k=2, capacity_factor=1.25, activation="swiglu")
    tp = from_jax_params(np_params, device="cpu")
    x = np.random.default_rng(4).standard_normal((64, 128)).astype(np.float32)
    y, aux = tm.apply_gmm(tp, torch.from_numpy(x), 1, 128, True)
    y0, aux0 = tm.apply_gmm(tp, torch.from_numpy(x))
    assert torch.equal(y, y0) and float(aux) == float(aux0)
    jy, jaux = jax.jit(lambda p, x: jm.apply_gmm(p, x, 1, 128, None))(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4)
    assert abs(float(aux) - float(jaux)) < 1e-5


CFG = dict(vocab=17, d_model=16, n_heads=4, n_layers=2, d_ff=32, max_len=64)


def test_prefill_positional_ffn_tag():
    """``prefill(params, tokens, cache, ffn_tag)``: ``"dense"`` is the
    default path, any other tag (the reference's sharded MoE dispatch)
    raises, naming its ROADMAP item."""
    model = TransformerLM(**CFG, device="cpu")
    params = model.init(0)
    tokens = torch.tensor([[1, 2, 3, 4, 5]])
    got, _ = model.prefill(params, tokens, model.init_cache(1, 16), "dense")
    want, _ = model.prefill(params, tokens, model.init_cache(1, 16))
    assert torch.equal(got, want)
    with pytest.raises(NotImplementedError, match="item 6"):
        model.prefill(params, tokens, model.init_cache(1, 16), "seq")


@pytest.mark.parametrize("capacity", [None, 48, 96])
def test_slot_cache_positional_capacity_matches_reference(capacity):
    """``SlotKVCache(model, params, n_slots, max_len, capacity)`` by
    position: the cache time axis is the reference's for the same
    arguments."""
    jmodel = jt.TransformerLM(**CFG)
    model = TransformerLM(**CFG, device="cpu")
    want = jc.SlotKVCache(jmodel, jmodel.init(0), 2, 40, capacity)
    got = tc.SlotKVCache(model, model.init(0), 2, 40, capacity)
    assert got.capacity == want.capacity
    assert tuple(got.cache["k"].shape) == tuple(want.cache["k"].shape)


def test_slot_cache_takes_a_cache_made_elsewhere():
    """``cache=`` hands in the buffer to use (the reference's sharded engine
    pre-places its own); a ``max_len`` past its capacity raises."""
    model = TransformerLM(**CFG, device="cpu")
    params = model.init(0)
    cache = model.init_cache(3, 32)
    kv = tc.SlotKVCache(model, params, 3, 32, None, cache)
    assert kv.cache is cache and kv.capacity == cache["k"].shape[3]
    with pytest.raises(ValueError, match="capacity"):
        tc.SlotKVCache(model, params, 3, 64, None, cache)


def test_adapter_steps_take_remat_in_place():
    """``build_train_step(optimizer, remat)`` and ``build_grad_step(remat)``
    by position: ``False`` builds the step; ``True`` raises as
    ``CompiledTrainer(remat=True)`` does, naming its ROADMAP item."""
    import keras

    from elephas_tpu_torch.models.optimizers import to_torch_optimizer

    m = keras.Sequential([keras.layers.Dense(4)])
    m.build((None, 8))
    m.compile("sgd", "mse")
    adapter = ta.KerasModelAdapter(m, device="cpu")
    opt = to_torch_optimizer({"class_name": "SGD", "config": {"learning_rate": 0.1}})
    assert callable(adapter.build_train_step(opt, False))
    assert callable(adapter.build_grad_step(False))
    with pytest.raises(NotImplementedError, match="item 13"):
        adapter.build_train_step(opt, True)
    with pytest.raises(NotImplementedError, match="item 13"):
        adapter.build_grad_step(True)


STATE = ["state_values", "weights_to_state", "state_to_weights", "install_state"]


@pytest.mark.parametrize("name", STATE)
def test_adapter_state_signature_matches_reference(name):
    """The adapter's two-part state takes the reference's names and
    positions: ``state_values()``, ``weights_to_state(flat)``,
    ``state_to_weights(tv, ntv)``, ``install_state(tv, ntv)``."""
    assert _params(getattr(ta.KerasModelAdapter, name)) == \
        _params(getattr(ja.KerasModelAdapter, name))


def test_adapter_state_splits_as_the_reference():
    """On a model with BatchNormalization and Dropout, ``weights_to_state``
    gives the reference's trainable values in its order and its
    non-trainable weight slots (the moving statistics; the reference's
    seed-generator state has no weight slot and no port counterpart);
    ``state_to_weights`` and ``install_state`` invert it."""
    import keras

    keras.utils.set_random_seed(0)
    m = keras.Sequential([keras.layers.Input((6,)), keras.layers.Dense(5),
                          keras.layers.BatchNormalization(), keras.layers.Dropout(0.1),
                          keras.layers.Dense(3)])
    m.compile("adam", "mse")
    flat = [np.random.default_rng(i).normal(size=w.shape).astype(np.float32)
            for i, w in enumerate(m.get_weights())]
    ref = ja.KerasModelAdapter(m)
    jtv, jntv = ref.weights_to_state(flat)
    port = ta.KerasModelAdapter(m, device="cpu")
    tv, ntv = port.weights_to_state(flat)
    assert [k.split("/")[-1] for k in ntv] == ["moving_mean", "moving_variance"]
    assert len(tv) == len(jtv)
    for got, want in zip(tv.values(), jtv):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    slots = [v for v, slot in zip(jntv, ref._ntv_slots) if slot is not None]
    for got, want in zip(ntv.values(), slots):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = port.state_to_weights(tv, ntv)
    for got, want in zip(back, ref.state_to_weights(jtv, jntv)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    port.install_state(tv, ntv)
    got_tv, got_ntv = port.state_values()
    assert list(got_tv) == list(tv) and list(got_ntv) == list(ntv)
    for got, want in zip(port.get_weights(), flat):
        np.testing.assert_array_equal(got, want)


# -- ops: fault 4 ------------------------------------------------------------------

# queued (ROADMAP §1 item 6) or logged departures (ROADMAP §3)
ABSENT_FROM_OPS = {"ring_attention", "ulysses_attention"}
DEPARTED = {("pallas_ops", "is_tpu_backend"), ("grouped_matmul", "tileable")}
CSRC = Path(TO.__file__).parent / "csrc"


@pytest.mark.parametrize("name", JO.__all__)
def test_ops_exports_match_reference(name):
    """Each name of ``elephas_tpu.ops.__all__`` is exported by the port's
    ``ops`` with the reference's signature, or is one ROADMAP queues."""
    if name in ABSENT_FROM_OPS:
        assert not hasattr(TO, name)
        return
    assert name in TO.__all__
    assert _params(getattr(TO, name)) == _params(getattr(JO, name))


def _replaced_modules(cu: Path):
    """The reference modules the source's ``Replaces:`` header names."""
    header = cu.read_text().split("\n\n")[0]
    at = header.index("Replaces:")
    block = header[at:].split("\n//\n")[0]
    return sorted(set(re.findall(r"elephas_tpu/ops/(\w+)\.py", block)))


@pytest.mark.parametrize("cu", sorted(p.name for p in CSRC.glob("*.cu")))
def test_kernel_module_matches_the_reference_it_replaces(cu):
    """The port module that builds ``csrc/<cu>`` (``ops/<stem>.py``) has every
    public function of each reference module the source replaces, with the
    reference's signature, but for the logged departures."""
    stem = cu.removesuffix(".cu")
    port = importlib.import_module(f"elephas_tpu_torch.ops.{stem}")
    assert f'_build.load("{stem}"' in Path(port.__file__).read_text()
    refs = _replaced_modules(CSRC / cu)
    assert refs
    for r in refs:
        ref = importlib.import_module(f"elephas_tpu.ops.{r}")
        for name, fn in sorted(vars(ref).items()):
            inner = getattr(fn, "fun", fn)
            if (name.startswith("_") or not callable(fn)
                    or getattr(inner, "__module__", None) != ref.__name__):
                continue
            if (r, name) in DEPARTED:
                assert not hasattr(port, name)
                continue
            assert _params(getattr(port, name)) == _params(fn), (r, name)


PATH_NAMES = [(mod, name) for mod in ("pallas_ops", "pallas_flash")
              for name, fn in sorted(vars(importlib.import_module(
                  f"elephas_tpu.ops.{mod}")).items())
              if (mod, name) not in DEPARTED and (
                  name in ("_BQ", "_BK") or not name.startswith("_") and callable(fn)
                  and getattr(getattr(fn, "fun", fn), "__module__", None)
                  == f"elephas_tpu.ops.{mod}")]


@pytest.mark.parametrize("mod,name", PATH_NAMES, ids=lambda x: x)
def test_reference_module_paths_import_from_the_port(mod, name):
    """``from elephas_tpu_torch.ops.<mod> import <name>`` works for every
    name the reference's ``ops/pallas_ops.py`` and ``ops/pallas_flash.py``
    define (``is_tpu_backend`` aside: the port picks by the tensor's
    device), with the reference's signature; ``_BQ == _BK == 512``."""
    ref = importlib.import_module(f"elephas_tpu.ops.{mod}")
    port = importlib.import_module(f"elephas_tpu_torch.ops.{mod}")
    if name in ("_BQ", "_BK"):
        assert getattr(port, name) == getattr(ref, name) == 512
        return
    assert name in port.__all__
    assert _params(getattr(port, name)) == _params(getattr(ref, name))


# -- the host parameter-server path, checkpoints and save/load -------------------

# reference module → port module; every public function and class the
# reference module defines, and each public method a class defines, is in
# the port with the reference's parameters. The port's one addition is a
# ``device="cuda"`` parameter (the workers' replicas and
# ``load_spark_model`` build on a device), taken out before comparing.
HOST_MODULES = ["utils.functional_utils", "utils.sockets", "utils.checkpoint",
                "parameter.compression", "parameter.server", "parameter.client",
                "parameter.native", "native_build", "worker"]
HOST_NAMES = [(mod, name) for mod in HOST_MODULES
              for name, obj in sorted(vars(importlib.import_module(
                  f"elephas_tpu.{mod}")).items())
              if not name.startswith("_") and callable(obj)
              and getattr(obj, "__module__", None) == f"elephas_tpu.{mod}"]
HOST_NAMES += [("worker", "_materialize"), ("spark_model", "SparkModel"),
               ("spark_model", "load_spark_model"), ("parallel.engine", "FitResult")]


def _params_sans_device(fn):
    return [p for p in _params(fn) if p != ("device", "cuda")]


@pytest.mark.parametrize("mod,name", HOST_NAMES, ids=lambda x: x)
def test_host_path_names_match_reference(mod, name):
    ref = getattr(importlib.import_module(f"elephas_tpu.{mod}"), name)
    port = getattr(importlib.import_module(f"elephas_tpu_torch.{mod}"), name)
    if not isinstance(ref, type):
        assert _params_sans_device(port) == _params(ref)
        return
    methods = [m for m, f in vars(ref).items() if callable(f)
               and (m == "__init__" or not m.startswith("_"))]
    for m in methods:
        assert hasattr(port, m), (name, m)
        assert _params_sans_device(getattr(port, m)) == _params(getattr(ref, m)), (name, m)
    if name == "FitResult":
        assert "worker_state" in dict(_params(port.__init__))


def test_compiled_trainer_fit_carries_worker_state():
    from elephas_tpu.parallel.engine import CompiledTrainer as JTrainer
    from elephas_tpu_torch.parallel.engine import CompiledTrainer as TTrainer

    assert _params(TTrainer.fit) == _params(JTrainer.fit)


# -- the API skins: Spark ML, the DataFrame facade, the search, DL4J ----------------

# reference module → port module, as the host path's above: every public
# function and class, and each public method of a class, with the
# reference's parameters; the one departure is the trailing
# ``device="cuda"`` of the estimator, the transformer, their loaders, the
# search and its worker (taken out before comparing).
SKIN_MODULES = ["ml_model", "ml.params", "ml.adapter", "ml.pipeline", "data.dataframe",
                "hyperparam", "dl4j"]
SKIN_NAMES = [(mod, name) for mod in SKIN_MODULES
              for name, obj in sorted(vars(importlib.import_module(
                  f"elephas_tpu.{mod}")).items())
              if not name.startswith("_") and callable(obj)
              and getattr(obj, "__module__", None) == f"elephas_tpu.{mod}"]
SKIN_NAMES += [("hyperparam", "_Choice"), ("hyperparam", "_Uniform"),
               ("hyperparam", "_QUniform"), ("hyperparam", "_LogUniform")]
DEVICE_TAKERS = {("ml_model", "ElephasEstimator"), ("ml_model", "ElephasTransformer"),
                 ("ml_model", "load_ml_estimator"), ("ml_model", "load_ml_transformer"),
                 ("hyperparam", "HyperParamModel"), ("hyperparam", "HyperasWorker")}


@pytest.mark.parametrize("mod,name", SKIN_NAMES, ids=lambda x: x)
def test_skin_names_match_reference(mod, name):
    ref = getattr(importlib.import_module(f"elephas_tpu.{mod}"), name)
    port = getattr(importlib.import_module(f"elephas_tpu_torch.{mod}"), name)
    fns = ([(None, ref, port)] if not isinstance(ref, type) else
           [(m, f, getattr(port, m, None)) for m, f in vars(ref).items()
            if callable(f) and (m == "__init__" or not m.startswith("_"))])
    for m, want, got in fns:
        assert got is not None, (name, m)
        if (mod, name) in DEVICE_TAKERS and m in (None, "__init__"):
            assert ("device", "cuda") in _params(got), (name, m)
            assert _params_sans_device(got) == _params(want), (name, m)
        else:
            assert _params(got) == _params(want), (name, m)


# -- speculative decoding -------------------------------------------------------

# port → reference, the same parameters
SPEC_SAME = [
    ("TransformerLM.init_cache", "models.transformer", "TransformerLM.init_cache"),
    ("TransformerLM.generate_speculative", "models.transformer",
     "TransformerLM.generate_speculative"),
    ("MoETransformerLM.generate_speculative", "models.transformer",
     "MoETransformerLM.generate_speculative"),
    ("spec_round_accept", "models.transformer", "spec_round_accept"),
    ("ServingEngine.swap_params", "serving.engine", "ServingEngine.swap_params"),
    ("NgramDrafter.__init__", "serving.engine", "NgramDrafter.__init__"),
    ("NgramDrafter.propose", "serving.engine", "NgramDrafter.propose"),
    ("ModelDrafter.__init__", "serving.engine", "ModelDrafter.__init__"),
]


def _resolve(mod, dotted):
    obj = importlib.import_module(mod)
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def _port_home(name):
    if name.startswith(("TransformerLM", "MoETransformerLM", "spec_")):
        return "elephas_tpu_torch.models.transformer"
    return "elephas_tpu_torch.serving.engine"


@pytest.mark.parametrize("port,mod,ref", SPEC_SAME, ids=lambda x: x)
def test_speculative_signature_matches_reference(port, mod, ref):
    assert _params(_resolve(_port_home(port), port)) == \
        _params(_resolve(f"elephas_tpu.{mod}", ref))


@pytest.mark.parametrize("port,ref", [
    ("elephas_tpu_torch.models.transformer:spec_verify_select",
     "elephas_tpu.models.transformer:spec_verify_select"),
    ("elephas_tpu_torch.serving.memory:PagedKVCache.verify_fn",
     "elephas_tpu.serving.memory:PagedKVCache.verify_fn"),
], ids=["spec_verify_select", "verify_fn"])
def test_speculative_departures_are_the_logged_ones(port, ref):
    """``spec_verify_select`` and ``PagedKVCache.verify_fn`` take the
    engine's per-slot seeds where the reference takes PRNG keys, and a
    trailing ``sampled`` (whether any row samples, known on the host), as
    ``select_slot_tokens`` does; nothing else differs (ROADMAP §3)."""
    got = _params(_resolve(*port.split(":")))
    want = [("seeds", d) if n == "keys" else (n, d)
            for n, d in _params(_resolve(*ref.split(":")))]
    sampled = dict(got)["sampled"]
    assert sampled in (None, inspect.Parameter.empty)
    assert got == want + [("sampled", sampled)]


# -- the LM remainder: windows, write_prompt_cache, beam search, phases ----------

LM_REMAINDER = [
    ("elephas_tpu_torch.models.transformer:write_prompt_cache",
     "elephas_tpu.models.transformer:write_prompt_cache"),
    ("elephas_tpu_torch.models.transformer:build_lm_train_phases",
     "elephas_tpu.models.transformer:build_lm_train_phases"),
    ("elephas_tpu_torch.models.beam:generate_beam",
     "elephas_tpu.models.beam:generate_beam"),
    ("elephas_tpu_torch.models.transformer:TransformerLM._window_period",
     "elephas_tpu.models.transformer:TransformerLM._window_period"),
    ("elephas_tpu_torch.models.transformer:TransformerLM.decode_chunk",
     "elephas_tpu.models.transformer:TransformerLM.decode_chunk"),
    ("elephas_tpu_torch.models.transformer:TransformerLM.prefill_slot",
     "elephas_tpu.models.transformer:TransformerLM.prefill_slot"),
]


@pytest.mark.parametrize("port,ref", LM_REMAINDER, ids=lambda x: x.split(":")[1])
def test_lm_remainder_signature_matches_reference(port, ref):
    assert _params(_resolve(*port.split(":"))) == _params(_resolve(*ref.split(":")))


@pytest.mark.parametrize("cls", ["TransformerLM", "MoETransformerLM"])
def test_lm_constructors_take_attn_window_in_place(cls):
    """The constructors keep the reference's parameters, ``attn_window``
    among them, plus the port's trailing ``device="cuda"``."""
    got = _params(getattr(importlib.import_module(
        "elephas_tpu_torch.models.transformer"), cls).__init__)
    want = _params(getattr(jt, cls).__init__)
    assert got == want + [("device", "cuda")]


# -- LoRA and multi-tenant serving --------------------------------------------

# every public function and class of the reference's ``models/lora.py``, and
# each public method of a class, with the reference's parameters; the one
# departure is ``MultiTenantLM.init``'s trailing ``device=None``, which
# every ``init`` of the port's LM family takes
LORA_NAMES = sorted(name for name, obj in vars(importlib.import_module(
    "elephas_tpu.models.lora")).items()
    if not name.startswith("_") and callable(obj)
    and getattr(obj, "__module__", None) == "elephas_tpu.models.lora")


@pytest.mark.parametrize("name", LORA_NAMES)
def test_lora_names_match_reference(name):
    ref = getattr(importlib.import_module("elephas_tpu.models.lora"), name)
    port = getattr(importlib.import_module("elephas_tpu_torch.models.lora"), name)
    if not isinstance(ref, type):
        assert _params(port) == _params(ref)
        return
    for m, want in vars(ref).items():
        if not callable(want) or (m != "__init__" and m.startswith("_")):
            continue
        got = getattr(port, m, None)
        assert got is not None, (name, m)
        got = getattr(got, "__func__", got)     # a classmethod
        want = getattr(want, "__func__", want)
        extra = [("device", None)] if (name, m) == ("MultiTenantLM", "init") else []
        assert _params(got) == _params(want) + extra, (name, m)


@pytest.mark.parametrize("port,ref", [
    ("elephas_tpu_torch.serving.engine:ServingEngine.submit",
     "elephas_tpu.serving.engine:ServingEngine.submit"),
    ("elephas_tpu_torch.serving.memory:PagedKVCache.admission_check",
     "elephas_tpu.serving.memory:PagedKVCache.admission_check"),
    ("elephas_tpu_torch.serving.memory:PagedKVCache.set_adapter",
     "elephas_tpu.serving.memory:PagedKVCache.set_adapter"),
    ("elephas_tpu_torch.serving.memory:PagedKVCache.release",
     "elephas_tpu.serving.memory:PagedKVCache.release"),
    ("elephas_tpu_torch.models.transformer:_adapter_ctx",
     "elephas_tpu.models.transformer:_adapter_ctx"),
], ids=lambda x: x.split(":")[1])
def test_multi_tenant_signature_matches_reference(port, ref):
    assert _params(_resolve(*port.split(":"))) == _params(_resolve(*ref.split(":")))


# -- resilience, streaming and the serving fleet ---------------------------------

# every public function and class of each module, and each public method of a
# class, with the reference's parameters; the soak's runners (and
# ``_classifier``, which builds the port's adapter) take the port's trailing
# ``device="cuda"``
ITEM10_MODULES = ["resilience.faults", "resilience.policy", "resilience.membership",
                  "resilience.supervisor", "resilience.soak", "streaming.bridge",
                  "streaming.publisher", "streaming.trainer", "fleet.traffic",
                  "fleet.policy", "fleet.router", "fleet.autoscaler"]
ITEM10_NAMES = [(mod, name) for mod in ITEM10_MODULES
                for name, obj in sorted(vars(importlib.import_module(
                    f"elephas_tpu.{mod}")).items())
                if not name.startswith("_") and callable(obj)
                and getattr(obj, "__module__", None) == f"elephas_tpu.{mod}"]
ITEM10_NAMES += [("resilience.faults", "_unit"), ("resilience.soak", "_toy_data"),
                 ("resilience.soak", "_wire_ledger_check"), ("fleet.router", "_percentile"),
                 ("serving.engine", "ServingEngine")]


@pytest.mark.parametrize("mod,name", ITEM10_NAMES, ids=lambda x: x)
def test_resilience_streaming_fleet_names_match_reference(mod, name):
    ref = getattr(importlib.import_module(f"elephas_tpu.{mod}"), name)
    port = getattr(importlib.import_module(f"elephas_tpu_torch.{mod}"), name)
    assert _is_port(port), (mod, name)
    fns = ([(None, ref, port)] if not isinstance(ref, type) else
           [(m, f, getattr(port, m, None)) for m, f in vars(ref).items()
            if callable(f) and (m == "__init__" or not m.startswith("_"))])
    if name == "ServingEngine":    # the engine's methods have rows of their own
        fns = [f for f in fns if f[0] == "__init__"]
    for m, want, got in fns:
        assert got is not None, (name, m)
        got, want = getattr(got, "__func__", got), getattr(want, "__func__", want)
        if mod == "resilience.soak" or (name, m) == ("ServingEngine", "__init__"):
            assert _params_sans_device(got) == _params(want), (name, m)
        else:
            assert _params(got) == _params(want), (name, m)
    if (mod, name) == ("serving.engine", "ServingEngine"):
        assert ("fault_plan", None) in _params(port.__init__)


def _is_port(obj) -> bool:
    return (getattr(obj, "__module__", None) or "").split(".")[0] == "elephas_tpu_torch"


def test_spark_model_resilience_options_and_fit_stream_match_reference():
    from elephas_tpu.spark_model import SparkModel as J
    from elephas_tpu_torch.spark_model import SparkModel as T

    want = dict(_params(J.__init__))
    got = dict(_params_sans_device(T.__init__))
    for name in ("fault_plan", "retry_policy", "membership", "quorum",
                 "round_deadline_s", "backup_stragglers", "hot_standby", "elastic",
                 "wire_stall_timeout_s"):
        assert got[name] == want[name], name
    assert _params(T.fit_stream) == _params(J.fit_stream)
    assert _params(T._membership_mask) == _params(J._membership_mask)
