"""Package-level exports of the port against the reference (fault 5 of
ROADMAP §3).

For each package of the reference that the port has, every name of the
reference's ``__all__`` is in the port's ``__all__`` and resolves to a port
object (a constant to the reference's value), and every public method of
each class of that ``__all__`` that the port ports exists on the port's
class. What is absent must be exactly the table below: a name ROADMAP
queues, by its item, or a logged departure. A new gap fails the test, and
so does a gap that a later change closes without taking it off the table.

``SlotKVCache.remaining`` and ``PagedKVCache.remaining`` (also part of
fault 5) are held to the reference's on a dense and a paged cache.
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import importlib

import numpy as np
import pytest

PACKAGES = ["", ".data", ".ml", ".mllib", ".models", ".ops", ".parallel",
            ".parameter", ".serving", ".utils", ".resilience", ".streaming", ".fleet"]

ITEM_6_SHARD = "ROADMAP queue 1 item 6, second half (sharding on torch.distributed)"
DEPARTURE_OPTAX = "ROADMAP §3 departure: to_optax is to_torch_optimizer"

# reference name absent from the port's package → why
ABSENT = {
    ".models": {
        **dict.fromkeys(["LMFsdpLayout", "build_lm_fsdp_train_step",
                         "build_lm_pp_train_step", "build_lm_pp_tp_train_step",
                         "lm_pp_tp_specs", "lm_pp_specs", "build_moe_lm_tp_generate",
                         "build_moe_lm_tp_train_step", "moe_tp_specs",
                         "shard_moe_tp_params", "build_lm_generate",
                         "build_lm_tp_generate", "build_lm_tp_train_step",
                         "build_mesh_tp", "shard_tp_params", "tp_specs", "SEQ_AXIS",
                         "build_mesh_sp", "ring_psum", "shard_lm_batch"], ITEM_6_SHARD),
        "to_optax": DEPARTURE_OPTAX,
    },
    ".ops": dict.fromkeys(["ring_attention", "ulysses_attention"], ITEM_6_SHARD),
    ".parallel": {
        **dict.fromkeys(["DATA_AXIS", "MODEL_AXIS", "PIPE_AXIS", "build_mesh2d",
                         "TensorParallelMLP", "build_tp_train_step",
                         "column_parallel_dense", "row_parallel_dense", "build_mesh_3d",
                         "TensorPipelineStack", "build_3d_train_step", "FSDPParams",
                         "build_fsdp_train_step", "build_mesh_pp", "PipelineDenseStack",
                         "build_pp_train_step", "pipeline_apply", "initialize_cluster",
                         "global_mesh", "hybrid_mesh", "JaxPodBackend"], ITEM_6_SHARD),
    },
}

# (class, public method of the reference's class) absent from the port's → why
ABSENT_METHODS = {
    ".models": {
        **{(cls, m): ITEM_6_SHARD for cls in ("TransformerLM", "MoETransformerLM")
           for m in ("shard_params", "specs")},
    },
    ".parallel": {("MoEFeedForward", "gather_params"): ITEM_6_SHARD},
}


def _public_methods(cls):
    return {m for m in dir(cls) if not m.startswith("_") and callable(getattr(cls, m, None))}


def _is_port_object(obj) -> bool:
    module = getattr(obj, "__module__", None) or ""
    return module.split(".")[0] == "elephas_tpu_torch"


@pytest.mark.parametrize("pkg", PACKAGES, ids=lambda p: "elephas_tpu" + p)
def test_package_exports_match_reference(pkg):
    ref = importlib.import_module("elephas_tpu" + pkg)
    port = importlib.import_module("elephas_tpu_torch" + pkg)
    port_all = set(getattr(port, "__all__", ()))
    absent = {n for n in ref.__all__ if n not in port_all or not hasattr(port, n)}
    assert absent == set(ABSENT.get(pkg, {})), (
        f"unexpected gaps {sorted(absent - set(ABSENT.get(pkg, {})))}, closed but "
        f"still tabled {sorted(set(ABSENT.get(pkg, {})) - absent)}")
    gaps = set()
    for name in sorted(set(ref.__all__) - absent):
        want, got = getattr(ref, name), getattr(port, name)
        if callable(want):
            assert _is_port_object(got), (name, got)
        elif isinstance(want, dict) and all(map(callable, want.values())):
            # a table of functions (the soak's SCENARIOS): the same keys,
            # each the port's function of the reference's name
            assert list(got) == list(want), name
            assert all(_is_port_object(got[k]) and got[k].__name__ == want[k].__name__
                       for k in want), name
        else:
            assert got == want, name
        if isinstance(want, type) and isinstance(got, type):
            gaps |= {(name, m) for m in _public_methods(want) - _public_methods(got)}
    assert gaps == set(ABSENT_METHODS.get(pkg, {}))


def test_every_absence_names_a_queued_item_or_a_departure():
    reasons = {r for table in (ABSENT, ABSENT_METHODS) for d in table.values()
               for r in d.values()}
    assert reasons == {ITEM_6_SHARD, DEPARTURE_OPTAX}


CFG = dict(vocab=17, d_model=16, n_heads=4, n_layers=2, d_ff=32, max_len=64)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_cache_remaining_matches_reference(paged):
    """``remaining(slot)`` is ``max_len - pos[slot]`` in both packages after
    the same allocations, inserts, decode advances and releases."""
    from elephas_tpu.models import transformer as jt
    from elephas_tpu.serving import cache as jc
    from elephas_tpu.serving import memory as jm
    from elephas_tpu_torch.models import TransformerLM
    from elephas_tpu_torch.serving import cache as tc
    from elephas_tpu_torch.serving import memory as tm

    jmodel, model = jt.TransformerLM(**CFG), TransformerLM(**CFG, device="cpu")
    if paged:
        caches = [jm.PagedKVCache(jmodel, jmodel.init(0), 2, 40, page_size=8),
                  tm.PagedKVCache(model, model.init(0), 2, 40, page_size=8)]
    else:
        caches = [jc.SlotKVCache(jmodel, jmodel.init(0), 2, 40),
                  tc.SlotKVCache(model, model.init(0), 2, 40)]
    prompt = np.arange(1, 8)
    seen = []
    for kv in caches:
        a, b = kv.allocate(), kv.allocate()
        row = [kv.remaining(a), kv.remaining(b)]
        kv.insert(a, prompt)
        row.append(kv.remaining(a))
        for _ in range(3):
            kv.advance(a)
        row += [kv.remaining(a), kv.remaining(b)]
        kv.release(a)
        row.append(kv.remaining(a))
        seen.append(row)
    assert seen[1] == seen[0] == [40, 40, 33, 30, 40, 40]
