"""Multi-tenant LoRA serving in the port (``MultiTenantLM`` behind the paged
``ServingEngine``) on the CPU.

Mirrors of the reference's multi-tenant tests
(``tests/serving/test_paged.py``: adapter 0 is the base model, ids
validated at submit, co-batched tenants each equal a dense engine on their
merged weights; ``tests/serving/test_speculative.py``: the same under
speculation; ``tests/serving/test_paged_fuzz.py``: speculation plus
``prefill_chunk=8``, ``kv.check()`` after every step), the port's greedy
co-batched streams against the JAX package's engine on the same weights,
the model's draws and merge against the reference's, and the port's own
pins: every paged launch (insert, decode, verify) and every draft launch
runs under the rows' adapters, and skipping the context at any one site
changes a tenant's tokens; no prefix page is shared across adapters; a
preempted tenant resumes under its adapter; per-adapter drafting accepts
every greedy self-draft."""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import contextlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.models import lora as jl
from elephas_tpu.serving import ServingEngine as JaxEngine
from elephas_tpu_torch.models import MultiTenantLM, TransformerLM, from_jax_params
from elephas_tpu_torch.serving import AdmissionError, ModelDrafter, ServingEngine
from elephas_tpu_torch.serving import memory as port_memory

V = 17
CFG = dict(vocab=V, d_model=16, n_heads=4, n_layers=2, d_ff=32, max_len=48)
MT = dict(n_adapters=3, lora_rank=4)


def _mt(**kw):
    return MultiTenantLM(**{**CFG, **MT, **kw}, device="cpu")


def _mt_params(mt):
    p = mt.init(1)
    p = mt.randomize_adapter(p, 1, seed=7)
    return mt.randomize_adapter(p, 2, seed=8)


def _prompts(rng, lens):
    return [rng.integers(0, V, size=(n,)).astype(np.int32) for n in lens]


def _run(eng, reqs, **submit_kw):
    ids = []
    for i, (prompt, max_new) in enumerate(reqs):
        ids.append(eng.submit(prompt, max_new, seed=i, **submit_kw))
        eng.step()
    eng.drain(max_steps=5000)
    return [eng.result(rid).tokens for rid in ids]


def _engine(model, params, **kw):
    return ServingEngine(model, params, device="cpu", **kw)


def _cobatch(eng, prompts, n_new=10, check=False):
    """Co-batched tenants: request ``i`` on adapter ``i % 3``."""
    ids = [eng.submit(p, n_new, seed=0, request_id=f"r{i}", adapter_id=i % 3)
           for i, p in enumerate(prompts)]
    for _ in range(5000):
        if not (eng.scheduler.queue_depth or eng.kv.active_slots):
            break
        eng.step()
        if check:
            eng.kv.check()
    return [eng.result(rid).tokens for rid in ids]


@pytest.fixture(scope="module")
def case():
    mt = _mt()
    return mt, _mt_params(mt), mt.base_model()


def _merged_tokens(case, prompts, n_new=10):
    """Each request on a dedicated dense engine over its tenant's merged
    weights (the reference's oracle)."""
    mt, params, base = case
    out = []
    for i, p in enumerate(prompts):
        ref = _engine(base, mt.merged_params(params, i % 3), n_slots=1)
        ref.submit(p, n_new, seed=0, request_id="x")
        ref.drain(max_steps=5000)
        out.append(ref.result("x").tokens)
    return out


@pytest.fixture(scope="module")
def cobatch_case(case):
    prompts = _prompts(np.random.default_rng(10), [21, 19, 23, 17])
    return prompts, _merged_tokens(case, prompts)


# -- the reference's tests, on the port ------------------------------------


def test_multi_tenant_adapter0_identity_and_validation(case):
    """Adapter 0 (zero-initialized B) equals the plain base model, sampled
    rows included; adapter ids are validated at submit on both engines."""
    mt, params, base = case
    mt0 = _mt()
    p0 = mt0.init(1)
    basep = {k: v for k, v in p0.items() if not k.startswith("lora_")}
    reqs = [(p, 8) for p in _prompts(np.random.default_rng(9), [5, 17, 11, 23])]
    want = _run(_engine(base, basep, n_slots=4), reqs, temperature=0.8)
    eng = _engine(mt0, p0, n_slots=4, paged=True, page_size=8)
    assert _run(eng, reqs, temperature=0.8, adapter_id=0) == want
    with pytest.raises(AdmissionError) as ei:
        eng.submit(reqs[0][0], 2, adapter_id=3)
    assert ei.value.reason == "bad_request"
    with pytest.raises(AdmissionError) as ei:
        eng.submit(reqs[0][0], 2, adapter_id=-1)
    assert ei.value.reason == "bad_request"
    dense = _engine(mt0, p0, n_slots=2)
    with pytest.raises(AdmissionError, match="paged"):
        dense.submit(reqs[0][0], 2, adapter_id=1)   # dense is single-tenant
    assert eng.snapshot()["counters"]["rejected"] == {"bad_request": 2}


def test_multi_tenant_cobatch_matches_merged_dense(case, cobatch_case):
    """Co-batched tenants with different adapters each equal a dedicated
    dense engine on that tenant's merged weights, and the adapters change
    the tokens (the comparison has power)."""
    mt, params, _ = case
    prompts, want = cobatch_case
    eng = _engine(mt, params, n_slots=4, paged=True, page_size=8)
    assert _cobatch(eng, prompts) == want
    eng.kv.check()
    base0 = _merged_tokens(case, prompts[1:2])[0]   # request 1 on adapter 0
    assert want[1] != base0 or want[2] != base0


@pytest.mark.parametrize("drafter", ["ngram", "self", "fewer_adapters", "plain"])
def test_spec_multi_tenant_adapters(case, cobatch_case, drafter):
    """Per-adapter speculation on the paged multi-tenant engine: each
    tenant's speculative stream equals the merged dense oracle, whatever
    the drafter. A ``MultiTenantLM`` self-draft drafts each row under its
    adapter and accepts every greedy draft; a drafter with fewer adapters
    drafts the rows past them with adapter 0; a plain drafter drafts every
    row with the base weights and accepts less."""
    mt, params, base = case
    prompts, want = cobatch_case
    drafters = {
        "ngram": lambda: None,
        "self": lambda: ModelDrafter(mt, params),
        "fewer_adapters": lambda: ModelDrafter(
            _mt(n_adapters=2), {k: v[:, :2] if k.startswith("lora_") else v
                                for k, v in params.items()}),
        "plain": lambda: ModelDrafter(base, mt.merged_params(params, 0)),
    }
    eng = _engine(mt, params, n_slots=4, paged=True, page_size=8, speculate_k=4,
                  drafter=drafters[drafter]())
    assert _cobatch(eng, prompts) == want
    fp = eng.snapshot()["fastpath"]
    assert fp["spec_rounds"] > 0
    if drafter == "self":
        assert fp["spec_accepted"] == fp["spec_drafted"] > 0
    if drafter == "plain":
        assert fp["spec_accepted"] < fp["spec_drafted"]
    if drafter == "fewer_adapters":
        assert eng._draft_aids.tolist() == [0, 1, 0, 0]
    eng.kv.check()


def test_fuzz_multi_tenant_knob_sweep(case):
    """Speculation plus chunked prefill, ``kv.check()`` after every step:
    each tenant equals its merged dense oracle."""
    mt = _mt(max_len=64)
    params = _mt_params(mt)
    prompts = _prompts(np.random.default_rng(21), [15, 19, 24, 9])
    eng = _engine(mt, params, n_slots=4, paged=True, page_size=8, speculate_k=4,
                  prefill_chunk=8)
    got = _cobatch(eng, prompts, check=True)
    assert eng.snapshot()["fastpath"]["prefill_chunks"] > 0
    assert got == _merged_tokens((mt, params, mt.base_model()), prompts)
    eng.kv.check()


# -- parity with the JAX package ---------------------------------------------


def test_model_draws_and_merge_match_reference():
    """``init`` and ``randomize_adapter`` draw the reference's bits;
    ``merged_params`` agrees within 1e-6; the per-row delta path under
    ``adapter_context`` equals the merged base model on each row."""
    jm = jl.MultiTenantLM(**CFG, **MT, lora_targets=("q", "k", "v", "o"))
    mt = _mt(lora_targets=("q", "k", "v", "o"))
    jp = jm.randomize_adapter(jm.init(seed=3), 2, seed=4)
    tp = mt.randomize_adapter(mt.init(3), 2, seed=4)
    assert list(tp) == list(jp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]), err_msg=k)
    jmerged, tmerged = jm.merged_params(jp, 2), mt.merged_params(tp, 2)
    assert sorted(tmerged) == sorted(jmerged) == sorted(mt.base_model().param_shapes())
    for k in jmerged:
        np.testing.assert_allclose(tmerged[k].numpy(), np.asarray(jmerged[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, V, (3, 9)))
    positions = torch.arange(9).expand(3, 9)
    with mt.adapter_context([0, 2, 2]):
        got = mt.apply(tp, tokens, positions)
    base = mt.base_model()
    for row, aid in enumerate((0, 2, 2)):
        want = base.apply(mt.merged_params(tp, aid), tokens[row:row + 1],
                          positions[row:row + 1])
        torch.testing.assert_close(got[row:row + 1], want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(mt.apply(tp, tokens, positions),       # no context:
                               base.apply(mt.merged_params(tp, 0), tokens, positions),
                               rtol=0, atol=0)                        # the base


def test_greedy_streams_match_reference_engine():
    """The same weights in both packages, co-batched tenants on the paged
    engine, greedy: the port emits the JAX engine's tokens (every compared
    position's top-2 margin on the tenant's merged weights is above 1e-5)."""
    jm = jl.MultiTenantLM(**CFG, **MT)
    np_params = jm.randomize_adapter(jm.randomize_adapter(jm.init(seed=1), 1, seed=7),
                                     2, seed=8)
    mt = _mt()
    params = from_jax_params(np_params, device="cpu")
    prompts = _prompts(np.random.default_rng(10), [21, 19, 23, 17, 12])
    jeng = JaxEngine(jm, {k: jnp.asarray(v) for k, v in np_params.items()},
                     n_slots=4, paged=True, page_size=8)
    want = _cobatch(jeng, prompts)
    got = _cobatch(_engine(mt, params, n_slots=4, paged=True, page_size=8), prompts)
    assert got == want
    base = mt.base_model()
    for i, (prompt, toks) in enumerate(zip(prompts, got)):
        seq = np.concatenate([prompt, toks])
        merged = mt.merged_params(params, i % 3)
        logits, _ = base.decode_chunk(merged, torch.from_numpy(seq)[None].long(), 0,
                                      base.init_cache(1, len(seq)))
        top = torch.topk(logits[0, len(prompt) - 1:-1], 2, dim=-1).values
        assert float((top[:, 0] - top[:, 1]).min()) > 1e-5


# -- the port's pins -----------------------------------------------------------


def test_every_launch_runs_under_the_rows_adapters(case, cobatch_case, monkeypatch):
    """Each paged insert, decode step and verify chunk, and each draft
    prefill and rollout step, runs with the rows' adapter ids active: a
    full-batch launch under the slots' ids, a one-slot insert under its
    request's id."""
    mt, params, _ = case
    prompts, want = cobatch_case
    draft = _mt()
    seen = []

    def watch(model, name):
        fn = getattr(model, name)

        def wrapped(params_, tokens, *args, **kw):
            rows = model._adapter_rows
            seen.append((name, tokens.shape[0], None if rows is None else rows.tolist()))
            return fn(params_, tokens, *args, **kw)
        monkeypatch.setattr(model, name, wrapped)

    for name in ("decode_step_paged", "decode_chunk_paged"):
        watch(mt, name)
    for name in ("decode_step", "prefill_slot"):
        watch(draft, name)
    eng = _engine(mt, params, n_slots=4, paged=True, page_size=8, speculate_k=4,
                  drafter=ModelDrafter(draft, params))
    assert _cobatch(eng, prompts, n_new=6) == [w[:6] for w in want]
    names = {n for n, _, _ in seen}
    assert names == {"decode_step_paged", "decode_chunk_paged", "decode_step",
                     "prefill_slot"}, names
    for name, batch, rows in seen:
        assert rows is not None and len(rows) == batch, (name, batch, rows)
        if batch == 4:     # slot i serves r{i} (adapter i % 3), 0 once freed
            assert all(r in (0, s % 3) for s, r in enumerate(rows)), (name, rows)
    assert [0, 1, 2, 0] in [rows for n, b, rows in seen if n == "decode_chunk_paged"]
    inserts = [rows[0] for n, b, rows in seen if n == "decode_chunk_paged" and b == 1]
    assert sorted(inserts) == [0, 0, 1, 2]


@pytest.mark.parametrize("site,spec", [("insert", 1), ("step", 1), ("verify_fn", 4)],
                         ids=["insert", "decode", "verify"])
def test_a_skipped_adapter_context_shows(case, cobatch_case, monkeypatch, site, spec):
    """The merged-oracle comparison catches a launch site that forgets the
    adapter context: skipping it at the one site changes some tenant's
    tokens (the site still runs under the real context everywhere else)."""
    mt, params, _ = case
    prompts, want = cobatch_case
    real = port_memory._adapter_ctx
    skipped = []

    def ctx(model, rows):
        if sys._getframe(1).f_code.co_name == site:
            skipped.append(site)
            return contextlib.nullcontext()
        return real(model, rows)

    monkeypatch.setattr(port_memory, "_adapter_ctx", ctx)
    eng = _engine(mt, params, n_slots=4, paged=True, page_size=8, speculate_k=spec)
    got = _cobatch(eng, prompts)
    assert skipped and got != want


def test_no_prefix_page_is_shared_across_adapters(case):
    """A 16-token shared prefix (two pages of 8) on adapters 1, 1, 2, 2, 0:
    each adapter's second request adopts its own first request's pages, a
    request never adopts another adapter's, the tree has one root per
    adapter with disjoint pages, and every stream equals its tenant's
    merged oracle."""
    mt, params, base = case
    rng = np.random.default_rng(3)
    system = rng.integers(0, V, size=16).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, V, size=5).astype(np.int32)])
               for _ in range(5)]
    aids = [1, 1, 2, 2, 0]
    eng = _engine(mt, params, n_slots=2, paged=True, page_size=8)
    hits, got = [], []
    for i, (p, aid) in enumerate(zip(prompts, aids)):
        free, need = eng.kv.admission_check(p, aid, 0)
        before = eng.kv.memory_stats()["prefix"]["hits_pages"]
        eng.submit(p, 6, request_id=f"r{i}", adapter_id=aid)
        eng.drain()
        hits.append(eng.kv.memory_stats()["prefix"]["hits_pages"] - before)
        got.append(eng.result(f"r{i}").tokens)
        assert need == (3 if hits[-1] == 0 else 1), (i, need, hits)
        eng.kv.check()
    assert hits == [0, 2, 0, 2, 0]
    roots = eng.kv.prefix._roots
    assert set(roots) == {(0, 0), (0, 1), (0, 2)}

    def pages(children):
        out = set()
        for node in children.values():
            out |= {node.lid} | pages(node.children)
        return out
    by_root = [pages(c) for c in roots.values()]
    assert all(len(p) == 2 for p in by_root)
    assert len(set().union(*by_root)) == 6              # disjoint
    for i, (p, aid) in enumerate(zip(prompts, aids)):
        ref = _engine(base, mt.merged_params(params, aid), n_slots=1)
        ref.submit(p, 6, request_id="x")
        ref.drain()
        assert got[i] == ref.result("x").tokens, i


def test_preempted_tenant_resumes_under_its_adapter(case):
    """A pool too small for every tenant at once (9 pages of 8): growth
    preempts, and each tenant, re-admitted with prompt ++ generated under
    its own adapter, still equals its merged oracle."""
    mt, params, base = case
    prompts = _prompts(np.random.default_rng(12), [20, 18, 22, 19])
    eng = _engine(mt, params, n_slots=4, paged=True, page_size=8,
                  pages_per_partition=9, prefix_cache=False)
    got = _cobatch(eng, prompts, n_new=16, check=True)
    assert eng.kv.memory_stats()["preemptions"] > 0
    assert got == _merged_tokens(case, prompts, n_new=16)


def test_adapter_bookkeeping(case):
    """``set_adapter`` patches the resident device ids by their dirty row,
    ``release`` resets the slot to adapter 0, ``admission_check`` takes
    ``(prompt, adapter_id, rank)`` with rank 0 on one device; the
    per-tenant rows of the snapshot count each adapter's requests."""
    mt, params, _ = case
    eng = _engine(mt, params, n_slots=2, paged=True, page_size=8)
    kv = eng.kv
    slot = kv.allocate()
    kv.set_adapter(slot, 2)
    assert kv._device_tables()[1].tolist()[slot] == 2 and not kv._aids_rows_dirty
    kv.release(slot)
    assert kv.aids[slot] == 0 and kv._device_tables()[1].tolist()[slot] == 0
    with pytest.raises(ValueError, match="rank"):
        kv.admission_check(np.arange(5), 0, 1)
    prompts = _prompts(np.random.default_rng(2), [6, 7, 8])
    for i, p in enumerate(prompts):
        eng.submit(p, 3, adapter_id=[1, 1, 2][i])
    eng.drain()
    tenants = eng.snapshot()["tenants"]
    assert {k: (v["submitted"], v["admitted"], v["tokens"])
            for k, v in tenants.items()} == {"1": (2, 2, 6), "2": (1, 1, 3)}


def test_multi_tenant_validation(case):
    mt, params, _ = case
    for kw, match in ((dict(n_adapters=0), "n_adapters"), (dict(lora_rank=0), "lora_rank"),
                      (dict(lora_targets=("q", "x")), "lora_targets"),
                      (dict(lora_targets=("q", "q")), "lora_targets")):
        with pytest.raises(ValueError, match=match):
            _mt(**kw)
    with pytest.raises(ValueError, match="out of range"):
        mt.load_adapter(params, 3, {})
    with pytest.raises(ValueError, match="not an adapted target"):
        mt.load_adapter(params, 1, {"o": (None, None)})
    with pytest.raises(ValueError, match="row must be"):
        mt.load_adapter(params, 1, {"q": (np.zeros((2, 16, 3)), np.zeros((2, 3, 16)))})
    with pytest.raises(ValueError, match="out of range"):
        mt.merged_params(params, 5)
    assert isinstance(mt.base_model(), TransformerLM)
    assert not isinstance(mt.base_model(), MultiTenantLM)
