"""The port's paged serving engine (``ServingEngine(paged=True)``) on the
CPU path: mirrors of the reference's local paged-engine tests
(tests/serving/test_paged.py, tests/serving/test_paged_fuzz.py), each held
to EXACT token equality with the port's dense engine and to ``kv.check()``
(every allocator, refcount and table invariant) — token identity under
pages 8/16, chunked prefill, fused decode, prefix reuse and preemption;
page-returning cancel and deadline reaps; page-gated admission; the memory
snapshot; prefix flush on a weight swap — and one mix against the JAX
package's paged engine: the same greedy tokens and the same integer memory
counters, since the host bookkeeping is the same algorithm."""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.models.transformer import TransformerLM as JaxLM
from elephas_tpu.serving import ServingEngine as JaxEngine
from elephas_tpu_torch.models import TransformerLM, from_jax_params
from elephas_tpu_torch.serving import AdmissionError, ServingEngine

V = 17
CFG = dict(vocab=V, d_model=16, n_heads=4, n_layers=2, d_ff=32, max_len=48)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _model():
    return TransformerLM(**CFG, device="cpu")


def _engine(model, params, **kw):
    return ServingEngine(model, params, device="cpu", **kw)


def _prompts(rng, lens):
    return [rng.integers(0, V, size=(n,)).astype(np.int32) for n in lens]


def _shared(rng, n, system_len=16, tail=6):
    system = rng.integers(0, V, size=(system_len,)).astype(np.int32)
    return [np.concatenate([system, rng.integers(0, V, size=(tail,)).astype(np.int32)])
            for _ in range(n)]


def _run(eng, reqs, check=False, **submit_kw):
    """Submit with one step after each, drain; ``check`` asserts the paged
    invariants after every step."""
    ids = []
    for i, (prompt, max_new) in enumerate(reqs):
        ids.append(eng.submit(prompt, max_new, seed=i, **submit_kw))
        eng.step()
        if check:
            eng.kv.check()
    for _ in range(5000):
        if not (eng.scheduler.queue_depth or eng.kv.active_slots):
            break
        eng.step()
        if check:
            eng.kv.check()
    return [eng.result(rid).tokens for rid in ids]


@pytest.fixture(scope="module")
def lm():
    model = _model()
    return model, model.init(1)


def _dense(lm, reqs, n_slots=4, **submit_kw):
    return _run(_engine(*lm, n_slots=n_slots), reqs, **submit_kw)


def _clean_pool(eng):
    """Every request's references are gone: only clean prefix pages remain,
    and evicting them empties the pool."""
    stats = eng.kv.memory_stats()
    assert stats["pages_used"] == stats["prefix"]["nodes"]
    eng.kv.evict_pages(0, stats["pages_total"])
    assert eng.kv.memory_stats()["pages_used"] == 0
    eng.kv.check()


@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("temp", [0.0, 0.9])
def test_identity_with_dense_engine(lm, page, temp):
    rng = np.random.default_rng(0)
    reqs = [(p, 8) for p in _prompts(rng, [5, 11, 23, 3, 17, 9])]
    eng = _engine(*lm, n_slots=4, paged=True, page_size=page)
    assert _run(eng, reqs, temperature=temp) == _dense(lm, reqs,
                                                       temperature=temp)
    eng.kv.check()


# (page, fuse_k, prefill_chunk): the reference fuzz's sweep without
# speculation, allocator invariants checked after every step
@pytest.mark.parametrize("page,fuse_k,chunk", [(8, 1, None), (16, 1, None),
                                               (8, 4, None), (8, 1, 8),
                                               (16, 4, 16), (8, 2, 8)])
def test_knob_sweep_identity_checked_every_step(lm, page, fuse_k, chunk):
    rng = np.random.default_rng(1000 + page * 31 + fuse_k * 7 + (chunk or 0))
    # prompt lengths land on, just before, and well past page boundaries
    reqs = [(p, 10) for p in _prompts(rng, [5, 16, 23, 7, 31, 9])]
    eng = _engine(*lm, n_slots=4, paged=True, page_size=page, fuse_k=fuse_k,
                  prefill_chunk=chunk)
    assert _run(eng, reqs, check=True, temperature=0.8) == _dense(
        lm, reqs, temperature=0.8)
    _clean_pool(eng)


def test_chunked_and_fused_identity(lm):
    rng = np.random.default_rng(1)
    reqs = [(p, 6) for p in _prompts(rng, [20, 3, 26, 17, 9])]
    dense = _run(_engine(*lm, n_slots=2, prefill_chunk=8, fuse_k=3), reqs,
                 temperature=0.7)
    eng = _engine(*lm, n_slots=2, prefill_chunk=8, fuse_k=3, paged=True,
                  page_size=8)
    assert _run(eng, reqs, temperature=0.7) == dense
    fp = eng.snapshot()["fastpath"]
    assert fp["prefill_chunks"] >= 4 and fp["fused_blocks"] >= 1
    eng.kv.check()


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_prefix_cache_reuse_and_off(lm, prefix_cache):
    """Requests sharing a 16-token system prompt adopt its two pages and
    still emit the dense tokens; an identical resubmission hits end to end.
    With the cache off nothing is shared and the tokens are the same."""
    rng = np.random.default_rng(3)
    reqs = [(p, 6) for p in _shared(rng, 6)]
    dense = _dense(lm, reqs, n_slots=2)
    eng = _engine(*lm, n_slots=2, paged=True, page_size=8,
                  prefix_cache=prefix_cache)
    assert _run(eng, reqs) == dense
    mem = eng.snapshot()["memory"]
    if prefix_cache:
        # the first request is cold; the other five adopt the 2 system pages
        assert mem["prefix"]["hits_pages"] >= 10
        assert mem["prefix"]["hit_ratio"] > 0.5
        assert _run(eng, reqs) == dense
    else:
        assert mem["prefix"]["nodes"] == 0 and mem["prefix"]["hits_pages"] == 0
    eng.kv.check()


@pytest.mark.parametrize("fuse_k", [1, 4])
def test_preemption_is_token_transparent(lm, fuse_k):
    """A pool too small for the co-batch (each request peaks at 5 pages of
    8; 11 usable) forces preemption of the newest request, which resumes
    from prompt ++ generated: every stream equals the dense engine's, and
    every page comes back."""
    rng = np.random.default_rng(5)
    reqs = [(p, 12) for p in _prompts(rng, [21, 19, 23, 17])]
    eng = _engine(*lm, n_slots=4, paged=True, page_size=8, fuse_k=fuse_k,
                  pages_per_partition=12, prefix_cache=False)
    assert _run(eng, reqs, check=True, temperature=0.8) == _dense(
        lm, reqs, temperature=0.8)
    assert eng.kv.preemptions > 0
    assert eng.snapshot()["memory"]["preemptions"] == eng.kv.preemptions
    assert eng.kv.memory_stats()["pages_used"] == 0


def test_decode_fn_is_one_fused_step(lm):
    """``kv.decode_fn`` (one step) emits what ``kv.fused_fn`` emits for a
    one-step window from the same state; both write the same K/V rows."""
    rng = np.random.default_rng(9)
    eng = _engine(*lm, n_slots=4, paged=True, page_size=8)
    for p in _prompts(rng, [5, 11, 8]):
        eng.submit(p, 6)
    while eng.kv.free_slots > 1:
        eng.step()
    eng.kv.ensure_decode(list(eng._slot_req), 1)
    state = (eng.params, eng.kv.cache, eng._tok, eng._pos, eng._temps,
             eng._seeds, eng._live)
    one, tok1, pos1 = eng.kv.decode_fn(*state, False)
    block, tok2, pos2 = eng.kv.fused_fn(*state, 1, False)
    assert torch.equal(one, block[:, 0])
    assert torch.equal(tok1, tok2) and torch.equal(pos1, pos2)


def test_submit_rejects_request_that_never_fits(lm):
    eng = _engine(*lm, n_slots=2, paged=True, page_size=8,
                  pages_per_partition=4)            # 3 usable pages = 24 tokens
    with pytest.raises(AdmissionError) as ei:
        eng.submit(np.zeros(20, np.int32), max_new=8)
    assert ei.value.reason == "length_exceeds_cache"
    eng.submit(np.zeros(16, np.int32), max_new=8)   # exactly 3 pages: fine


def test_cancel_returns_pages_active_and_queued(lm):
    """Cancelling a decoding request returns its pages; cancelling a queued
    one changes nothing in the allocator; survivors are unperturbed."""
    model, params = lm
    rng = np.random.default_rng(16)
    prompts = _shared(rng, 4, tail=4)
    want = {i: _dense(lm, [(p, 10)])[0] for i, p in enumerate(prompts)}
    eng = _engine(model, params, n_slots=2, paged=True, page_size=8)
    admitted = [eng.submit(prompts[i], 10, request_id=f"a{i}") for i in range(2)]
    for _ in range(4):
        eng.step()                       # both admitted, slots full
    assert eng.kv.free_slots == 0
    queued = [eng.submit(prompts[i], 10, request_id=f"q{i}") for i in (2, 3)]
    used = eng.kv.memory_stats()["pages_used"]
    assert eng.cancel(queued[0])
    eng.kv.check()
    assert eng.kv.memory_stats()["pages_used"] == used
    assert eng.result(queued[0]).tokens == []
    assert eng.cancel(admitted[1])
    eng.kv.check()
    assert eng.kv.memory_stats()["pages_used"] < used
    assert eng.result(admitted[1]).finish_reason == "cancelled"
    eng.drain(max_steps=5000)
    for i, rid in ((0, admitted[0]), (3, queued[1])):
        assert eng.result(rid).tokens == want[i]
    _clean_pool(eng)


def test_deadline_reaps_decref_shared_prefix(lm):
    """Two of four requests sharing a prefix pass their deadline mid-decode
    (the clock jumps 50 s at step 6); the reaps return every page, shared
    prefix decrefs included, with the invariants checked after every step,
    and the survivors' streams are unperturbed."""
    model, params = lm
    rng = np.random.default_rng(7)
    prompts = _shared(rng, 4, tail=4)

    class JumpClock:
        t = 0.0

        def __call__(self):
            return self.t

    clock = JumpClock()
    eng = _engine(model, params, n_slots=4, paged=True, page_size=8,
                  clock=clock)
    doomed = [eng.submit(prompts[i], 20, request_id=f"d{i}", deadline_s=30.0)
              for i in range(2)]
    safe = [eng.submit(prompts[i], 20, request_id=f"s{i}") for i in (2, 3)]
    steps = 0
    while eng.scheduler.queue_depth or eng.kv.active_slots:
        clock.t += 1.0 + (50.0 if steps == 6 else 0.0)
        eng.step()
        steps += 1
        eng.kv.check()
    for rid in doomed:
        fin = eng.result(rid)
        assert fin.finish_reason == "deadline" and len(fin.tokens) < 20
    for i, rid in zip((2, 3), safe):
        assert eng.result(rid).tokens == _dense(lm, [(prompts[i], 20)])[0]
    _clean_pool(eng)


def test_admission_by_free_pages_does_not_starve_long_prompt(lm):
    """A long prompt at the queue head is never overtaken by a cheaper one
    behind it: admission gates on the HEAD's page need, even with a free
    slot."""
    model, params = lm
    rng = np.random.default_rng(8)
    eng = _engine(model, params, n_slots=2, paged=True, page_size=8,
                  pages_per_partition=8, clock=FakeClock())
    a = eng.submit(_prompts(rng, [30])[0], 8, request_id="a")
    assert eng.step() == "prefill"
    eng.submit(_prompts(rng, [33])[0], 6, request_id="long")
    eng.submit(_prompts(rng, [4])[0], 2, request_id="short")
    assert eng.kv.free_slots == 1
    assert eng.step() == "decode"
    assert eng._requests["long"].slot is None
    assert eng._requests["short"].slot is None
    eng.drain(max_steps=5000)
    fins = {rid: eng.result(rid) for rid in (a, "long", "short")}
    assert all(f.finish_reason == "length" for f in fins.values())
    assert fins["long"].timing.admitted_at < fins["short"].timing.admitted_at
    for rid, n in (("a", 8), ("long", 6), ("short", 2)):
        assert fins[rid].tokens == _dense(lm, [(fins[rid].prompt, n)])[0]
    eng.kv.check()


def test_snapshot_memory_section_and_swap_flushes_prefixes(lm):
    model, params = lm
    rng = np.random.default_rng(11)
    eng = _engine(model, params, n_slots=2, paged=True, page_size=8)
    _run(eng, [(p, 4) for p in _prompts(rng, [9, 13, 17])])
    mem = json.loads(json.dumps(eng.snapshot()))["memory"]
    assert mem["page_size"] == 8 and mem["kv_hbm_bytes"] > 0
    assert 0.0 <= mem["page_utilization"] <= 1.0
    assert mem["pages_used"] + mem["pages_free"] == mem["pages_total"]
    assert mem["prefix"]["nodes"] > 0
    assert "memory" not in _engine(model, params, n_slots=2).snapshot()
    # a swap drops every cached prefix page (built under the old weights)
    eng.swap_params(model.init(2))
    mem = eng.kv.memory_stats()
    assert mem["prefix"]["nodes"] == 0 and mem["pages_used"] == 0
    eng.kv.check()


def test_matches_jax_paged_engine_tokens_and_counters():
    """Shared prefix plus a pool small enough to preempt, the same weights in
    both packages, greedy: the port emits the JAX paged engine's tokens
    (every emitted position's top-2 logit margin is above 1e-5, so no near
    tie could flip) and reports the same integer memory counters."""
    jm = JaxLM(**CFG)
    np_params = jm.init(1)
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    model = _model()
    params = from_jax_params(np_params, device="cpu")
    rng = np.random.default_rng(12)
    reqs = [(p, 16) for p in _shared(rng, 5, system_len=16, tail=5)]
    kw = dict(n_slots=4, paged=True, page_size=8, pages_per_partition=9)
    out = {}
    for name, eng in (("jax", JaxEngine(jm, jparams, **kw)),
                      ("torch", _engine(model, params, **kw))):
        out[name] = (_run(eng, reqs), eng.kv.memory_stats())
    assert out["torch"][0] == out["jax"][0]
    for prompt, toks in zip((p for p, _ in reqs), out["torch"][0]):
        seq = np.concatenate([prompt, toks])
        logits, _ = model.decode_chunk(params, torch.from_numpy(seq)[None].long(),
                                       0, model.init_cache(1, len(seq)))
        top = torch.topk(logits[0, len(prompt) - 1:-1], 2, dim=-1).values
        assert float((top[:, 0] - top[:, 1]).min()) > 1e-5
    (_, jmem), (_, tmem) = out["jax"], out["torch"]
    assert tmem["preemptions"] > 0 and tmem["prefix"]["hits_pages"] > 0
    for key in ("pages_used", "preemptions"):
        assert tmem[key] == jmem[key], key
    for key in ("hits_pages", "lookups_pages", "nodes"):
        assert tmem["prefix"][key] == jmem["prefix"][key], key
