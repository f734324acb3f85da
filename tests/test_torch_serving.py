"""The port's ServingEngine: greedy token identity with the JAX package's
per-request ``TransformerLM.generate`` under interleaved mixed-length load,
and mirrors of the reference's host-semantics tests
(tests/serving/test_engine.py) — slot reuse, backpressure, admission
reasons, streaming, EOS, cancel, deadlines and shedding, fake-clock timing,
result retention, sampled-stream independence — plus the fused-decode and
chunked-prefill fast paths, all on the CPU path."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.models.transformer import TransformerLM as JaxLM
from elephas_tpu_torch.models import TransformerLM, from_jax_params
from elephas_tpu_torch.serving import AdmissionError, ServingEngine

V = 17
CFG = dict(vocab=V, d_model=16, n_heads=4, n_layers=2, d_ff=32, max_len=48)


def _model(**kw):
    return TransformerLM(**dict(CFG, **kw), device="cpu")


def _params(model, seed=1):
    return model.init(seed)


def _engine(model, params, **kw):
    return ServingEngine(model, params, device="cpu", **kw)


def _mixed_requests(rng, n, lens=(2, 3, 5, 7, 9, 11), news=(3, 5, 7, 9)):
    """n (prompt, max_new) pairs cycling through mixed geometries."""
    li, ni = itertools.cycle(lens), itertools.cycle(news)
    return [(rng.integers(0, V, size=(next(li),)).astype(np.int32), next(ni))
            for _ in range(n)]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _top2_margins(model, params, seq):
    """Top-1 minus top-2 logit at every position of a teacher-forced pass."""
    cache = model.init_cache(1, len(seq))
    logits, _ = model.decode_chunk(params, torch.as_tensor(seq)[None], 0, cache)
    top = torch.topk(logits[0], 2, dim=-1).values
    return (top[:, 0] - top[:, 1]).numpy()


def test_greedy_identity_with_jax_generate_interleaved_mixed_lengths():
    """12 mixed-length requests through 8 slots, submissions interleaved
    with steps: every greedy continuation equals the JAX package's
    per-request ``generate`` token for token. Every emitted position has a
    top-2 logit margin above 1e-5, two orders of magnitude over the
    cross-framework logit error at this size (~1e-7; see
    test_torch_transformer.py), so a mismatch could not be a near-tie."""
    jm = JaxLM(**CFG)
    np_params = jm.init(1)
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    model = _model()
    params = from_jax_params(np_params, device="cpu")
    rng = np.random.default_rng(0)
    reqs = _mixed_requests(rng, 12)
    eng = _engine(model, params, n_slots=8, max_queue=16)
    ids = []
    for i, (prompt, max_new) in enumerate(reqs):
        ids.append(eng.submit(prompt, max_new))
        if i >= 4:
            eng.step()          # interleave: decode while submitting
    assert eng.kv.active_slots > 0
    fin = eng.drain(max_steps=2000)
    assert len(fin) == 12
    for rid, (prompt, max_new) in zip(ids, reqs):
        ref = np.asarray(jm.generate(jparams, prompt[None],
                                     max_new))[0, len(prompt):]
        got = np.asarray(fin[rid].tokens)
        seq = np.concatenate([prompt, got])
        margins = _top2_margins(model, params, seq)[len(prompt) - 1:-1]
        assert margins.min() > 1e-5, (rid, margins.min())
        np.testing.assert_array_equal(got, ref, err_msg=rid)
        assert fin[rid].finish_reason == "length"


def test_serves_more_requests_than_slots():
    model = _model()
    rng = np.random.default_rng(3)
    reqs = _mixed_requests(rng, 7)
    eng = _engine(model, _params(model), n_slots=2, max_queue=16)
    ids = [eng.submit(p, m) for p, m in reqs]
    fin = eng.drain(max_steps=2000)
    assert sorted(fin) == sorted(ids)
    snap = eng.snapshot()
    assert snap["counters"]["completed"] == 7
    assert snap["engine"]["active_slots"] == 0
    assert snap["engine"]["queue_depth"] == 0
    assert snap["engine"]["prefills"] == 7


def test_backpressure_rejects_when_queue_full():
    model = _model()
    rng = np.random.default_rng(4)
    eng = _engine(model, _params(model), n_slots=1, max_queue=2)
    p = rng.integers(0, V, size=(3,)).astype(np.int32)
    eng.submit(p, 2)
    eng.submit(p, 2)
    with pytest.raises(AdmissionError) as ei:
        eng.submit(p, 2)
    assert ei.value.reason == "queue_full"
    assert eng.snapshot()["counters"]["rejected"] == {"queue_full": 1}
    assert len(eng.drain(max_steps=500)) == 2


def test_admission_validation_reasons():
    model = _model()
    eng = _engine(model, _params(model), n_slots=1)
    with pytest.raises(AdmissionError) as ei:
        eng.submit(np.zeros(model.max_len + 1, np.int32), 1)
    assert ei.value.reason == "prompt_too_long"
    with pytest.raises(AdmissionError) as ei:
        eng.submit(np.zeros(40, np.int32), 20)
    assert ei.value.reason == "length_exceeds_cache"
    with pytest.raises(AdmissionError) as ei:
        eng.submit(np.zeros(4, np.int32), 0)
    assert ei.value.reason == "bad_request"
    with pytest.raises(AdmissionError) as ei:
        eng.submit(np.full(4, V, np.int32), 2)       # id past the vocab
    assert ei.value.reason == "bad_request"
    rid = eng.submit(np.zeros(4, np.int32), 2, request_id="dup")
    with pytest.raises(AdmissionError) as ei:
        eng.submit(np.zeros(4, np.int32), 2, request_id="dup")
    assert ei.value.reason == "bad_request"
    assert rid == "dup"


def test_streaming_callbacks_in_order_with_done_flag():
    model = _model()
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, V, size=(6,)).astype(np.int32)
    seen = []
    eng = _engine(model, _params(model), n_slots=2)
    rid = eng.submit(prompt, 5, on_token=lambda r, t, d: seen.append((r, t, d)))
    fin = eng.drain(max_steps=200)
    assert [t for _, t, _ in seen] == fin[rid].tokens
    assert [d for _, _, d in seen] == [False] * 4 + [True]
    assert all(r == rid for r, _, _ in seen)


def test_eos_finishes_early_and_frees_slot():
    model = _model()
    params = _params(model)
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, V, size=(5,)).astype(np.int32)
    ref = np.asarray(_run_one(model, params, prompt, 8))
    eos = int(ref[2])
    stop = int(np.argmax(ref == eos))
    eng = _engine(model, params, n_slots=1)
    rid = eng.submit(prompt, 8, eos_id=eos)
    rid2 = eng.submit(prompt, 3)            # queued behind the 1 slot
    fin = eng.drain(max_steps=200)
    np.testing.assert_array_equal(fin[rid].tokens, ref[:stop + 1])
    assert fin[rid].finish_reason == "eos"
    assert len(fin[rid2].tokens) == 3


def _run_one(model, params, prompt, max_new, **submit_kw):
    eng = _engine(model, params, n_slots=1)
    rid = eng.submit(prompt, max_new, **submit_kw)
    eng.drain(max_steps=500)
    return eng.result(rid).tokens


def test_sampled_stream_independent_of_cobatching():
    """A sampled request's tokens are a function of (seed, position) only:
    alone in a 2-slot engine or co-batched with 3 others in a 4-slot one,
    the same submission emits the same tokens; another seed differs."""
    model = _model()
    params = _params(model)
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, V, size=(6,)).astype(np.int32)
    others = _mixed_requests(rng, 3)

    solo = _engine(model, params, n_slots=2)
    r1 = solo.submit(prompt, 10, temperature=0.8, seed=42)
    solo.drain(max_steps=200)
    solo_tokens = solo.result(r1).tokens

    busy = _engine(model, params, n_slots=4)
    for p, m in others:
        busy.submit(p, m, temperature=1.3, seed=9)
    r2 = busy.submit(prompt, 10, temperature=0.8, seed=42)
    fin = busy.drain(max_steps=500)
    assert solo_tokens == fin[r2].tokens

    reseed = _engine(model, params, n_slots=2)
    r3 = reseed.submit(prompt, 10, temperature=0.8, seed=43)
    reseed.drain(max_steps=200)
    assert reseed.result(r3).tokens != solo_tokens


def test_sampler_follows_softmax():
    """The counter-based sampler draws from softmax(logits / T): over many
    (seed, position) keys the empirical frequencies match."""
    from elephas_tpu_torch.models import select_slot_tokens

    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]]).repeat(4000, 1)
    seeds = torch.arange(4000, dtype=torch.int64)
    out_pos = torch.full((4000,), 5, dtype=torch.int64)
    temps = torch.full((4000,), 0.7)
    draws = select_slot_tokens(logits, out_pos, temps, seeds).numpy()
    freq = np.bincount(draws, minlength=4) / 4000
    want = torch.softmax(logits[0] / 0.7, -1).numpy()
    np.testing.assert_allclose(freq, want, atol=0.03)
    greedy = select_slot_tokens(logits[:3], out_pos[:3], torch.zeros(3),
                                seeds[:3])
    assert greedy.tolist() == [0, 0, 0]


def test_timing_with_fake_clock():
    model = _model()
    rng = np.random.default_rng(8)
    p = rng.integers(0, V, size=(4,)).astype(np.int32)
    eng = _engine(model, _params(model), n_slots=1, clock=FakeClock())
    r1 = eng.submit(p, 2)
    r2 = eng.submit(p, 2)
    fin = eng.drain(max_steps=100)
    t1, t2 = fin[r1].timing, fin[r2].timing
    assert t2.queue_wait > t1.queue_wait
    assert t1.ttft == t1.first_token_at - t1.submitted_at
    assert t1.generated_tokens == 2 and t2.generated_tokens == 2


def test_result_pop_on_read_and_retention_bound():
    model = _model()
    params = _params(model)
    eng = _engine(model, params, n_slots=1)
    rid = eng.submit(np.zeros(3, np.int32), 2)
    eng.drain(max_steps=100)
    assert eng.result(rid, pop=False).finish_reason == "length"
    assert eng.result(rid).finish_reason == "length"
    assert eng.result(rid) is None
    assert eng.submit(np.zeros(3, np.int32), 2, request_id=rid) == rid

    eng = _engine(model, params, n_slots=1, max_finished=2)
    rids = [eng.submit(np.zeros(3, np.int32), 2) for _ in range(5)]
    eng.drain(max_steps=500)
    assert [eng.result(r, pop=False) is not None for r in rids] == \
        [False, False, False, True, True]
    assert eng.snapshot()["counters"]["results_evicted"] == 3
    with pytest.raises(ValueError):
        _engine(model, params, n_slots=1, max_finished=0)


def test_cancel_active_and_queued():
    model = _model()
    params = _params(model)
    rng = np.random.default_rng(12)
    p = rng.integers(0, V, size=(4,)).astype(np.int32)
    eng = _engine(model, params, n_slots=1, max_queue=8)
    rid = eng.submit(p, 10)
    eng.step()                               # prefill: 1 token out
    eng.step()                               # decode: 2nd token
    doomed = eng.submit(p, 4)
    assert eng.scheduler.queue_depth == 1
    assert eng.cancel(doomed)                # queued: never takes a slot
    assert eng.scheduler.queue_depth == 0
    assert eng.cancel(rid)                   # active: slot back in O(1)
    assert eng.kv.active_slots == 0
    fin = eng.result(rid)
    assert fin.finish_reason == "cancelled" and len(fin.tokens) == 2
    assert eng.result(doomed).tokens == []
    assert eng.cancel(rid) is False and eng.cancel("never-existed") is False
    assert eng.snapshot()["counters"]["cancelled"] == {"cancelled": 2}
    rid2 = eng.submit(p, 3)
    eng.drain(max_steps=100)
    assert eng.result(rid2).finish_reason == "length"
    assert eng.snapshot()["engine"]["prefills"] == 2


def test_deadline_expired_in_queue_is_shed_not_reaped():
    model = _model()
    rng = np.random.default_rng(14)
    p = rng.integers(0, V, size=(4,)).astype(np.int32)
    eng = _engine(model, _params(model), n_slots=1, clock=FakeClock())
    busy = eng.submit(p, 6)
    doomed = eng.submit(p, 6, deadline_s=2.0)   # FakeClock: +1s per call
    fin = eng.drain(max_steps=200)
    assert fin[doomed].finish_reason == "shed"
    assert fin[doomed].tokens == []
    assert fin[busy].finish_reason == "length"
    assert eng.snapshot()["counters"]["cancelled"] == {"shed": 1}
    with pytest.raises(AdmissionError) as ei:
        eng.submit(p, 2, deadline_s=0.0)
    assert ei.value.reason == "bad_request"


def test_admitted_request_past_deadline_is_reaped():
    model = _model()
    rng = np.random.default_rng(16)
    p = rng.integers(0, V, size=(4,)).astype(np.int32)
    eng = _engine(model, _params(model), n_slots=1, clock=FakeClock())
    rid = eng.submit(p, 20, deadline_s=8.0)
    fin = eng.drain(max_steps=200)
    assert fin[rid].finish_reason == "deadline"
    assert 0 < len(fin[rid].tokens) < 20
    assert eng.kv.free_slots == 1


def test_shed_at_admission_when_budget_provably_overruns():
    model = _model()
    params = _params(model)
    rng = np.random.default_rng(15)
    p = rng.integers(0, V, size=(4,)).astype(np.int32)
    eng = _engine(model, params, n_slots=2, clock=FakeClock(),
                  itl_estimate_s=10.0)
    hopeless = eng.submit(p, 8, deadline_s=60.0)   # 8 * 10 s > 60 s
    fine = eng.submit(p, 3, deadline_s=60.0)
    fin = eng.drain(max_steps=200)
    assert fin[hopeless].finish_reason == "shed"
    assert fin[hopeless].tokens == []
    assert fin[fine].finish_reason == "length"
    assert eng.snapshot()["engine"]["prefills"] == 1
    with pytest.raises(ValueError):
        _engine(model, params, itl_estimate_s=0.0)


def test_injectable_perf_clock_makes_histograms_deterministic():
    class CountingClock:
        def __init__(self):
            self.t = 0.0

        def __call__(self):
            self.t += 0.25
            return self.t

    def run_once():
        model = _model()
        rng = np.random.default_rng(21)
        eng = _engine(model, _params(model), n_slots=2, clock=FakeClock(),
                      perf_clock=CountingClock())
        for i, (p, n) in enumerate(_mixed_requests(rng, 3)):
            eng.submit(p, n, request_id=f"r{i}")
        eng.drain(max_steps=300)
        return eng.snapshot()

    a, b = run_once(), run_once()
    assert a == b
    d = a["fastpath"]["dispatch_overhead_s"]
    assert d["count"] > 0 and d["p50"] % 0.25 == 0


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_fused_decode_and_chunked_prefill_are_token_identical(temperature):
    """``fuse_k=4`` and ``prefill_chunk`` change how the work is launched,
    never the tokens (greedy and sampled)."""
    model = _model()
    params = _params(model)
    rng = np.random.default_rng(30)
    reqs = _mixed_requests(rng, 6, lens=(3, 11, 20, 6), news=(9, 5, 12))

    def run(**kw):
        eng = _engine(model, params, n_slots=3, **kw)
        ids = [eng.submit(p, m, temperature=temperature, seed=i)
               for i, (p, m) in enumerate(reqs)]
        fin = eng.drain(max_steps=2000)
        return [fin[r].tokens for r in ids], eng.snapshot()["fastpath"]

    plain, _ = run()
    fused, fp = run(fuse_k=4)
    assert fp["fused_blocks"] > 0
    chunked, cp = run(prefill_chunk=4)
    assert cp["prefill_chunks"] > 0
    both, _ = run(fuse_k=4, prefill_chunk=8)
    assert fused == plain and chunked == plain and both == plain


def test_swap_params_attributes_tokens_to_versions():
    model = _model()
    p1, p2 = _params(model, seed=1), _params(model, seed=2)
    rng = np.random.default_rng(31)
    prompt = rng.integers(0, V, size=(5,)).astype(np.int32)
    eng = _engine(model, p1, n_slots=1)
    rid = eng.submit(prompt, 6)
    for _ in range(3):
        eng.step()                      # prefill + 2 decode rounds
    assert eng.swap_params(p2) == 1
    fin = eng.drain(max_steps=100)[rid]
    assert fin.token_versions == [0, 0, 0, 1, 1, 1]
    assert (fin.version_first, fin.version_last) == (0, 1)
    assert eng.snapshot()["engine"]["weight_swaps"] == 1
    assert fin.tokens[:3] == _run_one(model, p1, prompt, 6)[:3]


def test_later_slices_raise_not_implemented():
    model = _model()
    params = _params(model)
    for kw in (dict(mesh=object()), dict(fault_plan=object()),
               dict(paged=True, mesh=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _engine(model, params, **kw)
