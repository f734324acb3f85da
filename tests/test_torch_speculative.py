"""The port's speculative decoding on the CPU path, against the JAX package
on the same numpy inputs (weights carried across by ``from_jax_params``)
and against the port's own sequential paths.

- The rules: ``spec_round_accept`` (``n`` exactly, the residual within
  1e-6), ``spec_verify_select`` (every offset is the sequential
  ``select_slot_tokens``; greedy rows equal the reference's), and
  ``NgramDrafter.propose`` (exactly the reference's).
- ``TransformerLM.generate_speculative``: greedy streams equal the port's
  ``generate`` and the reference's ``generate_speculative`` token for
  token, with the reference's stats; the sampled host loop draws the
  reference's tokens from the same numpy generators; the sampled device
  loop keeps the target's per-position frequencies (total variation under
  0.12, the reference's bound); MoE; a horizon at ``max_len``.
- ``ServingEngine(speculate_k, drafter)``: dense and paged, greedy and
  sampled, n-gram and model drafters, each stream equal to the
  ``speculate_k=1`` engine's token for token; the greedy stream equal to
  the reference engine's; EOS mid-round, deadlines, validation, the page
  reservation, page-straddling accepts, pages exhausted mid-window,
  ``swap_params(drafter_params)``, the metrics identities and the clock
  rule.

Each test compares token lists exactly. The port's logits differ from the
reference's by about 1e-7 at these widths (test_torch_transformer.py), and
the top-2 gaps of these seeds are far above that, so the streams are
compared without a tolerance; the residuals of ``spec_round_accept`` are
held within 1e-6."""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.models import transformer as jt
from elephas_tpu.serving import ServingEngine as JaxEngine
from elephas_tpu.serving.engine import NgramDrafter as JaxNgram
from elephas_tpu_torch.models import (MoETransformerLM, TransformerLM,
                                      from_jax_params)
from elephas_tpu_torch.models.transformer import (select_slot_tokens,
                                                  spec_round_accept,
                                                  spec_verify_select)
from elephas_tpu_torch.serving import (ModelDrafter, NgramDrafter,
                                       ServingEngine)
from elephas_tpu_torch.serving.scheduler import Scheduler, ServingRequest

V = 17
CFG = dict(vocab=V, d_model=16, n_heads=4, n_layers=2, d_ff=32, max_len=48)
DRAFT = dict(CFG, d_model=8, n_heads=2, n_layers=1, d_ff=16)


def _pair(cfg, seed):
    """The same weights in both packages: ``(jax model, jax params, port
    model, port params)``."""
    jm = jt.TransformerLM(**cfg)
    np_params = jm.init(seed)
    return (jm, {k: jnp.asarray(v) for k, v in np_params.items()},
            TransformerLM(**cfg, device="cpu"),
            from_jax_params(np_params, device="cpu"))


@pytest.fixture(scope="module")
def lms():
    """Target (seed 3) and a different draft model (seed 4) in both
    packages."""
    return _pair(CFG, 3), _pair(DRAFT, 4)


@pytest.fixture(scope="module")
def serve_case():
    jm, jp, model, params = _pair(CFG, 1)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, V, size=(n,)).astype(np.int32), 12)
            for n in (5, 9, 3, 7)]
    return jm, jp, model, params, reqs


def _engine(model, params, **kw):
    return ServingEngine(model, params, device="cpu", **kw)


def _run(eng, reqs, check=False, **submit_kw):
    """Submit with one step after each, drain (``check``: ``kv.check()``
    after every step); the token lists in submission order."""
    ids = []
    for i, (prompt, max_new) in enumerate(reqs):
        ids.append(eng.submit(prompt, max_new, seed=i, **submit_kw))
        eng.step()
    for _ in range(5000):
        if not (eng.scheduler.queue_depth or eng.kv.active_slots):
            break
        eng.step()
        if check:
            eng.kv.check()
    return [eng.result(rid).tokens for rid in ids]


# -- the rules -----------------------------------------------------------------


def test_spec_round_accept_matches_reference():
    """Random target/draft distributions, proposals and uniforms, plus
    uniforms forcing every acceptance length 0..k (``u = a/2`` accepts,
    ``u = (1+a)/2`` rejects): ``n`` equal, the residual within 1e-6."""
    rng = np.random.default_rng(0)
    B, k, Vs = 6, 3, 7

    def dists(*shape):
        p = rng.uniform(0.05, 1.0, shape + (Vs,))
        return (p / p.sum(-1, keepdims=True)).astype(np.float32)

    pt, pd = dists(B, k + 1), dists(B, k)
    d = rng.integers(0, Vs, size=(B, k))
    a = np.minimum(1.0, np.take_along_axis(pt[:, :k], d[..., None], -1)[..., 0]
                   / np.take_along_axis(pd, d[..., None], -1)[..., 0])
    forced = np.array([[a[b, i] / 2 if i < b % (k + 1) else (1 + a[b, i]) / 2
                        for i in range(k)] for b in range(B)], np.float32)
    for u in (rng.uniform(size=(B, k)).astype(np.float32), forced):
        n, resid = spec_round_accept(*(torch.from_numpy(x) for x in (pt, pd, d, u)))
        jn, jresid = jax.jit(jt.spec_round_accept)(pt, pd, d, u)
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
        np.testing.assert_allclose(resid.numpy(), np.asarray(jresid), atol=1e-6)
    assert sorted(n.tolist()) == [0, 0, 1, 1, 2, 3]


def test_verify_select_equals_sequential_selection():
    """At every chunk offset ``spec_verify_select`` picks exactly the
    sequential ``select_slot_tokens`` token at position ``pos + 1 + j``,
    greedy and sampled rows together, and ``n`` is the longest
    drafts-match prefix; the greedy rows' ``sel`` and ``n`` equal the
    reference's."""
    rng = np.random.default_rng(3)
    S, K = 4, 3
    logits = rng.normal(size=(S, K + 1, V)).astype(np.float32)
    drafts = rng.integers(0, V, size=(S, K))
    pos = np.array([2, 7, 0, 5])
    temps = np.array([0.0, 0.9, 0.0, 1.3], np.float32)
    drafts[0] = logits[0, :K].argmax(-1)          # a fully accepted row
    drafts[2, 0] = logits[2, 0].argmax(-1)        # a row accepting one
    t = {k_: torch.from_numpy(v) for k_, v in
         dict(logits=logits, drafts=drafts, pos=pos, temps=temps).items()}
    seeds = torch.tensor([11, 12, 13, 14])
    sel, n = spec_verify_select(t["logits"], t["drafts"], t["pos"], t["temps"], seeds)
    for j in range(K + 1):
        step = select_slot_tokens(t["logits"][:, j], t["pos"] + 1 + j, t["temps"], seeds)
        assert torch.equal(sel[:, j], step), j
    want = [0] * S
    for s in range(S):
        while want[s] < K and sel[s, want[s]] == drafts[s, want[s]]:
            want[s] += 1
    assert n.tolist() == want and want[0] == K and want[2] >= 1
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(S, dtype=jnp.uint32))
    jsel, jn = jt.spec_verify_select(jnp.asarray(logits), jnp.asarray(drafts, jnp.int32),
                                     jnp.asarray(pos, jnp.int32), jnp.asarray(temps), keys)
    greedy = temps <= 0
    np.testing.assert_array_equal(sel.numpy()[greedy], np.asarray(jsel)[greedy])
    np.testing.assert_array_equal(n.numpy()[greedy], np.asarray(jn)[greedy])


def test_ngram_drafter_matches_reference():
    """The reference's fixed cases, then 200 seeded random contexts of
    length 0-40 over 5 tokens at n_max 1-4 and k 1-6: exactly the
    reference's proposals."""
    d = NgramDrafter(n_max=3)
    assert d.propose(np.asarray([4, 5, 6, 9, 4, 5, 6]), 3).tolist() == [9, 4, 5]
    assert d.propose(np.asarray([7, 8, 7]), 4).tolist() == [8, 7, 7, 7]
    assert d.propose(np.asarray([1]), 2).tolist() == [1, 1]
    rng = np.random.default_rng(5)
    for _ in range(200):
        n_max, k = int(rng.integers(1, 5)), int(rng.integers(1, 7))
        ctx = rng.integers(0, 5, size=int(rng.integers(0, 41)))
        got = NgramDrafter(n_max).propose(ctx, k)
        np.testing.assert_array_equal(got, JaxNgram(n_max).propose(ctx, k))
    with pytest.raises(ValueError):
        NgramDrafter(0)


# -- generate_speculative ------------------------------------------------------

PROMPTS = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]], np.int32)


@pytest.fixture(scope="module")
def greedy_refs(lms):
    """The port's greedy ``generate`` (12 new tokens), and a lazy table of
    the reference's ``generate_speculative`` (all three rows, the
    different-seed draft, its device loop) by ``spec_k``."""
    (jm, jp, m, p), (jd, jdp, _, _) = lms
    refs = {}

    def ref(spec_k):
        if spec_k not in refs:
            out, stats = jm.generate_speculative(jp, PROMPTS, 12, jd, jdp,
                                                 spec_k=spec_k, with_stats=True)
            refs[spec_k] = np.asarray(out), stats
        return refs[spec_k]
    return m.generate(p, PROMPTS, 12).numpy(), ref


@pytest.mark.parametrize("host_loop", [False, True], ids=["device", "host"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("spec_k", [1, 3, 5])
def test_greedy_equals_generate_and_reference(lms, greedy_refs, spec_k, B, host_loop):
    """A different-seed draft and a self-draft: the tokens equal the
    port's greedy ``generate`` and the reference's
    ``generate_speculative`` (rows are independent, so a batch of one is
    the first row of the reference's three), and at three rows
    ``with_stats`` equals the reference's counts on both loops. A
    self-draft accepts every proposal on the CPU."""
    (_, _, m, p), (_, _, d, dp) = lms
    want, ref = greedy_refs
    ref_out, ref_stats = ref(spec_k)
    for self_draft in (False, True):
        draft, dparams = (m, p) if self_draft else (d, dp)
        got, stats = m.generate_speculative(p, PROMPTS[:B], 12, draft, dparams,
                                            spec_k=spec_k, host_loop=host_loop,
                                            with_stats=True)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want[:B])
        np.testing.assert_array_equal(got.numpy(), ref_out[:B])
        if B == 3 and not self_draft:
            assert stats == ref_stats
        if self_draft:
            assert stats["accepted"] == stats["proposed"]
            assert stats["tokens_emitted"] == 12 * B


def test_moe_greedy_equals_target_and_capacity_bound_raises():
    """An MoE target with capacity that never binds (cf·k >= E) speculates
    and equals its own greedy ``generate``; cf·k < E raises, naming the
    rule; a capacity-bound draft raises too."""
    kw = dict(vocab=V, d_model=16, n_heads=4, n_layers=1, d_ff=32, max_len=32,
              n_experts=4, k=2, device="cpu")
    moe = MoETransformerLM(capacity_factor=2.0, **kw)
    mp = moe.init(2)
    want = moe.generate(mp, PROMPTS[:2], 9).numpy()
    for spec_k in (2, 4):
        got = moe.generate_speculative(mp, PROMPTS[:2], 9, moe, mp, spec_k=spec_k)
        np.testing.assert_array_equal(got.numpy(), want)
    bound = MoETransformerLM(capacity_factor=1.25, **kw)
    with pytest.raises(NotImplementedError, match="capacity"):
        bound.generate_speculative(bound.init(2), PROMPTS[:1], 4, moe, mp)
    with pytest.raises(NotImplementedError, match="draft"):
        moe.generate_speculative(mp, PROMPTS[:1], 4, bound, bound.init(2))


@pytest.mark.parametrize("host_loop", [False, True], ids=["device", "host"])
def test_horizon_at_max_len_with_learned_positions(lms, host_loop):
    """``T0 + n_new == max_len``: the last rounds score chunk rows past
    ``max_len - 1`` (the frozen rows' rewrites, the rejected tails), whose
    learned-position index reads the last row; no index error, and the
    emitted tokens still equal ``generate``."""
    (_, _, m, p), (_, _, d, dp) = lms
    prompt = np.tile((np.arange(40) % V).astype(np.int32), (2, 1))
    prompt[1] = prompt[1][::-1]
    want = m.generate(p, prompt, 8).numpy()
    for spec_k in (4, 5):
        got = m.generate_speculative(p, prompt, 8, d, dp, spec_k=spec_k,
                                     host_loop=host_loop)
        np.testing.assert_array_equal(got.numpy(), want)
        got = m.generate_speculative(p, prompt[:1], 8, m, p, spec_k=spec_k,
                                     host_loop=host_loop)
        np.testing.assert_array_equal(got.numpy(), want[:1])


def test_validation(lms):
    (_, _, m, p), (_, _, d, dp) = lms
    with pytest.raises(ValueError, match="spec_k"):
        m.generate_speculative(p, PROMPTS, 4, d, dp, spec_k=0)
    with pytest.raises(ValueError, match="max_len"):
        m.generate_speculative(p, PROMPTS, 46, d, dp)
    other = TransformerLM(**dict(DRAFT, vocab=V + 1), device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        m.generate_speculative(p, PROMPTS, 4, other, other.init(0))
    same = m.generate_speculative(p, PROMPTS, 0, d, dp)
    assert same.dtype == torch.int32 and same.tolist() == PROMPTS.tolist()


@pytest.mark.parametrize("B", [1, 3])
def test_sampled_host_loop_matches_reference(lms, B):
    """Sampled, host loop: the port draws from the reference's numpy
    generators (``default_rng(seed)``, per row ``[seed, row]``), so on the
    same weights its tokens and stats equal the reference's; valid and
    deterministic per seed."""
    (jm, jp, m, p), (jd, jdp, d, dp) = lms
    kw = dict(spec_k=3, temperature=0.9, seed=4 + B, host_loop=True,
              with_stats=True)
    got, stats = m.generate_speculative(p, PROMPTS[:B], 9, d, dp, **kw)
    ref, ref_stats = jm.generate_speculative(jp, PROMPTS[:B], 9, jd, jdp, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert stats == ref_stats
    again = m.generate_speculative(p, PROMPTS[:B], 9, d, dp, **kw)[0]
    assert torch.equal(again, got)
    other = m.generate_speculative(p, PROMPTS[:B], 9, d, dp, **dict(kw, seed=99))[0]
    assert not torch.equal(other, got)
    assert got[:, :3].tolist() == PROMPTS[:B].tolist()
    assert bool(((got >= 0) & (got < V)).all())


def test_sampled_device_loop_contract_and_distribution():
    """The device loop's sampled rounds (the rejection rule in float32,
    draws from a ``torch.Generator``): valid, deterministic per seed,
    coherent stats; and the marginal token distribution at the first
    generated positions equals the target's own temperature sampling
    (``generate``) within total variation 0.12 over 8 rows x 60 seeds,
    the reference's test and bound."""
    target = TransformerLM(**dict(CFG, vocab=7, n_layers=1, max_len=16), device="cpu")
    tp = target.init(8)
    draft = TransformerLM(**dict(DRAFT, vocab=7, max_len=16), device="cpu")
    dp = draft.init(9)
    prompt = np.tile(np.array([[1, 2]], np.int32), (8, 1))
    out, stats = target.generate_speculative(tp, prompt, 3, draft, dp, spec_k=2,
                                             temperature=1.1, seed=5, with_stats=True)
    again = target.generate_speculative(tp, prompt, 3, draft, dp, spec_k=2,
                                        temperature=1.1, seed=5)
    assert torch.equal(out, again) and out.shape == (8, 5)
    assert stats["proposed"] >= stats["accepted"] >= 0 and stats["rounds"] >= 1
    assert stats["tokens_emitted"] == 8 * 3
    spec, plain = [], []
    for s in range(60):
        spec.append(target.generate_speculative(tp, prompt, 3, draft, dp, spec_k=2,
                                                temperature=1.1, seed=s).numpy())
        plain.append(target.generate(tp, prompt, 3, temperature=1.1,
                                     seed=10_000 + s).numpy())
    spec, plain = np.concatenate(spec), np.concatenate(plain)
    for j in range(2, 5):
        fs = np.bincount(spec[:, j], minlength=7) / len(spec)
        fp = np.bincount(plain[:, j], minlength=7) / len(plain)
        assert 0.5 * np.abs(fs - fp).sum() < 0.12, (j, fs, fp)


def test_init_cache_chunk():
    """``init_cache(batch, length, chunk)`` as the reference: a linear
    cache keeps its shape for any chunk, and ``chunk < 1`` raises."""
    jm = jt.TransformerLM(**CFG)
    m = TransformerLM(**CFG, device="cpu")
    for length, chunk in ((None, 1), (20, 5), (33, 6)):
        got = m.init_cache(2, length, chunk=chunk)["k"].shape
        assert tuple(got) == jm.init_cache(2, length, chunk=chunk)["k"].shape
        assert got == m.init_cache(2, length)["k"].shape
    with pytest.raises(ValueError, match="chunk"):
        m.init_cache(2, 16, chunk=0)


# -- the engine ------------------------------------------------------------------


@pytest.mark.parametrize("drafter", ["ngram", "model"])
@pytest.mark.parametrize("temp", [0.0, 0.8], ids=["greedy", "t0.8"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_stream_equals_sequential(serve_case, paged, temp, drafter):
    """``speculate_k=4`` with either drafter emits exactly the
    ``speculate_k=1`` engine's tokens, and the rounds ran; the paged pool
    passes ``kv.check()`` after every step; a self-draft ModelDrafter
    accepts every greedy proposal (its rollout ingests its last proposal,
    so a fully accepted round leaves no hole in the draft cache)."""
    _, _, model, params, reqs = serve_case
    kw = dict(n_slots=4, paged=paged, page_size=8)
    want = _run(_engine(model, params, **kw), reqs, temperature=temp)
    dr = ModelDrafter(model, params) if drafter == "model" else None
    eng = _engine(model, params, speculate_k=4, drafter=dr, **kw)
    assert _run(eng, reqs, check=paged, temperature=temp) == want
    fp = eng.snapshot()["fastpath"]
    assert fp["spec_rounds"] > 0
    if drafter == "model" and temp == 0.0:
        assert fp["spec_accepted"] == fp["spec_drafted"]
    assert isinstance(eng.drafter, ModelDrafter if dr else NgramDrafter)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_greedy_equals_reference_engine(serve_case, paged):
    """The greedy speculative stream equals the reference engine's
    speculative stream on the same weights, request by request, with the
    same number of verify rounds, drafts and accepts."""
    jm, jp, model, params, reqs = serve_case
    kw = dict(n_slots=4, speculate_k=4, paged=paged, page_size=8)
    eng = _engine(model, params, **kw)
    got = _run(eng, reqs)
    ref = JaxEngine(jm, jp, **kw)
    assert got == _run(ref, reqs)
    keys = ("spec_rounds", "spec_drafted", "spec_accepted", "spec_emitted", "spec_rows")
    fp, jfp = eng.snapshot()["fastpath"], ref.snapshot()["fastpath"]
    assert {k: fp[k] for k in keys} == {k: jfp[k] for k in keys}


def test_engine_eos_truncates_mid_round(serve_case):
    """A row hitting EOS inside an accepted run stops there: tokens and
    finish reasons equal the sequential engine's."""
    _, _, model, params, reqs = serve_case
    runs = []
    for k in (1, 4):
        eng = _engine(model, params, n_slots=4, speculate_k=k)
        ids = [eng.submit(p, n, seed=i, eos_id=2) for i, (p, n) in enumerate(reqs)]
        eng.drain(max_steps=5000)
        runs.append([(f.tokens, f.finish_reason) for f in map(eng.result, ids)])
    assert any(reason == "eos" for _, reason in runs[0])
    assert runs[1] == runs[0]
    assert eng.snapshot()["fastpath"]["spec_rounds"] > 0


def test_engine_stands_down_for_deadlines(serve_case):
    """Any live deadline sends the engine back to single steps: zero
    verify rounds, the stream unchanged."""
    _, _, model, params, reqs = serve_case
    want = _run(_engine(model, params, n_slots=4), reqs)
    eng = _engine(model, params, n_slots=4, speculate_k=4)
    assert _run(eng, reqs, deadline_s=1e9) == want
    assert eng.snapshot()["fastpath"]["spec_rounds"] == 0


def test_engine_validation(serve_case):
    _, _, model, params, _ = serve_case
    with pytest.raises(ValueError, match="speculate_k"):
        _engine(model, params, n_slots=2, speculate_k=0)
    moe = MoETransformerLM(vocab=V, d_model=16, n_heads=4, n_layers=1, d_ff=32,
                           max_len=48, n_experts=4, k=2, device="cpu")
    moep = moe.init(1)
    with pytest.raises(ValueError, match="dense-FFN"):
        _engine(moe, moep, n_slots=2, speculate_k=4)
    _engine(moe, moep, n_slots=2, speculate_k=1)       # the feature is off
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _engine(model, params, n_slots=2, speculate_k=4,
                drafter=ModelDrafter(model, params), mesh=object())

    class Tenants:      # a multi-tenant draft model drafts per adapter
        n_adapters = 3
    assert ModelDrafter(Tenants(), params).model.n_adapters == 3
    with pytest.raises(ValueError, match="ModelDrafter"):
        _engine(model, params, n_slots=2, speculate_k=4).swap_params(
            params, drafter_params=params)


def test_scheduler_holds_back_reserved_pages():
    """``decide(reserve_pages=)``: the head admits only when its pages and
    the reservation both fit (the reference's cases)."""
    s = Scheduler()
    s.push(ServingRequest(request_id="q", prompt=np.zeros(4, np.int32), max_new=4))
    common = dict(free_slots=1, active_slots=3, free_pages=5, need_pages=4)
    assert s.decide(**common) == "prefill"
    assert s.decide(**common, reserve_pages=1) == "prefill"
    assert s.decide(**common, reserve_pages=2) == "decode"
    assert s.decide(**common, reserve_pages=-3) == "prefill"
    assert s.decide(free_slots=1, active_slots=0, reserve_pages=99) == "prefill"


def test_spec_reserve_pages_against_reference_and_decide(serve_case):
    """The port's and the reference's paged speculative engines, stepped in
    lockstep over one mix with a queue: at every step the reserve (from the
    host's write heads and page maps) is the same, it counts exactly the
    unowned pages of each live slot's ``pos .. pos + speculate_k - 1``,
    and it is what ``Scheduler.decide`` received."""
    jm, jp, model, params, reqs = serve_case
    kw = dict(n_slots=2, speculate_k=4, paged=True, page_size=8)
    eng, ref = _engine(model, params, **kw), JaxEngine(jm, jp, **kw)
    seen = []
    real = eng.scheduler.decide

    def decide(*a, **k):
        seen.append((k["free_pages"], k["reserve_pages"]))
        return real(*a, **k)
    eng.scheduler.decide = decide
    for e in (eng, ref):
        for i, (p, n) in enumerate(reqs):
            e.submit(p, n, seed=i)
    nonzero = 0
    while eng.scheduler.queue_depth or eng.kv.active_slots:
        r, jr = eng._spec_reserve_pages(), ref._spec_reserve_pages()
        assert r == jr
        want = sum(1 for s in eng._slot_req
                   for m in range(int(eng.kv.pos[s]) // 8,
                                  min((int(eng.kv.pos[s]) + 3) // 8, eng.kv.M - 1) + 1)
                   if m not in eng.kv.owned[s])
        assert r == want
        assert eng.step() == ref.step()
        free, reserve = seen[-1]
        assert reserve == (0 if free is None else r)
        nonzero += reserve > 0
    assert nonzero > 0
    assert [eng.result(f"req-{i}").tokens for i in range(4)] == \
        [ref.result(f"req-{i}").tokens for i in range(4)]


def test_paged_accepts_straddle_page_boundaries(serve_case):
    """``speculate_k=5`` on pages of 8 with a self-draft: accepted runs of
    up to 5 tokens cross page edges; the stream equals the sequential
    engine's and the pool checks after every step."""
    _, _, model, params, reqs = serve_case
    long = [(p, 20) for p, _ in reqs]
    kw = dict(n_slots=4, paged=True, page_size=8)
    want = _run(_engine(model, params, **kw), long)
    eng = _engine(model, params, speculate_k=5, drafter=ModelDrafter(model, params), **kw)
    seen = []
    real = eng._verify_fn

    def verify(params_, cache, drafts, tokens, pos, *rest):
        out = real(params_, cache, drafts, tokens, pos, *rest)
        seen.extend((int(a), int(b)) for a, b in zip(pos, out[3]) if b > a)
        return out
    eng._verify_fn = verify
    assert _run(eng, long, check=True) == want
    assert any(a // 8 != (b - 1) // 8 for a, b in seen), "no accepted run crossed a page"


def test_pages_exhausted_mid_window_preempts_before_launch(serve_case):
    """A pool too small for four requests' speculative windows: the engine
    allocates ``pos .. pos + W`` before each verify and preempts when
    short; the pool checks after every step, preemptions happen, and the
    tokens equal an unpressured sequential run's."""
    _, _, model, params, reqs = serve_case
    long = [(np.concatenate([p, p]), 24) for p, _ in reqs]
    want = _run(_engine(model, params, n_slots=4), long)
    eng = _engine(model, params, n_slots=4, paged=True, page_size=8,
                  pages_per_partition=13, prefix_cache=False, speculate_k=4)
    assert _run(eng, long, check=True) == want
    assert eng.kv.preemptions > 0
    assert eng.snapshot()["fastpath"]["spec_rounds"] > 0
    assert eng.kv.memory_stats()["pages_used"] == 0


def test_swap_params_drafter_stands_down_and_swaps_atomically(serve_case):
    """One request on a self-drafting engine: a swap without
    ``drafter_params`` stands the ModelDrafter down (single steps, no
    verify round while stale); a swap with them changes target and drafter
    together and speculation resumes. The tokens and their versions equal
    a sequential engine swapped after the same numbers of tokens."""
    _, _, model, params, reqs = serve_case
    p2 = TransformerLM(**CFG, device="cpu").init(7)
    prompt = reqs[1][0]
    eng = _engine(model, params, n_slots=1, speculate_k=4,
                  drafter=ModelDrafter(model, params))
    rid = eng.submit(prompt, 30)
    for _ in range(3):
        eng.step()
    at = [len(eng._requests[rid].generated)]
    eng.swap_params(p2)
    assert eng._drafter_stale
    rounds = eng.snapshot()["fastpath"]["spec_rounds"]
    for _ in range(3):
        assert eng.step() == "decode"
    assert eng.snapshot()["fastpath"]["spec_rounds"] == rounds
    at.append(len(eng._requests[rid].generated))
    assert at[1] == at[0] + 3
    eng.swap_params(params, drafter_params=params)
    assert not eng._drafter_stale and eng.drafter.params is params
    got = eng.drain(max_steps=5000)[rid]
    assert eng.snapshot()["fastpath"]["spec_rounds"] > rounds

    seq = _engine(model, params, n_slots=1)
    sid = seq.submit(prompt, 30)
    for n_tokens, weights in zip(at, (p2, params)):
        while len(seq._requests[sid].generated) < n_tokens:
            seq.step()
        seq.swap_params(weights)
    want = seq.drain(max_steps=5000)[sid]
    assert got.tokens == want.tokens
    assert got.token_versions == want.token_versions == (
        [0] * at[0] + [1] * 3 + [2] * (30 - at[1]))


def test_engine_stays_inside_the_cache_at_its_end(serve_case):
    """Requests that end exactly at ``max_len`` (the cache's last
    position): every verify keeps ``pos + W <= capacity - 1``, which the
    in-place row update needs, and the stream is the sequential one."""
    _, _, model, params, reqs = serve_case
    full = [(p, CFG["max_len"] - len(p)) for p, _ in reqs]
    want = _run(_engine(model, params, n_slots=4), full)
    eng = _engine(model, params, n_slots=4, speculate_k=5,
                  drafter=ModelDrafter(model, params))
    cap = eng.kv.capacity
    heads = []
    real = eng._verify_fn

    def verify(params_, cache, drafts, tokens, pos, temps, seeds, live, sampled):
        heads.append(int((pos + drafts.shape[1])[live].max()))
        return real(params_, cache, drafts, tokens, pos, temps, seeds, live, sampled)
    eng._verify_fn = verify
    assert _run(eng, full) == want
    assert max(heads) == cap - 2 and cap == CFG["max_len"]


def test_spec_metrics_identities(serve_case):
    """The ``fastpath`` spec section exists iff ``speculate_k > 1`` and its
    counters obey the accounting identities."""
    _, _, model, params, reqs = serve_case
    off = _engine(model, params, n_slots=4)
    _run(off, reqs)
    assert "spec_rounds" not in off.snapshot()["fastpath"]
    eng = _engine(model, params, n_slots=4, speculate_k=4)
    _run(eng, reqs)
    fp = eng.snapshot()["fastpath"]
    assert fp["spec_rounds"] > 0
    assert fp["spec_emitted"] == fp["spec_accepted"] + fp["spec_rows"]
    assert fp["spec_accepted"] <= fp["spec_drafted"] <= fp["spec_rows"] * 3
    assert fp["acceptance_rate"]["count"] == fp["spec_rounds"]
    assert fp["fused_blocks"] == 0


def test_no_wall_clock_reads_outside_perf_clock():
    from elephas_tpu_torch.serving import engine as engine_mod
    from elephas_tpu_torch.serving import metrics as metrics_mod
    for mod in (engine_mod, metrics_mod):
        assert "time.time(" not in Path(mod.__file__).read_text(), mod.__name__
