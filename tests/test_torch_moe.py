"""The port's mixture-of-experts layer (``elephas_tpu_torch/parallel/
expert.py``) and LM (``MoETransformerLM``) against the JAX package on the
same numpy inputs, on the CPU (the grouped-matmul executor runs its plain
versions there).

- Routing: ``_top_k_select``, ``_top_k_dispatch`` and ``_tile_layout``
  exactly equal on the same gates.
- Executors: ``apply_gmm``, ``apply_slots``, ``apply_grouped`` and
  ``apply_reference`` against the reference at its own pins (outputs atol
  1e-4, aux 1e-5, gradients atol 1e-2: tests/ops/test_grouped_matmul.py,
  tests/parallel/test_expert.py), across activations, biases, capacity
  factors, ``ep`` groups, unaligned token counts, a hungry expert and
  expert-choice routing.
- The LM: ``init`` bitwise equal from one seed (float32 and bfloat16 expert
  storage), ``apply_with_aux`` for every ``moe_dispatch``, 3-step Adam
  trajectories, the bf16-storage mirror, greedy serving (dense and paged)
  and ``generate`` against the JAX package.

Cross-framework routing: the router softmax may round differently in the
last bit, so the end-to-end cases use seeds whose gates have no near tie
at the capacity or top-k boundary (the assertions would show one as a
token or loss mismatch far beyond these tolerances)."""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elephas_tpu.models.transformer import MoETransformerLM as JaxMoE
from elephas_tpu.models.transformer import build_lm_train_step as jax_train_step
from elephas_tpu.models.transformer import build_mesh_sp, shard_lm_batch
from elephas_tpu.parallel import expert as JE
from elephas_tpu.serving import ServingEngine as JaxEngine
from elephas_tpu_torch.models import (MoETransformerLM, adam,
                                      build_lm_train_step, from_jax_params,
                                      make_lm_batches, to_numpy)
from elephas_tpu_torch.parallel import expert as TE
from elephas_tpu_torch.serving import ServingEngine

V = 13
LM = dict(vocab=V, d_model=16, n_heads=4, n_layers=2, d_ff=32, max_len=32,
          n_experts=8, k=2)
# the Mixtral shape at toy width; capacity E/k never binds (exact routing)
MIXTRAL = dict(LM, capacity_factor=4.0, aux_weight=0.02, activation="swiglu",
               ffn_bias=False, norm="rmsnorm", pos_encoding="rotary",
               n_kv_heads=2, rope_theta=1e6)


def _np(t):
    return t.detach().numpy()


def _moe_pair(act="swiglu", bias=False, cf=1.25, E=4, d=128, f=128, k=2,
              routing="token_choice", seed=0):
    """The same MoE layer in both packages, the port's params from the
    reference's init."""
    jm = JE.MoEFeedForward(d, f, E, k=k, capacity_factor=cf, activation=act,
                           bias=bias, routing=routing)
    np_params = jm.init(seed)
    tm = TE.MoEFeedForward(d, f, E, k=k, capacity_factor=cf, activation=act,
                           bias=bias, routing=routing)
    return (jm, {k_: jnp.asarray(v) for k_, v in np_params.items()},
            tm, from_jax_params(np_params, device="cpu"))


def _x(n, d=128, seed=4):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _gates(n, e, seed):
    logits = np.random.default_rng(seed).standard_normal((n, e)).astype(np.float32)
    g = np.exp(logits - logits.max(-1, keepdims=True))
    return (g / g.sum(-1, keepdims=True)).astype(np.float32)


# -- routing -----------------------------------------------------------------


@pytest.mark.parametrize("n,e,k,cap", [(64, 8, 2, 20), (37, 3, 1, 5),
                                       (50, 8, 3, 40)])
def test_routing_and_tile_layout_match_jax_exactly(n, e, k, cap):
    """Same gates in, the same decisions out: expert ids, queue slots,
    combine weights and first-choice counts bit for bit (the integer
    cumsum against the reference's exact float cumsum of one-hots), the
    one-hot dispatch/combine tensors, and every array of the tile layout."""
    g = _gates(n, e, seed=n + k)
    je, js, jc, (jc1, jgs) = jax.jit(JE._top_k_select, static_argnums=(1, 2))(
        jnp.asarray(g), cap, k)
    te, ts, tc, (tc1, tgs) = TE._top_k_select(torch.from_numpy(g), cap, k)
    np.testing.assert_array_equal(_np(te), np.asarray(je))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(_np(tc1), np.asarray(jc1))
    np.testing.assert_allclose(_np(tgs), np.asarray(jgs), rtol=1e-6)
    jd, jcomb, _ = jax.jit(JE._top_k_dispatch, static_argnums=(1, 2))(
        jnp.asarray(g), cap, k)
    td, tcomb, _ = TE._top_k_dispatch(torch.from_numpy(g), cap, k)
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    np.testing.assert_array_equal(_np(tcomb), np.asarray(jcomb))
    for tm in (8, 128):
        jmoe = JE.MoEFeedForward(8, 8, e, k=k)
        tmoe = TE.MoEFeedForward(8, 8, e, k=k)
        got = tmoe._tile_layout(te, ts, n, tm)
        want = jax.jit(jmoe._tile_layout, static_argnums=(2, 3))(je, js, n, tm)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        assert got[3].dtype == torch.int32
        assert bool((got[3][1:] >= got[3][:-1]).all())      # non-decreasing


# -- executors ---------------------------------------------------------------


@pytest.mark.parametrize("act,bias,cf", [
    ("swiglu", False, 1.25),   # the Mixtral expert shape
    ("relu", True, 0.5),       # heavy drops: capacity keeps must agree
    ("gelu", False, 2.0),
])
def test_apply_gmm_matches_jax(act, bias, cf):
    jm, jp, tm, tp = _moe_pair(act, bias, cf)
    jx, tx = _x(256)
    y, aux = tm.apply_gmm(tp, tx)
    assert y.dtype == torch.float32 and y.shape == (256, 128)
    for fn in (jm.apply_gmm, jm.apply_reference):
        jy, jaux = jax.jit(fn)(jp, jx)
        np.testing.assert_allclose(_np(y), np.asarray(jy), atol=1e-4)
        assert abs(float(aux) - float(jaux)) < 1e-5
    ry, raux = tm.apply_reference(tp, tx)
    np.testing.assert_allclose(_np(y), _np(ry), atol=1e-4)


@pytest.mark.parametrize("executor", ["apply_gmm", "apply_slots", "apply_grouped",
                                      "apply_reference"])
def test_executors_with_ep_groups_match_jax(executor):
    """``ep=4`` dispatch groups, each with its own capacity (cf 1.0 binds)."""
    jm, jp, tm, tp = _moe_pair(cf=1.0)
    jx, tx = _x(256, seed=6)
    y, aux = getattr(tm, executor)(tp, tx, ep=4)
    jy, jaux = jax.jit(lambda p, x: jm.apply_reference(p, x, ep=4))(jp, jx)
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=1e-4)
    assert abs(float(aux) - float(jaux)) < 1e-5


@pytest.mark.parametrize("n,E", [(100, 4), (100, 8), (96, 3)])
def test_apply_gmm_unaligned_token_counts(n, E):
    """k·N not a multiple of the row tile: the buffer rounds up to a whole
    tile (the reference's regression case)."""
    jm, jp, tm, tp = _moe_pair(E=E)
    jx, tx = _x(n, seed=8)
    y, aux = tm.apply_gmm(tp, tx)
    jy, jaux = jax.jit(jm.apply_reference)(jp, jx)
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=1e-4)
    assert abs(float(aux) - float(jaux)) < 1e-5


def test_apply_gmm_hungry_expert_and_gradients():
    """A router biased so expert 3 is never chosen (its tile is all
    sentinel rows): forward against the reference, and the gradients of
    ``sum(y²) + aux`` against the reference's ``apply_gmm`` and one-hot
    oracle (atol 1e-2, the reference's pin); the hungry expert's weight
    gradients are exactly zero."""
    jm, jp, tm, tp = _moe_pair()
    wg = np.zeros((128, 4), np.float32)
    wg[:, :3] = np.random.default_rng(9).standard_normal((128, 3)) * 0.1
    wg[0, 3] = -30.0                  # with x[:, 0] = 1: logit -30 on every row
    jp["wg"], tp["wg"] = jnp.asarray(wg), torch.from_numpy(wg)
    x = np.random.default_rng(7).standard_normal((256, 128)).astype(np.float32)
    x[:, 0] = 1.0
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    y, aux = tm.apply_gmm(tp, tx)
    jy, jaux = jax.jit(jm.apply_reference)(jp, jx)
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=1e-4)

    leaves = {k_: v.clone().requires_grad_() for k_, v in tp.items()}
    y, aux = tm.apply_gmm(leaves, tx)
    ((y ** 2).sum() + aux).backward()
    for fn in (jm.apply_gmm, jm.apply_reference):
        jg = jax.jit(jax.grad(
            lambda p: jnp.sum(fn(p, jx)[0] ** 2) + fn(p, jx)[1]))(jp)
        for k_ in jg:
            np.testing.assert_allclose(_np(leaves[k_].grad), np.asarray(jg[k_]),
                                       atol=1e-2, err_msg=k_)
    for k_ in ("w1", "w2", "w3"):
        assert bool((leaves[k_].grad[3] == 0).all())


@pytest.mark.parametrize("executor", ["apply_slots", "apply_grouped"])
@pytest.mark.parametrize("act,bias,cf,k,ep", [
    ("relu", True, 1.5, 2, 1), ("swiglu", False, 0.5, 2, 2),
    ("gelu", True, 2.0, 1, 4)])
def test_slots_and_grouped_match_jax(executor, act, bias, cf, k, ep):
    jm, jp, tm, tp = _moe_pair(act, bias, cf, E=8, d=16, f=32, k=k)
    jx, tx = _x(64, d=16, seed=10)
    y, aux = getattr(tm, executor)(tp, tx, ep=ep)
    jy, jaux = jax.jit(lambda p, x: getattr(jm, executor)(p, x, ep=ep))(jp, jx)
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=1e-4)
    assert abs(float(aux) - float(jaux)) < 1e-5


@pytest.mark.parametrize("executor", ["apply_slots", "apply_grouped", "apply_gmm"])
def test_executor_gradients_match_jax_oracle(executor):
    """The gather-only backwards of the slot and grouped-matmul executors
    and autograd through the sort: gradients of ``sum(y²) + aux`` against
    the reference's one-hot oracle, atol 1e-2."""
    jm, jp, tm, tp = _moe_pair("relu", True, 1.25, E=8, d=16, f=32)
    jx, tx = _x(64, d=16, seed=11)
    leaves = {k_: v.clone().requires_grad_() for k_, v in tp.items()}
    xl = tx.clone().requires_grad_()
    y, aux = getattr(tm, executor)(leaves, xl, ep=2)
    ((y ** 2).sum() + aux).backward()

    def loss(p, x):
        yy, aa = jm.apply_reference(p, x, ep=2)
        return jnp.sum(yy ** 2) + aa

    jg, jgx = jax.jit(jax.grad(loss, (0, 1)))(jp, jx)
    for k_ in jg:
        np.testing.assert_allclose(_np(leaves[k_].grad), np.asarray(jg[k_]),
                                   atol=1e-2, err_msg=k_)
    np.testing.assert_allclose(_np(xl.grad), np.asarray(jgx), atol=1e-2)


@pytest.mark.parametrize("ep", [1, 2])
def test_expert_choice_apply_reference_matches_jax(ep):
    jm, jp, tm, tp = _moe_pair("relu", True, 1.0, E=8, d=8, f=16,
                               routing="expert_choice", seed=1)
    jx, tx = _x(64, d=8, seed=12)
    y, aux = tm.apply_reference(tp, tx, ep=ep)
    jy, jaux = jax.jit(lambda p, x: jm.apply_reference(p, x, ep=ep))(jp, jx)
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=1e-5)
    assert float(aux) == float(jaux) == 0.0
    for executor in ("apply_gmm", "apply_slots", "apply_grouped"):
        with pytest.raises(ValueError, match="token_choice"):
            getattr(tm, executor)(tp, tx)


def test_sharded_members_raise_naming_the_roadmap():
    _, _, tm, tp = _moe_pair()
    _, tx = _x(8)
    for call in (lambda: tm.apply(tp, tx), lambda: tm.apply_partial(tp, tx, 2, 0),
                 tm.specs, lambda: tm.shard_params(None, tp), TE.build_mesh_ep,
                 TE.build_ep_train_step):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


# -- the LM --------------------------------------------------------------------


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_bitwise_equal_to_jax(param_dtype):
    """One seed, the same weights: names, order, shapes, dtypes and bits;
    ``from_jax_params``/``to_numpy`` carry bf16 expert stacks both ways."""
    jm = JaxMoE(**MIXTRAL, param_dtype=param_dtype)
    tm = MoETransformerLM(**MIXTRAL, param_dtype=param_dtype, device="cpu")
    jp, tp = jm.init(3), tm.init(3)
    assert list(tp) == list(jp)
    conv = from_jax_params(jp, device="cpu")
    back = to_numpy(tp)
    for k_ in jp:
        assert tp[k_].dtype == conv[k_].dtype, k_
        assert torch.equal(tp[k_], conv[k_]), k_
        assert back[k_].dtype == np.asarray(jp[k_]).dtype, k_
        np.testing.assert_array_equal(back[k_].view(np.uint8),
                                      np.asarray(jp[k_]).view(np.uint8), err_msg=k_)
    want = torch.bfloat16 if param_dtype == "bfloat16" else torch.float32
    assert tp["w1"].dtype == want and tp["wg"].dtype == torch.float32


def _lm_pair(dispatch, seed=3, **kw):
    cfg = dict(MIXTRAL, moe_dispatch=dispatch, **kw)
    jm = JaxMoE(**cfg)
    np_params = jm.init(seed)
    return (jm, {k_: jnp.asarray(v) for k_, v in np_params.items()},
            MoETransformerLM(**cfg, device="cpu"),
            from_jax_params(np_params, device="cpu"))


def _tokens(b=4, t=32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, V, size=(b, t)), np.broadcast_to(np.arange(t), (b, t)).copy()


@pytest.mark.parametrize("dispatch", ["gmm", "slots", "ragged", "onehot"])
def test_apply_with_aux_matches_jax(dispatch):
    """Teacher-forced logits and the summed aux: the dense path with two
    dispatch groups per sequence against the reference's dense path; for
    the main path ("gmm") also the flash path (the whole block one group)
    against the reference's dense path at ``ep_groups=1``, the same
    routing."""
    tok, pos = _tokens()
    cases = ((2, "dense"), (1, "flash")) if dispatch == "gmm" else ((2, "dense"),)
    for groups, attn in cases:
        jm, jp, tm, tp = _lm_pair(dispatch, ep_groups=groups)
        jl, ja = jax.jit(lambda p, t, q: jm.apply_with_aux(p, t, q, attn="dense"))(
            jp, jnp.asarray(tok), jnp.asarray(pos))
        tl, ta = tm.apply_with_aux(tp, tok, pos, attn=attn)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-4, rtol=1e-4)
        assert abs(float(ta) - float(ja)) < 1e-5
        assert float(ta) > 0


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    start = rng.integers(0, V, size=(4, 1))
    return make_lm_batches((start + np.arange(33)) % V)


@pytest.mark.parametrize("dispatch", ["gmm", "slots"])
def test_train_trajectory_matches_jax(dispatch):
    """Three Adam steps at lr 1e-2 under ``attn="flash"``, the port's
    ``adam`` against ``optax.adam`` from the same weights, losses within
    rtol 5e-4: the pin the reference holds its own single-device
    dispatch modes to each other at (tests/models/test_moe_transformer.py),
    since the routing is identical and only float32 sums move."""
    cfg = dict(LM, capacity_factor=1.25, ep_groups=1, moe_dispatch=dispatch)
    jm = JaxMoE(**cfg)
    np_params = jm.init(3)
    batch = _batch()
    mesh = build_mesh_sp(data=1, seq=1)
    jstep, jinit = jax_train_step(jm, mesh, optax.adam(1e-2), attn="flash")
    jparams = jm.shard_params(mesh, np_params)
    jstate = jinit(jparams)
    jb = shard_lm_batch(mesh, *batch)
    tm = MoETransformerLM(**cfg, device="cpu")
    step, opt_init = build_lm_train_step(tm, None, adam(1e-2), attn="flash")
    params = from_jax_params(np_params, device="cpu")
    state = opt_init(params)
    got, want = [], []
    for _ in range(3):
        jparams, jstate, jl = jstep(jparams, jstate, *jb)
        params, state, loss = step(params, state, *batch)
        want.append(float(jl))
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-5)
    assert got[-1] < got[0]


def test_bf16_param_storage_tracks_f32_trajectory():
    """The mirror of the reference's bf16-storage test: expert stacks stay
    bf16 through the step, the router float32, and four steps track float32
    storage within rtol 1e-1 and learn."""
    cfg = dict(LM, capacity_factor=1.25, ep_groups=1, activation="swiglu",
               ffn_bias=False)
    batch = _batch()
    losses = {}
    for pd in ("float32", "bfloat16"):
        model = MoETransformerLM(**cfg, param_dtype=pd, device="cpu")
        step, opt_init = build_lm_train_step(model, None, adam(1e-2), attn="flash")
        params = model.init(3)
        state = opt_init(params)
        ls = []
        for _ in range(4):
            params, state, loss = step(params, state, *batch)
            ls.append(float(loss))
        if pd == "bfloat16":
            assert params["w1"].dtype == torch.bfloat16
            assert params["wg"].dtype == torch.float32
        losses[pd] = ls
    np.testing.assert_allclose(losses["bfloat16"], losses["float32"], rtol=1e-1)
    assert losses["bfloat16"][-1] < losses["bfloat16"][0]


def _requests(n=6, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, V, size=int(t)).astype(np.int32), int(m))
            for t, m in zip(rng.integers(2, 12, size=n), rng.integers(3, 8, size=n))]


def _drain(eng, reqs):
    ids = [eng.submit(p, m) for p, m in reqs]
    fin = eng.drain(max_steps=2000)
    return [list(fin[i].tokens) for i in ids]


def test_engine_greedy_tokens_match_jax_engine():
    """Six mixed requests through four slots (``moe_dispatch="gmm"``): the
    port's engine against the reference's engine on the same weights, and
    every emitted position's top-2 logit margin above 1e-5, so a mismatch
    could not be a near tie."""
    jm, jp, tm, tp = _lm_pair("gmm")
    reqs = _requests()
    want = _drain(JaxEngine(jm, jp, n_slots=4), reqs)
    got = _drain(ServingEngine(tm, tp, n_slots=4, device="cpu"), reqs)
    assert got == want
    for (prompt, _), toks in zip(reqs, got):
        seq = np.concatenate([prompt, toks]).astype(np.int64)
        logits, _ = tm.decode_chunk(tp, torch.from_numpy(seq)[None], 0,
                                    tm.init_cache(1, len(seq)))
        top = torch.topk(logits[0, len(prompt) - 1:-1], 2, dim=-1).values
        assert float((top[:, 0] - top[:, 1]).min()) > 1e-5


@pytest.mark.parametrize("dispatch", ["gmm", "slots"])
def test_paged_engine_equals_dense_bitwise(dispatch):
    """On the CPU the paged layer body and the dense one run the same plain
    attention and the same expert FFN: equal tokens, and one decode step's
    logits bitwise equal through the pool and through the dense cache."""
    _, _, tm, tp = _lm_pair(dispatch)
    reqs = _requests(seed=2)
    dense = _drain(ServingEngine(tm, tp, n_slots=4, device="cpu"), reqs)
    paged = ServingEngine(tm, tp, n_slots=4, paged=True, page_size=8, device="cpu")
    assert _drain(paged, reqs) == dense
    paged.kv.check()
    tok = torch.tensor([3, 5], dtype=torch.int64)
    pos = torch.tensor([6, 9], dtype=torch.int64)
    cache = tm.init_cache(2, 32)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, V, size=(2, 10)))
    _, cache = tm.decode_chunk(tp, prompt, 0, cache)
    ld, _ = tm.decode_step(tp, tok, pos, cache)
    page = 8
    P = 2 * 4 + 1
    pool = {n: torch.zeros((tm.n_layers, P, tm.n_kv_heads, page,
                            tm.d_model // tm.n_heads)) for n in ("k", "v")}
    table = (1 + torch.arange(8, dtype=torch.int32)).reshape(2, 4)
    _, pool = tm.decode_chunk_paged(tp, prompt, 0, pool, table, page)
    lp, _ = tm.decode_step_paged(tp, tok, pos, pool, table, page)
    assert torch.equal(ld, lp)


def test_generate_matches_jax_generate():
    jm, jp, tm, tp = _lm_pair("gmm")
    prompt = np.random.default_rng(5).integers(0, V, size=(3, 6))
    want = np.asarray(jm.generate(jp, jnp.asarray(prompt), 8))
    got = tm.generate(tp, prompt, 8)
    np.testing.assert_array_equal(got.numpy(), want)
