"""The port's grouped matmul (``elephas_tpu_torch/ops/grouped_matmul.py``) on
CPU tensors, where ``gmm``, ``gmm_t`` and ``tgmm`` run their plain versions:
against the JAX package's Pallas kernels in interpret mode at the cases of
``tests/ops/test_grouped_matmul.py`` and its ATOL of 5e-2 (XLA:CPU's matmuls
take bf16 fast paths there), forward and gradients; against a float64 numpy
oracle at ``max |diff| / max |ref| <= 1e-5`` (float32 sums over K <= 512);
empty groups, ragged K and N, bfloat16 inputs, and the dispatch by device.
The CUDA kernels are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

The signatures are the reference's, ``interpret`` last (compared through
``jax.custom_vjp``'s ``.fun``), and a reference-shaped positional call gives
the reference's result. The tensor-core K6-gmm's float32 arithmetic is
emulated here: 3xTF32 products (``tf32``/``_split`` of
``tests/test_torch_flash_tf32x3.py``), each 8-deep ``mma`` step added to
its accumulator with the rounding toward zero the tensor cores apply, and
each 32-deep stage of the contraction summed in a fresh accumulator and
added to the float32 sum once. At contraction 4096 and 14336 that holds
the float32 pin (2e-5, max |diff| / max |plain|) against the plain
version; a single TF32 product, or one accumulator over the whole
contraction, misses it. The tensor-core K6-tgmm's arithmetic too: the same
3xTF32 steps over an expert's rows, both operands read transposed, a fresh
accumulator for each 32-row stage, at 1152 rows (one expert's share of the
MoE training step) and 9216 (every row on one expert); and for bf16 inputs
with a float32 output, exact products, each 16-deep step added toward zero,
a fresh accumulator for each 64-row stage, held to the same float32 pin."""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.ops import grouped_matmul as JG
from elephas_tpu_torch.ops import grouped_matmul as G
from tests.test_torch_flash_tf32x3 import _split

ATOL = 5e-2
ORACLE_TOL = 1e-5
# (M, K, N, E, gmap): the reference tests' shapes, tm = M // len(gmap)
CASES = [(768, 256, 128, 4, [0, 1, 1, 2, 3, 3]),
         (512, 512, 128, 4, [0, 1, 2, 3])]


def _case(M, K, N, E, gmap, seed=0):
    rng = np.random.default_rng(seed)
    lhs = rng.standard_normal((M, K)).astype(np.float32)
    rhs = rng.standard_normal((E, K, N)).astype(np.float32)
    return lhs, rhs, np.asarray(gmap, np.int32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _oracle_gmm(lhs, rhs, gmap, transpose=False):
    tm = lhs.shape[0] // len(gmap)
    out = []
    for t, e in enumerate(gmap):
        w = rhs[e].T if transpose else rhs[e]
        out.append(lhs[t * tm:(t + 1) * tm].astype(np.float64) @ w.astype(np.float64))
    return np.concatenate(out)


def _oracle_tgmm(lhs, g, gmap, E):
    tm = lhs.shape[0] // len(gmap)
    out = np.zeros((E, lhs.shape[1], g.shape[1]))
    for t, e in enumerate(gmap):
        rows = slice(t * tm, (t + 1) * tm)
        out[e] += lhs[rows].astype(np.float64).T @ g[rows].astype(np.float64)
    return out


def _close_to_oracle(got, want):
    got = got.detach().to(torch.float64).numpy()
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= ORACLE_TOL, err


def test_gmm_and_gmm_t_match_jax_kernels():
    lhs, rhs, gmap = _case(*CASES[0])
    rhs_t = np.random.default_rng(1).standard_normal((4, 128, 256)).astype(np.float32)
    jl, jr, jrt, jg = (jnp.asarray(a) for a in (lhs, rhs, rhs_t, gmap))
    tl, tr, trt, tg = _t(lhs, rhs, rhs_t, gmap)
    got = G.gmm(tl, tr, tg)
    assert got.shape == (768, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(JG.gmm(jl, jr, jg, True)),
                               atol=ATOL)
    np.testing.assert_allclose(G.gmm_t(tl, trt, tg).numpy(),
                               np.asarray(JG.gmm_t(jl, jrt, jg, True)), atol=ATOL)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fn", ["gmm", "gmm_t"])
def test_gradients_match_jax(case, fn):
    """``sum(sin(f(lhs, rhs)))`` differentiated: the port's autograd
    Functions (gmm_t/gmm + tgmm in the backward) against the reference's
    custom VJP over its interpret-mode kernels."""
    lhs, rhs, gmap = _case(*case)
    if fn == "gmm_t":
        rhs = np.ascontiguousarray(rhs.transpose(0, 2, 1))
    jfn = getattr(JG, fn)
    jgl, jgr = jax.jit(jax.grad(
        lambda l, r: jnp.sum(jnp.sin(jfn(l, r, jnp.asarray(gmap), True))),
        (0, 1)))(jnp.asarray(lhs), jnp.asarray(rhs))
    tl, tr = (torch.from_numpy(a).requires_grad_() for a in (lhs, rhs))
    torch.sin(getattr(G, fn)(tl, tr, torch.from_numpy(gmap))).sum().backward()
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jgl), atol=ATOL)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(jgr), atol=ATOL)


def test_tgmm_matches_jax_and_zeroes_empty_groups():
    """The reference's case: group 2 is empty but owns one all-sentinel
    tile; its gradient must come out exactly zero."""
    M, K, N, E = 768, 256, 128, 4
    rng = np.random.default_rng(2)
    lhs = np.zeros((M, K), np.float32)
    g = np.zeros((M, N), np.float32)
    fill = rng.standard_normal
    lhs[:192], g[:192] = fill((192, K)), fill((192, N))
    lhs[256:512], g[256:512] = fill((256, K)), fill((256, N))
    lhs[640:768], g[640:768] = fill((128, K)), fill((128, N))
    gmap = np.asarray([0, 0, 1, 1, 2, 3], np.int32)
    got = G.tgmm(*_t(lhs, g, gmap), E)
    assert got.shape == (E, K, N) and got.dtype == torch.float32
    want = JG.tgmm(jnp.asarray(lhs), jnp.asarray(g), jnp.asarray(gmap), E,
                   jnp.float32, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    _close_to_oracle(got, _oracle_tgmm(lhs, g, gmap, E))
    assert bool((got[2] == 0).all())
    # a group with no tile at all (E larger than any gmap entry) is zero too
    wide = G.tgmm(*_t(lhs, g, gmap), E + 2)
    assert bool((wide[E:] == 0).all())
    torch.testing.assert_close(wide[:E], got, rtol=0, atol=0)


@pytest.mark.parametrize("M,K,N,E,gmap", CASES + [(640, 200, 100, 3, [0, 0, 2, 2, 2])])
def test_plain_versions_match_float64_oracle(M, K, N, E, gmap):
    lhs, rhs, gmap = _case(M, K, N, E, gmap, seed=3)
    rhs_t = np.ascontiguousarray(rhs.transpose(0, 2, 1))
    g = np.random.default_rng(4).standard_normal((M, N)).astype(np.float32)
    tl, tr, trt, tgm, tg = _t(lhs, rhs, rhs_t, gmap, g)
    _close_to_oracle(G.gmm(tl, tr, tgm), _oracle_gmm(lhs, rhs, gmap))
    _close_to_oracle(G.gmm_t(tl, trt, tgm), _oracle_gmm(lhs, rhs_t, gmap, True))
    _close_to_oracle(G.tgmm(tl, tg, tgm, E), _oracle_tgmm(lhs, g, gmap, E))


def test_ragged_k_and_n_match_jax_reference():
    """K 200 and N 100 split into no 128-lane tile: the reference falls back
    to its jnp oracle there, the port's kernels mask the edges."""
    lhs, rhs, gmap = _case(384, 200, 100, 2, [0, 1, 1])
    got = G.gmm(*_t(lhs, rhs, gmap))
    want = JG.gmm_reference(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(gmap))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    g = np.random.default_rng(5).standard_normal((384, 100)).astype(np.float32)
    got = G.tgmm(*_t(lhs, g, gmap), 2)
    want = JG.tgmm_reference(jnp.asarray(lhs), jnp.asarray(g), jnp.asarray(gmap), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_bf16_inputs_accumulate_in_float32():
    """bf16 operands: the product sums in float32 and rounds once to bf16,
    as the reference's ``preferred_element_type`` path; ``tgmm`` returns
    ``out_dtype``."""
    lhs, rhs, gmap = _case(256, 256, 128, 2, [0, 1])
    tl, tr = (torch.from_numpy(a).to(torch.bfloat16) for a in (lhs, rhs))
    tgm = torch.from_numpy(gmap)
    got = G.gmm(tl, tr, tgm)
    assert got.dtype == torch.bfloat16
    want = _oracle_gmm(tl.float().numpy(), tr.float().numpy(), gmap)
    torch.testing.assert_close(got, torch.from_numpy(want).to(torch.bfloat16),
                               rtol=0, atol=0)
    jwant = JG.gmm_reference(jnp.asarray(lhs, jnp.bfloat16),
                             jnp.asarray(rhs, jnp.bfloat16), jnp.asarray(gmap))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jwant).astype(np.float32), rtol=2e-2, atol=ATOL)
    out = G.tgmm(tl, tl, tgm, 2, torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 256, 256)


def test_cpu_tensors_take_the_plain_path_and_never_count():
    """A CPU tensor runs the plain version and counts no launch; the kernel
    launchers refuse anything not on a CUDA device (no quiet fallback)."""
    lhs, rhs, gmap = _t(*_case(256, 128, 128, 2, [0, 1]))
    before = (G.gmm.launches, G.gmm_t.launches, G.tgmm.launches)
    G.gmm(lhs, rhs, gmap)
    G.gmm_t(lhs, rhs.transpose(1, 2), gmap)
    G.tgmm(lhs, lhs, gmap, 2)
    assert (G.gmm.launches, G.gmm_t.launches, G.tgmm.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        G._launch_gmm(lhs, rhs, gmap, False)
    with pytest.raises(ValueError, match="CUDA"):
        G._launch_tgmm(lhs, lhs, gmap, 2, torch.float32)
    with pytest.raises(ValueError, match="tiles"):
        G.gmm(lhs[:201], rhs, gmap)


# -- the reference's signatures: interpret last ---------------------------------------


def _params(fn):
    fn = getattr(fn, "fun", fn)   # jax.custom_vjp keeps the function in .fun
    return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", ["gmm", "gmm_t", "tgmm"])
def test_signature_matches_reference(name):
    """Names, order and defaults of every parameter, ``interpret`` last, as
    the reference's (its ``gmm`` and ``gmm_t`` are ``jax.custom_vjp``
    objects: compared through ``.fun``). ``out_dtype``'s default is each
    framework's float32."""
    port, ref = _params(getattr(G, name)), _params(getattr(JG, name))
    assert [p for p, _ in port] == [p for p, _ in ref]
    assert [d for p, d in port if p != "out_dtype"] == [d for p, d in ref if p != "out_dtype"]


@pytest.mark.parametrize("fn", ["gmm", "gmm_t"])
def test_positional_interpret_matches_jax_kernel(fn):
    """``gmm(lhs, rhs, gmap, interpret)`` by position, as the reference
    calls it: the reference's Pallas kernel in interpret mode and the
    port's product agree (forward and gradients); ``interpret=False`` by
    keyword is taken too."""
    lhs, rhs, gmap = _case(*CASES[0], seed=7)
    if fn == "gmm_t":
        rhs = np.ascontiguousarray(rhs.transpose(0, 2, 1))
    jl, jr, jg = (jnp.asarray(a) for a in (lhs, rhs, gmap))
    want = np.asarray(getattr(JG, fn)(jl, jr, jg, True))
    tl, tr = (torch.from_numpy(a).requires_grad_() for a in (lhs, rhs))
    tg = torch.from_numpy(gmap)
    got = getattr(G, fn)(tl, tr, tg, True)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
    np.testing.assert_allclose(getattr(G, fn)(tl, tr, tg, interpret=False).detach().numpy(),
                               got.detach().numpy(), rtol=0, atol=0)
    jgl, jgr = jax.grad(lambda l, r: jnp.sum(jnp.sin(getattr(JG, fn)(l, r, jg, True))),
                        (0, 1))(jl, jr)
    torch.sin(got).sum().backward()
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jgl), atol=ATOL)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(jgr), atol=ATOL)


def test_tgmm_positional_interpret_matches_jax_kernel():
    """The reference's own positional call, ``tgmm(lhs, g, gmap, n_groups,
    dtype, interpret)`` (``parallel/expert.py:210``), in both packages."""
    lhs, _, gmap = _case(*CASES[1], seed=8)
    g = np.random.default_rng(9).standard_normal((lhs.shape[0], 128)).astype(np.float32)
    want = JG.tgmm(jnp.asarray(lhs), jnp.asarray(g), jnp.asarray(gmap), 4,
                   jnp.float32, True)
    got = G.tgmm(*_t(lhs, g, gmap), 4, torch.float32, True)
    assert got.dtype == torch.float32 and got.shape == (4, 512, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# -- the tensor-core K6-gmm's arithmetic, emulated ------------------------------------

PIN = 2e-5
STRETCH = 32    # the contraction summed in one fresh accumulator: a float32 stage


def _toward_zero(x64):
    """float64 to float32, rounded toward zero (the accumulation of an
    ``mma``)."""
    y = x64.to(torch.float32)
    return torch.where(y.double().abs() > x64.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def emulated_gmm(a, b, passes, stretch, step=8):
    """``a @ b`` (float32 ``[M, K] @ [K, N]``) as the kernel computes it:
    ``passes=3`` is 3xTF32 (small*big, big*small, big*big, in that order),
    ``passes=1`` one TF32 product, ``passes=0`` the operands as they are
    (bf16 values: exact products); each ``step``-deep ``mma`` step's exact
    product (8 for TF32, 16 for bf16) added to the accumulator toward zero;
    each ``stretch`` of the contraction in a fresh accumulator, added to the
    float32 sum once."""
    if passes:
        ab, as_ = _split(a)
        bb, bs = _split(b)
        pairs = [(as_, bb), (ab, bs), (ab, bb)] if passes == 3 else [(ab, bb)]
    else:
        pairs = [(a, b)]
    pairs = [(x.double(), y.double()) for x, y in pairs]
    K = a.shape[1]
    out = torch.zeros(a.shape[0], b.shape[1])
    for c0 in range(0, K, stretch):
        d = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float64)
        for k0 in range(c0, min(c0 + stretch, K), step):
            for x, y in pairs:
                d = _toward_zero(d + x[:, k0:k0 + step] @ y[k0:k0 + step]).double()
        out = out + d.float()
    return out


def emulated_tgmm(lhs, g, gmap, n_groups, passes, stretch, step=8):
    """``tgmm(lhs, g, gmap, n_groups)`` as K6-tgmm computes it: for each
    expert, ``emulated_gmm`` of its rows with both operands read transposed
    (``A(i, p) = lhs[p, i]``, ``B(p, j) = g[p, j]``), the contraction over
    the rows; zero for an expert with no tile."""
    tm = lhs.shape[0] // gmap.numel()
    out = torch.zeros(n_groups, lhs.shape[1], g.shape[1])
    for e, t0, t1 in G._runs(gmap):
        rows = slice(t0 * tm, t1 * tm)
        out[e] = emulated_gmm(lhs[rows].T, g[rows], passes, stretch, step)
    return out


def _emulation_case(K, seed):
    """One 128-row tile of the w2-shaped product: lhs N(0, 1), weights
    glorot-uniform as the MoE layer draws them, 32 output columns."""
    rng = np.random.default_rng(seed)
    lhs = rng.standard_normal((128, K)).astype(np.float32)
    limit = (6.0 / (K + 32)) ** 0.5
    w = ((rng.random((1, K, 32)) * 2 - 1) * limit).astype(np.float32)
    return torch.from_numpy(lhs), torch.from_numpy(w)


def _rel(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.mark.parametrize("K", [4096, 14336])
def test_3xtf32_stretches_hold_the_float32_pin(K):
    """The kernel's float32 arithmetic (3xTF32, fresh accumulators every 32
    of the contraction) within 2e-5 of the plain version; one TF32 product
    misses the pin, and so does one accumulator over the whole contraction
    (the rounding toward zero adds up)."""
    lhs, w = _emulation_case(K, seed=K)
    gmap = torch.zeros(1, dtype=torch.int32)
    plain = G.gmm(lhs, w, gmap)
    assert _rel(emulated_gmm(lhs, w[0], 3, STRETCH), plain) <= PIN
    assert _rel(emulated_gmm(lhs, w[0], 1, STRETCH), plain) > PIN
    assert _rel(emulated_gmm(lhs, w[0], 3, K), plain) > PIN


def test_3xtf32_emulation_reads_gmm_t_weights_transposed():
    """gmm_t's weights ``[E, N, K]`` read transposed give the same emulated
    product as gmm's ``[E, K, N]``: the kernel's two B layouts hold the same
    numbers, and the pin holds through ``gmm_t``'s plain version."""
    lhs, w = _emulation_case(4096, seed=3)
    gmap = torch.zeros(1, dtype=torch.int32)
    w_t = w.transpose(1, 2).contiguous()
    emulated = emulated_gmm(lhs, w_t[0].T, 3, STRETCH)
    assert torch.equal(emulated, emulated_gmm(lhs, w[0], 3, STRETCH))
    assert _rel(emulated, G.gmm_t(lhs, w_t, gmap)) <= PIN


def _tgmm_case(rows, seed):
    """``rows`` rows on expert 0 and one 128-row tile on expert 1 of 3
    (expert 2 has none): lhs ``[., 128]`` and g ``[., 32]`` N(0, 1), as the
    MoE training step's gathered tokens and cotangents."""
    rng = np.random.default_rng(seed)
    M = rows + 128
    lhs = torch.from_numpy(rng.standard_normal((M, 128)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((M, 32)).astype(np.float32))
    gmap = torch.tensor([0] * (rows // 128) + [1], dtype=torch.int32)
    return lhs, g, gmap


@pytest.mark.parametrize("rows", [1152, 9216])
def test_tgmm_3xtf32_stages_hold_the_float32_pin(rows):
    """K6-tgmm's float32 arithmetic (3xTF32 over the expert's rows, a fresh
    accumulator for each 32-row stage) within 2e-5 of the plain version at
    1152 rows (one expert's share of the MoE training step) and 9216 (every
    row on one expert). One TF32 product misses the pin at both. One
    accumulator over the whole contraction misses it at 9216 rows; at 1152
    it stays inside, but its error is over 10x the staged one."""
    lhs, g, gmap = _tgmm_case(rows, seed=rows)
    plain = G.tgmm(lhs, g, gmap, 3)
    staged = emulated_tgmm(lhs, g, gmap, 3, 3, STRETCH)
    assert bool((staged[2] == 0).all())
    err = _rel(staged, plain)
    assert err <= PIN
    assert _rel(emulated_tgmm(lhs, g, gmap, 3, 1, STRETCH), plain) > PIN
    whole = _rel(emulated_tgmm(lhs, g, gmap, 3, 3, rows), plain)
    assert whole > (PIN if rows == 9216 else 10 * err)


@pytest.mark.parametrize("rows", [1152, 9216])
def test_tgmm_bf16_stages_hold_the_float32_pin(rows):
    """bf16 inputs with a float32 output, held on the card to the float32
    pin: exact products, each 16-deep ``mma`` step added toward zero, a
    fresh accumulator for each 64-row stage, within 2e-5 of the plain
    version (the bf16 values widened, one float32 product)."""
    lhs, g, gmap = _tgmm_case(rows, seed=rows + 1)
    lb, gb = lhs.to(torch.bfloat16), g.to(torch.bfloat16)
    plain = G.tgmm(lb, gb, gmap, 3)
    assert plain.dtype == torch.float32
    staged = emulated_tgmm(lb.float(), gb.float(), gmap, 3, 0, 64, step=16)
    assert _rel(staged, plain) <= PIN
