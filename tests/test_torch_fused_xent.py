"""The port's fused classification loss (``elephas_tpu_torch/ops/fused_xent.py``)
on CPU tensors, where the dispatcher runs K1's plain versions: against the
JAX package's Pallas kernels in interpret mode (forward, and the gradient
through its custom VJP under ``jax.vjp``), including rows whose labels are
all zero or sum to 2, where the kernel's ``sum(y * (lse - x))`` departs from
the oracle ``lse - <y, x>``; against the oracle on one-hot rows; bf16
logits; and the CUDA wrappers' refusal of CPU tensors. The CUDA kernels are
held to these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerances: float32 at atol = rtol = 1e-5 (row sums of at most 1000
float32 terms in another order); bf16 logits at 1e-5 for the loss (both
sides widen the same bf16 values to float32) and one bf16 ulp (2**-8
relative) for the gradient, which both sides round to bf16 once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.ops import pallas_ops as JP
from elephas_tpu_torch.ops import fused_xent as X

TOL = 1e-5


def _case(B, C, seed=0, rows="mixed"):
    """Logits ``[B, C]`` and labels: one-hot, with row 0 all zero and row 1
    soft (summing to 2) when ``rows == "mixed"`` and B allows it."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, C)) * 3).astype(np.float32)
    y = np.eye(C, dtype=np.float32)[rng.integers(0, C, size=B)]
    if rows == "mixed":
        y[0] = 0.0
        if B > 1:
            y[1] = 0.0
            y[1, : min(C, 3)] = [0.5, 1.0, 0.5][: min(C, 3)]
    g = rng.normal(size=(B,)).astype(np.float32)
    return x, y, g


def _jax_vjp(x, y, g):
    out, vjp = jax.vjp(lambda a: JP.fused_xent_from_logits(a, jnp.asarray(y), True),
                       jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(g))[0])


def _port_vjp(x, y, g):
    xt = torch.from_numpy(x).requires_grad_()
    out = X.categorical_crossentropy_from_logits(xt, torch.from_numpy(y))
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    return out.detach(), dx


@pytest.mark.parametrize("B", [1, 13, 64])
@pytest.mark.parametrize("C", [10, 130, 1000])
def test_plain_versions_match_pallas_kernel(B, C):
    x, y, g = _case(B, C, seed=B * 1000 + C)
    want, want_dx = _jax_vjp(x, y, g)
    xt, yt, gt = (torch.from_numpy(a) for a in (x, y, g))
    fwd = X.fused_xent_fwd_reference(xt, yt)
    bwd = X.fused_xent_bwd_reference(xt, yt, gt)
    assert fwd.dtype == torch.float32 and fwd.shape == (B,)
    np.testing.assert_allclose(fwd.numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(bwd.numpy(), want_dx, atol=TOL, rtol=TOL)
    # the autograd Function of the dispatcher runs the same pair
    out, dx = _port_vjp(x, y, g)
    np.testing.assert_allclose(out.numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(dx.numpy(), want_dx, atol=TOL, rtol=TOL)


def test_unnormalised_rows_keep_the_kernels_arithmetic():
    """A zero-label row gives 0 and a row summing to 2 gives 2 lse - <y, x>
    (the oracle gives lse and lse - <y, x>); the backward is the oracle's
    gradient on both."""
    x, y, g = _case(4, 10, seed=3)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    fwd = X.fused_xent_fwd_reference(xt, yt).numpy()
    lse = torch.logsumexp(xt, dim=-1).numpy()
    dot = (y * x).sum(-1)
    assert fwd[0] == 0.0
    np.testing.assert_allclose(fwd[1], 2 * lse[1] - dot[1], rtol=TOL)
    oracle = X.xent_from_logits_reference(xt, yt).numpy()
    np.testing.assert_allclose(oracle[:2], lse[:2] - dot[:2], rtol=TOL)
    assert abs(fwd[0] - oracle[0]) > 1.0
    xg = xt.clone().requires_grad_()
    (want_dx,) = torch.autograd.grad(X.xent_from_logits_reference(xg, yt), xg,
                                     torch.from_numpy(g))
    _, dx = _port_vjp(x, y, g)
    np.testing.assert_allclose(dx.numpy(), want_dx.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("C", [10, 257])
def test_dispatcher_matches_jax_dispatcher_on_one_hot_rows(C):
    """On the CPU the JAX dispatcher runs its oracle; on one-hot rows the
    kernel's arithmetic is the same function."""
    x, y, g = _case(24, C, seed=C, rows="one_hot")
    want = JP.categorical_crossentropy_from_logits(jnp.asarray(x), jnp.asarray(y))
    want_dx = jax.grad(lambda a: jnp.sum(
        JP.categorical_crossentropy_from_logits(a, jnp.asarray(y)) * g))(jnp.asarray(x))
    out, dx = _port_vjp(x, y, g)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=TOL, rtol=TOL)
    oracle = X.xent_from_logits_reference(torch.from_numpy(x), torch.from_numpy(y))
    want_oracle = JP.xent_from_logits_reference(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(oracle.numpy(), np.asarray(want_oracle), atol=TOL, rtol=TOL)


def test_bf16_logits():
    x, y, g = _case(13, 130, seed=7)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    out, vjp = jax.vjp(lambda a: JP.fused_xent_from_logits(a, jnp.asarray(y), True), xj)
    want_dx = np.asarray(vjp(jnp.asarray(g))[0].astype(jnp.float32))
    xt = xb.clone().requires_grad_()
    got = X.categorical_crossentropy_from_logits(xt, torch.from_numpy(y))
    (dx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    assert got.dtype == torch.float32 and dx.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(dx.float().numpy(), want_dx, atol=2 ** -8, rtol=2 ** -8)


def test_cuda_wrappers_refuse_cpu_tensors():
    x, y, g = (torch.from_numpy(a) for a in _case(4, 10))
    before = (X.fused_xent_fwd.launches, X.fused_xent_bwd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        X.fused_xent_fwd(x, y)
    with pytest.raises(ValueError, match="CUDA"):
        X.fused_xent_bwd(x, y, g)
    with pytest.raises(ValueError, match="CUDA"):
        X.fused_xent_from_logits(x, y)
    assert (X.fused_xent_fwd.launches, X.fused_xent_bwd.launches) == before


@pytest.mark.parametrize("B,C", [(13, 10), (8, 130)])
def test_positional_interpret_matches_pallas_kernel(B, C):
    """``fused_xent_from_logits(x, y, True)`` by position in both packages:
    the reference runs its Pallas kernel in interpret mode; the port's entry
    takes the call (no ``TypeError``) and, as a kernel entry, refuses CPU
    tensors, so on the CPU its dispatcher (the same kernels' plain
    versions) gives the loss and the gradient, equal to the reference's at
    its tolerance. On the card the entry itself runs
    (``tests/test_torch_cuda.py``)."""
    x, y, g = _case(B, C, seed=B + C)
    want, want_dx = _jax_vjp(x, y, g)   # JP.fused_xent_from_logits(a, y, True)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    with pytest.raises(ValueError, match="CUDA"):
        X.fused_xent_from_logits(xt, yt, True)
    with pytest.raises(ValueError, match="CUDA"):
        X.fused_xent_from_logits(xt, yt, interpret=False)
    out, dx = _port_vjp(x, y, g)
    np.testing.assert_allclose(out.numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(dx.numpy(), want_dx, atol=TOL, rtol=TOL)


# -- the CUDA kernels' routes (xent_plan) and their arithmetic, emulated -------

# the widest rows the cluster route holds: eight CTAs, each slice (a
# multiple of 8 elements) of x and of the float32 labels in 227 KB less 1 KB
CLUSTER_CAP = {4: 8 * 28920, 2: 8 * 38560}


@pytest.mark.parametrize("itemsize", [4, 2], ids=["float32", "bf16"])
@pytest.mark.parametrize("C,route", [
    (1, "warp"), (10, "warp"), (16, "warp"), (17, "warp"), (32, "warp"), (33, "warp"),
    (128, "warp"), (129, "warp"), (1000, "warp"), (1024, "warp"), (1025, "cluster"), (4096, "cluster"), (4097, "cluster"),
    (50257, "cluster"), ("cap", "cluster"), ("cap+1", "stream"), (10 ** 6, "stream")])
def test_plan_routes_every_width(C, route, itemsize):
    """Each width gets a route, on its side of each boundary; a cluster
    plan's slices cover the row, each rank holds at least one element, and
    its shared memory fits the budget."""
    cap = CLUSTER_CAP[itemsize]
    C = {"cap": cap, "cap+1": cap + 1}.get(C, C)
    r, vec, n, sl = X.xent_plan(C, itemsize)
    assert X.ROUTES[r] == route
    if route == "warp":
        assert vec == (4 if C % 4 == 0 else 1) and (n, sl) == (1, 0)
    elif route == "cluster":
        assert 1 <= n <= 8 and sl % 8 == 0 and (n - 1) * sl < C <= n * sl
        assert n == min(8, -(-C // 12800))
        assert X._cluster_smem(sl, itemsize) <= 232448 - 1024
    else:       # the streamed cluster: eight CTAs a row, whatever its width
        assert n == 8 and sl % 8 == 0 and 7 * sl < C <= 8 * sl


def test_plan_reads_its_constants_and_routes_from_the_kernel_source():
    """The plan's constants are the .cu's own, and :data:`ROUTES` names its
    ``enum Route`` in order, so the two sides cannot drift apart."""
    import re

    text = (X._build.CSRC / "fused_xent.cu").read_text()
    assert (X._WARP_MAX, X._CLUSTER_MAX, X._SLICE_UNIT, X._SMEM_BUDGET) == (1024, 8, 8, 231424)
    for name, value in (("kWarpMax", X._WARP_MAX), ("kMaxCluster", X._CLUSTER_MAX),
                        ("kSliceUnit", X._SLICE_UNIT), ("kSmemBudget", X._SMEM_BUDGET)):
        assert f"constexpr int {name} = {value};" in text
    enum = re.search(r"enum Route \{([^}]*)\}", text).group(1)
    names = [re.match(r"\s*k(\w+) = (\d+)", part) for part in enum.split(",")]
    assert [(m.group(1).lower(), int(m.group(2))) for m in names] == \
        [(r, i) for i, r in enumerate(X.ROUTES)]


@pytest.mark.parametrize("vec_max", [4, 2, 1])
def test_plan_vector_width_follows_alignment(vec_max):
    """The warp route's loads take 4 elements where C and the pointers
    allow, else 1; the other routes' loads are their own."""
    assert X.xent_plan(10, 4, vec_max)[1] == 1
    assert X.xent_plan(16, 2, vec_max)[1] == (4 if vec_max == 4 else 1)
    assert X.xent_plan(50257, 4, vec_max)[1] == 1
    assert X.xent_plan(1000, 4, vec_max)[1] == (4 if vec_max == 4 else 1)
    assert X.xent_plan(1000, 2, vec_max)[1] == (4 if vec_max == 4 else 1)
    assert X.xent_plan(1001, 4, vec_max)[1] == 1


def test_vec_max_reads_every_pointer():
    buf = torch.zeros(64)
    assert X._vec_max(buf[:8], buf[4:12]) == 4
    assert X._vec_max(buf[:8], buf[2:10]) == 2
    assert X._vec_max(buf[1:9]) == 1
    half = torch.zeros(64, dtype=torch.bfloat16)
    assert X._vec_max(half[4:12], buf[:8]) == 4
    assert X._vec_max(half[2:10], buf[:8]) == 2
    assert X._vec_max(half[1:9], buf[:8]) == 1


def test_plan_covers_every_accepted_width():
    """Every C the wrappers accept (1 <= C < 2**31) has a valid plan."""
    rng = np.random.default_rng(0)
    widths = np.unique(np.concatenate([np.arange(1, 2100), rng.integers(2100, 2 ** 31, 400)]))
    for C in widths.tolist():
        for itemsize in (4, 2):
            r, vec, n, sl = X.xent_plan(C, itemsize)
            assert 0 <= r < len(X.ROUTES) and vec in (1, 4)
            if X.ROUTES[r] in ("cluster", "stream"):
                assert (n - 1) * sl < C <= n * sl
    with pytest.raises(ValueError):
        X.xent_plan(0, 4)
    assert {k: X.cluster_capacity(k) for k in (4, 2)} == CLUSTER_CAP


def _fold(v):
    """A left fold over the last axis in float32, as one thread adds its
    elements in order."""
    acc = torch.zeros(v.shape[:-1], dtype=torch.float32)
    for k in range(v.shape[-1]):
        acc = acc + v[..., k]
    return acc


def _butterfly(v):
    """A warp's ``__shfl_xor`` sum over the last axis of 32 lanes: 16, 8, 4,
    2, 1 (every lane ends with lane 0's value)."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _lanes(v, fill, C, vec):
    """``[B, 32, 4 NV]``: the warp route's lane l, element (j, e) at column
    4 (l + 32 j) + e (``vec``) or (4 j + e) * 32 + l, ``fill`` past C."""
    nv = -(-C // 128)
    nv = 1 << (nv - 1).bit_length()
    lane, j, e = torch.meshgrid(torch.arange(32), torch.arange(nv), torch.arange(4),
                                indexing="ij")
    col = (4 * (lane + 32 * j) + e) if vec == 4 else ((4 * j + e) * 32 + lane)
    col = col.reshape(32, 4 * nv)
    padded = torch.cat([v, torch.full((v.shape[0], 128 * nv - C), fill)], 1)
    return padded[:, col]


def _block_sum(v, lo, hi):
    """The cluster and stream routes' block sum of columns [lo, hi) of
    ``v``: thread t folds lo + t, lo + t + 256, ... in order, a butterfly in
    each warp, the eight warps in order."""
    w = hi - lo
    k = -(-w // 256)
    part = torch.cat([v[:, lo:hi], torch.zeros((v.shape[0], 256 * k - w))], 1)
    per_thread = _fold(part.reshape(-1, k, 256).transpose(1, 2))       # [B, 256]
    return _fold(_butterfly(per_thread.reshape(-1, 8, 32)))


def _ranks(plan, C):
    """The column range [lo, hi) of each CTA of a cluster or stream plan."""
    _, _, n, sl = plan
    return [(r * sl, min(C, (r + 1) * sl)) for r in range(n)]


def _row_sums(v, plan, C):
    """Per-row sums of ``v`` ``[B, C]`` (zeros where a route skips a column)
    in the order of ``plan``'s route."""
    route, vec, n, sl = plan
    if X.ROUTES[route] == "warp":
        return _butterfly(_fold(_lanes(v, 0.0, C, vec)))
    parts = torch.stack([_block_sum(v, lo, hi) for lo, hi in _ranks(plan, C)], 1)
    return _fold(parts)    # the ranks' partials in rank order


def _emulate(x, y, g, plan):
    """K1-fwd and K1-bwd in float32 on the CPU in the kernels' order:
    (loss [B], dx [B, C] in x's dtype). On the cluster and stream routes
    each CTA sums exp(x - m_r) over its slice with its own max m_r (0 for a
    slice of -inf logits); the rank-order merge rescales each CTA's sum
    once, by exp(m_r - M). Rows of up to 128 classes divide by the sum,
    wider ones multiply by its inverse."""
    C = x.shape[1]
    xf, yf = x.float(), y.float()
    m = xf.amax(1, keepdim=True)            # a max is exact in any order
    if X.ROUTES[plan[0]] in ("cluster", "stream"):
        ranks = _ranks(plan, C)
        m_r = torch.stack([xf[:, lo:hi].amax(1) for lo, hi in ranks], 1)
        s_r = torch.stack([_block_sum(torch.exp(xf - m_r[:, r, None]), lo, hi)
                           for r, (lo, hi) in enumerate(ranks)], 1)
        s_r = torch.where(m_r == -torch.inf, 0.0, s_r)
        s = _fold(s_r * torch.exp(m_r - m))[:, None]
    else:
        s = _row_sums(torch.exp(xf - m), plan, C)[:, None]
    e = torch.exp(xf - m)
    p = e / s if C <= 128 else e * torch.reciprocal(s)
    lse = torch.log(s) + m
    fwd = _row_sums(yf * (lse - xf), plan, C)
    dx = (p - yf) * g.float()[:, None]
    return fwd, dx.to(x.dtype)


def _case25(B, C, seed):
    """chip_smoke.py's inputs: logits ~ 3 N(0, 1), one-hot labels, row 0
    all zero, row 1 one-hot plus 0.5 on its first three columns (sum 2.5)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, C)) * 3).astype(np.float32)
    y = np.zeros((B, C), np.float32)
    y[np.arange(B), rng.integers(0, C, size=B)] = 1.0
    y[0] = 0.0
    y[1, :3] += 0.5
    g = rng.normal(size=B).astype(np.float32)
    return x, y, g


@pytest.mark.parametrize("B,C,route", [
    (37, 10, "warp"), (9, 16, "warp"), (5, 17, "warp"), (4, 128, "warp"), (4, 129, "warp"),
    (6, 1000, "warp"),
    (4, 1024, "warp"), (3, 1025, "cluster"), (2, 4097, "cluster"), (2, 50257, "cluster"),
    (2, CLUSTER_CAP[4] + 1, "stream")])
def test_route_order_matches_plain_and_pallas(B, C, route):
    """Each route's order of sums (the warp route's per-lane folds and
    butterfly, dividing up to C 128 and multiplying past it; the
    cluster's per-thread folds, warps in order, each CTA's sum rescaled
    once, ranks in order; C = 50257 with ragged slice ends; the stream
    route's eight CTAs) holds the plain version and the JAX kernel in
    interpret mode at the card's pins: loss 1e-5, dx 1e-6. The zero-label
    row gives exactly 0, the row summing to 2.5 its 2.5-weighted loss."""
    x, y, g = _case25(B, C, seed=C)
    xt, yt, gt = (torch.from_numpy(a) for a in (x, y, g))
    plan = X.xent_plan(C, 4)
    assert X.ROUTES[plan[0]] == route
    fwd, dx = _emulate(xt, yt, gt, plan)
    assert float(fwd[0]) == 0.0
    want_f, want_dx = _jax_vjp(x, y, g)
    for f_ref, dx_ref in ((X.fused_xent_fwd_reference(xt, yt),
                           X.fused_xent_bwd_reference(xt, yt, gt)),
                          (torch.from_numpy(want_f), torch.from_numpy(want_dx))):
        torch.testing.assert_close(fwd, f_ref, atol=TOL, rtol=TOL)
        torch.testing.assert_close(dx, dx_ref, atol=1e-6, rtol=1e-6)
    lse = torch.logsumexp(xt[1].double(), 0)
    np.testing.assert_allclose(float(fwd[1]), float(2.5 * lse - (yt[1].double() * xt[1]).sum()),
                               rtol=TOL)


@pytest.mark.parametrize("B,C", [(13, 10), (5, 1000), (2, 50257)])
def test_route_order_bf16_logits(B, C):
    """bf16 logits widened to float32 on every route: the loss at 1e-5 and dx
    at one bf16 ulp (2**-8) against the plain version and the JAX kernel."""
    x, y, g = _case25(B, C, seed=C + 1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    yt, gt = torch.from_numpy(y), torch.from_numpy(g)
    fwd, dx = _emulate(xb, yt, gt, X.xent_plan(C, 2))
    assert dx.dtype == torch.bfloat16 and float(fwd[0]) == 0.0
    out, vjp = jax.vjp(lambda a: JP.fused_xent_from_logits(a, jnp.asarray(y), True),
                       jnp.asarray(x).astype(jnp.bfloat16))
    want_dx = np.asarray(vjp(jnp.asarray(g))[0].astype(jnp.float32))
    torch.testing.assert_close(fwd, torch.from_numpy(np.asarray(out)), atol=TOL, rtol=TOL)
    torch.testing.assert_close(fwd, X.fused_xent_fwd_reference(xb, yt), atol=TOL, rtol=TOL)
    for ref in (torch.from_numpy(want_dx), X.fused_xent_bwd_reference(xb, yt, gt).float()):
        torch.testing.assert_close(dx.float(), ref, atol=2 ** -8, rtol=2 ** -8)


@pytest.mark.parametrize("C", [50257, CLUSTER_CAP[4] + 1], ids=["cluster", "stream"])
def test_route_order_masked_slice(C):
    """A CTA's whole slice of -inf logits (a masked block of a vocabulary)
    in rows 2 and 3, on the cluster and stream routes: that CTA adds 0 to
    the row's sum, where exp(-inf - -inf) would make it NaN, so dx is finite
    and holds the plain version and the JAX kernel at 1e-6. The loss holds
    them at 1e-5 too, NaN where all three give NaN: y * (lse - x) is 0 * inf
    at a masked column with a zero label."""
    plan = X.xent_plan(C, 4)
    lo, hi = _ranks(plan, C)[1]
    x, y, g = _case25(4, C, seed=C + 2)
    x[2:, lo:hi] = -np.inf
    y[2:] = 0.0
    y[2:, 0] = 1.0
    xt, yt, gt = (torch.from_numpy(a) for a in (x, y, g))
    fwd, dx = _emulate(xt, yt, gt, plan)
    assert bool(torch.isfinite(dx).all()) and bool(torch.isfinite(fwd[:2]).all())
    want_f, want_dx = _jax_vjp(x, y, g)
    for f_ref, dx_ref in ((X.fused_xent_fwd_reference(xt, yt),
                           X.fused_xent_bwd_reference(xt, yt, gt)),
                          (torch.from_numpy(want_f), torch.from_numpy(want_dx))):
        torch.testing.assert_close(fwd, f_ref, atol=TOL, rtol=TOL, equal_nan=True)
        torch.testing.assert_close(dx, dx_ref, atol=1e-6, rtol=1e-6)
