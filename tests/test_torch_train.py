"""The port's LM training path against the JAX package's on the same weights
and tokens: 20-step loss trajectories of ``build_lm_train_step`` (dense and
flash attention, ``adam_compact`` and ``adam`` against ``optax.adam``,
GPT-2- and Llama-shaped models) within rtol 5e-3, the tolerance of the
reference's ``tests/models/test_train_overlap.py``; the losses; and, within
torch, the reference's identities for the step's knobs (fused apply, grad
accumulation, remat, the streamed head)."""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elephas_tpu.models import adam_compact as jax_adam_compact
from elephas_tpu.models import transformer as jt
from elephas_tpu.models.optimizers import \
    scale_by_adam_compact as jax_scale_by_adam_compact
from elephas_tpu_torch.models import (TransformerLM, adam, adam_compact,
                                      build_lm_eval_step, build_lm_train_step,
                                      chunked_summed_xent, from_jax_params,
                                      fused_adam, make_lm_batches,
                                      scale_by_adam_compact)

V = 17
BASE = dict(vocab=V, d_model=16, n_heads=4, n_layers=2, d_ff=32, max_len=48)
CONFIGS = {
    "gpt2": dict(BASE, activation="gelu", norm="layernorm", attn_bias=True,
                 ffn_bias=True, pos_encoding="learned", tie_embeddings=True),
    "llama": dict(BASE, activation="swiglu", norm="rmsnorm", attn_bias=False,
                  ffn_bias=False, pos_encoding="rotary", n_kv_heads=2,
                  rope_theta=500000.0),
}
LOSS_RTOL = 5e-3
LR = 1e-2


def _weights(name, seed=0):
    """Init weights of ``name`` with norm scales and biases perturbed off
    their constants, so every affine and bias gradient carries signal."""
    rng = np.random.default_rng(seed + 100)
    return {k: (v + 0.1 * rng.normal(size=v.shape).astype(np.float32)
                if k.startswith(("ln", "b")) else v)
            for k, v in jt.TransformerLM(**CONFIGS[name]).init(seed).items()}


def _batch(seed=0, rows=4, t=32):
    rng = np.random.default_rng(seed)
    return make_lm_batches(rng.integers(0, V, size=(rows, t + 1)))


def _port_losses(name, optimizer, steps, **knobs):
    model = TransformerLM(**CONFIGS[name], device="cpu")
    step, opt_init = build_lm_train_step(model, None, optimizer, **knobs)
    params = from_jax_params(_weights(name), device="cpu")
    state = opt_init(params)
    batch = _batch()
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, *batch)
        losses.append(float(loss))
    return np.asarray(losses), params


_GPT2_FLASH = {}


def _gpt2_flash_losses(steps):
    """The first ``steps`` losses of GPT-2's 20-step ``attn="flash"``
    trajectory under ``adam_compact(LR)``, computed once: several pins
    compare against it."""
    if not _GPT2_FLASH:
        _GPT2_FLASH["losses"] = _port_losses("gpt2", adam_compact(LR), 20, attn="flash")[0]
    return _GPT2_FLASH["losses"][:steps]


def _jax_losses(name, optimizer, steps, attn):
    model = jt.TransformerLM(**CONFIGS[name])
    mesh = jt.build_mesh_sp(data=1, seq=1)
    step, opt_init = jt.build_lm_train_step(model, mesh, optimizer, attn=attn)
    params = model.shard_params(mesh, {k: jnp.asarray(v)
                                       for k, v in _weights(name).items()})
    state = opt_init(params)
    batch = jt.shard_lm_batch(mesh, *_batch())
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, *batch)
        losses.append(float(loss))
    return np.asarray(losses)


@pytest.mark.parametrize("name,attn,opt", [
    ("gpt2", "dense", "adam_compact"),
    ("gpt2", "flash", "adam_compact"),
    ("llama", "dense", "adam_compact"),
    ("llama", "flash", "adam_compact"),
    ("gpt2", "flash", "adam"),
    ("llama", "flash", "adam"),
])
def test_loss_trajectory_matches_jax(name, attn, opt):
    """ROADMAP queue 1 item 2's 'done when': 20 steps from the same weights
    on the same tokens, rtol 5e-3. ``adam`` is held to ``optax.adam``."""
    port_opt, jax_opt = ((adam_compact(LR), jax_adam_compact(LR))
                         if opt == "adam_compact" else (adam(LR), optax.adam(LR)))
    got = (_gpt2_flash_losses(20) if (name, attn, opt) == ("gpt2", "flash", "adam_compact")
           else _port_losses(name, port_opt, 20, attn=attn)[0])
    want = _jax_losses(name, jax_opt, 20, attn)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=1e-5)
    assert got[-1] < got[0] - 0.5        # it learns


@pytest.mark.parametrize("which", ["scale_by_adam_compact", "adam"])
def test_optimizer_updates_match_reference(which):
    """Three updates on the same gradients: the unscaled compact transform
    against the reference's (bf16 moments, float32 math), and ``adam``
    against ``optax.adam``; rtol 1e-5 (float32 arithmetic in another
    framework)."""
    port, ref = ((scale_by_adam_compact(), jax_scale_by_adam_compact())
                 if which != "adam" else (adam(LR), optax.adam(LR)))
    rng = np.random.default_rng(7)
    shapes = {"w": (3, 4), "b": (4,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    state = port.init({k: torch.from_numpy(v) for k, v in params.items()})
    jstate = ref.init({k: jnp.asarray(v) for k, v in params.items()})
    for _ in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        upd, state = port.update({k: torch.from_numpy(v) for k, v in grads.items()},
                                 state)
        jupd, jstate = ref.update({k: jnp.asarray(v) for k, v in grads.items()},
                                  jstate)
        for k in shapes:
            np.testing.assert_allclose(upd[k].numpy(), np.asarray(jupd[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    assert int(state.count) == 3


def test_fused_apply_bit_identical_to_unfused():
    """``fused_apply`` replays ``update`` + ``(p + u).to(p.dtype)``: params
    and losses bit-identical over 5 steps, compact and float32 moments."""
    for opt in (adam_compact, fused_adam):
        base, p_base = _port_losses("gpt2", opt(LR), 5, attn="flash")
        fused, p_fused = _port_losses("gpt2", opt(LR), 5, attn="flash",
                                      fused_apply=True)
        np.testing.assert_array_equal(fused, base)
        for k in p_base:
            assert torch.equal(p_fused[k], p_base[k]), k


def test_accum_steps_matches_full_batch():
    """Two micro-batches of 2 rows sum to the 4-row gradient: allclose at
    the reference's pin (tests/models/test_grad_accum.py, rtol 1e-5)."""
    base, _ = _port_losses("llama", adam_compact(LR), 3, attn="flash")
    acc, _ = _port_losses("llama", adam_compact(LR), 3, attn="flash",
                          accum_steps=2)
    np.testing.assert_allclose(acc, base, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="accum_steps"):
        _port_losses("llama", adam_compact(LR), 1, attn="flash", accum_steps=3)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_matches_none(remat):
    """Remat recomputes the block forward in the backward: the first step
    agrees to rtol 1e-5 and the trajectory to 5e-3, as the reference pins."""
    base = _gpt2_flash_losses(20)
    got, _ = _port_losses("gpt2", adam_compact(LR), 20, attn="flash",
                          remat=remat)
    np.testing.assert_allclose(got[0], base[0], rtol=1e-5)
    np.testing.assert_allclose(got, base, rtol=5e-3, atol=1e-5)


def test_vocab_block_trajectory_unchanged():
    """The streamed head is the dense head to float tolerance (the
    reference's tests/models/test_chunked_xent.py pin, rtol 1e-5)."""
    base = _gpt2_flash_losses(5)
    got, _ = _port_losses("gpt2", adam_compact(LR), 5, attn="flash",
                          vocab_block=8)
    np.testing.assert_allclose(got, base, rtol=1e-5)


@pytest.mark.parametrize("block", [8, 17, 5])
def test_chunked_summed_xent_matches_jax(block):
    """Value and both gradients against the reference's custom VJP, for a
    block dividing V, one equal to V and a ragged last block."""
    rng = np.random.default_rng(3)
    h = rng.normal(size=(2, 5, 16)).astype(np.float32)
    w = rng.normal(size=(16, V)).astype(np.float32)
    tg = rng.integers(0, V, size=(2, 5)).astype(np.int32)
    want, (jdh, jdw) = jax.value_and_grad(
        lambda h, w: jt.chunked_summed_xent(h, w, jnp.asarray(tg), block),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    got = chunked_summed_xent(th, tw, torch.from_numpy(tg).long(), block)
    dh, dw = torch.autograd.grad(got, (th, tw))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_eval_step_and_apply_match_jax(attn):
    name = "llama"
    npp = _weights(name)
    tok, pos, tg = _batch(seed=5)
    model = TransformerLM(**CONFIGS[name], device="cpu")
    params = from_jax_params(npp, device="cpu")
    jm = jt.TransformerLM(**CONFIGS[name])
    jp = {k: jnp.asarray(v) for k, v in npp.items()}
    np.testing.assert_allclose(
        model.apply(params, tok, pos, attn).numpy(),
        np.asarray(jm.apply(jp, jnp.asarray(tok), jnp.asarray(pos), attn)),
        atol=1e-4, rtol=1e-4)
    got = build_lm_eval_step(model, None, attn)(params, tok, pos, tg)
    mesh = jt.build_mesh_sp(data=1, seq=1)
    want = jt.build_lm_eval_step(jm, mesh, attn)(
        jm.shard_params(mesh, jp), *jt.shard_lm_batch(mesh, tok, pos, tg))
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_step_returns_device_scalar_and_leaves_inputs():
    model = TransformerLM(**CONFIGS["gpt2"], device="cpu")
    step, opt_init = build_lm_train_step(model, None, adam_compact(LR),
                                         attn="flash")
    params = from_jax_params(_weights("gpt2"), device="cpu")
    before = {k: v.clone() for k, v in params.items()}
    state = opt_init(params)
    new, state2, loss = step(params, state, *_batch())
    assert loss.dim() == 0 and loss.device == params["tok"].device
    assert int(state2.count) == 1 and int(state.count) == 0
    for k in params:
        assert torch.equal(params[k], before[k]), k
        assert not torch.equal(new[k], before[k]), k
    loss2, grads = step.grad(params, *_batch())
    assert float(loss2) == float(loss) and set(grads) == set(params)


def test_knob_validation():
    """The reference's refusals (tests/models/test_train_overlap.py), plus
    the paths this slice does not port."""
    model = TransformerLM(**CONFIGS["gpt2"], device="cpu")
    with pytest.raises(ValueError, match="fused_apply"):
        build_lm_train_step(model, None, adam(LR), attn="flash",
                            fused_apply=True)
    with pytest.raises(ValueError, match="remat"):
        build_lm_train_step(model, None, adam_compact(LR), attn="flash",
                            remat="dotz")
    with pytest.raises(ValueError, match="overlap_grads"):
        build_lm_train_step(model, None, adam_compact(LR), attn="flash",
                            overlap_grads="rings")
    with pytest.raises(ValueError, match="accum_steps"):
        build_lm_train_step(model, None, adam_compact(LR), attn="flash",
                            accum_steps=0)
    with pytest.raises(ValueError, match="attn"):
        build_lm_train_step(model, None, adam_compact(LR), attn="sparse")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_lm_train_step(model, None, adam_compact(LR))     # attn="ring"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_lm_train_step(model, None, adam_compact(LR), attn="ulysses")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_lm_train_step(model, object(), adam_compact(LR), attn="flash")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_lm_train_step(model, None, adam_compact(LR), attn="flash",
                            overlap_grads=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_lm_eval_step(model, None)
    step, _ = build_lm_train_step(model, None, adam_compact(LR), attn="flash")
    tok, pos, tg = make_lm_batches(np.zeros((1, 50), np.int32))
    with pytest.raises(ValueError, match="max_len"):
        step.grad(from_jax_params(_weights("gpt2"), device="cpu"), tok, pos, tg)
