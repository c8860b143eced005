"""The training path's kernels, in their plain versions, against the
JAX package's Pallas kernels run in interpret mode on the CPU (as
tests/test_pallas.py and tests/test_fused_xent.py run them), from the
same numpy inputs; and the port's dropout and optimizers.

- B1-backward: gradients through the port's ``_GRUScan`` (plain forward
  and plain BPTT) against ``jax.grad`` of ``pallas_rnn.gru_scan`` and
  ``bidirectional_gru_scan`` (the hand-written BPTT kernel), with
  ragged masks, forward and reverse. Tolerance 2e-5 absolute plus 1e-4
  relative: float32 sums in another order, compounded over 7 steps.
- B7: the port's fused cross-entropy (plain versions of its three
  kernels) against ``fused_xent._fused`` and ``xent_reference``: values
  and dx/dW/db, eps 0 and 0.1, both layouts, V = 300 (not a multiple of
  the 128-column tile). Tolerance 2e-5 relative, 2e-6 absolute, that of
  tests/test_fused_xent.py.
- K2: the backward of the port's ``fused_bahdanau_step`` Function
  against the gradients of the JAX ``fused_bahdanau_step``, 1e-5.
- Dropout and the optimizers (one step against optax, and clipping).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuralmonkey_tpu.ops import fused_xent as jax_fx
from neuralmonkey_tpu.ops.pallas_attention import \
    fused_bahdanau_step as jax_bahdanau
from neuralmonkey_tpu.ops.pallas_rnn import (bidirectional_gru_scan,
                                             gru_scan as jax_gru_scan)

from neuralmonkey_tpu_torch import functions
from neuralmonkey_tpu_torch.model.part import Context, ModelPart, fold_seed
from neuralmonkey_tpu_torch.ops import (cuda_attention, cuda_rnn,
                                        fused_xent, kernel_config, nn)
from neuralmonkey_tpu_torch.trainers import optimizers
from neuralmonkey_tpu_torch.trainers.generic_trainer import Update

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BATCH, TIME, WIDTH, HIDDEN = 4, 7, 6, 5
LENGTHS = [7, 4, 1, 0]


def _mask(lengths, time=TIME):
    mask = np.zeros((len(lengths), time), np.float32)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1.0
    return mask


def _gru_params(rng, width=WIDTH, hidden=HIDDEN):
    def u(*shape):
        return rng.uniform(-0.6, 0.6, shape).astype(np.float32)
    return {"gates_x": u(width, 2 * hidden), "gates_h": u(hidden, 2 * hidden),
            "gates_b": u(2 * hidden) + 1.0, "cand_x": u(width, hidden),
            "cand_h": u(hidden, hidden), "cand_b": u(hidden)}


def _leaf(array):
    return torch.from_numpy(np.array(array)).requires_grad_()


def _close(got, ref, atol, rtol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=rtol)


# ---------------------------------------------------------------------- #
# B1-backward: the GRU BPTT
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_bptt_matches_jax_pallas(reverse):
    rng = np.random.RandomState(3 + reverse)
    params = _gru_params(rng)
    inputs = rng.randn(BATCH, TIME, WIDTH).astype(np.float32)
    mask = _mask(LENGTHS)
    gout = rng.randn(BATCH, TIME, HIDDEN).astype(np.float32)
    gfinal = rng.randn(BATCH, HIDDEN).astype(np.float32)

    def jax_loss(p, x):
        out, final = jax_gru_scan(p, x, jnp.asarray(mask), reverse=reverse,
                                  batch_tile=2)
        return jnp.sum(out * gout) + jnp.sum(final * gfinal)

    ref_p, ref_x = jax.grad(jax_loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(inputs))

    port_p = {k: _leaf(v) for k, v in params.items()}
    port_x = _leaf(inputs)
    out, final = cuda_rnn.gru_scan([(port_p, reverse)], port_x,
                                   torch.from_numpy(mask))
    ((out * torch.from_numpy(gout)).sum()
     + (final * torch.from_numpy(gfinal)).sum()).backward()
    for key, value in port_p.items():
        _close(value.grad, ref_p[key], 2e-5, 1e-4)
    _close(port_x.grad, ref_x, 2e-5, 1e-4)


def test_bidirectional_gru_bptt_matches_jax_pallas():
    """Both directions in one Function: its per-direction slicing of
    the hoisted inputs, carries and gradients."""
    rng = np.random.RandomState(7)
    fw, bw = _gru_params(rng), _gru_params(rng)
    inputs = rng.randn(BATCH, TIME, WIDTH).astype(np.float32)
    mask = _mask([5, 7, 2, 3])
    gout = rng.randn(BATCH, TIME, 2 * HIDDEN).astype(np.float32)
    gfinal = rng.randn(BATCH, 2 * HIDDEN).astype(np.float32)

    def jax_loss(f, b, x):
        out, final = bidirectional_gru_scan(f, b, x, jnp.asarray(mask),
                                            batch_tile=2)
        return jnp.sum(out * gout) + jnp.sum(final * gfinal)

    def jnp_tree(p):
        return {k: jnp.asarray(v) for k, v in p.items()}
    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp_tree(fw), jnp_tree(bw), jnp.asarray(inputs))

    port_fw = {k: _leaf(v) for k, v in fw.items()}
    port_bw = {k: _leaf(v) for k, v in bw.items()}
    port_x = _leaf(inputs)
    out, final = cuda_rnn.gru_scan([(port_fw, False), (port_bw, True)],
                                   port_x, torch.from_numpy(mask))
    ((out * torch.from_numpy(gout)).sum()
     + (final * torch.from_numpy(gfinal)).sum()).backward()
    for port_p, ref_p in ((port_fw, ref[0]), (port_bw, ref[1])):
        for key, value in port_p.items():
            _close(value.grad, ref_p[key], 2e-5, 1e-4)
    _close(port_x.grad, ref[2], 2e-5, 1e-4)


def test_gru_scan_keeps_carries_only_for_gradients():
    """Inference through the Function saves nothing; the plain forward
    and the plain BPTT count no kernel launches."""
    rng = np.random.RandomState(0)
    params = {k: torch.from_numpy(v) for k, v in _gru_params(rng).items()}
    inputs = torch.from_numpy(rng.randn(2, 3, WIDTH).astype(np.float32))
    kernel_config.reset_launch_counts()
    with torch.inference_mode():
        out, _ = cuda_rnn.gru_scan([(params, False)], inputs,
                                   torch.ones(2, 3))
    assert out.grad_fn is None
    leaf = inputs.clone().requires_grad_()
    cuda_rnn.gru_scan([(params, True)], leaf, torch.ones(2, 3))[0] \
        .sum().backward()
    assert leaf.grad is not None
    assert not any(kernel_config.launch_counts().values())


# ---------------------------------------------------------------------- #
# B7: fused softmax cross-entropy
# ---------------------------------------------------------------------- #
def _xent_operands(transposed, n=64, d=128, v=300, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, d) * 0.3).astype(np.float32)
    w = (rng.randn(*((v, d) if transposed else (d, v))) * 0.05).astype(
        np.float32)
    b = (rng.randn(v) * 0.1).astype(np.float32)
    targets = rng.randint(0, v, size=(n,)).astype(np.int32)
    cot = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return x, w, b, targets, cot


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_fused_xent_matches_jax_pallas(monkeypatch, transposed, eps):
    monkeypatch.setenv("NM_USE_PALLAS", "1")
    x, w, b, targets, cot = _xent_operands(transposed)
    n, d = x.shape
    v = len(b)
    tiling = jax_fx._tiling(n, d, jax_fx.vp_pad(v, jax_fx.LANE))

    def jax_loss(x_, w_, b_):
        nll = jax_fx._fused(x_, w_, b_, jnp.asarray(targets), eps, v,
                            tiling, transposed)
        return jnp.sum(nll * cot), nll

    (_, ref_nll), ref_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    plain_nll = jax_fx.xent_reference(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b), jnp.asarray(targets),
                                      eps, transposed)

    px, pw, pb = _leaf(x), _leaf(w), _leaf(b)
    nll = fused_xent.fused_softmax_xent(px, pw, pb,
                                        torch.from_numpy(targets), eps,
                                        transposed)
    (nll * torch.from_numpy(cot)).sum().backward()
    _close(nll, ref_nll, 2e-6, 2e-5)
    _close(nll, plain_nll, 2e-6, 2e-5)
    for got, ref in zip((px.grad, pw.grad, pb.grad), ref_grads):
        _close(got, ref, 2e-6, 2e-5)


def test_fused_xent_plain_kernels_agree_with_materialized_logits():
    """The plain versions of the three kernels against autograd of the
    port's materialized-logits cross-entropy."""
    x, w, b, targets, cot = _xent_operands(False, n=9, d=7, v=130, seed=1)
    args = [torch.from_numpy(a) for a in (x, w, b)]
    t = torch.from_numpy(targets)
    g = torch.from_numpy(cot)
    nll, lse = fused_xent.xent_fwd(*args, t, 0.1, False)
    leaves = [a.clone().requires_grad_() for a in args]
    ref = fused_xent.xent_reference(*leaves, t, 0.1, False)
    (ref * g).sum().backward()
    torch.testing.assert_close(nll, ref.detach(), atol=2e-6, rtol=2e-5)
    dx = fused_xent.xent_bwd_dx(*args, t, lse, g, 0.1, False)
    dw, db = fused_xent.xent_bwd_dw(*args, t, lse, g, 0.1, False)
    for got, leaf in zip((dx, dw, db), leaves):
        torch.testing.assert_close(got, leaf.grad, atol=2e-6, rtol=2e-5)


def test_fused_xent_switch(monkeypatch):
    x = torch.zeros(2, 3)
    monkeypatch.delenv("NM_FUSED_XENT", raising=False)
    assert not fused_xent.eligible(x, x)
    monkeypatch.setenv("NM_FUSED_XENT", "1")
    assert fused_xent.eligible(x, x)
    assert not fused_xent.eligible(x.double(), x)


# ---------------------------------------------------------------------- #
# K2: the Bahdanau step's backward (recompute through the plain version)
# ---------------------------------------------------------------------- #
def test_bahdanau_backward_matches_jax():
    rng = np.random.RandomState(5)
    batch, time, att, dim = 4, 6, 8, 10
    keys = rng.randn(batch, time, att).astype(np.float32)
    states = rng.randn(batch, time, dim).astype(np.float32)
    mask = _mask([6, 3, 1, 0], time)
    pq = rng.randn(batch, att).astype(np.float32)
    v = (rng.randn(att) / np.sqrt(att)).astype(np.float32)
    dctx = rng.randn(batch, dim).astype(np.float32)
    dw = rng.randn(batch, time).astype(np.float32)

    def jax_loss(k, s, q, vv):
        c, w = jax_bahdanau(k, s, jnp.asarray(mask), q, vv)
        return jnp.sum(c * dctx) + jnp.sum(w * dw)
    ref = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (keys, states, pq, v)))

    leaves = [_leaf(a) for a in (keys, states, pq, v)]
    context, weights = cuda_attention.fused_bahdanau_step(
        leaves[0], leaves[1], torch.from_numpy(mask), leaves[2], leaves[3])
    assert context.grad_fn is not None
    ((context * torch.from_numpy(dctx)).sum()
     + (weights * torch.from_numpy(dw)).sum()).backward()
    for leaf, r in zip(leaves, ref):
        _close(leaf.grad, r, 1e-5, 1e-5)


# ---------------------------------------------------------------------- #
# dropout
# ---------------------------------------------------------------------- #
def test_dropout_keep_share_scale_and_identity():
    x = torch.ones(200, 500)
    gen = torch.Generator().manual_seed(0)
    y = nn.dropout(x, 0.8, gen, True)
    kept = y != 0
    # 100000 draws: the keep share is within 5 standard deviations
    assert abs(float(kept.float().mean()) - 0.8) < 5 * (0.8 * 0.2 / 1e5) ** .5
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.8))
    assert nn.dropout(x, 0.8, gen, False) is x
    assert nn.dropout(x, 1.0, gen, True) is x
    again = nn.dropout(x, 0.8, torch.Generator().manual_seed(0), True)
    assert torch.equal(again, y)


def test_context_dropout_generators_per_part_and_site():
    part = ModelPart("enc")
    x = torch.ones(64, 64)
    ctx = Context({}, {}, train=True, rng=fold_seed(7, 3))
    a = ctx.dropout(part, x, 0.5, "a")
    assert torch.equal(a, Context({}, {}, train=True,
                                  rng=fold_seed(7, 3)).dropout(
        part, x, 0.5, "a"))
    assert not torch.equal(a, ctx.dropout(part, x, 0.5, "b"))
    assert not torch.equal(a, Context({}, {}, train=True,
                                      rng=fold_seed(7, 4)).dropout(
        part, x, 0.5, "a"))
    assert Context({}, {}, train=False).dropout(part, x, 0.5, "a") is x
    with pytest.raises(ValueError, match="no rng"):
        Context({}, {}, train=True).dropout(part, x, 0.5, "a")


# ---------------------------------------------------------------------- #
# optimizers: one step against optax
# ---------------------------------------------------------------------- #
def _opt_case(seed=0):
    rng = np.random.RandomState(seed)
    params = {"a/w": rng.randn(5, 3).astype(np.float32),
              "b": rng.randn(4).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 0.5).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("name,port,tx", [
    ("adam", optimizers.AdamOptimizer(0.01, epsilon=1e-7),
     optax.adam(0.01, eps=1e-7)),
    ("sgd", optimizers.GradientDescentOptimizer(0.3), optax.sgd(0.3)),
    ("momentum", optimizers.MomentumOptimizer(0.3, momentum=0.8),
     optax.sgd(0.3, momentum=0.8)),
    ("nesterov", optimizers.MomentumOptimizer(0.3, 0.8, use_nesterov=True),
     optax.sgd(0.3, momentum=0.8, nesterov=True)),
    ("adam_schedule",
     optimizers.AdamOptimizer(functions.exponential_decay(0.01, 2, 0.5)),
     optax.adam(optax.exponential_decay(0.01, 2, 0.5))),
], ids=lambda p: p if isinstance(p, str) else "")
def test_optimizer_steps_match_optax(name, port, tx):
    """Three updates, so the moments, the bias corrections and the
    schedules are exercised; float32 to 1e-6."""
    del name
    params, grads = _opt_case()
    jax_params = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jax_params)
    flat = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    transform = port.make()
    port_state = transform.init(flat)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        transform.apply(flat, {k: torch.from_numpy(v) for k, v in g.items()},
                        port_state)
    for k, v in flat.items():
        _close(v, jax_params[k], 1e-6, 1e-6)


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
    """Both sides of the clip threshold, and the norm reported before
    clipping."""
    params, grads = _opt_case(seed=1)
    g = {k: v * scale for k, v in grads[0].items()}
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.sgd(1.0))
    jax_params = {k: jnp.asarray(v) for k, v in params.items()}
    updates, _ = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                           tx.init(jax_params), jax_params)
    jax_params = optax.apply_updates(jax_params, updates)
    update = Update(optimizers.GradientDescentOptimizer(1.0).make(), 1.0)
    flat = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    norm = update.apply(flat, {k: torch.from_numpy(v) for k, v in g.items()},
                        update.init(flat))
    _close(norm, optax.global_norm({k: jnp.asarray(v)
                                    for k, v in g.items()}), 1e-6, 1e-6)
    for k, v in flat.items():
        _close(v, jax_params[k], 1e-6, 1e-6)


@pytest.mark.parametrize("name", ["AdadeltaOptimizer", "RMSPropOptimizer",
                                  "AdafactorOptimizer"])
def test_unported_optimizers_raise(name):
    with pytest.raises(NotImplementedError, match="not ported"):
        getattr(optimizers, name)(learning_rate=0.1)


def test_schedules_match_jax():
    from neuralmonkey_tpu import functions as jax_functions
    for make in ("noam_decay", "exponential_decay", "piecewise_constant",
                 "inverse_sigmoid_decay"):
        args = {"noam_decay": (0.5, 64, 10),
                "exponential_decay": (0.1, 3, 0.5, True),
                "piecewise_constant": ([2, 5], [1.0, 0.5, 0.1]),
                "inverse_sigmoid_decay": (1.0, 4.0)}[make]
        port, ref = (getattr(m, make)(*args)
                     for m in (functions, jax_functions))
        for step in range(0, 12):
            np.testing.assert_allclose(port(step), float(ref(step)),
                                       rtol=1e-6)
