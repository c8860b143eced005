"""The ring attention of the PyTorch port
(``neuralmonkey_tpu_torch/parallel/ring_attention.py``) at two context
ranks over gloo on the CPU: the counterparts of the JAX package's
``tests/test_context_parallel.py`` ring tests, and the port's ring held
against the JAX package's ``ring_attention`` on its 8-device virtual
CPU mesh (``tests/conftest.py``), forward and gradients, in both
schedules.

Every case is made from a numpy seed in the test process; both ranks
take their slices of the time axes, run the ring (forward, then the
written-out backward of ``loss = sum(out * w)``) and return the whole
output and gradients, gathered. The references are the port's dense
attention and the JAX package's ring on the same inputs. ``jax.random``
draws other dropout bits than the port, so the dropout cases hand both
the same keep mask: the JAX package's ``blockwise_dropout_mask``,
which the port's ``_block_keep`` is made to return block by block, so
that the comparison holds where each block's mask is placed.
Tolerance 1e-5.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralmonkey_tpu.parallel import ring_attention as jax_ring
from neuralmonkey_tpu_torch.ops.attention import (attention_bias_from_mask,
                                                  causal_bias,
                                                  dot_product_attention)
from neuralmonkey_tpu_torch.parallel import mesh, ring_attention, tensor
from neuralmonkey_tpu_torch.runtime import CUDAManager

import test_torch_parallel as harness

torch.set_num_threads(1)

ATOL = 1e-5
CP = 2


def make_case(name, seed, batch=4, heads=2, tq=16, tk=16, dh=8,
              causal=False, schedule="auto", keep_prob=1.0):
    """Random q, k, v, a ragged key mask (every row keeps a prefix of at
    least 3) and the loss weights ``w``, from a numpy seed."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(3, tk + 1, size=batch)
    return {"name": name, "causal": causal, "schedule": schedule,
            "keep_prob": keep_prob,
            "q": rng.randn(batch, heads, tq, dh).astype(np.float32),
            "k": rng.randn(batch, heads, tk, dh).astype(np.float32),
            "v": rng.randn(batch, heads, tk, dh).astype(np.float32),
            "mask": (np.arange(tk)[None] < lens[:, None]).astype(np.float32),
            "w": rng.randn(batch, heads, tq, dh).astype(np.float32)}


def case_list():
    cases = []
    for causal in (False, True):
        cases.append(make_case(f"dense_{causal}", 0, causal=causal))
    cases.append(make_case("cross", 1, tq=8, tk=24))
    # 6 / 2 = 3 a rank: odd, so the causal ring is the contiguous one
    cases.append(make_case("contiguous_causal", 6, tq=6, tk=6, causal=True))
    for causal in (False, True):
        for schedule in ("contiguous", "zigzag"):
            if schedule == "zigzag" and not causal:
                continue
            cases.append(make_case(f"jax_{schedule}_{causal}", 3,
                                   causal=causal, schedule=schedule))
    for causal in (False, True):
        for tq in (16, 6):
            cases.append(make_case(f"dropout_{causal}_{tq}", 9, tq=tq,
                                   tk=tq, causal=causal, keep_prob=0.75))
    return cases


def jax_keep_mask(case):
    """The JAX package's blockwise keep mask of a dropout case."""
    batch, heads, tq = case["q"].shape[:3]
    tk = case["k"].shape[2]
    return np.asarray(jax_ring.blockwise_dropout_mask(
        jax.random.PRNGKey(11), case["keep_prob"], batch, heads, tq, tk, CP,
        case["causal"]))


# ---------------------------------------------------------------------- #
# on the ranks
# ---------------------------------------------------------------------- #
def _slice(x, axis):
    size = x.shape[axis] // CP
    return x.narrow(axis, mesh.index("context") * size, size)


def ring_cases(directory, cases):
    """Each case through the ring: the gathered output and gradients;
    and the score elements each schedule folds forward."""
    del directory
    CUDAManager(device="cpu", num_context_shards=CP)
    out = {}
    for case in cases:
        keep = case.get("keep")
        if keep is not None:
            full = torch.from_numpy(keep)

            def block_keep(seed, q_chunk, kv_chunk, n_chunks, keep_prob,
                           shape, device, full=full):
                del seed, keep_prob, device
                bq, bk = shape[2], shape[3]
                return full[:, :, q_chunk * bq:(q_chunk + 1) * bq,
                            kv_chunk * bk:(kv_chunk + 1) * bk]
            ring_attention._block_keep = block_keep
        q, k, v = (_slice(torch.from_numpy(case[n]), 2).clone()
                   .requires_grad_() for n in "qkv")
        mask = _slice(torch.from_numpy(case["mask"]), 1)
        result = ring_attention.ring_attention(
            q, k, v, mask, case["causal"],
            dropout_seed=5 if case["keep_prob"] < 1 else None,
            dropout_keep_prob=case["keep_prob"],
            schedule=case["schedule"])
        (result * _slice(torch.from_numpy(case["w"]), 2)).sum().backward()
        out[case["name"]] = {
            name: tensor.all_gather(t.detach(), 2, "context").numpy()
            for name, t in (("out", result), ("dq", q.grad),
                            ("dk", k.grad), ("dv", v.grad))}
    folds = {}
    case = make_case("folds", 8, batch=2, tq=32, tk=32, dh=16, causal=True)
    for schedule in ("zigzag", "contiguous"):
        q, k, v = (_slice(torch.from_numpy(case[n]), 2) for n in "qkv")
        ring_attention.SCORE_ELEMENTS[0] = 0
        ring_attention.ring_attention(
            q, k, v, _slice(torch.from_numpy(case["mask"]), 1), True,
            schedule=schedule)
        folds[schedule] = ring_attention.SCORE_ELEMENTS[0]
    eligible = {str(shape): ring_attention.ring_eligible(*shape)
                for shape in ((16, 16), (8, 24), (1, 16), (16, 5))}
    return {"cases": out, "folds": folds, "eligible": eligible}


# ---------------------------------------------------------------------- #
# references in the test process
# ---------------------------------------------------------------------- #
def dense(case, keep=None):
    """The port's dense attention (with a given keep mask, dense dropout
    semantics), its output and gradients."""
    q, k, v = (torch.from_numpy(case[n]).requires_grad_() for n in "qkv")
    bias = attention_bias_from_mask(torch.from_numpy(case["mask"]))
    if case["causal"]:
        bias = bias + causal_bias(k.shape[2])[:, :, :q.shape[2], :]
    if keep is None:
        out = dot_product_attention(q, k, v, bias)
    else:
        weights = torch.softmax(
            torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
            + bias, dim=-1)
        weights = torch.where(torch.tensor(keep),
                              weights / case["keep_prob"], 0.0)
        out = torch.matmul(weights, v)
    (out * torch.from_numpy(case["w"])).sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy()}


def jax_reference(case):
    """The JAX package's ring on a (data 4, context 2) mesh: output and
    gradients (dropout from the key the keep mask was drawn from)."""
    devs = np.array(jax.devices()[:4 * CP]).reshape(4, CP)
    jax_ring.enable_context_parallel(
        jax.sharding.Mesh(devs, ("data", "context")))
    try:
        mask = jnp.asarray(case["mask"])
        w = jnp.asarray(case["w"])
        dropout = case["keep_prob"] < 1
        rng = jax.random.PRNGKey(11) if dropout else None

        def loss(q, k, v):
            out = jax_ring.ring_attention(
                q, k, v, mask, case["causal"], dropout_rng=rng,
                dropout_keep_prob=case["keep_prob"],
                schedule=case["schedule"])
            return jnp.sum(out * w), out

        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(
                *(jnp.asarray(case[n]) for n in "qkv"))
    finally:
        jax_ring.disable_context_parallel()
    return {"out": np.asarray(out),
            **{n: np.asarray(g) for n, g in zip(("dq", "dk", "dv"), grads)}}


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    cases = case_list()
    for case in cases:
        if case["keep_prob"] < 1:
            case["keep"] = jax_keep_mask(case)
    results = harness.run_ranks(str(tmp_path_factory.mktemp("ring")),
                                ["ring_cases"], (cases,), module=__name__)
    return {c["name"]: c for c in cases}, [r["ring_cases"] for r in results]


def _close(got, want, name):
    for key in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[key], want[key], atol=ATOL, rtol=0,
                                   err_msg=f"{name}: {key}")


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_dense_reference(ring, causal):
    cases, ranks = ring
    name = f"dense_{causal}"
    want = dense(cases[name])
    for rank in ranks:
        np.testing.assert_allclose(rank["cases"][name]["out"], want["out"],
                                   atol=ATOL, rtol=0)


def test_ring_cross_attention_shapes(ring):
    """Tq != Tk (the decoder's cross-attention): both time axes ride the
    ring."""
    cases, ranks = ring
    want = dense(cases["cross"])
    for rank in ranks:
        _close(rank["cases"]["cross"], want, "cross")


@pytest.mark.parametrize("causal", [False, True])
def test_ring_gradients_match_dense(ring, causal):
    """The written-out backward (the key and value gradients travelling
    back around the ring) equals the dense attention's gradients."""
    cases, ranks = ring
    name = f"dense_{causal}"
    want = dense(cases[name])
    for rank in ranks:
        _close(rank["cases"][name], want, name)


def test_ring_contiguous_causal_fallback_matches_dense(ring):
    """An odd block a rank (6 / 2): the zigzag does not take it, the
    contiguous causal ring is exact, forward and backward."""
    cases, ranks = ring
    want = dense(cases["contiguous_causal"])
    for rank in ranks:
        _close(rank["cases"]["contiguous_causal"], want,
               "contiguous_causal")


def test_zigzag_halves_causal_ring_work(ring):
    """The zigzag folds 3 + 2(C-1) thin blocks of (T/2C)^2 scores where
    the contiguous causal ring folds C blocks of (T/C)^2, the ones above
    the diagonal masked: at C = 2, 5/8 of the work."""
    _, ranks = ring
    for rank in ranks:
        folds = rank["folds"]
        assert folds["zigzag"] * 8 == folds["contiguous"] * 5, folds
        assert folds["zigzag"] < 0.75 * folds["contiguous"]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq", [16, 6])
def test_ring_dropout_matches_dense_blockwise(ring, causal, tq):
    """Attention dropout in the ring with the blockwise keep mask (the
    zigzag's thin blocks at tq 16 when causal, the contiguous blocks
    otherwise): the dense result and gradients with that whole mask."""
    cases, ranks = ring
    name = f"dropout_{causal}_{tq}"
    case = cases[name]
    want = dense(case, case["keep"])
    for rank in ranks:
        _close(rank["cases"][name], want, name)


def test_blockwise_dropout_mask_places_each_block():
    """The port's own blockwise mask: each (q chunk, kv chunk) block is
    ``_block_keep`` of its global chunk indices, zigzag thin chunks when
    causal with an even block, chunks of T/C otherwise."""
    full = ring_attention.blockwise_dropout_mask(7, 0.75, 2, 3, 16, 16, 2,
                                                 True)
    assert full.shape == (2, 3, 16, 16) and full.dtype == torch.bool
    block = ring_attention._block_keep(7, 3, 1, 4, 0.75, (2, 3, 4, 4), "cpu")
    assert torch.equal(full[:, :, 12:16, 4:8], block)
    contiguous = ring_attention.blockwise_dropout_mask(7, 0.75, 2, 3, 16, 16,
                                                       2, False)
    assert torch.equal(contiguous[:, :, 8:16, 0:8], ring_attention._block_keep(
        7, 1, 0, 2, 0.75, (2, 3, 8, 8), "cpu"))
    assert 0.6 < full.float().mean() < 0.9


def test_ring_eligibility_guards(ring):
    assert not ring_attention.ring_eligible(16, 16)  # no context axis here
    _, ranks = ring
    for rank in ranks:
        assert rank["eligible"] == {"(16, 16)": True, "(8, 24)": True,
                                    "(1, 16)": False, "(16, 5)": False}


@pytest.mark.parametrize("name", ["jax_contiguous_False",
                                  "jax_contiguous_True",
                                  "jax_zigzag_True",
                                  "dropout_True_16", "dropout_False_6"])
def test_ring_matches_jax_ring_attention(ring, name):
    """The port's ring against the JAX package's on the same inputs:
    output and gradients, in both schedules, and with dropout (the same
    keep mask, block by block)."""
    cases, ranks = ring
    want = jax_reference(cases[name])
    for rank in ranks:
        _close(rank["cases"][name], want, name)
