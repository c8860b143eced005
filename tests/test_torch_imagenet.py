"""The port's ImageNet encoder and its converter against the JAX
package, on the CPU.

- ``ImageNet`` (``vgg_16`` and ``resnet_v2_50``) at 64 x 64, batch 2,
  from one seeded draw loaded into both packages (``params_from_jax``):
  every layer's map, the spatial states and mask, the output (pooled and
  through ``encoded_layer``), each within 1e-5 of the largest entry of
  the JAX package's (its forward compiled with ``jax.jit``); the same at
  63 x 65, whose stride-2 ``"SAME"`` convolutions pad asymmetrically
  (the root pads 3 before and 3 after, the strided 3 x 3s 0 or 1
  before and 1 after) and whose VALID pools drop the odd cell.
- ``fine_tune=False``: no gradient reaches the CNN (all zero in both
  packages); ``fine_tune=True``: every gradient within 1e-4 of its
  largest entry of the JAX package's, and one SGD step from it equal.
- A captioning model, a Bahdanau decoder over ``ImageNet(vgg_16)``: its
  loss and gradients within 1e-4, its greedy and beam ids equal.
- ``convert_imagenet`` on seeded slim (VGG-16, ResNet-v2-50) and
  torchvision (VGG-16) ``.npz`` sources: the port writes the JAX
  package's arrays, and a part warm-started from the file through the
  port's manager holds them and runs the JAX package's forward.
- The refusals: ``input_size`` other than 224, an unknown network or
  layer, the bf16 policy.
- The 19-, 101- and 152-layer networks against the JAX package at
  32 x 32 (marked slow).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from neuralmonkey_tpu.model.part import Context as JaxContext
from neuralmonkey_tpu.model.part import collect_parts as jax_collect_parts
from neuralmonkey_tpu.model.part import init_all_params as jax_init
from neuralmonkey_tpu.models.attention.feed_forward import \
    Attention as JaxAttention
from neuralmonkey_tpu.models.decoders.beam_search_decoder import \
    BeamSearchDecoder as JaxBeamSearch
from neuralmonkey_tpu.models.decoders.decoder import Decoder as JaxDecoder
from neuralmonkey_tpu.models.encoders import imagenet_encoder as jax_inet
from neuralmonkey_tpu.ops import policy as jax_policy
from neuralmonkey_tpu.utils import convert_imagenet as jax_convert
from neuralmonkey_tpu.utils.saving import flatten_tree as jax_flatten
from neuralmonkey_tpu.utils.saving import restore_into as jax_restore
from neuralmonkey_tpu.vocabulary import Vocabulary as JaxVocabulary

from neuralmonkey_tpu_torch.dataset import Dataset
from neuralmonkey_tpu_torch.model.part import (Context, collect_parts,
                                               init_all_params)
from neuralmonkey_tpu_torch.models.attention.feed_forward import Attention
from neuralmonkey_tpu_torch.models.decoders.beam_search_decoder import \
    BeamSearchDecoder
from neuralmonkey_tpu_torch.models.decoders.decoder import Decoder
from neuralmonkey_tpu_torch.models.encoders import imagenet_encoder
from neuralmonkey_tpu_torch.ops import policy
from neuralmonkey_tpu_torch.runtime import CUDAManager
from neuralmonkey_tpu_torch.utils import convert_imagenet
from neuralmonkey_tpu_torch.utils.saving import flatten_tree, params_from_jax
from neuralmonkey_tpu_torch.vocabulary import Vocabulary

torch.set_num_threads(4)
REL_TOL, GRAD_TOL = 1e-5, 1e-4


def _encoders(network, **kwargs):
    return (jax_inet.ImageNet(name="img", data_id="images",
                              network_type=network, **kwargs),
            imagenet_encoder.ImageNet(name="img", data_id="images",
                                      network_type=network, **kwargs))


def _draw(flat_shapes, seed):
    """A seeded draw for every leaf: He-scaled kernels, small biases, and
    batch-norm moments and scales near their identity."""
    rng = np.random.RandomState(seed)
    flat = {}
    for key, shape in sorted(flat_shapes.items()):
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "w":
            fan_in = int(np.prod(shape[:-1]))
            value = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
        elif leaf in ("scale", "variance"):
            value = 1.0 + 0.2 * rng.rand(*shape)
        else:  # b, bias, mean
            value = 0.05 * rng.randn(*shape)
        flat[key] = value.astype(np.float32)
    return flat


def _shared(jax_roots, port_roots, seed=0):
    """(JAX params, port params, the flat draw) of the parts under the
    roots; the JAX tree's structure from ``eval_shape``."""
    jax_shapes = jax.eval_shape(lambda: jax_init(
        jax_collect_parts(jax_roots), jax.random.PRNGKey(0)))
    template = init_all_params(collect_parts(port_roots), seed=0)
    flat = _draw({k: v.shape for k, v in flatten_tree(template).items()},
                 seed)
    return jax_restore(jax_shapes, flat), params_from_jax(flat, template), \
        flat


def _images(shape, seed=1, batch=2):
    return np.random.RandomState(seed).rand(batch, *shape).astype(
        np.float32) * 2 - 1


def _rel(got, ref):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    return float(np.abs(got.detach().numpy() - ref).max()) / scale


def _jax_layers(jax_enc, jax_params, images):
    return jax.jit(lambda p, x: jax_enc._layers(
        JaxContext(p, {"img.images": x})))(jax_params, jnp.asarray(images))


@pytest.mark.parametrize("network", ["vgg_16", "resnet_v2_50"])
@pytest.mark.parametrize("size", [(64, 64), (63, 65)])
def test_imagenet_matches_jax(network, size):
    jax_enc, enc = _encoders(network)
    jax_params, params, _ = _shared([jax_enc], [enc], seed=3)
    images = _images((*size, 3))
    ref = _jax_layers(jax_enc, jax_params, images)
    ctx = Context(params, {"img.images": torch.from_numpy(images)})
    with torch.inference_mode():
        layers = enc._layers(ctx)
        assert sorted(layers) == sorted(ref)
        for name, value in layers.items():
            assert tuple(value.shape) == ref[name].shape, name
            assert _rel(value, ref[name]) <= REL_TOL, name
        states = enc.spatial_states(ctx)
        out = enc.output(ctx)
    default = "conv5_3" if network == "vgg_16" else "postnorm"
    np.testing.assert_array_equal(states.numpy(), layers[default].numpy())
    want_out = np.asarray(ref[default]).mean(axis=(1, 2))
    assert _rel(out, want_out) <= REL_TOL
    assert enc.spatial_mask(ctx).shape == states.shape[:3]
    assert float(enc.spatial_mask(ctx).min()) == 1.0
    assert enc.state_dim == enc.output_dim == jax_enc.state_dim


@pytest.mark.parametrize("network,spatial,encoded", [
    ("vgg_16", "conv3_2", "pool4"),
    ("resnet_v2_50", "block2_1", "block4_2"),
])
def test_spatial_and_encoded_layers_match_jax(network, spatial, encoded):
    jax_enc, enc = _encoders(network, spatial_layer=spatial,
                             encoded_layer=encoded)
    jax_params, params, _ = _shared([jax_enc], [enc], seed=4)
    images = _images((32, 32, 3), seed=5)
    jax_ctx = {"img.images": jnp.asarray(images)}
    ref_states, ref_mask, ref_out = jax.jit(lambda p: (
        jax_enc.spatial_states(JaxContext(p, jax_ctx)),
        jax_enc.spatial_mask(JaxContext(p, jax_ctx)),
        jax_enc.output(JaxContext(p, jax_ctx))))(jax_params)
    ctx = Context(params, {"img.images": torch.from_numpy(images)})
    with torch.inference_mode():
        assert _rel(enc.spatial_states(ctx), ref_states) <= REL_TOL
        np.testing.assert_array_equal(enc.spatial_mask(ctx).numpy(),
                                      np.asarray(ref_mask))
        assert _rel(enc.output(ctx), ref_out) <= REL_TOL


def _grads(jax_enc, enc, jax_params, params, images):
    def jax_loss(p):
        ctx = JaxContext(p, {"img.images": jnp.asarray(images)})
        return (jnp.sum(jax_enc.output(ctx) ** 2)
                + jnp.sum(jax_enc.spatial_states(ctx) ** 2) * 1e-3)
    ref = jax_flatten(jax.jit(jax.grad(jax_loss))(jax_params))
    flat = flatten_tree(params)
    for leaf in flat.values():
        leaf.requires_grad_(True)
    ctx = Context(params, {"img.images": torch.from_numpy(images)})
    loss = ((enc.output(ctx) ** 2).sum()
            + (enc.spatial_states(ctx) ** 2).sum() * 1e-3)
    if loss.requires_grad:
        loss.backward()
    return ref, flat, loss


@pytest.mark.parametrize("network", ["vgg_16", "resnet_v2_50"])
def test_frozen_imagenet_takes_no_gradient(network):
    jax_enc, enc = _encoders(network)
    jax_params, params, _ = _shared([jax_enc], [enc], seed=6)
    ref, flat, loss = _grads(jax_enc, enc, jax_params, params,
                             _images((32, 32, 3), seed=7))
    assert not loss.requires_grad  # nothing to differentiate
    assert all(float(np.abs(np.asarray(g)).max()) == 0.0
               for g in ref.values())
    assert all(leaf.grad is None for leaf in flat.values())


@pytest.mark.parametrize("network", ["vgg_16", "resnet_v2_50"])
def test_fine_tuned_imagenet_gradients_and_step_match_jax(network):
    jax_enc, enc = _encoders(network, fine_tune=True)
    jax_params, params, draw = _shared([jax_enc], [enc], seed=8)
    ref, flat, _ = _grads(jax_enc, enc, jax_params, params,
                          _images((32, 32, 3), seed=9))
    assert set(ref) == set(flat)
    for key, want in ref.items():
        want = np.asarray(want)
        assert float(np.abs(want).max()) > 0.0, key
        assert _rel(flat[key].grad, want) <= GRAD_TOL, key
    # one SGD step from the shared draw
    lr = 1e-3
    for key, want in ref.items():
        stepped = (flat[key] - lr * flat[key].grad).detach().numpy()
        np.testing.assert_allclose(stepped, draw[key] - lr * np.asarray(want),
                                   rtol=0, atol=lr * GRAD_TOL * float(
                                       np.abs(np.asarray(want)).max())
                                   + 1e-7, err_msg=key)


# ---------------------------------------------------------------------- #
# a captioning model with the CNN in the graph
# ---------------------------------------------------------------------- #
OUT, BEAM, VOCAB = 5, 3, 30


def _captioner(fine_tune):
    models = []
    for inet, att, dec, vocab in (
            (jax_inet, JaxAttention, JaxDecoder, JaxVocabulary),
            (imagenet_encoder, Attention, Decoder, Vocabulary)):
        enc = inet.ImageNet(name="img", data_id="images",
                            network_type="vgg_16", fine_tune=fine_tune)
        models.append(dec(
            name="decoder",
            vocabulary=vocab([f"w{i}" for i in range(VOCAB - 4)]),
            data_id="caption", max_output_len=OUT, encoders=[enc],
            attentions=[att(name="att", encoder=enc, state_size=12)],
            rnn_size=16, embedding_size=16))
    return models


def _caption_batch(seed):
    rng = np.random.RandomState(seed)
    full = rng.randint(4, VOCAB, (2, OUT + 1)).astype(np.int32)
    full[:, 0] = 1  # <s>
    mask = np.ones((2, OUT), np.float32)
    mask[1, 3:] = 0.0
    return {"img.images": _images((32, 32, 3), seed=seed + 1),
            "decoder.train_inputs": full[:, :-1],
            "decoder.train_targets": full[:, 1:],
            "decoder.train_mask": mask}


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.detach().to(dtype).requires_grad_(True)


def _port_grads(dec, params, batch, dtype):
    """The port's loss and gradients with every parameter and float
    batch array in ``dtype``."""
    tree = _cast(params, dtype)
    loss = dec.train_loss(Context(tree, {
        k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32
        else torch.from_numpy(v) for k, v in batch.items()}))
    loss.backward()
    return loss, {k: v.grad for k, v in flatten_tree(tree).items()}


@pytest.mark.parametrize("fine_tune", [False, True])
def test_captioning_model_matches_jax(fine_tune):
    """The loss and the decoder's gradients of a float32 step; the CNN's
    gradients all zero when frozen, and when fine-tuned those of a
    float64 step of the port (one of VGG's ReLUs may sit within float32
    rounding of 0, where a float32 gradient takes either branch: the
    card's float64 rule in ``chip_smoke.py``)."""
    jax_dec, dec = _captioner(fine_tune)
    jax_params, params, _ = _shared([jax_dec], [dec], seed=10)
    batch = _caption_batch(11)
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    jax_loss, jax_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_dec.train_loss(JaxContext(p, jax_batch))))(jax_params)
    loss, grads = _port_grads(dec, params, batch, torch.float32)
    if fine_tune:
        grads64 = _port_grads(dec, params, batch, torch.float64)[1]
    assert abs(loss.item() - float(jax_loss)) <= 1e-5 * abs(float(jax_loss))
    for key, want in jax_flatten(jax_grads).items():
        want = np.asarray(want)
        if key.startswith("img/") and not fine_tune:
            assert grads[key] is None and float(np.abs(want).max()) == 0.0
            continue
        got = grads64[key] if key.startswith("img/") else grads[key]
        assert _rel(got.float(), want) <= GRAD_TOL, key

    ctx = Context(params, {"img.images": torch.from_numpy(
        batch["img.images"])})
    jax_ctx = JaxContext(jax_params, {"img.images": jax_batch["img.images"]})
    with torch.inference_mode():
        np.testing.assert_array_equal(
            dec.greedy_ids(ctx).numpy(), np.asarray(jax.jit(
                lambda p: jax_dec.greedy_ids(JaxContext(
                    p, {"img.images": jax_batch["img.images"]})))(
                        jax_params)))
        got = BeamSearchDecoder(name="bs", parent_decoder=dec,
                                beam_size=BEAM).search(ctx)
    want = JaxBeamSearch(name="bs", parent_decoder=jax_dec,
                         beam_size=BEAM).search(jax_ctx)
    np.testing.assert_array_equal(got.token_ids.numpy(),
                                  np.asarray(want.token_ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-4)


# ---------------------------------------------------------------------- #
# the converter
# ---------------------------------------------------------------------- #
def _slim_vgg(network, rng):
    source = {}
    cin = 3
    for block, n_convs in enumerate(jax_inet.VGG_CONFIGS[network], start=1):
        cout = jax_inet.VGG_CHANNELS[block - 1]
        for i in range(1, n_convs + 1):
            key = f"{network}/conv{block}/conv{block}_{i}"
            source[f"{key}/weights"] = (rng.randn(3, 3, cin, cout)
                                        * np.sqrt(2.0 / (9 * cin))
                                        ).astype(np.float32)
            source[f"{key}/biases"] = (rng.randn(cout) * 0.05).astype(
                np.float32)
            cin = cout
    return source


def _slim_resnet(network, rng):
    source = {}

    def bn(key, c):
        source[f"{key}/gamma"] = (1 + 0.2 * rng.rand(c)).astype(np.float32)
        source[f"{key}/beta"] = (0.05 * rng.randn(c)).astype(np.float32)
        source[f"{key}/moving_mean"] = (0.05 * rng.randn(c)).astype(
            np.float32)
        source[f"{key}/moving_variance"] = (1 + 0.2 * rng.rand(c)).astype(
            np.float32)

    def conv(key, kh, cin, cout, bias=False):
        source[f"{key}/weights"] = (rng.randn(kh, kh, cin, cout) * np.sqrt(
            2.0 / (kh * kh * cin))).astype(np.float32)
        if bias:
            source[f"{key}/biases"] = (0.05 * rng.randn(cout)).astype(
                np.float32)

    conv(f"{network}/conv1", 7, 3, 64, bias=True)
    cin = 64
    for stage, n_blocks in enumerate(jax_inet.RESNET_CONFIGS[network],
                                     start=1):
        cmid = 64 * 2 ** (stage - 1)
        for block in range(n_blocks):
            key = f"{network}/block{stage}/unit_{block + 1}/bottleneck_v2"
            bn(f"{key}/preact", cin)
            conv(f"{key}/conv1", 1, cin, cmid)
            bn(f"{key}/conv1/BatchNorm", cmid)
            conv(f"{key}/conv2", 3, cmid, cmid)
            bn(f"{key}/conv2/BatchNorm", cmid)
            conv(f"{key}/conv3", 1, cmid, 4 * cmid, bias=True)
            if block == 0:
                conv(f"{key}/shortcut", 1, cin, 4 * cmid, bias=True)
            cin = 4 * cmid
    bn(f"{network}/postnorm", cin)
    return source


def _torchvision_vgg(slim, network):
    names = [f"conv{b}_{i}" for b, n in enumerate(
        jax_inet.VGG_CONFIGS[network], start=1) for i in range(1, n + 1)]
    out = {}
    for name, idx in zip(names,
                         jax_convert._TORCHVISION_VGG_CONV_IDX[network]):
        key = f"{network}/conv{name[4]}/{name}"
        out[f"features.{idx}.weight"] = slim[f"{key}/weights"].transpose(
            3, 2, 0, 1)  # HWIO -> OIHW
        out[f"features.{idx}.bias"] = slim[f"{key}/biases"]
    return out


@pytest.mark.parametrize("network,layout", [
    ("vgg_16", "slim"), ("vgg_16", "torchvision"), ("resnet_v2_50", "slim")])
def test_convert_imagenet_matches_jax_and_warm_starts(tmp_path, network,
                                                      layout):
    rng = np.random.RandomState(12)
    source = (_slim_vgg(network, rng) if network.startswith("vgg")
              else _slim_resnet(network, rng))
    if layout == "torchvision":
        source = _torchvision_vgg(source, network)
    assert convert_imagenet.detect_layout(source) == layout
    want = jax_convert.convert(source, network)
    got = convert_imagenet.convert(source, network)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key])

    src = str(tmp_path / "source.npz")
    with open(src, "wb") as f:
        np.savez(f, **source)
    outs = {}
    for name, module in (("port", convert_imagenet), ("jax", jax_convert)):
        outs[name] = str(tmp_path / f"{name}.npz")
        assert module.main(["--source", src, "--network", network,
                            "--output", outs[name]]) == 0
    with np.load(outs["port"]) as a, np.load(outs["jax"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])

    # a warm start through the port's manager from the converted file
    jax_enc, enc = _encoders(network, load_checkpoint=outs["port"])
    manager = CUDAManager(random_seed=0, device="cpu")
    manager.initialize_model_parts([enc], seed=0)
    for key, value in flatten_tree(manager.params["img"]).items():
        np.testing.assert_array_equal(value.numpy(), want[key])
    images = _images((32, 32, 3), seed=13)
    batch = enc.featurize(Dataset("d", {"images": list(images)}))
    ctx = Context(manager.params, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    jax_params = {"img": jax_restore(jax.eval_shape(lambda: jax_init(
        jax_collect_parts([jax_enc]), jax.random.PRNGKey(0)))["img"], want)}
    ref = _jax_layers(jax_enc, jax_params, images)
    with torch.inference_mode():
        default = "conv5_3" if network == "vgg_16" else "postnorm"
        assert _rel(enc.spatial_states(ctx), ref[default]) <= REL_TOL


def test_convert_imagenet_refuses_a_resnet_in_the_torchvision_layout():
    source = _torchvision_vgg(_slim_vgg("vgg_16", np.random.RandomState(0)),
                              "vgg_16")
    for module in (convert_imagenet, jax_convert):
        with pytest.raises(ValueError, match="slim-layout"):
            module.convert(source, "resnet_v2_50")
        with pytest.raises(ValueError, match="Cannot detect"):
            module.detect_layout({"x": np.zeros(1)})


# ---------------------------------------------------------------------- #
# refusals
# ---------------------------------------------------------------------- #
def test_imagenet_refusals(monkeypatch):
    with pytest.raises(ValueError, match="input_size"):
        imagenet_encoder.ImageNet(name="img", data_id="images",
                                  input_size=64)
    for module in (imagenet_encoder, jax_inet):
        with pytest.raises(ValueError, match="network_type"):
            module.ImageNet(name="img", data_id="images",
                            network_type="vgg_11")
    enc = imagenet_encoder.ImageNet(name="img", data_id="images",
                                    spatial_layer="conv9_9")
    params = init_all_params(collect_parts([enc]), seed=0)
    ctx = Context(params, {"img.images": torch.zeros(1, 32, 32, 3)})
    with pytest.raises(ValueError, match="conv9_9"):
        enc.spatial_states(ctx)
    # under the bf16 compute policy (both packages read the variable) the
    # JAX package's convolution raises a TypeError on the float32 images
    # beside the bf16 kernels, the port a ValueError that names the
    # policy, before any convolution runs
    jax_enc = jax_inet.ImageNet(name="img", data_id="images")
    jax_params = jax.tree_util.tree_map(
        lambda leaf: jnp.zeros(leaf.shape, leaf.dtype),
        jax.eval_shape(lambda: jax_init(jax_collect_parts([jax_enc]),
                                        jax.random.PRNGKey(0))))
    monkeypatch.setenv("NM_COMPUTE_DTYPE", "bfloat16")
    assert policy.compute_dtype() == torch.bfloat16
    assert jax_policy.compute_dtype() == jnp.bfloat16
    with pytest.raises(TypeError):
        jax.jit(lambda p: jax_enc.output(JaxContext(
            p, {"img.images": jnp.zeros((1, 32, 32, 3))})))(jax_params)
    ctx = Context(params, {"img.images": torch.zeros(1, 32, 32, 3)})
    with pytest.raises(ValueError, match="bfloat16"):
        enc.output(ctx)


@pytest.mark.slow
@pytest.mark.parametrize("network", ["vgg_19", "resnet_v2_101",
                                     "resnet_v2_152"])
def test_deep_imagenet_matches_jax(network):
    jax_enc, enc = _encoders(network)
    jax_params, params, _ = _shared([jax_enc], [enc], seed=14)
    images = _images((32, 32, 3), seed=15)
    ref = _jax_layers(jax_enc, jax_params, images)
    ctx = Context(params, {"img.images": torch.from_numpy(images)})
    with torch.inference_mode():
        for name, value in enc._layers(ctx).items():
            assert _rel(value, ref[name]) <= REL_TOL, name
