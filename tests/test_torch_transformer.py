"""The port's Transformer against the JAX package, on the CPU.

The JAX side runs its Pallas kernels in interpret mode
(``NM_USE_PALLAS=1``, as tests/test_flash_dropout.py runs them), so its
model paths go through flash attention, the lineage kernel and the
fused kernels. Sizes: 2 layers, width 32, 4 heads.

- The encoder's states from the same parameters, ragged masks: 1e-5.
- The decoder's ``train_loss`` and the gradient of every parameter,
  label smoothing 0.1, dropout off, with and without ``NM_FUSED_XENT=1``
  (tied (V, D) layout): loss 1e-5, gradients 2e-5 absolute plus 1e-4
  relative (float32 sums in another order).
- Recomputation (``remat=True``) gives the loss and gradients of the
  plain pass, dropout on (the layers replay the same masks); every
  parameter gets a gradient.
- Greedy ids and beam-10 ids (and scores to 1e-4) from one shared
  ``.npz``, through both lineage forms and both selections; the RNN's
  beam-10 ids through the ancestry-carrying search.
- tests/configs/transformer.ini (``DelayedUpdateTrainer`` at k = 2, Adam,
  noam, label smoothing, BPE) trained 4 steps by both packages from one
  set of parameters: losses and gradient norms step by step to 1e-4
  relative (Adam divides by the square roots of tiny second moments).
- BPE pre- and postprocessing equal to the JAX package's on tests/data.
- transformer.ini and examples/transformer_bpe.ini train and decode
  through the port's ``train`` and ``run`` CLIs on the CPU.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from neuralmonkey_tpu.experiment import Experiment as JaxExperiment
from neuralmonkey_tpu.model.part import Context as JaxContext
from neuralmonkey_tpu.model.part import collect_parts as jax_collect_parts
from neuralmonkey_tpu.model.part import init_all_params as jax_init
from neuralmonkey_tpu.models.attention.feed_forward import \
    Attention as JaxAttention
from neuralmonkey_tpu.models.decoders.beam_search_decoder import \
    BeamSearchDecoder as JaxBeamSearch
from neuralmonkey_tpu.models.decoders.decoder import Decoder as JaxDecoder
from neuralmonkey_tpu.models.decoders.transformer import \
    TransformerDecoder as JaxTransformerDecoder
from neuralmonkey_tpu.models.encoders.recurrent import \
    SentenceEncoder as JaxSentenceEncoder
from neuralmonkey_tpu.models.encoders.transformer import \
    TransformerEncoder as JaxTransformerEncoder
from neuralmonkey_tpu.ops import kernel_config as jax_kernel_config
from neuralmonkey_tpu.processors.bpe import (
    BPEPostprocessor as JaxBPEPostprocessor,
    BPEPreprocessor as JaxBPEPreprocessor)
from neuralmonkey_tpu.utils.saving import flatten_tree as jax_flatten
from neuralmonkey_tpu.utils.saving import restore_into as jax_restore
from neuralmonkey_tpu.vocabulary import Vocabulary as JaxVocabulary

from neuralmonkey_tpu_torch import run as torch_run
from neuralmonkey_tpu_torch import train as torch_train
from neuralmonkey_tpu_torch.dataset import BatchingScheme
from neuralmonkey_tpu_torch.experiment import Experiment
from neuralmonkey_tpu_torch.model.part import (Context, collect_parts,
                                               init_all_params)
from neuralmonkey_tpu_torch.models.attention.feed_forward import Attention
from neuralmonkey_tpu_torch.models.decoders.beam_search_decoder import \
    BeamSearchDecoder
from neuralmonkey_tpu_torch.models.decoders.decoder import Decoder
from neuralmonkey_tpu_torch.models.decoders.transformer import \
    TransformerDecoder
from neuralmonkey_tpu_torch.models.encoders.recurrent import SentenceEncoder
from neuralmonkey_tpu_torch.models.encoders.transformer import \
    TransformerEncoder
from neuralmonkey_tpu_torch.processors.bpe import (BPEPostprocessor,
                                                   BPEPreprocessor)
from neuralmonkey_tpu_torch.runtime import CUDAManager
from neuralmonkey_tpu_torch.utils.saving import (flatten_tree, load_flat,
                                                 params_from_jax)
from neuralmonkey_tpu_torch.vocabulary import Vocabulary

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
CONFIG = os.path.join(REPO, "tests", "configs", "transformer.ini")
BATCH, SRC, TGT, WIDTH, VOCAB = 3, 7, 6, 32, 60


@pytest.fixture
def jax_pallas(monkeypatch):
    """The JAX package's Pallas kernels, in interpret mode."""
    monkeypatch.setenv("NM_USE_PALLAS", "1")
    jax_kernel_config._use_pallas_cached.cache_clear()
    yield monkeypatch
    jax_kernel_config._use_pallas_cached.cache_clear()


def _build(enc_cls, dec_cls, vocab_cls, label_smoothing=0.1, keep=1.0,
           att_keep=1.0, remat=False, max_out=TGT):
    vocab = vocab_cls([f"w{i}" for i in range(VOCAB - 4)])
    enc = enc_cls(name="encoder", vocabulary=vocab, data_id="source",
                  embedding_size=WIDTH, ff_hidden_size=64, depth=2,
                  n_heads=4, dropout_keep_prob=keep,
                  attention_dropout_keep_prob=att_keep, max_input_len=SRC,
                  remat=remat)
    return dec_cls(name="decoder", vocabulary=vocab, data_id="target",
                   max_output_len=max_out, encoders=[enc],
                   embedding_size=WIDTH, ff_hidden_size=64, depth=2,
                   n_heads_self=4, n_heads_enc=4,
                   label_smoothing=label_smoothing, dropout_keep_prob=keep,
                   attention_dropout_keep_prob=att_keep, remat=remat)


def _jax_params(jax_dec, seed=0, scale=0.1):
    """The JAX initialization, perturbed so that every bias and layer
    norm parameter is off its initial value: flat numpy arrays."""
    rng = np.random.RandomState(seed)
    template = jax_init(jax_collect_parts([jax_dec]), jax.random.PRNGKey(0))
    flat = {k: (np.asarray(v) + rng.randn(*v.shape) * scale).astype(
        np.float32) for k, v in jax_flatten(template).items()}
    return template, flat


def _port_params(port_dec, flat):
    return params_from_jax(flat, init_all_params(collect_parts([port_dec]),
                                                 seed=0))


def _batch(rng, targets=True):
    mask = np.zeros((BATCH, SRC), np.float32)
    for i, n in enumerate([7, 4, 2]):
        mask[i, :n] = 1.0
    batch = {"encoder_input.ids": rng.randint(4, VOCAB, (BATCH, SRC)).astype(
                 np.int32),
             "encoder_input.mask": mask}
    if targets:
        tmask = np.zeros((BATCH, TGT), np.float32)
        for i, n in enumerate([6, 3, 1]):
            tmask[i, :n] = 1.0
        batch.update({
            "decoder.train_inputs": rng.randint(1, VOCAB, (BATCH, TGT)
                                                ).astype(np.int32),
            "decoder.train_targets": rng.randint(2, VOCAB, (BATCH, TGT)
                                                 ).astype(np.int32),
            "decoder.train_mask": tmask})
    return batch


def _jax_ctx(params, batch, train=False):
    return JaxContext(params, {k: jax.numpy.asarray(v)
                               for k, v in batch.items()},
                      train=train, rng=jax.random.PRNGKey(1))


def _port_ctx(params, batch, train=False, rng=1):
    return Context(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                   train=train, rng=rng)


# ---------------------------------------------------------------------- #
# encoder and decoder against JAX
# ---------------------------------------------------------------------- #
def test_encoder_states_match_jax(jax_pallas):
    jax_dec = _build(JaxTransformerEncoder, JaxTransformerDecoder,
                     JaxVocabulary)
    port_dec = _build(TransformerEncoder, TransformerDecoder, Vocabulary)
    template, flat = _jax_params(jax_dec)
    batch = _batch(np.random.RandomState(1), targets=False)
    jax_enc, port_enc = jax_dec.encoders[0], port_dec.encoders[0]
    ref = jax_enc.temporal_states(_jax_ctx(jax_restore(template, flat),
                                           batch))
    got = port_enc.temporal_states(_port_ctx(_port_params(port_dec, flat),
                                             batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    ref_out = jax_enc.output(_jax_ctx(jax_restore(template, flat), batch))
    got_out = port_enc.output(_port_ctx(_port_params(port_dec, flat),
                                        batch))
    np.testing.assert_allclose(got_out.numpy(), np.asarray(ref_out),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_decoder_loss_and_gradients_match_jax(jax_pallas, fused):
    if fused:
        jax_pallas.setenv("NM_FUSED_XENT", "1")
    jax_dec = _build(JaxTransformerEncoder, JaxTransformerDecoder,
                     JaxVocabulary)
    port_dec = _build(TransformerEncoder, TransformerDecoder, Vocabulary)
    template, flat = _jax_params(jax_dec)
    batch = _batch(np.random.RandomState(2))

    def jax_loss(p):
        return jax_dec.train_loss(_jax_ctx(p, batch, train=True))
    ref_loss, ref_grads = jax.value_and_grad(jax_loss)(
        jax_restore(template, flat))
    ref_grads = jax_flatten(ref_grads)

    params = _port_params(port_dec, flat)
    leaves = flatten_tree(params)
    for p in leaves.values():
        p.requires_grad_(True)
    loss = port_dec.train_loss(_port_ctx(params, batch, train=True))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=1e-5,
                               rtol=0)
    assert set(leaves) == set(ref_grads)
    for key, p in leaves.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_grads[key]),
                                   atol=2e-5, rtol=1e-4, err_msg=key)


def _loss_and_grads(dec, params, batch):
    leaves = flatten_tree(params)
    for p in leaves.values():
        p.grad = None
        p.requires_grad_(True)
    loss = dec.train_loss(_port_ctx(params, batch, train=True, rng=5))
    loss.backward()
    return loss.item(), {k: p.grad.clone() for k, p in leaves.items()}


def test_remat_matches_the_plain_pass_with_dropout_on():
    batch = _batch(np.random.RandomState(3))
    plain = _build(TransformerEncoder, TransformerDecoder, Vocabulary,
                   keep=0.8, att_keep=0.9)
    remat = _build(TransformerEncoder, TransformerDecoder, Vocabulary,
                   keep=0.8, att_keep=0.9, remat=True)
    params = init_all_params(collect_parts([plain]), seed=3)
    ref_loss, ref_grads = _loss_and_grads(plain, params, batch)
    loss, grads = _loss_and_grads(remat, params, batch)
    assert loss == pytest.approx(ref_loss, rel=1e-6)
    for key, g in grads.items():
        torch.testing.assert_close(g, ref_grads[key], atol=1e-6, rtol=1e-5)
    # dropout is on: another pass seed gives another loss
    other = plain.train_loss(_port_ctx(params, batch, train=True, rng=6))
    assert other.item() != pytest.approx(ref_loss, rel=1e-6)
    missing = [k for k, g in grads.items() if not bool(g.abs().sum() > 0)]
    assert not missing, missing


# ---------------------------------------------------------------------- #
# decoding from one shared checkpoint
# ---------------------------------------------------------------------- #
def _decode_both(tmp_path, enc_cls_pair, dec_cls_pair, build, beam,
                 selection, monkeypatch, exact_rounding=False):
    """Greedy and beam ids of both packages from one shared ``.npz``.
    ``exact_rounding`` compiles the JAX side with XLA's excess precision
    off, so that it rounds after every bf16 operation as the port does
    (tests/test_torch_precision.py)."""
    jax_dec = build(enc_cls_pair[0], dec_cls_pair[0], JaxVocabulary)
    port_dec = build(enc_cls_pair[1], dec_cls_pair[1], Vocabulary)
    template, flat = _jax_params(jax_dec, seed=4, scale=0.3)
    ckpt = tmp_path / "shared.npz"
    with open(ckpt, "wb") as f:
        np.savez(f, **flat)
    params = params_from_jax(load_flat(str(ckpt)), init_all_params(
        collect_parts([port_dec]), seed=0))
    batch = _batch(np.random.RandomState(5), targets=False)
    jax_bs = JaxBeamSearch(name="bs", parent_decoder=jax_dec,
                           beam_size=beam, selection_method=selection)
    port_bs = BeamSearchDecoder(name="bs", parent_decoder=port_dec,
                                beam_size=beam, selection_method=selection)
    jax_params = jax_restore(template, flat)
    if exact_rounding:
        def run(fn):
            return jax.jit(fn).lower(jax_params).compile(
                {"xla_allow_excess_precision": False})(jax_params)
    else:
        def run(fn):
            return fn(jax_params)
    ref_greedy = np.asarray(run(lambda p: jax_dec.decoded(_jax_ctx(p,
                                                                   batch))))
    ref = run(lambda p: jax_bs.search(_jax_ctx(p, batch)))
    with torch.inference_mode():
        ctx = _port_ctx(params, batch)
        greedy = port_dec.decoded(ctx).numpy()
        got = port_bs.search(ctx)
    np.testing.assert_array_equal(greedy, ref_greedy)
    np.testing.assert_array_equal(got.token_ids.numpy(),
                                  np.asarray(ref.token_ids))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores),
                               atol=1e-4)


@pytest.mark.parametrize("lineage_kernel", ["0", "1"])
@pytest.mark.parametrize("selection", ["flat", "hierarchical"])
def test_transformer_ids_match_jax(tmp_path, jax_pallas, lineage_kernel,
                                   selection):
    """Greedy and beam-10 ids through the einsum lineage step and, with
    NM_LINEAGE_KERNEL=1, through the lineage attention on caches in the
    kernel's layout (the JAX package's interpreted kernel)."""
    jax_pallas.setenv("NM_LINEAGE_KERNEL", lineage_kernel)
    _decode_both(tmp_path, (JaxTransformerEncoder, TransformerEncoder),
                 (JaxTransformerDecoder, TransformerDecoder),
                 lambda e, d, v: _build(e, d, v, max_out=9), 10, selection,
                 jax_pallas)


@pytest.mark.parametrize("lineage_kernel", ["0", "1"])
def test_transformer_head_dim_192_ids_match_jax(tmp_path, jax_pallas,
                                                lineage_kernel):
    """Head dim 192, which the JAX flash kernels pad and the JAX lineage
    kernel's lane rule refuses: the port's attention takes flash
    attention (its kernels take head dims up to 256), and under
    NM_LINEAGE_KERNEL=1 its lineage kernel layout (the kernel takes head
    dims up to 512) gives the ids of the JAX package, whose decoder keeps
    the einsum form there."""
    jax_pallas.setenv("NM_LINEAGE_KERNEL", lineage_kernel)

    def build(enc_cls, dec_cls, vocab_cls):
        vocab = vocab_cls([f"w{i}" for i in range(VOCAB - 4)])
        enc = enc_cls(name="encoder", vocabulary=vocab, data_id="source",
                      embedding_size=384, ff_hidden_size=64, depth=1,
                      n_heads=2, dropout_keep_prob=1.0, max_input_len=SRC)
        return dec_cls(name="decoder", vocabulary=vocab, data_id="target",
                       max_output_len=6, encoders=[enc], embedding_size=384,
                       ff_hidden_size=64, depth=1, n_heads_self=2,
                       n_heads_enc=2, label_smoothing=0.1,
                       dropout_keep_prob=1.0)
    _decode_both(tmp_path, (JaxTransformerEncoder, TransformerEncoder),
                 (JaxTransformerDecoder, TransformerDecoder), build, 4,
                 "hierarchical", jax_pallas)


def test_lineage_bf16_caches_raise(tmp_path, jax_pallas):
    """``NM_LINEAGE_KERNEL_BF16=1`` no longer raises: under the float32
    policy the lineage kernel layout keeps its caches in bf16 (the
    kernel's bf16 instance on the card, its plain version here), and the
    greedy and beam-10 ids equal the JAX package's on its interpreted
    kernel over bf16 caches (scores to 1e-4), the JAX side rounding after
    every bf16 operation (``exact_rounding``)."""
    jax_pallas.setenv("NM_LINEAGE_KERNEL", "1")
    jax_pallas.setenv("NM_LINEAGE_KERNEL_BF16", "1")
    # one device: a JAX manager built earlier in this process leaves its
    # 8-device mesh registered, and its sharded kernels sum in another
    # order
    jax_pallas.setattr(jax_kernel_config, "_ACTIVE_MESH", None)
    dec = _build(TransformerEncoder, TransformerDecoder, Vocabulary)
    state = dec.tile_decode_state(dec.decode_initial_state(
        _port_ctx(init_all_params(collect_parts([dec]), seed=0),
                  _batch(np.random.RandomState(0), targets=False)),
        {"embed_table": torch.zeros(1, 32)}), 4)
    assert {c.dtype for layer in state for c in layer.values()} == {
        torch.bfloat16}
    _decode_both(tmp_path, (JaxTransformerEncoder, TransformerEncoder),
                 (JaxTransformerDecoder, TransformerDecoder),
                 lambda e, d, v: _build(e, d, v, max_out=9), 10,
                 "hierarchical", jax_pallas, exact_rounding=True)


def _build_rnn(enc_cls, dec_cls, vocab_cls):
    att_cls = JaxAttention if enc_cls is JaxSentenceEncoder else Attention
    vocab = vocab_cls([f"w{i}" for i in range(VOCAB - 4)])
    enc = enc_cls(name="encoder", vocabulary=vocab, data_id="source",
                  embedding_size=16, rnn_size=16, max_input_len=SRC)
    att = att_cls(name="attention", encoder=enc, state_size=16)
    return dec_cls(name="decoder", vocabulary=vocab, data_id="target",
                   max_output_len=8, rnn_size=16, encoders=[enc],
                   attentions=[att], embedding_size=16,
                   conditional_gru=True)


@pytest.mark.parametrize("selection", ["flat", "hierarchical"])
@pytest.mark.parametrize("composed", [False, True])
def test_rnn_beam_ids_unchanged(tmp_path, monkeypatch, selection, composed):
    """The RNN decoder reads its parents from the ancestry the search now
    carries: its beam-10 ids still equal the JAX package's, whether the
    search writes only the parents' column (the RNN's default) or
    composes the whole ancestry."""
    monkeypatch.setattr(Decoder, "reads_ancestry", composed)
    _decode_both(tmp_path, (JaxSentenceEncoder, SentenceEncoder),
                 (JaxDecoder, Decoder), _build_rnn, 10, selection,
                 monkeypatch)


# ---------------------------------------------------------------------- #
# transformer.ini: delayed updates, noam, BPE; the CLIs
# ---------------------------------------------------------------------- #
def _changes(tmp_path, extra=()):
    return [f'main.output="{tmp_path / "out"}"',
            "encoder.dropout_keep_prob=1.0",
            "decoder.dropout_keep_prob=1.0", *extra]


def test_delayed_updates_train_like_optax_multisteps(tmp_path):
    """Four batches at batches_per_update=2: two real Adam updates on
    the averaged, clipped gradients, the noam rate stepping once per
    update; the losses, gradient norms and parameters follow the JAX
    package's optax.MultiSteps step by step."""
    jax_exp = JaxExperiment(CONFIG, train_mode=True,
                            config_changes=_changes(tmp_path))
    jax_exp.build_model()
    exp = Experiment(CONFIG, train_mode=True, config_changes=_changes(
        tmp_path, ['tf_manager.device="cpu"']))
    exp.build_model()
    manager = exp.tf_manager
    manager.params = params_from_jax(jax_flatten(jax_exp.tf_manager.params),
                                     manager.params)
    scheme = BatchingScheme(batch_size=16)
    jax_batches = jax_exp.model.train_dataset.batches(scheme, shuffled=False)
    batches = exp.model.train_dataset.batches(scheme, shuffled=False)
    before = {k: v.clone() for k, v in flatten_tree(manager.params).items()}
    for step in range(4):
        ref = jax_exp.tf_manager.train_on_batch(jax_exp.model.trainer,
                                                next(jax_batches), 16)
        got = manager.train_on_batch(exp.model.trainer, next(batches), 16)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-4,
                                       err_msg=f"step {step} {key}")
        changed = any(not torch.equal(before[k], v) for k, v in
                      flatten_tree(manager.params).items())
        assert changed == (step >= 1), step
    ref_params = jax_flatten(jax_exp.tf_manager.params)
    for key, value in flatten_tree(manager.params).items():
        if key.endswith("/k/b"):
            # a key bias shifts every score of a row alike: its gradient
            # is float32 rounding noise, which Adam scales to full steps
            continue
        np.testing.assert_allclose(value.detach().numpy(),
                                   np.asarray(ref_params[key]),
                                   atol=1e-5, rtol=1e-3, err_msg=key)


def test_bpe_matches_jax():
    merges = os.path.join(DATA, "merges.bpe")
    jax_pre, pre = JaxBPEPreprocessor(merge_file=merges), \
        BPEPreprocessor(merge_file=merges)
    jax_post, post = JaxBPEPostprocessor(), BPEPostprocessor()
    for name in ("train.en", "train.de", "val.en", "val.de"):
        with open(os.path.join(DATA, name), encoding="utf-8") as f:
            sentences = [line.split() for line in f]
        encoded = [pre(s) for s in sentences]
        assert encoded == [jax_pre(s) for s in sentences], name
        assert any(any(t.endswith("@@") for t in s) for s in encoded), name
        assert post(encoded) == jax_post(encoded) == sentences, name


DATA_INI = """\
[main]
test_datasets=[<test_data>]

[bpe]
class=processors.bpe.BPEPreprocessor
merge_file="{data}/merges.bpe"

[test_data]
class=dataset.load_dataset_from_files
s_source="{data}/val.en"
s_target="{data}/val.de"
preprocessors=[("source", "source_bpe", <bpe>)]
{outputs}
"""


def _train_and_run(tmp_path, config, changes, outputs, data=DATA):
    assert torch_train.main([config, *changes]) == 0
    out = tmp_path / "out"
    assert os.path.exists(out / "variables.data.best")
    data_ini = tmp_path / "data.ini"
    data_ini.write_text(DATA_INI.format(data=data, outputs="\n".join(
        f's_{series}_out="{out}/{series}.txt"' for series in outputs)))
    assert torch_run.main([str(out / "experiment.ini"), str(data_ini),
                           str(out / "variables.data.best")]) == 0
    for series in outputs:
        with open(out / f"{series}.txt", encoding="utf-8") as f:
            lines = f.read().splitlines()
        assert len(lines) == 30
        assert not any("@@" in line for line in lines)


def test_transformer_ini_through_the_clis(tmp_path):
    _train_and_run(tmp_path, CONFIG, _changes(tmp_path, [
        'tf_manager.device="cpu"', "main.epochs=1"]), ["target"])


def test_transformer_bpe_example_through_the_clis(tmp_path):
    """examples/transformer_bpe.ini (length buckets, a lazy training set,
    greedy and beam-10 runners, BPE on both sides) with its data
    variable pointed at tests/data and its widths cut for the CPU."""
    data = tmp_path / "data"
    data.mkdir()
    for name in ("train.en", "train.de", "val.en", "val.de", "merges.bpe"):
        shutil.copy(os.path.join(DATA, name), data / name)
    text = open(os.path.join(REPO, "examples", "transformer_bpe.ini"),
                encoding="utf-8").read()
    text = text.replace('data="data/iwslt14"', f'data="{data}"')
    config = tmp_path / "transformer_bpe.ini"
    config.write_text(text)
    small = [f"{part}.{key}={value}" for part in ("encoder", "decoder")
             for key, value in (("embedding_size", 32),
                                ("ff_hidden_size", 64), ("depth", 2))]
    _train_and_run(tmp_path, str(config), [
        f'main.output="{tmp_path / "out"}"', 'tf_manager.device="cpu"',
        "main.epochs=1", "main.batch_size=32", "batching.batch_size=32",
        "noam.model_dimension=32", "decoder.max_output_len=12", *small],
        ["target", "target_beam"], data=str(data))


def test_context_parallel_settings_raise():
    """Context parallelism is ported (tests/test_torch_context_parallel.py);
    in one process a context axis of 2 does not divide the world: the
    JAX package's error."""
    with pytest.raises(ValueError,
                       match="1 devices not divisible by context=2"):
        CUDAManager(device="cpu", num_context_shards=2)


@pytest.mark.parametrize("option", ["moe_experts", "pipeline_stages"])
def test_unported_transformer_options_raise(option):
    """Both options are ported (tests/test_torch_moe.py,
    tests/test_torch_pipeline.py, tests/test_torch_expert_parallel.py);
    what raises is what the JAX package refuses: an expert or pipe axis
    one process cannot hold, and pipeline options the depth does not
    divide."""
    vocab = Vocabulary(["a", "b"])
    if option == "moe_experts":
        encoder = TransformerEncoder(name="enc", vocabulary=vocab,
                                     data_id="source", embedding_size=8,
                                     n_heads=2, moe_experts=2)
        assert encoder.moe.on
        with pytest.raises(ValueError,
                           match="1 devices not divisible by expert=2"):
            CUDAManager(device="cpu", num_expert_shards=2)
        return
    encoder = TransformerEncoder(name="enc", vocabulary=vocab,
                                 data_id="source", embedding_size=8,
                                 n_heads=2, **{option: 2})
    assert encoder.pipeline_stages == 2
    with pytest.raises(ValueError, match="depth 6 not divisible by 4"):
        TransformerEncoder(name="enc", vocabulary=vocab, data_id="source",
                           embedding_size=8, n_heads=2, **{option: 4})
    with pytest.raises(ValueError, match="1 devices not divisible by pipe=2"):
        CUDAManager(device="cpu", num_pipeline_stages=2)
