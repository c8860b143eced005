"""The port's model and trainer long tail against the JAX package, on
the CPU: per-part warm starts, the prefetch thread, ``align_logits`` and
``use_approx_top_k``, attention images and ``visualize_embeddings``.

- Warm starts: a part's ``load_checkpoint`` takes its ``<part>/...``
  entries of a whole-model ``.npz``, or a part-local ``.npz`` without
  the prefix; the restored tensors equal the file's, the other parts
  keep their initialization; ``save_checkpoint`` raises.
- The prefetch worker, the five cases of
  ``tests/test_prefetch_robustness.py`` on the port's manager (early
  break, consumer exception, worker exception, full iteration, 60
  abandoned rounds beside training steps); and its batches, shuffle
  draws included, equal the synchronous loop's.
- Beam search from one shared ``.npz``: ``align_logits`` (hierarchical,
  the fused projection off and on) and ``use_approx_top_k`` (flat, at a
  vocabulary where "auto" would be hierarchical) give the JAX package's
  ids, and its scores to 1e-5; under ``align_logits`` the selector reads
  lane-aligned logits, under ``use_approx_top_k`` no fused projection,
  ``rowmax_lse`` or ``small_topk`` runs.
- Attention maps: the greedy runner's and the beam runner's
  (``visualize_attention``) against the JAX package's, to 1e-5;
  ``utils/png.py`` and ``_write_attention_maps`` write the JAX
  package's bytes; ``visualize_embeddings`` writes its files.
- One reference-dialect INI through ``python -m
  neuralmonkey_tpu_torch.train`` with each knob: LayerNormGRU and
  NoisyGRU cells, the three optimizers, a part's ``load_checkpoint``,
  ``align_logits``, ``use_approx_top_k``, ``visualize_attention`` and
  ``visualize_embeddings``.
"""

import os
import random
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralmonkey_tpu import learning_utils as jax_learning_utils
from neuralmonkey_tpu.experiment import Experiment as JaxExperiment
from neuralmonkey_tpu.model.part import Context as JaxContext
from neuralmonkey_tpu.model.part import collect_parts as jax_collect_parts
from neuralmonkey_tpu.model.part import init_all_params as jax_init
from neuralmonkey_tpu.model.sequence import \
    EmbeddedSequence as JaxEmbeddedSequence
from neuralmonkey_tpu.models.attention.feed_forward import \
    Attention as JaxAttention
from neuralmonkey_tpu.models.decoders.beam_search_decoder import \
    BeamSearchDecoder as JaxBeamSearch
from neuralmonkey_tpu.models.decoders.decoder import Decoder as JaxDecoder
from neuralmonkey_tpu.models.encoders.recurrent import \
    SentenceEncoder as JaxSentenceEncoder
from neuralmonkey_tpu.runners.base_runner import \
    ExecutionResult as JaxExecutionResult
from neuralmonkey_tpu.runners.beam_search_runner import \
    BeamSearchRunner as JaxBeamSearchRunner
from neuralmonkey_tpu.runners.runner import GreedyRunner as JaxGreedyRunner
from neuralmonkey_tpu.utils import png as jax_png
from neuralmonkey_tpu.utils.saving import flatten_tree as jax_flatten
from neuralmonkey_tpu.vocabulary import Vocabulary as JaxVocabulary

from neuralmonkey_tpu_torch import learning_utils
from neuralmonkey_tpu_torch import train as torch_train
from neuralmonkey_tpu_torch.dataset import BatchingScheme, Dataset
from neuralmonkey_tpu_torch.experiment import Experiment
from neuralmonkey_tpu_torch.model.part import (Context, collect_parts,
                                               init_all_params)
from neuralmonkey_tpu_torch.model.sequence import EmbeddedSequence
from neuralmonkey_tpu_torch.models.attention.feed_forward import Attention
from neuralmonkey_tpu_torch.models.decoders import beam_search_decoder
from neuralmonkey_tpu_torch.models.decoders.beam_search_decoder import \
    BeamSearchDecoder
from neuralmonkey_tpu_torch.models.decoders.decoder import Decoder
from neuralmonkey_tpu_torch.models.encoders.recurrent import SentenceEncoder
from neuralmonkey_tpu_torch.ops import beam_select
from neuralmonkey_tpu_torch.runners.base_runner import ExecutionResult
from neuralmonkey_tpu_torch.runners.beam_search_runner import \
    BeamSearchRunner
from neuralmonkey_tpu_torch.runners.runner import GreedyRunner
from neuralmonkey_tpu_torch.runtime import CUDAManager
from neuralmonkey_tpu_torch.trainers.cross_entropy_trainer import \
    CrossEntropyTrainer
from neuralmonkey_tpu_torch.trainers.optimizers import AdamOptimizer
from neuralmonkey_tpu_torch.utils import png
from neuralmonkey_tpu_torch.utils.saving import (flatten_tree, load_flat,
                                                 params_from_jax, save_tree)
from neuralmonkey_tpu_torch.vocabulary import Vocabulary

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


def _sentences(n, seed=0, words=20):
    rng = np.random.RandomState(seed)
    return [[f"w{i}" for i in rng.randint(0, words, size=rng.randint(2, 7))]
            for _ in range(n)]


def _translation(port, target_words=20, name="m"):
    """(encoder, decoder, trainer, dataset) of a small model in one
    package; ``target_words`` sets the target vocabulary's size."""
    src, tgt = _sentences(64, 0), _sentences(64, 1, target_words)
    vocab_cls, enc_cls, att_cls, dec_cls = (
        (Vocabulary, SentenceEncoder, Attention, Decoder) if port else
        (JaxVocabulary, JaxSentenceEncoder, JaxAttention, JaxDecoder))
    vs = vocab_cls([f"w{i}" for i in range(20)])
    vt = vocab_cls([f"w{i}" for i in range(target_words)])
    enc = enc_cls(name=f"{name}_enc", vocabulary=vs, data_id="source",
                  embedding_size=8, rnn_size=6, max_input_len=8)
    att = att_cls(name=f"{name}_att", encoder=enc, state_size=6)
    dec = dec_cls(name=f"{name}_dec", vocabulary=vt, data_id="target",
                  max_output_len=6, rnn_size=7, encoders=[enc],
                  attentions=[att], embedding_size=8, conditional_gru=True)
    return enc, dec, {"source": src, "target": tgt}


# ---------------------------------------------------------------------- #
# per-part warm starts
# ---------------------------------------------------------------------- #
def test_part_warm_starts(tmp_path):
    enc, dec, _ = _translation(True)
    full = init_all_params(collect_parts([dec]), seed=5)
    whole = str(tmp_path / "whole.npz")
    save_tree(whole, full)
    local = str(tmp_path / "local.npz")
    save_tree(local, full[enc.name])

    for path in (whole, local):
        enc2, dec2, _ = _translation(True)
        enc2.load_checkpoint = path
        manager = CUDAManager(random_seed=1, device="cpu")
        manager.initialize_model_parts([dec2], seed=1)
        fresh = init_all_params(collect_parts([dec2]), seed=1)
        for key, value in flatten_tree(manager.params).items():
            part = key.split("/", 1)[0]
            ref = (flatten_tree(full)[key] if part == enc.name
                   else flatten_tree(fresh)[key])
            assert torch.equal(value, ref), (path, key)

    with pytest.raises(ValueError, match="save_checkpoint"):
        SentenceEncoder(name="e", vocabulary=Vocabulary(["a"]),
                        data_id="source", embedding_size=4, rnn_size=4,
                        save_checkpoint=str(tmp_path / "e.npz"))
    # a checkpoint whose keys miss the part's raises, as a shape does
    enc3, dec3, _ = _translation(True, name="other")
    enc3.load_checkpoint = whole
    with pytest.raises(KeyError):
        CUDAManager(device="cpu").initialize_model_parts([dec3], seed=1)


# ---------------------------------------------------------------------- #
# the prefetch worker
# ---------------------------------------------------------------------- #
def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("nm-prefetch") and t.is_alive()]


@pytest.fixture(scope="module")
def manager_and_dataset():
    _, dec, series = _translation(True, name="pf")
    trainer = CrossEntropyTrainer(
        decoders=[dec], optimizer=AdamOptimizer(learning_rate=1e-3))
    manager = CUDAManager(random_seed=0, device="cpu")
    manager.initialize_model_parts([trainer], seed=0)
    return manager, trainer, Dataset("toy", series)


def _wait_for_no_workers():
    deadline = time.monotonic() + 10.0
    while _prefetch_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    return not _prefetch_threads()


def test_prefetch_early_break_joins_worker(manager_and_dataset):
    manager, _, ds = manager_and_dataset
    gen = manager.iter_prepared_batches(ds, BatchingScheme(batch_size=8), 8,
                                        train=True)
    _, real = next(gen)
    assert real > 0
    gen.close()
    assert _wait_for_no_workers(), "prefetch worker leaked after close"


def test_prefetch_consumer_exception_joins_worker(manager_and_dataset):
    manager, _, ds = manager_and_dataset

    def consume():
        for _batch in manager.iter_prepared_batches(
                ds, BatchingScheme(batch_size=8), 8, train=True):
            raise RuntimeError("consumer bailed")

    with pytest.raises(RuntimeError, match="consumer bailed"):
        consume()
    assert _wait_for_no_workers()


def test_prefetch_worker_exception_propagates(manager_and_dataset):
    manager, _, _ = manager_and_dataset

    class PoisonDataset:
        def batches(self, scheme, shuffled=False):
            raise ValueError("poisoned batches")

    with pytest.raises(ValueError, match="poisoned batches"):
        for _batch in manager.iter_prepared_batches(
                PoisonDataset(), BatchingScheme(batch_size=8), 8):
            pass
    assert not _prefetch_threads()


def test_prefetch_full_iteration(manager_and_dataset):
    manager, _, ds = manager_and_dataset
    total = sum(real for _batch, real in manager.iter_prepared_batches(
        ds, BatchingScheme(batch_size=16), 16, train=False, shuffled=False))
    assert total == 64
    assert not _prefetch_threads()


def test_prefetch_stress_abandonment(manager_and_dataset):
    """Many pipelined iterations abandoned at varying depths, with
    training steps on the main thread: none leaves a worker behind."""
    manager, trainer, ds = manager_and_dataset
    start_threads = threading.active_count()
    for round_idx in range(60):
        gen = manager.iter_prepared_batches(
            ds, BatchingScheme(batch_size=8), 8, train=True,
            prefetch_depth=2)
        taken = 0
        for batch, _real in gen:
            manager.train_on_prepared(trainer, batch)
            taken += 1
            if taken > round_idx % 3:
                break
        gen.close()
        assert not _prefetch_threads(), f"leak at round {round_idx}"
    assert threading.active_count() <= start_threads + 1


def test_prefetch_keeps_order_and_shuffles(manager_and_dataset):
    """The worker's batches, shuffled, equal the synchronous loop's from
    the same random state."""
    manager, _, ds = manager_and_dataset
    scheme = BatchingScheme(batch_size=8)
    random.seed(11)
    sync = [manager.build_batch(b, 8, train=True)
            for b in ds.batches(scheme, shuffled=True)]
    random.seed(11)
    prefetched = list(manager.iter_prepared_batches(ds, scheme, 8,
                                                    train=True))
    assert len(prefetched) == len(sync) == 8
    for (got, got_real), (ref, ref_real) in zip(prefetched, sync):
        assert got_real == ref_real
        assert set(got) == set(ref)
        for key in ref:
            assert torch.equal(got[key], ref[key]), key


# ---------------------------------------------------------------------- #
# beam search knobs and attention maps, from one shared checkpoint
# ---------------------------------------------------------------------- #
def _shared_models(tmp_path, target_words):
    """Both packages' decoders over one ``.npz``, and a batch of 4."""
    _, jax_dec, series = _translation(False, target_words)
    _, dec, _ = _translation(True, target_words)
    jax_params = jax_init(jax_collect_parts([jax_dec]),
                          jax.random.PRNGKey(4))
    path = tmp_path / "shared.npz"
    with open(path, "wb") as f:
        np.savez(f, **{k: np.asarray(v)
                       for k, v in jax_flatten(jax_params).items()})
    params = params_from_jax(load_flat(str(path)),
                             init_all_params(collect_parts([dec]), seed=0))
    enc = dec.encoders[0]
    ids, mask = enc.vocabulary.sentences_to_tensor(series["source"][:4],
                                                   max_len=8)
    batch = {"m_enc_input.ids": ids, "m_enc_input.mask": mask}
    return (jax_dec, JaxContext(jax_params, {k: jnp.asarray(v) for k, v in
                                             batch.items()}),
            dec, Context(params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}))


def _assert_same_search(got, ref):
    np.testing.assert_array_equal(got.token_ids.numpy(),
                                  np.asarray(ref.token_ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores),
                               atol=1e-5)


@pytest.mark.parametrize("fused", ["0", "1"])
def test_align_logits_matches_jax(tmp_path, monkeypatch, fused):
    """At 155 target ids the aligned table has 256 columns: the selector
    reads 256-wide logits, where without ``align_logits`` it reads 155
    (and pads them itself); both searches give the JAX package's aligned
    search's ids and scores."""
    monkeypatch.setenv("NM_FUSED_LOGITS", fused)
    jax_dec, jax_ctx, dec, ctx = _shared_models(tmp_path, 151)
    widths = []
    real = BeamSearchDecoder._select_hier

    def recording(self, x, *args, **kwargs):
        widths.append(x.shape[-1])
        return real(self, x, *args, **kwargs)
    monkeypatch.setattr(BeamSearchDecoder, "_select_hier", recording)
    ref = JaxBeamSearch(
        name="bs", parent_decoder=jax_dec, beam_size=3,
        selection_method="hierarchical", align_logits=True).search(jax_ctx)
    searches = {}
    for align in (True, False):
        widths.clear()
        with torch.inference_mode():
            searches[align] = BeamSearchDecoder(
                name="bs", parent_decoder=dec, beam_size=3,
                selection_method="hierarchical",
                align_logits=align).search(ctx)
        vocab = len(dec.vocabulary)
        assert vocab == 155
        # the fused projection pads to 1024 columns whether aligned or not
        expected = 1024 if fused == "1" else (256 if align else vocab)
        assert widths and set(widths) == {expected}
    _assert_same_search(searches[True], ref)
    # the pad columns never win: the same search as without the flag
    _assert_same_search(searches[False], ref)


def test_use_approx_top_k_matches_jax(tmp_path, monkeypatch):
    """At 2104 target ids "auto" selects hierarchically; with
    ``use_approx_top_k`` it selects flat (the JAX package's
    ``approx_max_k`` is exact off the TPU): the same ids and scores, and
    no fused projection, ``rowmax_lse`` or ``small_topk``."""
    jax_dec, jax_ctx, dec, ctx = _shared_models(tmp_path, 2100)
    launched = []
    for name in ("fused_logits_rowmax_lse", "rowmax_lse", "small_topk"):
        real = getattr(beam_select, name)

        def counting(*args, _real=real, _name=name, **kwargs):
            launched.append(_name)
            return _real(*args, **kwargs)
        monkeypatch.setattr(beam_search_decoder, name, counting,
                            raising=False)
    from neuralmonkey_tpu_torch.models.decoders import autoregressive
    monkeypatch.setattr(
        autoregressive, "fused_logits_rowmax_lse",
        lambda *a, **k: launched.append("fused") or
        beam_select.fused_logits_rowmax_lse(*a, **k))
    assert BeamSearchDecoder(name="bs", parent_decoder=dec,
                             beam_size=3)._method() == "hierarchical"
    search = BeamSearchDecoder(name="bs", parent_decoder=dec, beam_size=3,
                               use_approx_top_k=True)
    assert search._method() == "flat"
    ref = JaxBeamSearch(name="bs", parent_decoder=jax_dec, beam_size=3,
                        use_approx_top_k=True).search(jax_ctx)
    with torch.inference_mode():
        got = search.search(ctx)
    _assert_same_search(got, ref)
    assert launched == []


def test_attention_maps_match_jax(tmp_path):
    """The greedy runner's (B, T_out, T_src) maps and the beam runner's
    rank-1 maps, cut to the hypothesis's length."""
    jax_dec, jax_ctx, dec, ctx = _shared_models(tmp_path, 20)
    ref = JaxGreedyRunner("target", jax_dec,
                          visualize_attention=True).fetches(jax_ctx)
    with torch.inference_mode():
        got = GreedyRunner("target", dec,
                           visualize_attention=True).fetches(ctx)
    np.testing.assert_array_equal(got["decoded"].numpy(),
                                  np.asarray(ref["decoded"]))
    np.testing.assert_allclose(got["attention"].numpy(),
                               np.asarray(ref["attention"]), atol=1e-5)
    assert got["attention"].shape == (4, 6, ctx.batch["m_enc_input.ids"].shape[1])
    with torch.inference_mode():
        assert "attention" not in GreedyRunner("target", dec).fetches(ctx)

    jax_runner = JaxBeamSearchRunner("target", JaxBeamSearch(
        name="bs", parent_decoder=jax_dec, beam_size=3),
        visualize_attention=True)
    runner = BeamSearchRunner("target", BeamSearchDecoder(
        name="bs", parent_decoder=dec, beam_size=3),
        visualize_attention=True)
    jax_result = jax_runner.collect_results(
        {k: np.asarray(v) for k, v in jax_runner.fetches(jax_ctx).items()},
        4)
    with torch.inference_mode():
        result = runner.collect_results(
            {k: v.numpy() for k, v in runner.fetches(ctx).items()}, 4)
    assert result.outputs == jax_result.outputs
    for got_map, ref_map in zip(result.aux["attention"],
                                jax_result.aux["attention"]):
        np.testing.assert_allclose(got_map, ref_map, atol=1e-5)


def test_png_and_attention_files_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    arrays = [rng.rand(5, 9), rng.randn(12, 3).astype(np.float32),
              np.full((4, 4), 0.5), np.eye(3)]
    for array in arrays:
        for kwargs in ({}, {"scale": 1}, {"normalize": False}):
            assert png.png_bytes(array, **kwargs) == \
                jax_png.png_bytes(array, **kwargs)
    with pytest.raises(ValueError, match="2-D"):
        png.png_bytes(np.zeros(3))

    maps = [rng.rand(4, 6).astype(np.float32) for _ in range(4)]
    for out, fn, result_cls in (
            ("port", learning_utils._write_attention_maps, ExecutionResult),
            ("jax", jax_learning_utils._write_attention_maps,
             JaxExecutionResult)):
        fn([result_cls(outputs=[], losses={}, size=0),
            result_cls(outputs=[], losses={}, size=4,
                       aux={"attention": maps})],
           str(tmp_path / out), step=7)
    names = sorted(os.listdir(tmp_path / "jax" / "attention_maps"))
    assert names == [f"step7_ex{i}.png" for i in range(3)]
    assert sorted(os.listdir(tmp_path / "port" / "attention_maps")) == names
    for name in names:
        assert (tmp_path / "port" / "attention_maps" / name).read_bytes() \
            == (tmp_path / "jax" / "attention_maps" / name).read_bytes()


def test_visualize_embeddings_matches_jax(tmp_path):
    table = np.random.RandomState(2).randn(9, 3).astype(np.float32)
    words = [f"w{i}" for i in range(5)]
    for out, exp_cls, seq_cls, vocab_cls, wrap in (
            ("port", Experiment, EmbeddedSequence, Vocabulary,
             torch.from_numpy),
            ("jax", JaxExperiment, JaxEmbeddedSequence, JaxVocabulary,
             jnp.asarray)):
        seq = seq_cls(name="emb", vocabulary=vocab_cls(words),
                      data_id="source", embedding_size=3)
        no_table = seq_cls(name="missing", vocabulary=vocab_cls(words),
                           data_id="source", embedding_size=3)
        os.makedirs(tmp_path / out)
        fake = SimpleNamespace(
            output_dir=str(tmp_path / out),
            tf_manager=SimpleNamespace(params={"emb": {
                "embeddings": wrap(table)}}))
        exp_cls._write_embedding_projections(fake, [seq, no_table])
    for name in ("emb_embeddings.tsv", "emb_metadata.tsv"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))


# ---------------------------------------------------------------------- #
# one INI with each knob, through the train CLI
# ---------------------------------------------------------------------- #
LONG_TAIL_INI = """\
[main]
name="long tail"
tf_manager=<tf_manager>
output="{out}"
overwrite_output_dir=True
batch_size=32
epochs=1
train_dataset=<train_data>
val_dataset=<val_data>
trainer=<trainer>
runners=[<runner>]
evaluation=[("target", evaluators.bleu.BLEU)]
logging_period=5
validation_period=5
random_seed=1234
{main_extra}

[tf_manager]
class=tf_manager.TensorFlowManager
num_sessions=1
device="cpu"

[train_data]
class=dataset.load_dataset_from_files
s_source="{data}/train.en"
s_target="{data}/train.de"
lazy=False

[val_data]
class=dataset.load_dataset_from_files
s_source="{data}/val.en"
s_target="{data}/val.de"

[encoder_vocabulary]
class=vocabulary.from_dataset
datasets=[<train_data>]
series_ids=["source"]
max_size=60

[decoder_vocabulary]
class=vocabulary.from_dataset
datasets=[<train_data>]
series_ids=["target"]
max_size=150

[input_sequence]
class=model.sequence.EmbeddedSequence
name="input_sequence"
vocabulary=<encoder_vocabulary>
data_id="source"
embedding_size=8
max_length=9

[encoder]
class=encoders.recurrent.RecurrentEncoder
name="encoder"
input_sequence=<input_sequence>
rnn_size=8
rnn_cell="{encoder_cell}"
{encoder_extra}

[attention]
class=attention.feed_forward.Attention
name="attention"
encoder=<encoder>
state_size=8

[decoder]
class=decoders.decoder.Decoder
name="decoder"
encoders=[<encoder>]
attentions=[<attention>]
rnn_size=8
embedding_size=8
rnn_cell="{decoder_cell}"
data_id="target"
max_output_len=9
vocabulary=<decoder_vocabulary>

[trainer]
class=trainers.cross_entropy_trainer.CrossEntropyTrainer
decoders=[<decoder>]
clip_norm=1.0
optimizer=<optimizer>

[optimizer]
{optimizer}

{runner}
"""

GREEDY = """[runner]
class=runners.runner.GreedyRunner
decoder=<decoder>
output_series="target"
visualize_attention=True
"""

BEAM = """[beam]
class=decoders.beam_search_decoder.BeamSearchDecoder
name="beam"
parent_decoder=<decoder>
beam_size=3
{beam_extra}

[runner]
class=runners.beam_search_runner.BeamSearchRunner
decoder=<beam>
output_series="target"
visualize_attention=True
"""


def _long_tail_ini(tmp_path, name, **fields):
    path = tmp_path / f"{name}.ini"
    path.write_text(LONG_TAIL_INI.format(
        out=tmp_path / name, data=DATA,
        **dict({"main_extra": "", "encoder_extra": ""}, **fields)))
    return str(path)


def test_long_tail_ini_trains_through_the_cli(tmp_path):
    first = _long_tail_ini(
        tmp_path, "first", encoder_cell="LayerNormGRU",
        decoder_cell="NoisyGRU",
        main_extra="visualize_embeddings=[<input_sequence>]",
        optimizer="class=tf.train.AdadeltaOptimizer\nepsilon=1e-4",
        runner=GREEDY)
    assert torch_train.main([first]) == 0
    out = tmp_path / "first"
    vectors = (out / "input_sequence_embeddings.tsv").read_text()
    tokens = (out / "input_sequence_metadata.tsv").read_text()
    assert len(vectors.splitlines()) == len(tokens.splitlines()) > 4
    assert os.listdir(out / "attention_maps")

    second = _long_tail_ini(
        tmp_path, "second", encoder_cell="NoisyGRU", decoder_cell="GRU",
        optimizer="class=tf.train.RMSPropOptimizer\nlearning_rate=0.01",
        runner=BEAM.format(beam_extra='selection_method="hierarchical"\n'
                           "align_logits=True"))
    assert torch_train.main([second]) == 0
    assert os.listdir(tmp_path / "second" / "attention_maps")

    # the encoder warm-starts from the first run's best checkpoint
    best = str(out / "variables.data.best")
    third = _long_tail_ini(
        tmp_path, "third", encoder_cell="LayerNormGRU",
        decoder_cell="LayerNormGRU",
        encoder_extra=f'load_checkpoint="{best}"',
        optimizer="class=trainers.optimizers.AdafactorOptimizer",
        runner=BEAM.format(beam_extra="use_approx_top_k=True"))
    exp = Experiment(third, train_mode=True)
    exp.build_model()
    saved = load_flat(best)
    encoder = flatten_tree(exp.tf_manager.params["encoder"])
    assert encoder and all(np.array_equal(value.numpy(),
                                          saved[f"encoder/{key}"])
                           for key, value in encoder.items())
    assert torch_train.main([third]) == 0
