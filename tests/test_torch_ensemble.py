"""Checkpoint ensembles and checkpoint averaging in the PyTorch port,
against the JAX package on the CPU.

Tiny models (width 16, a 300-word vocabulary, 8 output steps); two
parameter sets drawn from numpy with different seeds, loaded into both
packages (the JAX tree's structure from ``jax.eval_shape``, its side
under ``jax.jit``):

- ``average_flat`` bitwise equal to the JAX package's over float32 and
  float64 leaves, the same ValueError on different key sets, and the
  ``average_checkpoints`` CLI's file equal to the JAX package's;
- the RNN's greedy ensemble: ids equal, averaged log-probs within 1e-5;
  its beam-3 ensemble through the flat and the hierarchical selector:
  ids and lengths equal, scores within 1e-5;
- the Transformer's beam ensemble, by default and under
  ``NM_LINEAGE_KERNEL=1``: the same, and its steps never see the lineage
  kernel's cache layout (no ``"kq"``);
- two identical parameter sets give the single model's ids; the
  manager gives a runner without ``ensemble_fetches`` the first set;
- ``run`` with two checkpoints, and with ``--average``, writes the JAX
  ``run``'s output files; ``num_sessions`` below 1 raises ValueError.
"""

import os

import jax
import numpy as np
import pytest
import torch

from neuralmonkey_tpu import run as jax_run
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
from neuralmonkey_tpu.utils import average_checkpoints as jax_average
from neuralmonkey_tpu.utils.saving import restore_into as jax_restore
from neuralmonkey_tpu.vocabulary import Vocabulary as JaxVocabulary

from neuralmonkey_tpu_torch import run as torch_run
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
from neuralmonkey_tpu_torch.runtime import CUDAManager
from neuralmonkey_tpu_torch.utils import average_checkpoints
from neuralmonkey_tpu_torch.utils.saving import (flatten_tree, load_flat,
                                                 params_from_jax)
from neuralmonkey_tpu_torch.vocabulary import Vocabulary

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
BATCH, SRC, TGT, WIDTH, VOCAB = 3, 7, 8, 16, 300
ATOL = 1e-5


def _build_rnn(enc_cls, att_cls, dec_cls, vocab_cls):
    vocab = vocab_cls([f"w{i}" for i in range(VOCAB - 4)])
    enc = enc_cls(name="encoder", vocabulary=vocab, data_id="source",
                  embedding_size=WIDTH, rnn_size=WIDTH, max_input_len=SRC)
    att = att_cls(name="attention", encoder=enc, state_size=WIDTH)
    return dec_cls(name="decoder", vocabulary=vocab, data_id="target",
                   max_output_len=TGT, rnn_size=WIDTH, encoders=[enc],
                   attentions=[att], embedding_size=WIDTH,
                   conditional_gru=True)


def _build_transformer(enc_cls, dec_cls, vocab_cls):
    vocab = vocab_cls([f"w{i}" for i in range(VOCAB - 4)])
    enc = enc_cls(name="encoder", vocabulary=vocab, data_id="source",
                  embedding_size=WIDTH, ff_hidden_size=32, depth=2,
                  n_heads=2, max_input_len=SRC)
    return dec_cls(name="decoder", vocabulary=vocab, data_id="target",
                   max_output_len=TGT, encoders=[enc], embedding_size=WIDTH,
                   ff_hidden_size=32, depth=2, n_heads_self=2,
                   n_heads_enc=2)


MODELS = {
    "rnn": lambda port: _build_rnn(
        *((SentenceEncoder, Attention, Decoder, Vocabulary) if port else
          (JaxSentenceEncoder, JaxAttention, JaxDecoder, JaxVocabulary))),
    "transformer": lambda port: _build_transformer(
        *((TransformerEncoder, TransformerDecoder, Vocabulary) if port else
          (JaxTransformerEncoder, JaxTransformerDecoder, JaxVocabulary))),
}


def _models(kind, seeds=(0, 1), scale=0.3):
    """(JAX decoder, port decoder, [(JAX params, port params)] one a
    seed): each set one numpy draw loaded into both packages."""
    jax_dec, port_dec = MODELS[kind](False), MODELS[kind](True)
    jax_shapes = jax.eval_shape(lambda: jax_init(
        jax_collect_parts([jax_dec]), jax.random.PRNGKey(0)))
    template = init_all_params(collect_parts([port_dec]), seed=0)
    sets = []
    for seed in seeds:
        rng = np.random.RandomState(seed)
        flat = {k: (rng.randn(*v.shape) * scale).astype(np.float32)
                for k, v in sorted(flatten_tree(template).items())}
        sets.append((jax_restore(jax_shapes, flat),
                     params_from_jax(flat, template)))
    return jax_dec, port_dec, sets


def _batch():
    rng = np.random.RandomState(7)
    mask = np.zeros((BATCH, SRC), np.float32)
    for i, n in enumerate([7, 4, 2]):
        mask[i, :n] = 1.0
    return {"encoder_input.ids": rng.randint(4, VOCAB, (BATCH, SRC)).astype(
                np.int32),
            "encoder_input.mask": mask}


def _jax_contexts(params_list, batch):
    arrays = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    return [JaxContext(p, arrays, train=False) for p in params_list]


def _port_contexts(params_list, batch):
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    return [Context(p, tensors, train=False) for p in params_list]


# ---------------------------------------------------------------------- #
# averaging
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("dtypes", [
    (np.float32, np.float32), (np.float64, np.float64),
    (np.float32, np.float64)], ids=["f32", "f64", "mixed"])
def test_average_flat_matches_jax_bitwise(dtypes):
    rng = np.random.RandomState(3)
    flats = [{"part/w": rng.randn(4, 5).astype(dtypes[0]),
              "part/b": rng.randn(7).astype(dtypes[1]),
              "other/x": rng.randn(2, 3, 2).astype(dtypes[0])}
             for _ in range(3)]
    got = average_checkpoints.average_flat(flats)
    ref = jax_average.average_flat(flats)
    assert set(got) == set(ref)
    for key, value in ref.items():
        assert got[key].dtype == value.dtype
        np.testing.assert_array_equal(got[key], value)


def test_average_flat_refuses_different_keys_as_jax():
    a = {"x": np.ones(2, np.float32), "y": np.ones(2, np.float32)}
    b = {"x": np.ones(2, np.float32)}
    with pytest.raises(ValueError, match="different parameter sets"):
        jax_average.average_flat([a, b])
    with pytest.raises(ValueError, match="different parameter sets"):
        average_checkpoints.average_flat([a, b])


def test_average_checkpoints_cli_writes_the_jax_file(tmp_path):
    rng = np.random.RandomState(4)
    paths = []
    for i in range(3):
        path = str(tmp_path / f"c{i}.npz")
        with open(path, "wb") as f:
            np.savez(f, **{"a/w": rng.randn(3, 4).astype(np.float32),
                           "a/b": rng.randn(4)})
        paths.append(path)
    assert average_checkpoints.main([str(tmp_path / "port.npz"),
                                     *paths]) == 0
    jax_average.average_checkpoints(paths, str(tmp_path / "jax.npz"))
    got, ref = (load_flat(str(tmp_path / f"{n}.npz"))
                for n in ("port", "jax"))
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(got[key], ref[key])


# ---------------------------------------------------------------------- #
# ensemble decoding against the JAX package
# ---------------------------------------------------------------------- #
def test_rnn_greedy_ensemble_matches_jax():
    jax_dec, port_dec, sets = _models("rnn")
    batch = _batch()
    ref_lp, ref_ids = jax.jit(lambda p: jax_dec.ensemble_greedy_outputs(
        _jax_contexts(p, batch)))([s[0] for s in sets])
    with torch.inference_mode():
        contexts = _port_contexts([s[1] for s in sets], batch)
        log_probs, ids = port_dec.ensemble_greedy_outputs(contexts)
        lean = port_dec.ensemble_greedy_ids(
            _port_contexts([s[1] for s in sets], batch))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_array_equal(lean.numpy(), np.asarray(ref_ids))
    np.testing.assert_allclose(log_probs.numpy(), np.asarray(ref_lp),
                               atol=ATOL, rtol=0)


def _beam_both(kind, selection, beam=3, seeds=(0, 1)):
    jax_dec, port_dec, sets = _models(kind, seeds)
    batch = _batch()
    jax_bs = JaxBeamSearch(name="bs", parent_decoder=jax_dec,
                           beam_size=beam, selection_method=selection)
    port_bs = BeamSearchDecoder(name="bs", parent_decoder=port_dec,
                                beam_size=beam, selection_method=selection)
    ref = jax.jit(lambda p: jax_bs.ensemble_search(
        _jax_contexts(p, batch)))([s[0] for s in sets])
    with torch.inference_mode():
        got = port_bs.ensemble_search(
            _port_contexts([s[1] for s in sets], batch))
    return ref, got, (port_dec, port_bs, sets, batch)


def _assert_same_search(got, ref, atol=ATOL):
    np.testing.assert_array_equal(got.token_ids.numpy(),
                                  np.asarray(ref.token_ids))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("selection", ["flat", "hierarchical"])
def test_rnn_beam_ensemble_matches_jax(selection):
    ref, got, _ = _beam_both("rnn", selection)
    _assert_same_search(got, ref)


@pytest.mark.parametrize("lineage_kernel", ["0", "1"])
def test_transformer_beam_ensemble_matches_jax(monkeypatch, lineage_kernel):
    """By default and under NM_LINEAGE_KERNEL=1 the ensemble's steps run
    on plain row-tiled caches (the einsum form), as the JAX package's
    stacked states do."""
    monkeypatch.setenv("NM_LINEAGE_KERNEL", lineage_kernel)
    layouts = []
    step = TransformerDecoder.decode_step_lineage

    def recording_step(self, constants, loop_state, *args, **kwargs):
        layouts.append(sorted(loop_state[0]))
        return step(self, constants, loop_state, *args, **kwargs)
    monkeypatch.setattr(TransformerDecoder, "decode_step_lineage",
                        recording_step)
    ref, got, _ = _beam_both("transformer", "hierarchical", beam=4)
    _assert_same_search(got, ref)
    assert layouts and all(keys == ["k", "v"] for keys in layouts)


@pytest.mark.parametrize("kind,selection", [
    ("rnn", "flat"), ("rnn", "hierarchical"),
    ("transformer", "hierarchical")])
def test_identical_sets_give_the_single_model(kind, selection):
    """Two copies of one parameter set average to that model's own
    distributions: the single model's greedy and beam ids."""
    _, port_dec, sets = _models(kind, seeds=(2,))
    params = sets[0][1]
    batch = _batch()
    port_bs = BeamSearchDecoder(name="bs", parent_decoder=port_dec,
                                beam_size=3, selection_method=selection)
    with torch.inference_mode():
        single_ctx = _port_contexts([params], batch)[0]
        single_ids = port_dec.decoded(single_ctx)
        single = port_bs.search(single_ctx)
        double_ids = port_dec.ensemble_greedy_ids(
            _port_contexts([params, params], batch))
        double = port_bs.ensemble_search(
            _port_contexts([params, params], batch))
    torch.testing.assert_close(double_ids, single_ids, rtol=0, atol=0)
    torch.testing.assert_close(double.token_ids, single.token_ids, rtol=0,
                               atol=0)
    torch.testing.assert_close(double.scores, single.scores, rtol=0,
                               atol=1e-4)


# ---------------------------------------------------------------------- #
# the manager and the run CLI
# ---------------------------------------------------------------------- #
def test_num_sessions_below_one_raises_as_jax():
    from neuralmonkey_tpu.runtime import TPUManager
    with pytest.raises(ValueError, match="num_sessions"):
        TPUManager(num_sessions=0)
    with pytest.raises(ValueError, match="num_sessions"):
        CUDAManager(num_sessions=0, device="cpu")
    assert CUDAManager(num_sessions=2, device="cpu").num_sessions == 2


def test_other_runners_read_the_first_set():
    """With two parameter sets the manager gives a runner without
    ``ensemble_fetches`` the first set's context, as the JAX package's
    manager does; an ensemble-capable runner gets both."""
    from neuralmonkey_tpu_torch.dataset import Dataset
    from neuralmonkey_tpu_torch.runners.representation_runner import \
        RepresentationRunner
    from neuralmonkey_tpu_torch.runners.runner import GreedyRunner
    _, port_dec, sets = _models("rnn")
    vectors = RepresentationRunner("vectors", port_dec.encoders[0])
    greedy = GreedyRunner("target", port_dec)
    manager = CUDAManager(device="cpu")
    manager.initialize_model_parts([greedy, vectors], seed=0)
    manager.params_list = [s[1] for s in sets]
    dataset = Dataset("d", {"source": [["w5", "w9", "w7"], ["w4"]]})
    got = manager.run_on_batch([greedy, vectors], dataset, 2)
    batch, _ = manager.build_batch(dataset, 2)
    with torch.inference_mode():
        contexts = [Context(s[1], batch) for s in sets]
        first = port_dec.encoders[0].output(contexts[0]).numpy()
        ids = port_dec.ensemble_greedy_ids(contexts).numpy()
    np.testing.assert_array_equal(np.stack(got[1].outputs), first)
    assert got[0].outputs == port_dec.vocabulary.vectors_to_sentences(ids)


EXPERIMENT_INI = """\
[main]
name="ensemble test"
tf_manager=<tf_manager>
output="{out}"
batch_size=3
runners=[<runner>, <bs_runner>]
postprocess=None
random_seed=1234

[tf_manager]
class=tf_manager.TensorFlowManager
num_sessions=2
{manager_extra}

[train_data]
class=dataset.load_dataset_from_files
s_source="{data}/train.en"
s_target="{data}/train.de"

[encoder_vocabulary]
class=vocabulary.from_dataset
datasets=[<train_data>]
series_ids=["source"]
max_size=300

[decoder_vocabulary]
class=vocabulary.from_dataset
datasets=[<train_data>]
series_ids=["target"]
max_size=300

[encoder]
class=encoders.recurrent.SentenceEncoder
name="sentence_encoder"
rnn_size=16
max_input_len=7
embedding_size=16
data_id="source"
vocabulary=<encoder_vocabulary>

[attention]
class=attention.feed_forward.Attention
name="attention_sentence_encoder"
encoder=<encoder>
state_size=16

[decoder]
class=decoders.decoder.Decoder
name="decoder"
encoders=[<encoder>]
attentions=[<attention>]
rnn_size=16
embedding_size=16
data_id="target"
max_output_len=6
vocabulary=<decoder_vocabulary>

[bs_decoder]
class=decoders.beam_search_decoder.BeamSearchDecoder
name="bs_decoder"
parent_decoder=<decoder>
beam_size=3
selection_method="hierarchical"

[runner]
class=runners.runner.GreedyRunner
decoder=<decoder>
output_series="target"

[bs_runner]
class=runners.beam_search_runner.BeamSearchRunner
decoder=<bs_decoder>
output_series="target_beam"
"""

DATA_INI = """\
[main]
test_datasets=[<val_data>]

[val_data]
class=dataset.load_dataset_from_files
s_source="{data}/val.en"
s_target_out="{out}/greedy.txt"
s_target_beam_out="{out}/beam.txt"
"""


@pytest.mark.parametrize("average", [False, True],
                         ids=["ensemble", "average"])
def test_run_with_two_checkpoints_writes_the_jax_outputs(tmp_path, average):
    """``run exp.ini data.ini a.npz b.npz [--average]`` in both packages,
    the port's INI on the CPU: the same greedy and beam-3 files."""
    from neuralmonkey_tpu.experiment import Experiment as JaxExperiment
    inis = {}
    for name, extra in (("jax", ""), ("port", 'device="cpu"')):
        (tmp_path / name).mkdir()
        inis[name] = (tmp_path / f"{name}.ini", tmp_path / f"{name}_data.ini")
        inis[name][0].write_text(EXPERIMENT_INI.format(
            out=tmp_path / name, data=DATA, manager_extra=extra))
        inis[name][1].write_text(DATA_INI.format(data=DATA,
                                                 out=tmp_path / name))
    exp = JaxExperiment(str(inis["jax"][0]), train_mode=False)
    exp.build_model()
    shapes = {k: v.shape for k, v in flatten_tree(
        exp.tf_manager.params).items()}
    ckpts = []
    for seed in (0, 1):
        rng = np.random.RandomState(seed)
        path = str(tmp_path / f"ckpt{seed}.npz")
        with open(path, "wb") as f:
            np.savez(f, **{k: (rng.randn(*s) * 0.3).astype(np.float32)
                           for k, s in sorted(shapes.items())})
        ckpts.append(path)
    flags = ["--average"] if average else []
    assert jax_run.main([str(p) for p in inis["jax"]] + ckpts + flags) == 0
    assert torch_run.main([str(p) for p in inis["port"]] + ckpts
                          + flags) == 0
    for name in ("greedy.txt", "beam.txt"):
        ref = (tmp_path / "jax" / name).read_text().splitlines()
        got = (tmp_path / "port" / name).read_text().splitlines()
        assert len(got) == len(ref) > 0
        assert got == ref
