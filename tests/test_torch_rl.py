"""Self-critical training in the port against the JAX package, on the CPU.

A small attentive RNN model (BiGRU 8 + 8, Bahdanau attention, a GRU
decoder of 16, vocabulary 30, 6 output steps, batch 4 with one padding
row) is built by both packages from one numpy draw of its parameters.
Tolerance 1e-5 on values and 1e-4 on gradients, unless a test says
otherwise:

- ``gleu_sentence`` and ``GLEUEvaluator`` (orders 1-4, deduplication)
  on random sentences, ``sentence_bleu`` and the batch rewards: equal
  to 1e-12;
- ``greedy_outputs``: the logits, ids and attention weights;
- ``sample_outputs``: the two packages draw from different generators,
  so the ids JAX draws are forced through the port's steps
  (``draw_samples``), which must then give the same ids (PAD after END)
  and the same summed log-probs; the port's own draws are valid ids
  whose log-probs equal their scores under ``decode_step``;
- the self-critical and REINFORCE losses and their gradients for the
  same sampled ids (the greedy ids, deterministic, are each package's
  own); the rewards on the host, the advantage without gradient;
- ``ReinforceTrainer``'s objectives, ``MultitaskTrainer``'s round robin
  through the manager with one optimizer state per child in ``.opt``,
  resumed per child;
- self_critical.ini to its gate (tests/test_capability_inis.py:
  GLEU-4 > 0.05 after a falling loss);
- the builder: the new symbols' reference-dialect names resolve into
  the port.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralmonkey_tpu.evaluators import gleu as jax_gleu
from neuralmonkey_tpu.model.part import Context as JaxContext
from neuralmonkey_tpu.model.part import collect_parts as jax_collect_parts
from neuralmonkey_tpu.model.part import init_all_params as jax_init
from neuralmonkey_tpu.models.attention.feed_forward import \
    Attention as JaxAttention
from neuralmonkey_tpu.models.decoders.decoder import Decoder as JaxDecoder
from neuralmonkey_tpu.models.encoders.recurrent import \
    SentenceEncoder as JaxSentenceEncoder
from neuralmonkey_tpu.trainers import self_critical_objective as jax_sc
from neuralmonkey_tpu.utils.saving import flatten_tree as jax_flatten
from neuralmonkey_tpu.utils.saving import restore_into as jax_restore
from neuralmonkey_tpu.vocabulary import Vocabulary as JaxVocabulary

from neuralmonkey_tpu_torch.config.builder import resolve_class_symbol
from neuralmonkey_tpu_torch.evaluators import gleu
from neuralmonkey_tpu_torch.experiment import Experiment
from neuralmonkey_tpu_torch.model.part import (Context, collect_parts,
                                               init_all_params)
from neuralmonkey_tpu_torch.models.attention import (combination,
                                                     feed_forward,
                                                     scaled_dot_product)
from neuralmonkey_tpu_torch.models.attention.feed_forward import Attention
from neuralmonkey_tpu_torch.models.decoders.decoder import Decoder
from neuralmonkey_tpu_torch.models.encoders import numpy_stateful_filler
from neuralmonkey_tpu_torch.models.encoders.recurrent import SentenceEncoder
from neuralmonkey_tpu_torch.readers import numpy_reader
from neuralmonkey_tpu_torch.runtime import CUDAManager
from neuralmonkey_tpu_torch.trainers import self_critical_objective as sc
from neuralmonkey_tpu_torch.trainers.cross_entropy_trainer import \
    CrossEntropyTrainer
from neuralmonkey_tpu_torch.trainers.multitask_trainer import \
    MultitaskTrainer
from neuralmonkey_tpu_torch.trainers.rl_trainer import (ReinforceTrainer,
                                                        SelfCriticalTrainer)
from neuralmonkey_tpu_torch.utils.saving import (flatten_tree, load_flat,
                                                 params_from_jax)
from neuralmonkey_tpu_torch.vocabulary import (END_TOKEN_INDEX,
                                               PAD_TOKEN_INDEX, Vocabulary)

torch.set_num_threads(1)
TESTS = os.path.dirname(os.path.abspath(__file__))
BATCH, SRC, OUT, VOCAB = 4, 5, 6, 30
ATOL, GRAD_ATOL = 1e-5, 1e-4


# ---------------------------------------------------------------------- #
# the reward
# ---------------------------------------------------------------------- #
def _sentences(rng, n, words=6):
    return [[f"w{i}" for i in rng.randint(0, words, rng.randint(0, 9))]
            for _ in range(n)]


@pytest.mark.parametrize("max_n", [1, 2, 4])
def test_gleu_sentence_matches_jax(max_n):
    rng = np.random.RandomState(max_n)
    for hyp, ref in zip(_sentences(rng, 50), _sentences(rng, 50)):
        assert gleu.gleu_sentence(hyp, ref, max_n) == pytest.approx(
            jax_gleu.gleu_sentence(hyp, ref, max_n), abs=1e-12)


@pytest.mark.parametrize("n,deduplicate", [(4, False), (4, True),
                                           (2, True)])
def test_gleu_evaluator_matches_jax(n, deduplicate):
    """The corpus score and its name; the INIs' ``evaluators.gleu.GLEU``
    is GLEU-4."""
    rng = np.random.RandomState(10 + n)
    hyps, refs = _sentences(rng, 40, 3), _sentences(rng, 40, 3)
    ours = gleu.GLEUEvaluator(n=n, deduplicate=deduplicate)
    theirs = jax_gleu.GLEUEvaluator(n=n, deduplicate=deduplicate)
    assert ours.name == theirs.name
    assert ours(hyps, refs) == pytest.approx(theirs(hyps, refs), abs=1e-12)
    assert gleu.GLEU.name == "GLEU-4"


@pytest.mark.parametrize("reward", ["sentence_gleu", "sentence_bleu"])
def test_batch_rewards_match_jax(reward):
    """Ids up to END, PAD dropped, scored row by row."""
    rng = np.random.RandomState(3)
    hyp = rng.randint(0, 8, (16, 9)).astype(np.int32)
    ref = rng.randint(0, 8, (16, 9)).astype(np.int32)
    np.testing.assert_allclose(
        sc._batch_rewards(getattr(sc, reward), hyp, ref),
        jax_sc._batch_rewards(getattr(jax_sc, reward), hyp, ref),
        atol=1e-12, rtol=0)


# ---------------------------------------------------------------------- #
# the decodes and the objectives
# ---------------------------------------------------------------------- #
def _model(encoder_cls, attention_cls, decoder_cls, vocab_cls):
    vocab = vocab_cls([f"w{i}" for i in range(VOCAB - 4)])
    enc = encoder_cls(name="encoder", vocabulary=vocab, data_id="source",
                      embedding_size=8, rnn_size=8)
    att = attention_cls(name="attention", encoder=enc, state_size=12)
    return decoder_cls(name="decoder", vocabulary=vocab, data_id="target",
                       max_output_len=OUT, encoders=[enc], attentions=[att],
                       rnn_size=16, embedding_size=8, conditional_gru=True)


class Case:
    """The model in both packages with one numpy draw of its parameters
    (scaled to spread the output distribution), and one batch: three
    sentences and a padding row."""

    def __init__(self, seed=0, end_bias=0.0):
        self.jax = _model(JaxSentenceEncoder, JaxAttention, JaxDecoder,
                          JaxVocabulary)
        self.port = _model(SentenceEncoder, Attention, Decoder, Vocabulary)
        jax_params = jax_init(jax_collect_parts([self.jax]),
                              jax.random.PRNGKey(0))
        rng = np.random.RandomState(seed)
        flat = {k: (rng.randn(*v.shape) * 0.5).astype(np.float32)
                for k, v in jax_flatten(jax_params).items()}
        # END's logit raised, for samples that finish
        flat["decoder/logit/b"][END_TOKEN_INDEX] += end_bias
        self.jax_params = jax_restore(jax_params, flat)
        self.params = params_from_jax(flat, init_all_params(
            collect_parts([self.port]), seed=0))
        mask = np.zeros((BATCH, SRC), np.float32)
        for i, n in enumerate([5, 3, 2]):
            mask[i, :n] = 1.0
        full = rng.randint(4, VOCAB, (BATCH, OUT + 1)).astype(np.int32)
        full[:, 0] = 1  # <s>
        full[1, 3] = END_TOKEN_INDEX
        full[1, 4:] = full[3] = PAD_TOKEN_INDEX
        tmask = (full[:, 1:] != PAD_TOKEN_INDEX).astype(np.float32)
        self.batch = {"encoder_input.ids": rng.randint(
                          4, VOCAB, (BATCH, SRC)).astype(np.int32),
                      "encoder_input.mask": mask,
                      "decoder.train_inputs": full[:, :-1],
                      "decoder.train_targets": full[:, 1:],
                      "decoder.train_mask": tmask}

    def contexts(self, train=False, params=None):
        jax_ctx = JaxContext(self.jax_params, {
            k: jnp.asarray(v) for k, v in self.batch.items()}, train=train,
            rng=jax.random.PRNGKey(5))
        ctx = Context(self.params if params is None else params, {
            k: torch.from_numpy(v) for k, v in self.batch.items()},
            train=train, rng=5)
        return jax_ctx, ctx


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


def test_greedy_outputs_match_jax():
    """All ``max_output_len`` steps: logits (B, L, V), ids (B, L) with
    PAD after END, and each step's attention weights stacked on a
    leading time axis, as the JAX scan stacks them."""
    case = Case()
    jax_ctx, ctx = case.contexts()
    jax_logits, jax_ids, jax_aux = case.jax.greedy_outputs(jax_ctx)
    logits, ids, aux = case.port.greedy_outputs(ctx)
    assert logits.shape == (BATCH, OUT, VOCAB) and ids.dtype == torch.int32
    _close(logits, jax_logits)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jax_ids))
    np.testing.assert_array_equal(case.port.greedy_ids(ctx).numpy(),
                                  ids.numpy())
    _close(aux["attention_weights"][0], jax_aux["attention_weights"][0])


def _transformer(encoder_cls, decoder_cls, vocab_cls):
    vocab = vocab_cls([f"w{i}" for i in range(VOCAB - 4)])
    enc = encoder_cls(name="encoder", vocabulary=vocab, data_id="source",
                      embedding_size=16, ff_hidden_size=32, depth=1,
                      n_heads=2, max_input_len=SRC)
    return decoder_cls(name="decoder", vocabulary=vocab, data_id="target",
                       max_output_len=OUT, encoders=[enc],
                       embedding_size=16, ff_hidden_size=32, depth=1,
                       n_heads_self=2, n_heads_enc=2)


def test_transformer_greedy_and_sampled_outputs_match_jax(monkeypatch):
    """The decode loops are the autoregressive base's, so they serve the
    Transformer decoder too: ``greedy_outputs``' logits and ids, and
    JAX's sampled ids scored alike."""
    from neuralmonkey_tpu.models.decoders.transformer import \
        TransformerDecoder as JaxTransformerDecoder
    from neuralmonkey_tpu.models.encoders.transformer import \
        TransformerEncoder as JaxTransformerEncoder
    from neuralmonkey_tpu_torch.models.decoders.transformer import \
        TransformerDecoder
    from neuralmonkey_tpu_torch.models.encoders.transformer import \
        TransformerEncoder
    jax_dec = _transformer(JaxTransformerEncoder, JaxTransformerDecoder,
                           JaxVocabulary)
    dec = _transformer(TransformerEncoder, TransformerDecoder, Vocabulary)
    jax_params = jax_init(jax_collect_parts([jax_dec]), jax.random.PRNGKey(0))
    rng = np.random.RandomState(4)
    flat = {k: (np.asarray(v) + rng.randn(*v.shape) * 0.3).astype(np.float32)
            for k, v in jax_flatten(jax_params).items()}
    flat["decoder/logit_bias"][END_TOKEN_INDEX] += 2.0
    jax_params = jax_restore(jax_params, flat)
    params = params_from_jax(flat, init_all_params(collect_parts([dec]),
                                                   seed=0))
    batch = Case().batch
    batch = {k: v for k, v in batch.items() if k.startswith("encoder")}
    jax_ctx = JaxContext(jax_params, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                         rng=jax.random.PRNGKey(5))
    ctx = Context(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                  rng=5)
    jax_logits, jax_ids, _ = jax_dec.greedy_outputs(jax_ctx)
    logits, ids, aux = dec.greedy_outputs(ctx)
    _close(logits, jax_logits, atol=1e-4)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jax_ids))
    assert isinstance(aux, dict)
    jax_ids, jax_logprob = jax_dec.sample_outputs(jax_ctx)
    _forced(monkeypatch, dec, jax_ids)
    ids, logprob = dec.sample_outputs(ctx)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jax_ids))
    _close(logprob, jax_logprob, atol=1e-4)


def _forced(monkeypatch, decoder, ids):
    """Make ``decoder.draw_samples`` return column ``t`` of ``ids`` at
    its ``t``-th call."""
    columns = iter(torch.from_numpy(np.array(ids)).unbind(1))
    monkeypatch.setattr(decoder, "draw_samples",
                        lambda log_probs, generator: next(columns))


def test_sample_outputs_score_jax_draws_alike(monkeypatch):
    """The ids JAX's ``sample_outputs`` draws, forced through the port's
    steps, come back equal (a finished row keeps PAD) with the same
    summed log-probs; a finished row adds no more log-prob."""
    case = Case(seed=1, end_bias=3.0)
    jax_ctx, ctx = case.contexts()
    jax_ids, jax_logprob = case.jax.sample_outputs(jax_ctx)
    jax_ids = np.asarray(jax_ids)
    assert (jax_ids == END_TOKEN_INDEX).any(), "no sentence finished"
    _forced(monkeypatch, case.port, jax_ids)
    ids, logprob = case.port.sample_outputs(ctx)
    np.testing.assert_array_equal(ids.numpy(), jax_ids)
    _close(logprob, jax_logprob)
    assert float(logprob[(jax_ids == END_TOKEN_INDEX).any(1)].min()) < 0


def test_sample_outputs_own_draws_are_scored_by_the_steps():
    """The port's own draws (its generator, seeded from the pass's seed):
    PAD after END, and the log-prob of each row is the sum of its tokens'
    log-softmax under ``decode_step`` fed the same ids. Two passes of one
    seed draw alike; another seed draws otherwise."""
    case = Case(seed=2, end_bias=3.0)
    _, ctx = case.contexts()
    ids, logprob = case.port.sample_outputs(ctx)
    again, _ = case.port.sample_outputs(Context(case.params, ctx.batch,
                                                rng=5))
    other, _ = case.port.sample_outputs(Context(case.params, ctx.batch,
                                                rng=6))
    assert torch.equal(ids, again) and not torch.equal(ids, other)
    dec = case.port
    constants = dec.decode_constants(ctx)
    state = dec.decode_initial_state(ctx, constants)
    prev = torch.full((BATCH,), 1, dtype=torch.int32)
    total = torch.zeros(BATCH)
    finished = torch.zeros(BATCH, dtype=torch.bool)
    for t in range(OUT):
        state, logits, _ = dec.decode_step(constants, state, prev, t)
        lp = torch.log_softmax(logits, -1).gather(
            -1, ids[:, t].long()[:, None])[:, 0]
        assert bool((ids[finished, t] == PAD_TOKEN_INDEX).all())
        total += torch.where(finished, 0.0, lp)
        finished |= ids[:, t] == END_TOKEN_INDEX
        prev = ids[:, t]
    torch.testing.assert_close(logprob, total)


def _objective_grads(jax_objective, objective, case):
    jax_loss, jax_grads = jax.value_and_grad(lambda p: jax_objective.loss(
        JaxContext(p, {k: jnp.asarray(v) for k, v in case.batch.items()},
                   train=True, rng=jax.random.PRNGKey(5))))(case.jax_params)
    flat = flatten_tree(case.params)
    for leaf in flat.values():
        leaf.requires_grad_(True)
    _, ctx = case.contexts(train=True)
    loss = objective.loss(ctx)
    loss.backward()
    return jax_loss, jax_flatten(jax_grads), loss, flat


@pytest.mark.parametrize("kind", ["self_critical", "reinforce",
                                  "reinforce_no_baseline"])
def test_rl_objectives_match_jax(monkeypatch, kind):
    """For the ids JAX samples (forced through the port's steps), the
    loss -mean(advantage · log p(sample)) and its gradients; the
    advantage (the sample's GLEU less the greedy decode's, or less the
    batch mean, or the reward alone) carries no gradient."""
    case = Case(seed=3, end_bias=3.0)
    jax_ctx, _ = case.contexts(train=True)
    jax_ids, _ = case.jax.sample_outputs(jax_ctx)
    _forced(monkeypatch, case.port, jax_ids)
    if kind == "self_critical":
        jax_objective = jax_sc.self_critical_objective(case.jax)
        objective = sc.self_critical_objective(case.port)
    else:
        baseline = kind == "reinforce"
        jax_objective = jax_sc.reinforce_objective(
            case.jax, subtract_baseline=baseline)
        objective = sc.reinforce_objective(case.port,
                                           subtract_baseline=baseline)
    assert objective.name == jax_objective.name
    jax_loss, jax_grads, loss, flat = _objective_grads(jax_objective,
                                                       objective, case)
    assert float(jax_loss) != 0.0
    _close(loss, jax_loss)
    assert set(jax_grads) == set(flat)
    for key, ref in jax_grads.items():
        got = flat[key].grad
        got = np.zeros_like(ref) if got is None else got.numpy()
        np.testing.assert_allclose(got, np.asarray(ref), atol=GRAD_ATOL,
                                   rtol=0, err_msg=key)


def test_reinforce_trainer_objectives():
    """Self-critical (the default) or REINFORCE per decoder, and the
    cross-entropy at ``xent_weight`` when it is above 0."""
    dec = Case().port
    trainer = ReinforceTrainer([dec], xent_weight=0.5, clip_norm=1.0)
    assert SelfCriticalTrainer is ReinforceTrainer
    assert [(o.name, o.weight) for o in trainer.objectives] == [
        ("decoder - self-critical", 1.0), ("decoder - cross-entropy", 0.5)]
    trainer = ReinforceTrainer([dec], self_critical=False)
    assert [o.name for o in trainer.objectives] == ["decoder - reinforce"]


# ---------------------------------------------------------------------- #
# the multitask trainer
# ---------------------------------------------------------------------- #
def test_multitask_trainer_takes_turns_with_its_own_optimizer_states(
        tmp_path):
    """Children step in turn by the global step; each keeps its own
    optimizer state (here Adam at two rates and SGD, three labels), all
    saved in ``.opt`` and each restored to its own child in a new
    manager."""
    from neuralmonkey_tpu_torch.trainers.optimizers import (
        AdamOptimizer, GradientDescentOptimizer)
    case = Case()
    dec = case.port
    children = [CrossEntropyTrainer([dec], name="a",
                                    optimizer=AdamOptimizer(0.01)),
                ReinforceTrainer([dec], name="b", xent_weight=0.5,
                                 optimizer=AdamOptimizer(0.001)),
                CrossEntropyTrainer([dec], name="c",
                                    optimizer=GradientDescentOptimizer(0.1))]
    multi = MultitaskTrainer(children)
    assert [multi.select(s).name for s in range(5)] == ["a", "b", "c", "a",
                                                        "b"]
    assert set(multi.all_parts) == {dec}
    manager = CUDAManager(device="cpu")
    manager.initialize_model_parts([multi])
    batch = {k: torch.from_numpy(v) for k, v in case.batch.items()}
    picked = []
    for _ in range(4):
        before = set(manager._opt_states)
        manager.train_on_prepared(multi, batch)
        picked.append((set(manager._opt_states) - before) or None)
    labels = [manager._trainer_label(c) for c in children]
    assert picked[:3] == [{label} for label in labels] and picked[3] is None
    path = str(tmp_path / "variables.data")
    manager.save(path)
    saved = load_flat(path + ".opt")
    assert {key.split("/", 1)[0] for key in saved} == set(labels)
    fresh = CUDAManager(device="cpu")
    fresh.initialize_model_parts([multi])
    fresh.load_optimizer_state(path)
    for child, label in zip(children, labels):
        _, _, state = fresh._optimizer(child)
        for name, value in state.items():
            np.testing.assert_array_equal(value.numpy(),
                                          saved[f"{label}/{name}"])


def test_experiment_builds_a_multitask_trainer_from_a_list(tmp_path,
                                                          monkeypatch):
    """``trainer=[<a>, <b>]`` in [main] trains through one
    MultitaskTrainer: both children's optimizer states in ``.opt``."""
    monkeypatch.chdir(os.path.dirname(TESTS))
    with open(os.path.join(TESTS, "configs", "self_critical.ini")) as f:
        text = f.read()
    text = text.replace("trainer=<trainer>", "trainer=[<trainer>, <xent>]")
    text += ("\n[xent]\nclass=trainers.cross_entropy_trainer."
             "CrossEntropyTrainer\ndecoders=[<decoder>]\noptimizer=<adam>\n")
    ini = tmp_path / "multi.ini"
    ini.write_text(text)
    out = tmp_path / "out"
    exp = Experiment(str(ini), train_mode=True, config_changes=[
        'tf_manager.device="cpu"', f'main.output="{out}"', "main.epochs=1"])
    exp.train()
    saved = load_flat(str(out / "variables.data.opt"))
    assert {key.split("/", 1)[0] for key in saved} == {
        "trainer:decoder - self-critical+decoder - cross-entropy",
        "xent:decoder - cross-entropy"}


# ---------------------------------------------------------------------- #
# self_critical.ini
# ---------------------------------------------------------------------- #
def test_self_critical_ini_clears_its_gate(tmp_path, monkeypatch):
    monkeypatch.chdir(os.path.dirname(TESTS))
    out = tmp_path / "sc"
    Experiment(os.path.join(TESTS, "configs", "self_critical.ini"),
               train_mode=True, config_changes=[
                   'tf_manager.device="cpu"', f'main.output="{out}"',
                   "main.logging_period=10"]).train()
    with open(out / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if r["kind"] == "train"]
    val = [r for r in records if r["kind"] == "val"]
    assert train[-1]["loss"] < train[0]["loss"], "loss did not decrease"
    assert val and val[-1]["target/GLEU-4"] > 0.05, val[-1]


@pytest.mark.parametrize("symbol,target", [
    ("trainers.rl_trainer.ReinforceTrainer", ReinforceTrainer),
    ("neuralmonkey.trainers.rl_trainer.SelfCriticalTrainer",
     ReinforceTrainer),
    ("neuralmonkey_tpu.trainers.multitask_trainer.MultitaskTrainer",
     MultitaskTrainer),
    ("trainers.self_critical_objective.self_critical_objective",
     sc.self_critical_objective),
    ("evaluators.gleu.GLEU", gleu.GLEU),
    ("readers.numpy_reader.numpy_file_list_reader",
     numpy_reader.from_file_list),
    ("attention.combination.HierarchicalMultiAttention",
     combination.HierarchicalMultiAttention),
    ("attention.coverage.CoverageAttention",
     feed_forward.CoverageAttention),
    ("neuralmonkey.attention.scaled_dot_product.MultiHeadAttention",
     scaled_dot_product.MultiHeadAttention),
    ("encoders.numpy_stateful_filler.SpatialFiller",
     numpy_stateful_filler.SpatialFiller)])
def test_builder_resolves_the_new_symbols_into_the_port(symbol, target):
    """Reference-dialect names (bare, ``neuralmonkey.``, the JAX
    package's) of the new classes and functions build the port's."""
    assert resolve_class_symbol(symbol) is target
