#!/usr/bin/env python3
"""Smoke test of the PyTorch port (neuralmonkey_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device: a CUDA card of compute capability >= 9.0; prints its name and
   power limit as nvidia-smi reports them;
2. build: compiles the port's CUDA kernels from csrc/ with nvcc;
3. kernels: each hand-written kernel (K1 GRU scan, K2 Bahdanau step,
   K3 fused logits + selection reductions, K4 small top-k, the GRU BPTT,
   the three fused cross-entropy kernels, the LSTM scan and its BPTT,
   and ``rowmax_lse``) against its plain PyTorch version on the card, at
   the shapes the serving and training paths give it and at one ragged
   shape, with median times from CUDA events, the bound of the same work
   on this card and, where one PyTorch call computes the same function,
   that call's time (cuDNN's LSTM for the LSTM kernels), K2's time with
   the L2 cache flushed before each call, K2 also at phase 31's B·K 640
   rows (``beam_rows`` in K2's entry of the kernels line), K1's scan
   alone
   without and with the carries a gradient needs, K3 beside cuBLAS's
   ``addmm`` of the same shape (a reference for the product alone: no
   PyTorch call computes K3's whole function), the whole
   LSTM backward (autograd through the port's scan: ``lstm_bptt``, the
   recurrent weights' products and the hoisted input's backward) beside
   the plain scan's and cuDNN's backward of the same function, and the
   whole GRU backward (``gru_bptt``, the r recompute, the recurrent
   weights' products and the hoisted input's backward) beside the plain
   scan's (cuDNN's GRU applies r after the recurrent product: another
   function);
3b. past the kernels' first limits: shapes that the JAX package runs,
   through the port's entry points on the card against the CPU: a GRU
   encoder's training step at H 8192 (K1 forward, the plain BPTT past
   ``bptt_fits``, as the JAX package's plain path), an LSTM's at H 8448
   (the plain scan past ``lstm_scan_fits``), multi-head attention at head
   dims 192 and 256 (the flash kernels, which the JAX package pads to any
   head dim) and 320 and 512 (their chunked instances), the lineage
   attention at head dims 640 and 1024 (its chunked instance), K4 at beam
   64 (k 64 over 15360 entries; k 65 through the plain top-k), the
   lineage layout's switch, and the kept designs of the bf16 instances,
   kept for the shapes their gates refuse: the bf16 lineage attention at
   head dim 320 and at 90 lanes (its scratch design) and the bf16-W
   cross-entropy at tied D 130 and untied V 1001 (its widened forward and
   backward); none may raise, each chunked and kept instance must
   launch; each chunked instance is then timed beside its plain version,
   SDPA (the lineage attention's with its bias as the mask) and its bound
   (flash at B 8, H 4, 128 x 128, head dims 512 and 320; lineage at B 8,
   H 2, beam 10, 480 lanes, head dims 1024 and 640);
4. slice: the flagship RNN model (bench.py widths: vocabulary 30000,
   embeddings 512, BiGRU 512, attention 512, conditional-GRU decoder)
   with random seeded weights decodes 128 synthetic sentences greedily
   and with beam 10 through ``neuralmonkey_tpu_torch.run``; every kernel
   must have been launched by that run;
5. parity: 8 of those sentences decoded on the CPU (plain versions) and
   on the card (kernels) give the same greedy ids, or first differ at a
   step where the CPU's top-two logit margin is below 1e-3; and each
   beam search picks the same candidates on both, or first picks
   differently at a step and slot where the CPU's gap to its next
   candidate is below 1e-3 (the next over every candidate: after the
   last slot, the better of the chosen column groups' next and the best
   group that the selector's first stage left out);
6. training: ``python -m neuralmonkey_tpu_torch.train`` trains the same
   model (batch 64, source 32, target 48, Adam, clip 1.0, keep-prob
   0.8) on synthetic pairs whose target is a fixed map of the source
   for one epoch of 20 steps, with one validation (greedy and beam 10)
   and one checkpoint, and ``run`` decodes from that checkpoint; twice,
   without and with ``NM_FUSED_XENT=1``. The loss must fall; K1, the
   BPTT and K2 must launch in both runs, the cross-entropy kernels in
   the second only;
7. training parity: from that checkpoint, dropout off, 8 sentences:
   the loss and every parameter gradient of one step on the card
   (kernels, with and without the fused cross-entropy) against the CPU
   (plain versions): loss to 1e-5 relative, each parameter's gradient
   to 1e-3 of its largest entry (float32 sums in another order through
   80 recurrent steps; TF32 off);
8. Transformer kernels: flash attention forward, dq and dkv at the
   encoder's (32 x 32), the decoder's causal (48 x 48) and cross
   (48 x 32) shapes of bench.py's Transformer (batch 64, 8 heads, head
   dim 64) and at a ragged shape, with and without attention dropout
   (keep 0.9): outputs and lse to 1e-5, the gradients to 1e-4 of their
   largest entry against autograd of the plain version, and the
   dropout mask read back from the kernel equal to the hash's; the
   forward and the backward also at a long source (batch 8, 512 x 512,
   ragged keys), the forward timed with SDPA beside it
   (``long_source_*`` fields); dq, dkv and the whole backward (dcap, dq,
   dkv) timed beside SDPA's backward at the encoder, decoder, cross and
   long-source shapes (``backward_by_shape``); lineage
   attention at batch 64, 8 heads, beam 10, 48 steps, windows 12, 24
   and 48 (each timed), at batch 1 (the lane split, timed), at head dims
   256 and 512 (timed), and at a ragged shape (63 lanes), to 1e-5, with
   its time with
   the L2 cache flushed (``l2_flushed_ms``) and its launch plans;
9. Transformer serving: bench.py's Transformer (512 wide, FFN 2048, 6 +
   6 layers, 8 heads, vocabulary 30000, tied target embeddings) with
   random seeded weights decodes the 128 sentences greedily and with
   beam 10 through ``run``, then with beam 10 again under
   ``NM_LINEAGE_KERNEL=1``; the flash forward, K3 and K4 must launch in
   the first run, lineage attention in the second;
10. Transformer parity: 8 sentences on the CPU and on the card, greedy
   and beam 10 (lineage kernel form), by the margin rule of phase 5;
11. Transformer training: 20 steps through ``train`` (delayed updates
   every 2 batches, Adam on the noam schedule, label smoothing 0.1,
   attention dropout keep 0.9, residual dropout keep 0.9); the loss
   must fall and the flash forward, dq and dkv kernels must launch;
12. Transformer training parity: from that checkpoint, residual
   dropout off and attention dropout on (both devices draw the same
   hash mask from the same key words), the loss and every gradient of
   one step on the card, without and with the fused cross-entropy (tied
   (V, D) layout, label smoothing 0.1), against the CPU, by the limits
   of phase 7; an attention key bias, whose exact gradient is 0, is held
   against the largest entry of its key weight's gradient, and the CPU
   follows the card's ReLU branch, every unit whose sign differs
   between the devices being within 1e-4 of 0 on the CPU;
13. LSTM serving: the flagship model with ``rnn_cell="LSTM"`` in its
   encoder (a bidirectional LSTM of 512, TF1 gate order, forget bias
   1.0) decodes the 128 sentences greedily and with beam 10 through
   ``run``, then with beam 10 again under ``NM_FUSED_LOGITS=0``; the
   LSTM scan, K2, K3 and K4 must launch in the first run, ``rowmax_lse``
   and not K3 in the second, and the GRU scan in neither;
14. LSTM parity: phase 5's rule for that model, with the fused logit
   projection and under ``NM_FUSED_LOGITS=0``;
15. LSTM training: 20 steps through ``train`` as in phase 6 (the
   unfused cross-entropy); the loss must fall and the LSTM scan, its
   BPTT and K2 must launch;
16. LSTM training parity: phase 7 from that checkpoint.
17. server: phase 4's checkpoint behind ``server.ModelService`` and
   ``ThreadingHTTPServer`` on 127.0.0.1 (window 10 ms): 32 concurrent
   ``POST /run`` requests of 1-8 of phase 4's sentences; each answer
   equals phase 4's output, or a greedy answer first differs where the
   CPU's gap between the two tokens is below 1e-3 and a differing beam
   answer's sentence passes phase 5's rule; K1-K4 must launch; prints the
   requests, model calls, p50 and p99 latency, sentences/s and launches;
18. task heads: the labeler and the word-alignment decoder over the
   flagship encoder and decoder at full width on phase 6's pairs: one
   training step's loss and gradients on the card against the CPU by
   phase 7's rule against phase 12's float64 reference, and the
   labeler's tags equal to the CPU's or differing
   only where the CPU's top-two gap is below 1e-3; then labeler.ini,
   language_model.ini, post_edit.ini, regressor.ini, alignment.ini and
   str.ini of tests/configs train on the card to the gates of
   tests/test_capability_inis.py, each with a falling loss and its
   kernels launched;
19. multimodal: examples/multimodal_mt.ini's model (vocabulary 20000, a
   BiGRU 512 over the text, a 14 x 14 x 512 map projected to 512, a
   Bahdanau attention of 512 over each, a hierarchical attention of 512
   over both, a GRU decoder of 512, 50 output steps) decodes 128
   synthetic sentences with their maps greedily and with beam 10 through
   ``run`` (K1-K4 must launch), and examples/captioning.ini's model (the
   map as it is, attention 512, decoder 512, vocabulary 15000, 24 steps)
   greedily (K2 must launch); 8 sentences of each against the CPU by
   phase 5's rule; the MMT model trains 4 steps through ``train`` (K1,
   the BPTT and K2, and K3 and K4 in its validation, must launch) and
   one step against the CPU by phase 12's float64 rule; K2 at the image
   shapes (T 196, A 512, D 512; B 64, and B 640 for the hierarchical
   children tiled under beam 10) against its plain version, timed beside
   it and its bound (``image_shapes`` in K2's entry of the kernels line);
20. self-critical: phase 6's model trains 4 steps through ``train`` with
   ``ReinforceTrainer`` (self-critical, GLEU rewards on the host,
   cross-entropy at 0.5, clip 1.0, Adam; K1, the BPTT, K2, K3 and K4 must
   launch; finite losses), then one step on 8 sentences against the
   CPU, which replays the card's sampled and greedy ids, by phase 12's
   float64 rule;
21. CNN: the flagship model with ``SentenceCNNEncoder`` as its encoder at
   the widths of Lee, Cho & Hofmann (2017: filter widths 1-8 with 200,
   200, 250, 250, 300, 300, 300 and 300 filters, 4 highway layers) under
   a BiGRU of 512 decodes the 128 sentences greedily and with beam 10
   through ``run`` (K1-K4 must launch), 8 of them against the CPU by
   phase 5's rule; it trains 4 steps through ``train`` (K1, the BPTT and
   K2 must launch) and one step against the CPU by phase 12's float64
   rule; Kim's (2014) classifier (``SequenceCNNEncoder``, embeddings
   300, widths 3, 4 and 5 with 100 filters each, ``Classifier`` at
   keep-prob 0.5, 30000 words) labels 64 sentences on the card as on
   the CPU (differing only where the CPU's top-two gap is below 1e-3);
   one ``CNNEncoder`` forward over 64 images of 224 x 224 x 3 (two 3 x 3
   convolutions of 64, a 2 x 2 max-pool, a strided 3 x 3 convolution of
   128, instance norm) against the CPU; sentence_cnn.ini and
   classifier.ini train on the card to their gates;
22. MoE: bench.py's Transformer cut to 2 + 2 layers with 8 experts,
   top-2 routing at capacity factor 1.5 in every FFN, decodes the 128
   sentences greedily and with beam 10 through ``run`` in both lineage forms, 8 of them against the
   CPU by phase 5's rule in each form; it trains 8 steps of
   ``DelayedUpdateTrainer`` (k = 2, noam, router noise 0.01, z-loss
   0.001) through ``train`` with a falling loss, and one step with the
   noise off against the CPU by phase 12's float64 rule; the flash
   kernels, K3, K4 and the lineage attention must launch; moe.ini trains
   on the card to its gate;
23. speech: ``RawRNNEncoder`` (a BiGRU of 512) over 40 log-mel-sized
   features under ``CTCDecoder`` (a 32-symbol vocabulary), batch 32 of
   400 frames, decodes 128 synthetic utterances greedily and with the
   prefix beam search at beam 8 through ``run`` (K1 must launch); 32 of
   them on the card and the CPU: equal greedy ids, or a first differing
   frame where the CPU's top-two gap is below 1e-3, and the beam's best
   prefixes equal, or the searches first choosing differently where the
   CPU's gap to the next candidate is below 1e-3; it trains 4 steps
   through ``train`` (K1 and the BPTT must launch) and one step against
   the CPU by phase 12's float64 rule; ctc.ini (WER < 0.8) and
   audio_classifier.ini (AccuracySeqLevel > 0.5) train on the card on
   the WAVs of tests/data to their gates;
24. bf16 policy: ``NM_COMPUTE_DTYPE=bfloat16`` over phase 4's and phase
   9's models and phases 6's and 11's training INIs: the RNN decodes the
   128 sentences greedily and with beam 10 through ``run`` (K1-K4 launch;
   K3 on the bf16 table widened to float32, as the JAX package arms it),
   8 against the CPU under the policy by phase 5's rule at
   ``BF16_MARGIN`` (0.1: a value on a bf16 rounding boundary may round
   apart on the two devices), its beam scores within 0.05 plus 0.5% of
   float32's;
   it trains 20 steps through ``train``, one step's loss within 2^-8
   (relative) of the CPU's and 5% of float32's; the Transformer decodes
   with beam 10 in both lineage forms (the lineage attention's bf16
   instance, never its float32 one, in the kernel form), the kernel form
   against the CPU at ``BF16_MARGIN`` and its scores against float32;
   it trains 20 steps with ``NM_FUSED_XENT=1`` (the bf16-W cross-entropy
   kernels, never the float32 ones) and one fused step against the CPU
   and float32; K3 launches on a bf16 W (widened) and matches its plain
   version within 1e-4.
   The float32 and bf16 rates of the same paths print side by side. The
   kernels phase holds the bf16 instances against their plain versions:
   the lineage attention on bf16 caches (one bf16 ulp of a weight times
   the largest value, and at most 1% of the rows more than 2^-16 of it
   apart, a rule that must reject the plain version with a rounding
   point left out) and the three fused cross-entropy kernels reading
   a bf16 W (1e-5, 1e-4 as their float32 instances), each timed beside
   the kept design on the same operands (``pr15_design_ms``), the forward's
   second call bitwise equal to its first; phase 24 must never launch
   the kept designs;
25. ensembles, averaging and grid decoding: phase 4's model and a second
   member initialised from another seed decode the 128 sentences through
   ``run`` as a logit ensemble (greedy and beam 10): K1, K2 and K4 must
   launch, K3 and ``rowmax_lse`` never (the selector takes the averaged
   log-probs); 8 of them against the CPU's ensemble by phase 5's rule,
   the greedy margins taken on the CPU's averaged log-probs. The two
   checkpoints averaged by ``utils.average_checkpoints`` must equal the
   numpy mean bitwise, and ``run --average`` must decode the ids of
   ``run`` on that file. Phase 9's Transformer with a second member
   decodes as an ensemble by default and under ``NM_LINEAGE_KERNEL=1``
   (the same ids in both): the flash forward and K4 must launch, the
   lineage attention (any instance), K3 and ``rowmax_lse`` never; 8
   sentences against the CPU by phase 5's rule. Phase 18's labeler
   (``max_input_len`` 32, alone) labels 128 sentences of 80-200 words
   through ``run --grid``: K1 must launch and each output line must have
   its sentence's length. The ensemble, ``--average`` and grid rates and
   the hand-written kernels' launches per decode step print beside phase
   4's single-model rates.
26. the model and trainer long tail: phase 6's flagship trains 8 steps
   through ``train`` (the prefetch worker on) with a LayerNormGRU encoder
   and Adafactor, a NoisyGRU encoder and RMSProp, and a NoisyGRU encoder
   and Adadelta: K2 must launch, K1 and ``gru_bptt`` never (the step
   scan runs these cells); attention maps are written as PNGs; one step
   of each against the CPU by phase 7's rule with phase 12's float64
   reference (the card's noise draws replayed on the CPU), and the first
   update against the CPU's from the same gradients (``UPDATE_ERR``). A
   run resumed from a checkpoint and its ``.opt`` must continue the
   uninterrupted card run's losses (1e-5); phase 6's model warm-starts
   its decoder by part (the file's tensors exactly). Phase 4's model
   decodes the 128 sentences through ``run`` under ``align_logits`` (K3
   on the table aligned to 30080 columns) and ``use_approx_top_k`` (the
   flat selector: K3, ``rowmax_lse`` and K4 never), 8 of them against
   the CPU by phase 5's rule (the flat selector's gaps from its sort);
   its greedy and beam-10 attention maps within 1e-5 of the CPU's where
   the ids agree. Prints each run's train tokens/s beside the GRU's over
   the same steps, each optimizer's ms per update over the flagship's
   parameters, the GRU's tokens/s with and without the prefetch worker
   in turns, and beam-10 sentences/s under ``align_logits`` beside the
   default in turns.
27. the host and image tail: examples/captioning.ini's decoder (RNN,
   embeddings and attention 512, 24 steps, vocabulary 15000, batch 64)
   over ``ImageNet(network_type="vgg_16")`` run in the graph on 224 x
   224 x 3 seeded images (conv5_3, 14 x 14 x 512, is the attention's T
   196): 128 images captioned greedily and with beam 10 through ``run``
   (K2 must launch in the greedy runner's pass, K3 and K4 in the beam's),
   8 against the CPU by phase 5's rule; 4 training steps through
   ``train`` with ``fine_tune=False`` (K2 must launch, the loss fall, the
   CNN's tensors stay as initialised) and one step against the CPU by
   phase 12's float64 rule, then 2 steps with ``fine_tune=True`` (the
   CNN's tensors move); the VGG-16 forward at batch 64 and ResNet-v2-50's
   (``postnorm``, 7 x 7 x 2048) at batch 32 against the CPU within 1e-4
   of the largest entry, each timed with its images/s; chrF3, TER,
   SacreBLEU and F1 of the serving model's greedy captions of 8 images
   against its beam captions equal on both devices; the
   port's logbook (``python -m neuralmonkey_tpu_torch.logbook``) on a
   free local port over the phase's training runs answers ``/`` and
   ``/experiment/<name>``; phase 9's Transformer with
   ``visualize_attention``: its greedy and beam-10 maps within 1e-5 of
   the CPU's where the ids agree, the hand-written kernels' launches and
   the ATen operations per decode step with and without the maps (the
   launches equal); the native host library: an 8000-merge BPE table
   learned by the port's ``learn_bpe`` (in a process of its own, during
   the phase) from 20000 seeded sentences, applied through the native
   codec and the Python loop (``NM_NATIVE=0``) from cold caches with
   byte-equal output, the flagship's 30000-word vocabulary over 20000 of
   its sentences both ways with equal ``(ids, mask)``, sentences/s of
   each, and 4 processes building the library into one fresh
   ``NM_NATIVE_CACHE`` at once, each loading it.
28. data parallelism (``parallel/``): phase 6's model with dropout off
   trains 4 steps (batch 64) through the train CLI's ``main`` in this
   process, with no process group; then (a) in a process of its own that
   joins a process group of one over NCCL from the ``NM_*`` environment,
   the same 4 steps replicated, under ``shard_optimizer_state`` (ZeRO-1)
   and under ``fsdp``, each within 1e-5 of the first run's losses; (b)
   two processes sharing the card (both ``cuda:0``, gloo) train the same
   64 global rows a step under the three modes: both ranks' losses
   equal, within 1e-5 of (a)'s, K1, ``gru_bptt`` and K2 launched by
   each rank, only rank 0 writing checkpoints and metrics; each rank
   restores rank 0's checkpoint and ``.opt`` and takes one step more,
   holding at rest under ZeRO-1 and FSDP at most 0.55 of the replicated
   optimizer (and FSDP parameter) bytes; one process continues FSDP's
   checkpoint as the two ranks do (1e-5); the two ranks decode phase 4's
   128 sentences under fsdp, greedily and with beam 10 (K1-K4 launched
   by each rank), to phase 4's ids by phase 5's rule. Prints each rank's
   memory peak, its bytes at rest and the tokens/s of (a) and of (b),
   the latter two ranks time-sharing one card (not scaling).
29. the model axes: phase 11's Transformer with dropout off, 4 steps
   (batch 64) in one process and on two ranks sharing the card over
   gloo, under TP 2 with sequence sharding and under CP 2 (step-1 loss
   and parameters within 1e-5 of one process's), and phase 9's first
   batch decoded under TP 2 by phase 5's rule; the flash kernels and K4
   checked at a rank's 4 heads just after phase 3.
30. the pipe and expert axes: phase 11's Transformer with its layers
   stacked for 2 pipeline stages and 4 microbatches, and phase 22's
   Transformer with 8 experts (router noise and dropout off), 4 steps
   (batch 64) each in one process and on two ranks sharing the card
   over gloo, over a pipe axis of 2 and over an expert axis of 2:
   step-1 loss and parameters within 1e-5 of one process's, both ranks'
   losses equal, the flash kernels launched by each rank, 3 layers a
   stage and 4 experts a rank at rest; phase 9's checkpoint in the
   stacked layout decodes phase 9's first batch over the pipe axis
   (greedy and beam 10, the flash forward, K3 and K4 launched by each
   rank) to phase 9's ids by phase 5's rule. Prints each rank's bytes
   at rest and peak and their share of one process's, tokens/s (two
   ranks time-sharing one card: not scaling) and the kernels' launches
   on the ranks.
31. the physical reorder: ``NM_LINEAGE=0`` over phase 4's first batch
   of 64 sentences through ``run``, greedy and beam 10: phase 4's RNN
   (K2 must launch at B·K 640 rows, K3 and K4 too), then phase 9's
   Transformer, by default and under ``NM_LINEAGE_KERNEL=1`` (K3 and K4
   must launch); no run may launch the lineage attention. The beam
   searches of the first 8 sentences are held to phases 5's and 10's
   CPU searches by phase 5's rule (the CPU's lineage search: the same
   picks, step by step). Prints each model's beam-10 sentences/s over
   that batch in both forms, the median of 3 passes each.

Kernel times are device times: CUDA events between back-to-back calls
queued behind a spin kernel (``call_ms`` times one call of the wrapper
alone, with its host cost).

Every phase prints its seconds. Standard output holds the launch plans
of the redesigned kernels (K1 ``gru_scan``, K2, ``lstm_scan``,
``lstm_bptt``, ``gru_bptt``, ``fused_xent_bwd_dx`` and ``_dw``, the flash
forward and backward) as
one JSON line, the card's name and power limit, a JSON object of the
phases' results, then, on the line before the last, a JSON object with
one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 1234
VOCAB, EMB, RNN, ATT = 30000, 512, 512, 512
BATCH, SRC_LEN, BEAM, MAX_OUT = 64, 32, 10, 48
N_SENTENCES, N_PARITY = 128, 8
MARGIN = 1e-3

SERVING_KERNELS = ("gru_scan", "fused_bahdanau_step",
                   "fused_logits_rowmax_lse", "small_topk")
TGT_LEN, N_TRAIN, N_VAL, KEEP_PROB = 48, 20 * BATCH, BATCH, 0.8
SOURCE_WORDS = 2000  # synthetic sources draw from the first 2000 words
XENT_N, XENT_D = BATCH * TGT_LEN, EMB
# the H100's published peaks (SXM, 700 W): float32 on the CUDA cores,
# TF32 on the tensor cores (dense), and HBM3
F32_PEAK, TF32_PEAK, HBM_RATE = 67e12, 495e12, 3.35e12
# bf16 on the tensor cores (dense)
BF16_PEAK = 989e12
# a spin of about 50 ms at the H100's clock: long enough for the host to
# queue every timed call behind it
SPIN_CYCLES = 100_000_000
# training parity: a ReLU pre-activation this close to 0 may take either
# side on either device
RELU_MARGIN = 1e-4
# training parity against a float64 step: the card's float32 gradient may
# lie this many times as far from it as the CPU's float32 gradient does
GRAD_SPREAD = 4.0

KERNELS = {
    "gru_scan": ("neuralmonkey_tpu_torch/csrc/gru_scan.cu",
                 "neuralmonkey_tpu/ops/pallas_rnn.py:86"),
    "gru_bptt": ("neuralmonkey_tpu_torch/csrc/gru_bptt.cu",
                 "neuralmonkey_tpu/ops/pallas_rnn.py:130"),
    "fused_bahdanau_step": ("neuralmonkey_tpu_torch/csrc/bahdanau.cu",
                            "neuralmonkey_tpu/ops/pallas_attention.py:885"),
    "fused_logits_rowmax_lse": ("neuralmonkey_tpu_torch/csrc/beam_select.cu",
                                "neuralmonkey_tpu/ops/beam_select.py:216"),
    "small_topk": ("neuralmonkey_tpu_torch/csrc/beam_select.cu",
                   "neuralmonkey_tpu/ops/beam_select.py:102"),
    "fused_xent_fwd": ("neuralmonkey_tpu_torch/csrc/fused_xent.cu",
                       "neuralmonkey_tpu/ops/fused_xent.py:166"),
    "fused_xent_bwd_dx": ("neuralmonkey_tpu_torch/csrc/fused_xent.cu",
                          "neuralmonkey_tpu/ops/fused_xent.py:290"),
    "fused_xent_bwd_dw": ("neuralmonkey_tpu_torch/csrc/fused_xent.cu",
                          "neuralmonkey_tpu/ops/fused_xent.py:316"),
    "flash_attention_fwd": (
        "neuralmonkey_tpu_torch/csrc/flash_attention.cu",
        "neuralmonkey_tpu/ops/pallas_attention.py:85"),
    "flash_attention_bwd_dq": (
        "neuralmonkey_tpu_torch/csrc/flash_attention.cu",
        "neuralmonkey_tpu/ops/pallas_attention.py:359"),
    "flash_attention_bwd_dkv": (
        "neuralmonkey_tpu_torch/csrc/flash_attention.cu",
        "neuralmonkey_tpu/ops/pallas_attention.py:425"),
    "lineage_attention": ("neuralmonkey_tpu_torch/csrc/lineage_attention.cu",
                          "neuralmonkey_tpu/ops/lineage_attention.py:71"),
    "lstm_scan": ("neuralmonkey_tpu_torch/csrc/lstm_scan.cu",
                  "neuralmonkey_tpu/ops/pallas_rnn.py:473"),
    "lstm_bptt": ("neuralmonkey_tpu_torch/csrc/lstm_bptt.cu",
                  "neuralmonkey_tpu/ops/pallas_rnn.py:514"),
    "rowmax_lse": ("neuralmonkey_tpu_torch/csrc/beam_select.cu",
                   "neuralmonkey_tpu/ops/beam_select.py:52"),
    # the chunked instances past the single-pass head dims (the JAX kernels
    # pad any head dim): the same TPU kernels
    "flash_attention_fwd_chunked": (
        "neuralmonkey_tpu_torch/csrc/flash_attention.cu",
        "neuralmonkey_tpu/ops/pallas_attention.py:85"),
    "flash_attention_bwd_dq_chunked": (
        "neuralmonkey_tpu_torch/csrc/flash_attention.cu",
        "neuralmonkey_tpu/ops/pallas_attention.py:359"),
    "flash_attention_bwd_dkv_chunked": (
        "neuralmonkey_tpu_torch/csrc/flash_attention.cu",
        "neuralmonkey_tpu/ops/pallas_attention.py:425"),
    "lineage_attention_chunked": (
        "neuralmonkey_tpu_torch/csrc/lineage_attention.cu",
        "neuralmonkey_tpu/ops/lineage_attention.py:71"),
    # the bf16 instances (the bf16 compute policy, phase 24): the lineage
    # attention on bf16 caches, the fused cross-entropy reading a bf16 W
    "lineage_attention_bf16": (
        "neuralmonkey_tpu_torch/csrc/lineage_attention.cu",
        "neuralmonkey_tpu/ops/lineage_attention.py:71"),
    "fused_xent_fwd_bf16w": ("neuralmonkey_tpu_torch/csrc/fused_xent.cu",
                             "neuralmonkey_tpu/ops/fused_xent.py:166"),
    "fused_xent_bwd_dx_bf16w": ("neuralmonkey_tpu_torch/csrc/fused_xent.cu",
                                "neuralmonkey_tpu/ops/fused_xent.py:290"),
    "fused_xent_bwd_dw_bf16w": ("neuralmonkey_tpu_torch/csrc/fused_xent.cu",
                                "neuralmonkey_tpu/ops/fused_xent.py:316"),
    # the earlier designs of the bf16 instances, kept for the shapes their
    # gates refuse (phase 3b's): the lineage attention through a float32
    # scores scratch (odd lane counts, head dims past 256), the
    # cross-entropy where W's bf16 rows are not 16-byte aligned (W widened
    # as it is staged)
    "lineage_attention_bf16_scratch": (
        "neuralmonkey_tpu_torch/csrc/lineage_attention.cu",
        "neuralmonkey_tpu/ops/lineage_attention.py:71"),
    "fused_xent_fwd_bf16w_widened": (
        "neuralmonkey_tpu_torch/csrc/fused_xent.cu",
        "neuralmonkey_tpu/ops/fused_xent.py:166"),
    "fused_xent_bwd_dx_bf16w_widened": (
        "neuralmonkey_tpu_torch/csrc/fused_xent.cu",
        "neuralmonkey_tpu/ops/fused_xent.py:290"),
    "fused_xent_bwd_dw_bf16w_widened": (
        "neuralmonkey_tpu_torch/csrc/fused_xent.cu",
        "neuralmonkey_tpu/ops/fused_xent.py:316"),
}
CHUNKED_KERNELS = ("flash_attention_fwd_chunked",
                   "flash_attention_bwd_dq_chunked",
                   "flash_attention_bwd_dkv_chunked",
                   "lineage_attention_chunked")
# bench.py build_transformer: 512 wide, FFN 2048, 6 + 6 layers, 8 heads
T_DIM, T_FF, T_DEPTH, T_HEADS = 512, 2048, 6, 8
T_HEAD_DIM = T_DIM // T_HEADS
FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")
T_SERVING_KERNELS = ("flash_attention_fwd", "fused_logits_rowmax_lse",
                     "small_topk")
T_ATT_KEEP = 0.9
# the flash kernels' main-path shapes (batch, heads, q len, kv len, head
# dim, causal) and the long source
FLASH_SHAPES = {
    "encoder": (BATCH, T_HEADS, SRC_LEN, SRC_LEN, T_HEAD_DIM, False),
    "decoder self": (BATCH, T_HEADS, TGT_LEN, TGT_LEN, T_HEAD_DIM, True),
    "cross": (BATCH, T_HEADS, TGT_LEN, SRC_LEN, T_HEAD_DIM, False),
    "long source": (8, T_HEADS, 512, 512, T_HEAD_DIM, False)}
# the flagship model with rnn_cell="LSTM" in its encoder
LSTM_SERVING_KERNELS = ("lstm_scan", "fused_bahdanau_step",
                        "fused_logits_rowmax_lse", "small_topk")
LSTM_UNFUSED_KERNELS = ("lstm_scan", "rowmax_lse", "small_topk")
LSTM_TRAINING_KERNELS = ("lstm_scan", "lstm_bptt", "fused_bahdanau_step")
# the bf16 compute policy (phase 24). Card against CPU: both compute the
# same function with float32 sums in another order, so a value that lands
# within a few float32 ulps of a bf16 rounding boundary may round to either
# side, moving one input of a later product by one bf16 ulp (2^-8 of it);
# where that input is a layer-norm row's scale or a cache entry, every
# logit after it moves (on the CPU the JAX package's own compiled and
# op-by-op programs differ so by 0.04 in a logit at width 32:
# tests/test_torch_precision.py). So ids may first differ where the CPU's
# gap is below BF16_MARGIN, not 1e-3; one step's loss agrees to one bf16
# ulp (2^-8) relative. bf16 against float32: losses within 5%, as the JAX
# package's tests/test_precision_policy.py holds them; beam scores within
# 0.05 there too, for a width-6 RNN over 5 steps, where a score is a few
# units. Phase 9's random 30000-word Transformer scores its 48 tokens at
# over 100 (on an H100 up to 0.147 apart, 0.13% of a score; the RNN's
# up to 2.9e-4), so scores take 0.5% of a score beside the 0.05: about
# four times the largest share seen, where a misrounded layer moves a
# score by percents
BF16_MARGIN = 0.1
BF16_LOSS_RTOL = 2.0 ** -8
BF16_TRACKS_RTOL, BF16_SCORES_ATOL, BF16_SCORES_RTOL = 0.05, 0.05, 0.005
BF16_KERNELS = ("lineage_attention_bf16", "fused_xent_fwd_bf16w",
                "fused_xent_bwd_dx_bf16w", "fused_xent_bwd_dw_bf16w")
WIDENED_KERNELS = ("fused_xent_fwd_bf16w_widened",
                   "fused_xent_bwd_dx_bf16w_widened",
                   "fused_xent_bwd_dw_bf16w_widened")
LINEAGE_SCRATCH = "lineage_attention_bf16_scratch"


def import_everything() -> None:
    """Import every module the phases below import (the tests check
    that none of them reaches JAX or the JAX package)."""
    import torch  # noqa: F401

    from neuralmonkey_tpu_torch import (  # noqa: F401
        experiment, run, server, train)
    from neuralmonkey_tpu_torch.model import part  # noqa: F401
    from neuralmonkey_tpu_torch.models.decoders import (  # noqa: F401
        beam_search_decoder, classifier, ctc_decoder, sequence_labeler,
        sequence_regressor, transformer, word_alignment_decoder)
    from neuralmonkey_tpu_torch.models.attention import \
        combination  # noqa: F401
    from neuralmonkey_tpu_torch.models.encoders import (  # noqa: F401
        cnn_encoder, numpy_stateful_filler, raw_rnn_encoder,
        sentence_cnn_encoder, sequence_cnn_encoder)
    from neuralmonkey_tpu_torch.readers import (  # noqa: F401
        audio_reader, numpy_reader)
    from neuralmonkey_tpu_torch.runners import (  # noqa: F401
        label_runner, perplexity_runner, plain_runner, regression_runner,
        word_alignment_runner)
    from neuralmonkey_tpu_torch.evaluators import wer  # noqa: F401
    from neuralmonkey_tpu_torch.models.encoders import \
        transformer as _  # noqa: F401
    from neuralmonkey_tpu_torch.ops import (  # noqa: F401
        beam_select, cuda_attention, cuda_rnn, flash_attention, fused_xent,
        kernel_config, lineage_attention, moe, nn, policy, sharding)
    from neuralmonkey_tpu_torch.parallel import (  # noqa: F401
        distributed, mesh, ring_attention, tensor, zero)
    from neuralmonkey_tpu_torch.trainers import (  # noqa: F401
        delayed_update_trainer, rl_trainer)
    from neuralmonkey_tpu_torch.utils import (  # noqa: F401
        average_checkpoints, png, saving)
    from neuralmonkey_tpu_torch.nn import (  # noqa: F401
        highway, mlp, noisy_gru_cell, ortho_gru_cell, projection, utils)


def log(message: str) -> None:
    print(f"[chip_smoke] {message}", file=sys.stderr, flush=True)


def time_ms(fn, runs: int = 25) -> float:
    """Median device milliseconds of one call of ``fn``: CUDA events
    between ``runs`` back-to-back calls, all queued while the card runs a
    spin kernel, so the host's cost of a call does not reach the card's
    clock (a call that synchronizes falls back to its wall time)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(runs + 1)]
    torch.cuda._sleep(SPIN_CYCLES)
    events[0].record()
    for event in events[1:]:
        fn()
        event.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b)
                             for a, b in zip(events, events[1:]))


def flushed_ms(fn, runs: int = 25) -> float:
    """Median device milliseconds of one call of ``fn`` with the L2 cache
    cold: a 64 MB buffer (more than the H100's 50 MB of L2) is written
    before each call, outside the CUDA events around it, all queued
    behind a spin kernel as in :func:`time_ms`."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    torch.cuda._sleep(SPIN_CYCLES)
    for start, end in pairs:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def call_ms(fn, runs: int = 25) -> float:
    """Median milliseconds of one call of ``fn`` from CUDA events around
    it alone: the device time, or the host's cost of the call where that
    is longer."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def bound(flops: float, nbytes: float, peak: float = F32_PEAK):
    """(ms, what bounds it): the least time this card could take for
    ``flops`` operations at ``peak`` (by default float32 on the CUDA
    cores) and ``nbytes`` bytes of memory traffic (each input read once,
    each output written once)."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_RATE * 1e3
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes"))


# ---------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------- #
def check_kernels(device):
    import torch

    from neuralmonkey_tpu_torch.ops import (beam_select, cuda_attention,
                                            cuda_rnn, nn)

    gen = torch.Generator().manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    def lengths_mask(lengths, time):
        mask = torch.zeros(len(lengths), time)
        for i, n in enumerate(lengths):
            mask[i, :n] = 1.0
        return mask.to(device)

    results = {}

    def record(name, err, tol, shape, ms=None, plain_ms=None, work=None,
               library_ms=None, call=None, peak=F32_PEAK, **extra):
        """Check ``err <= tol``; for the timed shape keep the times, the
        bound of ``work`` = (flops, bytes) at ``peak``, ``extra`` times
        and, given the kernel's wrapper as ``call``, its time alone with
        the host's cost."""
        log(f"{name} {shape}: max_abs_err {err:.3g} (tol {tol:g})"
            + ("" if ms is None else f", kernel {ms:.4f} ms, plain "
               f"{plain_ms:.4f} ms"))
        if not err <= tol:
            raise AssertionError(f"{name} {shape}: error {err} > {tol}")
        entry = results.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if ms is not None:
            entry.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         call_ms=call_ms(call) if call else None, **extra)
            entry["bound_ms"], entry["bound_by"] = bound(*work, peak)

    # K1: the encoder's BiGRU through the wrapper it calls (input
    # projection, weight stacking, direction encoding), against the same
    # call on CPU copies; error compounds over T
    def cpu(tree):
        return {k: v.cpu() for k, v in tree.items()}

    for batch, time_, width, hidden, lengths, timed in (
            (BATCH, SRC_LEN, EMB, RNN, [SRC_LEN] * BATCH, True),
            (5, 7, 24, 50, [7, 5, 3, 1, 6], False)):
        fw, bw = ({k: v.to(device) for k, v in
                   nn.GRUCell(width, hidden).init(gen).items()}
                  for _ in range(2))
        inputs = randn(batch, time_, width)
        mask = lengths_mask(lengths, time_)
        got = cuda_rnn.gru_scan([(fw, False), (bw, True)], inputs, mask)
        ref = cuda_rnn.gru_scan([(cpu(fw), False), (cpu(bw), True)],
                                inputs.cpu(), mask.cpu())
        err = max(max_err(got[0].cpu(), ref[0]),
                  max_err(got[1].cpu(), ref[1]))
        timing = {}
        if timed:
            wgh = torch.stack([fw["gates_h"], bw["gates_h"]])
            wch = torch.stack([fw["cand_h"], bw["cand_h"]])
            x = cuda_rnn.hoisted_inputs([fw, bw], inputs)
            x_grad = x.detach().requires_grad_()

            def scan_alone():
                with torch.no_grad():
                    return cuda_rnn._GRUScan.apply(x, mask, wgh, wch, 2)

            def wrapper():
                return cuda_rnn.gru_scan([(fw, False), (bw, True)], inputs,
                                         mask)
            # the wrapper, and its two parts: the persistent scan (with
            # its scratch), without and with the carries a gradient
            # needs, and the hoisted input GEMM
            timing = dict(
                ms=time_ms(wrapper), call=wrapper,
                plain_ms=time_ms(lambda: cuda_rnn.gru_scan_reference(
                    cuda_rnn.hoisted_inputs([fw, bw], inputs), mask, wgh,
                    wch, [False, True])),
                scan_ms=time_ms(scan_alone),
                scan_saved_ms=time_ms(lambda: cuda_rnn._GRUScan.apply(
                    x_grad, mask, wgh, wch, 2)),
                hoisted_gemm_ms=time_ms(
                    lambda: cuda_rnn.hoisted_inputs([fw, bw], inputs)))
        # the wrapper's work: the hoisted input product and the scan
        work = (2 * batch * time_ * width * 6 * hidden
                + time_ * batch * 12 * hidden * hidden,
                4 * (batch * time_ * width + 2 * width * 3 * hidden
                     + 2 * 3 * hidden + 2 * 3 * hidden * hidden
                     + batch * time_ + batch * time_ * 2 * hidden
                     + batch * 2 * hidden))
        record("gru_scan", err, 1e-4, (batch, time_, hidden), work=work,
               **timing)

    # K2: greedy attention step; exact masked-softmax constants
    for batch, time_, lengths, timed in (
            (BATCH, SRC_LEN, [SRC_LEN] * BATCH, True),
            (5, 9, [9, 4, 1, 0, 7], False)):
        keys = randn(batch, time_, ATT)
        states = randn(batch, time_, 2 * RNN)
        mask = lengths_mask(lengths, time_)
        pq = randn(batch, ATT)
        v = randn(ATT, scale=ATT ** -0.5)
        got = cuda_attention.fused_bahdanau_step(keys, states, mask, pq, v)
        ref = cuda_attention.bahdanau_reference(keys, states, mask, pq, v)
        record("fused_bahdanau_step", max_err(got[1], ref[1]), 1e-5,
               (batch, time_, "weights"))
        timing = {}
        if timed:
            def step():
                return cuda_attention.fused_bahdanau_step(keys, states, mask,
                                                          pq, v)
            # back to back the 12.6 MB of keys and states stay in the 50
            # MB L2; the flushed time reads them from device memory
            timing = dict(ms=time_ms(step), l2_flushed_ms=flushed_ms(step),
                          plain_ms=time_ms(
                              lambda: cuda_attention.bahdanau_reference(
                                  keys, states, mask, pq, v)))
        dim = 2 * RNN
        work = (batch * time_ * (4 * ATT + 2 * dim),
                4 * (batch * time_ * (ATT + dim + 2) + batch * ATT + ATT
                     + batch * dim))
        record("fused_bahdanau_step", max_err(got[0], ref[0]), 1e-4,
               (batch, time_, "context"), work=work, **timing)
    results["fused_bahdanau_step"]["beam_rows"] = bahdanau_beam_rows(
        cuda_attention, randn, record)

    # K3: one beam step's logit projection, vocabulary padded as in the
    # search (multiple of 1024 columns, bias -1e9 on the pad)
    vp = -(-VOCAB // 1024) * 1024
    for n, d, v_real, vp_, timed in ((BATCH * BEAM, EMB, VOCAB, vp, True),
                                     (37, 100, 1000, 1024, False)):
        x = randn(n, d)
        w = randn(d, vp_, scale=d ** -0.5)
        b = torch.cat([torch.randn(v_real, generator=gen) * 0.1,
                       torch.full((vp_ - v_real,), -1e9)]).to(device)
        got = beam_select.fused_logits_rowmax_lse(x, w, b)
        ref = beam_select.fused_logits_reference(x, w, b)
        # compared where the vocabulary is real: at -1e9 the f32 spacing
        # is 64, and the pad only has to stay far below every real logit
        real_groups = -(-v_real // 128)
        for part, g, r in (("logits", got[0][:, :v_real],
                            ref[0][:, :v_real]),
                           ("rowmax", got[1][:, :real_groups],
                            ref[1][:, :real_groups])):
            scale = max(1.0, float(r.abs().max()))
            record("fused_logits_rowmax_lse", max_err(g, r) / scale, 1e-4,
                   (n, d, vp_, part))
        if not float(got[0][:, v_real:].max()) < -1e8:
            raise AssertionError("fused_logits_rowmax_lse: pad columns "
                                 "are not far below the real logits")
        timing = ((time_ms(lambda: beam_select.fused_logits_rowmax_lse(
            x, w, b)), time_ms(lambda: beam_select.fused_logits_reference(
                x, w, b))) if timed else ())
        # its product runs on the tensor cores as three TF32 products
        # (3xTF32): the bound takes those at the TF32 peak; the float32
        # bound beside it. No one PyTorch call computes the logits with
        # both reductions: cuBLAS's product alone (addmm) is kept as a
        # reference for the product, not as a library yardstick
        k3_bytes = 4 * (n * d + d * vp_ + vp_ + n * vp_ + n * vp_ // 128 + n)
        extra = ({"bound_peak": "3xTF32 on the tensor cores, 495 TFLOP/s "
                  "dense", "bound_f32_ms": bound(
                      2 * n * d * vp_ + 3 * n * vp_, k3_bytes)[0],
                  "cublas_addmm_ms": time_ms(lambda: torch.addmm(b, x, w))}
                 if timed else {})
        record("fused_logits_rowmax_lse", max_err(got[2], ref[2]), 1e-4,
               (n, d, vp_, "lse"), *timing,
               work=(3 * 2 * n * d * vp_ + 3 * n * vp_, k3_bytes),
               peak=TF32_PEAK, **extra)

    # K4: both selection stages, a long row (several warps a row) at k 64
    # and a ragged shape (4-byte loads); rounded inputs force ties, which
    # must go to the lowest index exactly as in the plain version. Timed
    # at the group stage, with the candidate stage's time beside it
    candidates = torch.round(randn(BATCH, BEAM * 128, scale=3.0))
    for batch, n, k, timed in ((BATCH, BEAM * vp // 128, BEAM, True),
                               (BATCH, BEAM * 128, BEAM, False),
                               (BATCH, 30720, 64, False),
                               (5, 300, 7, False)):
        x = torch.round(randn(batch, n, scale=3.0))
        got = beam_select.small_topk(x, k)
        ref = beam_select.topk_reference(x, k)
        if not torch.equal(got[1], ref[1]) or not torch.equal(got[0],
                                                              ref[0]):
            raise AssertionError(f"small_topk {(batch, n, k)}: values or "
                                 "indices differ from the plain version")
        timing = ((time_ms(lambda: beam_select.small_topk(x, k)),
                   time_ms(lambda: beam_select.topk_reference(x, k)))
                  if timed else ())
        extra = ({"plan": beam_select.topk_plan(batch, n, k)._asdict(),
                  "candidate_stage_ms": time_ms(
                      lambda: beam_select.small_topk(candidates, BEAM)),
                  "candidate_stage_shape": list(candidates.shape)}
                 if timed else {})
        record("small_topk", 0.0, 0.0, (batch, n, k), *timing,
               work=(batch * n * k, 4 * batch * n + 8 * batch * k),
               library_ms=(time_ms(lambda: torch.topk(x, k, dim=1))
                           if timed else None), **extra)

    check_train_kernels(device, randn, lengths_mask, record)
    long, by_shape, lineage_extra = check_transformer_kernels(
        device, randn, lengths_mask, record)
    results["lineage_attention"].update(lineage_extra)
    results["flash_attention_fwd"].update(
        {f"long_source_{key}": value for key, value in long.items()})
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        results[name]["backward_by_shape"] = by_shape
    check_lstm_kernels(device, randn, lengths_mask, record)
    lineage_b1 = check_bf16_kernels(device, randn, record)
    results["lineage_attention_bf16"].update(lineage_b1)
    torch.cuda.synchronize()
    return results


def bahdanau_beam_rows(cuda_attention, randn, record) -> dict:
    """K2 at the physical beam search's rows (``NM_LINEAGE=0``, phase
    31): B·K = 640 rows of T 32, A 512, D 1024, weights to 1e-5 and the
    context to 1e-4 against the plain version, timed back to back and
    with the L2 cache flushed, beside its plain version and its bound
    (130 MB of keys and states: more than the L2 either way)."""
    from neuralmonkey_tpu_torch.ops import kernel_config

    rows, dim = BATCH * BEAM, 2 * RNN
    keys, states = randn(rows, SRC_LEN, ATT), randn(rows, SRC_LEN, dim)
    mask = keys.new_ones(rows, SRC_LEN)
    pq, v = randn(rows, ATT), randn(ATT, scale=ATT ** -0.5)
    got = cuda_attention.fused_bahdanau_step(keys, states, mask, pq, v)
    ref = cuda_attention.bahdanau_reference(keys, states, mask, pq, v)
    errs = (max_err(got[1], ref[1]), max_err(got[0], ref[0]))
    record("fused_bahdanau_step", errs[0], 1e-5, (rows, SRC_LEN, "weights"))
    record("fused_bahdanau_step", errs[1], 1e-4, (rows, SRC_LEN, "context"))

    def step():
        return cuda_attention.fused_bahdanau_step(keys, states, mask, pq, v)
    bound_ms, bound_by = bound(
        rows * SRC_LEN * (4 * ATT + 2 * dim),
        4 * (rows * SRC_LEN * (ATT + dim + 2) + rows * ATT + ATT
             + rows * dim))
    out = {"shape": [rows, SRC_LEN, ATT, dim], "max_abs_err": max(errs),
           "ms": time_ms(step), "l2_flushed_ms": flushed_ms(step),
           "plain_ms": time_ms(lambda: cuda_attention.bahdanau_reference(
               keys, states, mask, pq, v)),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "plan": cuda_attention.bahdanau_plan(
               rows, SRC_LEN, ATT, dim, *kernel_config.device_limits(
                   keys.device.index or 0))._asdict()}
    log(f"fused_bahdanau_step beam rows: {out}")
    return out


def lineage_bf16_apart(got, ref, vmax: float):
    """(rows apart, rows allowed) of the bf16 lineage instance's context
    ``got`` against its plain version ``ref``, both (B, H, K, Dh): a
    (b, h, slot) row is apart when any entry differs by more than 2^-16
    ``vmax``; at most 1% of the rows, and at least 2, may be (one bf16
    rounding tie of a large weight moves a whole row)."""
    apart = ((got - ref).abs() > 2.0 ** -16 * vmax).any(dim=-1)
    return int(apart.sum()), max(2, apart.numel() // 100)


def lineage_bf16_mutants(q, k_cache, v_cache, bias):
    """The plain bf16 lineage version with one rounding point left out,
    each a fault that ``lineage_bf16_apart`` must reject: the normalised
    weights kept float32 before the context product, the unnormalised
    weights rounded (the online softmax's form), and q scaled in float32
    after its rounding."""
    import math

    import torch

    from neuralmonkey_tpu_torch.ops.nn import scalar
    bf16 = torch.bfloat16
    lanes = bias.shape[-1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    k = k_cache[..., :lanes].float()
    v = v_cache[:, :, :lanes].float()

    def weights(q_scaled):
        s = torch.matmul(q_scaled, k) + bias[:, None]
        return torch.exp(s - s.amax(dim=-1, keepdim=True))

    p = weights((q.to(bf16) * scalar(scale, bf16)).float())
    total = p.sum(dim=-1, keepdim=True)
    wide_q = weights(q.to(bf16).float() * scale)
    return {
        "float32 weights": torch.matmul(p / total, v),
        "unnormalised weights rounded":
            torch.matmul(p.to(bf16).float(), v) / total,
        "q scaled in float32": torch.matmul(
            (wide_q / wide_q.sum(dim=-1, keepdim=True)).to(bf16).float(),
            v)}


def check_bf16_kernels(device, randn, record):
    """The bf16 compute policy's kernel instances against their plain
    versions on the card: the lineage attention on bf16 caches at the
    Transformer's beam step (B 64, H 8, beam 10, 48 steps, head dim 64;
    windows 12 and 48), at B 1 (the lane split: a cluster of 8) and at
    head dims 32, 512 and 640, each launching the instance its shape gate
    names (the one-pass kernel, or the scratch design past it: head
    dims 512 and 640), timed at the full window with its plain version,
    SDPA over the same bf16 operands (the lineage bias as its mask) and
    the scratch design on the same operands (``pr15_design_ms``; also at
    B 1);
    the three fused cross-entropy kernels reading a bf16 W at the
    Transformer's loss tail (the tied (V, D) table, label smoothing 0.1,
    3072 x 512 x 30000), where all three run on warpgroup products, timed
    beside the widened designs on the same operands, at D 510, which W's
    rows send to the widened designs (timed), and at ragged shapes. The lineage
    tolerance (``lineage_bf16_apart``): a normalised weight on a bf16
    rounding tie may round either way (the sums' order differs from
    cuBLAS's), moving the entries of its row by one bf16 ulp of that
    weight times the value, at most 2^-8 max |v|; such ties are rare, so
    at most 1% of the (b, h, slot) rows (and at least 2) may hold an
    entry more than 2^-16 max |v| off. Every shape also checks that the
    rule rejects the plain version with a rounding point left out
    (``lineage_bf16_mutants``). Returns the lineage attention's times at
    B 1, the one-pass kernel's and the scratch design's."""
    import torch
    import torch.nn.functional as F

    from neuralmonkey_tpu_torch.ops import fused_xent, kernel_config
    from neuralmonkey_tpu_torch.ops import lineage_attention as la

    gen = torch.Generator().manual_seed(SEED + 7)
    bf16 = torch.bfloat16
    limits = kernel_config.device_limits(0)
    b1 = {}  # the one-pass kernel and the scratch design at B 1
    for b, h, beam, t, d, windows in (
            (BATCH, T_HEADS, BEAM, TGT_LEN, T_HEAD_DIM, (12, TGT_LEN)),
            (1, T_HEADS, BEAM, TGT_LEN, T_HEAD_DIM, (TGT_LEN,)),
            (4, 2, BEAM, TGT_LEN, 32, (TGT_LEN,)),
            (4, 2, BEAM, TGT_LEN, 512, (TGT_LEN,)),
            (2, 2, BEAM, 12, 640, (12,))):
        q = randn(b, h, beam, d)
        kq = randn(b, h, d, beam * t).to(bf16)
        vq = randn(b, h, beam * t, d).to(bf16)
        for win in windows:
            anc = torch.randint(0, beam, (b, beam, t), generator=gen,
                                dtype=torch.int32).to(device)
            lanes = la.lane_window(win, beam, beam * t)
            bias = la.lineage_bias(anc, win - 1, win, beam, lanes, t)
            plan = la.lineage_bf16_pass_plan(b, h, beam, d, beam * t, lanes,
                                             *limits)
            name = ("lineage_attention_bf16" if plan is not None
                    else LINEAGE_SCRATCH)
            kernel_config.reset_launch_counts()
            got = la.lineage_attention(q, kq, vq, bias)
            counts = kernel_config.launch_counts()
            if counts[name] != 1 or sum(counts.values()) != 1:
                raise AssertionError(
                    f"lineage bf16 {(b, h, beam, t, d, win)}: launched "
                    f"{ {k: n for k, n in counts.items() if n} }, not {name}")
            ref = la.lineage_attention_reference(q, kq, vq, bias)
            vmax = float(vq[:, :, :lanes].float().abs().max())
            tol = 2.0 ** -8 * vmax
            rows_apart, allowed = lineage_bf16_apart(got, ref, vmax)
            if rows_apart > allowed:
                raise AssertionError(
                    f"{name} {(b, h, beam, t, d, win)}: "
                    f"{rows_apart} rows more than 2^-16 max|v| apart, "
                    f"allowed {allowed}")
            mutants = {}
            for mutant, out in lineage_bf16_mutants(q, kq, vq,
                                                    bias).items():
                if torch.equal(out, ref):
                    continue  # 1/sqrt(d) a power of two: q's scaling exact
                mutants[mutant] = lineage_bf16_apart(out, ref, vmax)[0]
                if mutants[mutant] <= allowed:
                    raise AssertionError(
                        f"{name}: the rule accepts the "
                        f"plain version with {mutant} ({mutants[mutant]} "
                        f"rows apart, allowed {allowed})")
            log(f"{name} {(b, h, beam, t, d, win)}: "
                f"{rows_apart} of {b * h * beam} rows apart (allowed "
                f"{allowed}); mutants' rows apart {mutants}")

            def call():
                return la.lineage_attention(q, kq, vq, bias)

            def scratch():
                return la.launch_bf16(LINEAGE_SCRATCH, q, kq, vq, bias)
            # the bf16 caches' bytes (2 a value), q, the bias and the
            # float32 context; both products at the bf16 tensor-core peak
            work = (4 * b * h * beam * lanes * d,
                    2 * 2 * b * h * lanes * d + 4 * (
                        2 * b * h * beam * d + b * beam * lanes))
            timing = {}
            if b == 1:
                b1 = {"b1_ms": time_ms(call), "b1_pr15_design_ms":
                      time_ms(scratch), "b1_plan": plan and plan._asdict()}
            if (b, d, win) == (BATCH, T_HEAD_DIM, TGT_LEN):
                qb = q.to(bf16)
                library = (lambda: F.scaled_dot_product_attention(
                    qb, kq[..., :lanes].transpose(-1, -2), vq[:, :, :lanes],
                    attn_mask=bias[:, None].to(bf16)))

                def plain():
                    return la.lineage_attention_reference(q, kq, vq, bias)
                timing = timings(call, plain, library)
                old = scratch()
                old_apart = lineage_bf16_apart(old, ref, vmax)[0]
                if old_apart > allowed:
                    raise AssertionError(f"{LINEAGE_SCRATCH}: {old_apart} "
                                         f"rows apart, allowed {allowed}")
                scratch_timing = timings(scratch, plain, library)
                timing.update(l2_flushed_ms=flushed_ms(call),
                              mean_abs_err=float((got - ref).abs().mean()),
                              tolerance=tol, rows_apart=rows_apart,
                              rows_allowed=allowed,
                              mutants_rows_apart=mutants,
                              pr15_design_ms=scratch_timing["ms"],
                              pr15_bound_ms=bound(*work, BF16_PEAK)[0],
                              plan=plan._asdict())
                # the scratch design on the same operands: its own row
                record(LINEAGE_SCRATCH, max_err(old, ref), tol,
                       (b, h, beam, t, d, f"window {win}"), work=work,
                       peak=BF16_PEAK, rows_apart=old_apart,
                       l2_flushed_ms=flushed_ms(scratch),
                       plan=la.lineage_bf16_plan(
                           b, h, beam, d, lanes, limits[0])._asdict(),
                       **scratch_timing)
            record(name, max_err(got, ref), tol,
                   (b, h, beam, t, d, f"window {win}"), work=work,
                   peak=BF16_PEAK, **timing)

    # the bf16-W cross-entropy: the timed shape (the tied table, as phase 24
    # trains), where all three kernels run on warpgroup products, each timed
    # beside the widened design on the same operands; D 510, which W's rows
    # send to the widened instances (timed); and untimed ragged shapes of both
    for n, d, v, transposed, eps, timed in (
            (XENT_N, XENT_D, VOCAB, True, 0.1, True),
            (XENT_N, XENT_D - 2, VOCAB, True, 0.1, True),
            (333, 130, 1000, False, 0.0, False),
            (333, 130, 1000, True, 0.0, False),
            (333, 128, 1001, False, 0.1, False)):
        x = randn(n, d, scale=0.5)
        w = randn(*((v, d) if transposed else (d, v)),
                  scale=d ** -0.5).to(bf16)
        wide = w.float()
        b = randn(v, scale=0.1)
        targets = torch.randint(0, v, (n,), generator=gen,
                                dtype=torch.int32).to(device)
        g = torch.rand(n, generator=gen).to(device)
        case = (n, d, v, "tied" if transposed else "plain", eps, "bf16 W")
        wgmma = fused_xent.wgmma_takes(d, v, transposed)
        # W's bytes are bf16 (2 a value)
        read = 4 * (n * d + v + n) + 2 * d * v
        fwd_args = (x, w, b, targets, eps, transposed)
        nll, lse = fused_xent.xent_fwd(*fwd_args)
        ref_nll, _ = fused_xent.fwd_reference(x, wide, b, targets, eps,
                                              transposed)
        fwd_err = max_err(nll, ref_nll) / max(1.0,
                                              float(ref_nll.abs().max()))
        timing = (kernel_times(lambda: fused_xent.xent_fwd(*fwd_args),
                               lambda: fused_xent.fwd_reference(
                                   x, wide, b, targets, eps, transposed))
                  if timed else {})
        fwd_tf32 = (2 * 2 * n * d * v, read + 8 * n)
        if wgmma:
            # x·W in three bf16 passes on wgmma, at the bf16 peak
            fwd_work, fwd_peak, extra = (
                (2 * 3 * n * d * v, read + 8 * n), BF16_PEAK, {})
            if timed:
                again = fused_xent.xent_fwd(*fwd_args)
                equal = all(torch.equal(a, c) for a, c in zip((nll, lse),
                                                               again))
                if not equal:
                    raise AssertionError("bf16-W forward: a second call "
                                         "differs from the first")
                extra = {
                    "bound_peak": "3 bf16 passes for x·W on wgmma, 989 "
                    "TFLOP/s dense",
                    "pr15_bound_ms": bound(*fwd_tf32, TF32_PEAK)[0],
                    "pr15_design_ms": time_ms(
                        lambda: fused_xent.launch_fwd(WIDENED_KERNELS[0],
                                                      *fwd_args)),
                    "rerun_bitwise_equal": equal,
                    **{f"plan_{k}": val for k, val in fused_xent.
                       wgmma_fwd_plan(n, d, v, *limits)._asdict().items()
                       if k != "walks"}}
        else:
            # the widened design: every product with W takes two TF32 passes
            # (a bf16 value has no low TF32 part)
            fwd_work, fwd_peak = fwd_tf32, TF32_PEAK
            extra = {"bound_peak": "2 TF32 passes on the tensor cores, 495 "
                     "TFLOP/s dense"} if timed else {}
        record("fused_xent_fwd_bf16w" if wgmma else WIDENED_KERNELS[0],
               fwd_err, 1e-5, case, work=fwd_work, peak=fwd_peak, **timing,
               **extra)
        bwd_args = (x, w, b, targets, lse, g, eps, transposed)
        plain_args = (x, wide, b, targets, lse, g, eps, transposed)
        dx_bytes = read + 8 * n + 4 * n * d
        dw_bytes = read + 8 * n + 4 * (d * v + v)
        dx = fused_xent.xent_bwd_dx(*bwd_args)
        ref_dx = fused_xent.bwd_dx_reference(*plain_args)
        dx_err = max_err(dx, ref_dx) / max(1e-6, float(ref_dx.abs().max()))
        dw, db = fused_xent.xent_bwd_dw(*bwd_args)
        ref_dw, ref_db = fused_xent.bwd_dw_reference(*plain_args)
        dw_err = max(
            max_err(dw, ref_dw) / max(1e-6, float(ref_dw.abs().max())),
            max_err(db, ref_db) / max(1e-6, float(ref_db.abs().max())))
        if not wgmma:
            # PR 15's design: two TF32 passes for a product with W, three
            # for x^T dl
            names = WIDENED_KERNELS[1:]
            dx_work, dw_work, peak = (2 * 4 * n * d * v, dx_bytes), (
                2 * 5 * n * d * v, dw_bytes), TF32_PEAK
            dx_extra = dw_extra = {}
            if timed:
                dx_extra = {"bound_peak": "2 TF32 passes for x·W and dl·Wᵀ, "
                            "495 TFLOP/s dense"}
                dw_extra = {"bound_peak": "2 TF32 passes for x·W, 3 for "
                            "xᵀ·dl, 495 TFLOP/s dense"}
        else:
            # three bf16 passes for x·W and for dl·Wᵀ; six for xᵀ·dl (both
            # operands split), all on wgmma at the bf16 peak
            names = ("fused_xent_bwd_dx_bf16w", "fused_xent_bwd_dw_bf16w")
            dx_work, dw_work, peak = (2 * 6 * n * d * v, dx_bytes), (
                2 * 9 * n * d * v, dw_bytes), BF16_PEAK
            dx_extra = dw_extra = {}
            if timed:
                again = (fused_xent.xent_bwd_dx(*bwd_args),
                         *fused_xent.xent_bwd_dw(*bwd_args))
                equal = all(torch.equal(a, c)
                            for a, c in zip((dx, dw, db), again))
                if not equal:
                    raise AssertionError("bf16-W backward: a second call "
                                         "differs from the first")
                plans = {k: plan(n, d, v, *limits)._asdict() for k, plan in (
                    ("dx", fused_xent.wgmma_dx_plan),
                    ("dw", fused_xent.wgmma_dw_plan))}
                dx_extra = {
                    "bound_peak": "3 bf16 passes for x·W and for dl·Wᵀ on "
                    "wgmma, 989 TFLOP/s dense",
                    "pr15_bound_ms": bound(2 * 4 * n * d * v, dx_bytes,
                                           TF32_PEAK)[0],
                    "pr15_design_ms": time_ms(
                        lambda: fused_xent.launch_bwd_dx(
                            WIDENED_KERNELS[1], *bwd_args)),
                    "rerun_bitwise_equal": equal,
                    **{f"plan_{k}": val for k, val in plans["dx"].items()
                       if k != "walks"}}
                dw_extra = {
                    "bound_peak": "3 bf16 passes for x·W, 6 for xᵀ·dl (the "
                    "time of 3 TF32 passes) on wgmma, 989 TFLOP/s dense",
                    "pr15_bound_ms": bound(2 * 5 * n * d * v, dw_bytes,
                                           TF32_PEAK)[0],
                    "pr15_design_ms": time_ms(
                        lambda: fused_xent.launch_bwd_dw(
                            WIDENED_KERNELS[2], *bwd_args)),
                    "rerun_bitwise_equal": equal,
                    **{f"plan_{k}": val for k, val in plans["dw"].items()
                       if k != "walks"}}
        timing = (kernel_times(lambda: fused_xent.xent_bwd_dx(*bwd_args),
                               lambda: fused_xent.bwd_dx_reference(
                                   *plain_args)) if timed else {})
        record(names[0], dx_err, 1e-4, case, work=dx_work, peak=peak,
               **timing, **dx_extra)
        # dW is written float32 (the autograd Function rounds it to bf16)
        timing = (kernel_times(lambda: fused_xent.xent_bwd_dw(*bwd_args),
                               lambda: fused_xent.bwd_dw_reference(
                                   *plain_args)) if timed else {})
        record(names[1], dw_err, 1e-4, case, work=dw_work, peak=peak,
               **timing, **dw_extra)
    return b1


def check_train_kernels(device, randn, lengths_mask, record):
    """The training path's kernels against their plain versions."""
    import torch

    from neuralmonkey_tpu_torch.ops import cuda_rnn, fused_xent, nn

    # BPTT: the encoder's BiGRU at bench widths, and a ragged odd shape;
    # the gradients grow through the reverse steps, so the error is
    # held against the largest of them
    for batch, time_, hidden, lengths, timed in (
            (BATCH, SRC_LEN, RNN, [SRC_LEN] * BATCH, True),
            (5, 7, 37, [7, 5, 3, 1, 0], False)):
        x = randn(batch, time_, 6 * hidden, scale=0.5)
        mask = lengths_mask(lengths, time_)
        hprev = randn(batch, time_, 2 * hidden, scale=0.5)
        gout = randn(batch, time_, 2 * hidden)
        gfinal = randn(batch, 2 * hidden)
        wgh = randn(2, hidden, 2 * hidden, scale=hidden ** -0.5)
        wch = randn(2, hidden, hidden, scale=hidden ** -0.5)
        args = (x, mask, hprev, gout, gfinal, wgh, wch)
        got = cuda_rnn.gru_bptt(*args, 2)
        ref = cuda_rnn.gru_bptt_reference(*args, [False, True])
        scale = max(1.0, float(ref.abs().max()))
        timing = {}
        if timed:
            # no one PyTorch call computes it: cuDNN's GRU (nn.GRU) applies
            # r after the recurrent product, the TF1 GRU before it. Like for
            # like: the whole GRU backward, the port's against the plain
            # scan's
            timing = dict(
                ms=time_ms(lambda: cuda_rnn.gru_bptt(*args, 2)),
                plain_ms=time_ms(lambda: cuda_rnn.gru_bptt_reference(
                    *args, [False, True])),
                call=lambda: cuda_rnn.gru_bptt(*args, 2),
                **gru_backward_times(cuda_rnn, nn, device, batch, time_, EMB,
                                     hidden))
        work = (2 * batch * time_ * (12 * hidden * hidden + 20 * hidden),
                4 * (2 * batch * time_ * 6 * hidden + batch * time_
                     + 2 * batch * time_ * 2 * hidden + batch * 2 * hidden
                     + 2 * 3 * hidden * hidden))
        record("gru_bptt", max_err(got, ref) / scale, 1e-4,
               (batch, time_, hidden), work=work, **timing)

    # fused cross-entropy: the decoder's loss tail at bench widths (one
    # batch of 64 x 48 target tokens), both layouts and both label
    # smoothings, and a ragged shape; timed in the layout and smoothing
    # the training phase uses, (D, V) and eps 0
    gen = torch.Generator().manual_seed(SEED + 1)
    for n, d, v in ((XENT_N, XENT_D, VOCAB), (333, 130, 1000)):
        for transposed in (False, True):
            for eps in (0.0, 0.1):
                timed = (n, transposed, eps) == (XENT_N, False, 0.0)
                x = randn(n, d, scale=0.5)
                w = randn(*((v, d) if transposed else (d, v)),
                          scale=d ** -0.5)
                b = randn(v, scale=0.1)
                targets = torch.randint(0, v, (n,), generator=gen,
                                        dtype=torch.int32).to(device)
                g = torch.rand(n, generator=gen).to(device)
                case = (n, d, v, "tied" if transposed else "plain", eps)
                nll, lse = fused_xent.xent_fwd(x, w, b, targets, eps,
                                               transposed)
                ref_nll, _ = fused_xent.fwd_reference(x, w, b, targets, eps,
                                                      transposed)
                fwd_args = (x, w, b, targets, eps, transposed)
                timing = ((time_ms(lambda: fused_xent.xent_fwd(*fwd_args)),
                           time_ms(lambda: fused_xent.fwd_reference(
                               *fwd_args))) if timed else ())
                read = 4 * (n * d + d * v + v + n)
                # its product runs on the tensor cores in 3xTF32, as dx's:
                # the bound takes the three TF32 products at the TF32 peak;
                # the float32 bound beside it
                record("fused_xent_fwd", max_err(nll, ref_nll) / max(
                    1.0, float(ref_nll.abs().max())), 1e-5, case, *timing,
                    work=(3 * 2 * n * d * v, read + 8 * n), peak=TF32_PEAK,
                    **({"bound_peak": "3xTF32 on the tensor cores, 495 "
                        "TFLOP/s dense", "bound_f32_ms": bound(
                            2 * n * d * v + 5 * n * v, read + 8 * n)[0]}
                       if timed else {}))
                bwd_args = (x, w, b, targets, lse, g, eps, transposed)
                dx = fused_xent.xent_bwd_dx(*bwd_args)
                ref_dx = fused_xent.bwd_dx_reference(*bwd_args)
                timing = ((time_ms(lambda: fused_xent.xent_bwd_dx(
                    *bwd_args)), time_ms(lambda: fused_xent.bwd_dx_reference(
                        *bwd_args))) if timed else ())
                # its products run on the tensor cores as three TF32
                # products each (3xTF32): the bound takes those at the
                # TF32 peak; the float32 bound beside it
                dx_bytes = read + 8 * n + 4 * n * d
                record("fused_xent_bwd_dx", max_err(dx, ref_dx) / max(
                    1e-6, float(ref_dx.abs().max())), 1e-4, case, *timing,
                    work=(3 * 4 * n * d * v, dx_bytes), peak=TF32_PEAK,
                    **({"bound_peak": "3xTF32 on the tensor cores, 495 "
                        "TFLOP/s dense", "bound_f32_ms": bound(
                            4 * n * d * v + 6 * n * v, dx_bytes)[0]}
                       if timed else {}))
                dw, db = fused_xent.xent_bwd_dw(*bwd_args)
                ref_dw, ref_db = fused_xent.bwd_dw_reference(*bwd_args)
                timing = ((time_ms(lambda: fused_xent.xent_bwd_dw(
                    *bwd_args)), time_ms(lambda: fused_xent.bwd_dw_reference(
                        *bwd_args))) if timed else ())
                err = max(max_err(dw, ref_dw) / max(
                    1e-6, float(ref_dw.abs().max())),
                    max_err(db, ref_db) / max(
                        1e-6, float(ref_db.abs().max())))
                # 3xTF32 on the tensor cores, as dx: the bound takes its
                # three TF32 products at the TF32 peak; the f32 bound beside
                dw_bytes = read + 8 * n + 4 * (d * v + v)
                record("fused_xent_bwd_dw", err, 1e-4, case, *timing,
                       work=(3 * 4 * n * d * v, dw_bytes), peak=TF32_PEAK,
                       **({"bound_peak": "3xTF32 on the tensor cores, 495 "
                           "TFLOP/s dense", "bound_f32_ms": bound(
                               4 * n * d * v + 6 * n * v, dw_bytes)[0]}
                          if timed else {}))


def check_transformer_kernels(device, randn, lengths_mask, record):
    """Flash attention (forward, dq, dkv) and lineage attention against
    their plain versions at the Transformer's shapes."""
    import torch
    import torch.nn.functional as F

    from neuralmonkey_tpu_torch.ops import flash_attention as fa
    from neuralmonkey_tpu_torch.ops import kernel_config
    from neuralmonkey_tpu_torch.ops import lineage_attention as la

    gen = torch.Generator().manual_seed(SEED + 3)
    key_words = (SEED, -7 * SEED)

    def source_lengths(batch, time_):
        return torch.randint(1, time_ + 1, (batch,), generator=gen).tolist()

    # (case, batch, heads, q len, kv len, head dim, causal, key lengths):
    # the encoder's and the cross-attention's keys are ragged sources;
    # the decoder's self-attention sees every key under the causal mask;
    # the ragged case spans two key tiles with an odd head dimension
    cases = (
        ("encoder", BATCH, T_HEADS, SRC_LEN, SRC_LEN, T_HEAD_DIM, False,
         source_lengths(BATCH, SRC_LEN)),
        ("decoder self", BATCH, T_HEADS, TGT_LEN, TGT_LEN, T_HEAD_DIM, True,
         [TGT_LEN] * BATCH),
        ("cross", BATCH, T_HEADS, TGT_LEN, SRC_LEN, T_HEAD_DIM, False,
         source_lengths(BATCH, SRC_LEN)),
        ("ragged", 3, 5, 37, 70, 40, False, [70, 33, 1]),
    )
    by_shape = {}  # the backward's times at each main-path shape
    for case, b, h, tq, tk, d, causal, lengths in cases:
        mask = lengths_mask(lengths, tk)
        q, k, v, g = (randn(b, h, t, d) for t in (tq, tk, tk, tq))
        for keep in (1.0, T_ATT_KEEP):
            drop = (key_words if keep < 1.0 else None, keep)
            shape = (case, b, h, tq, tk, d, f"keep {keep}")
            timed = case == "encoder" and keep == 1.0
            out, lse = fa.flash_forward(q, k, v, mask, causal, *drop)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            ref_out, ref_lse = fa.flash_forward_reference(*leaves, mask,
                                                          causal, *drop)
            ref_grads = torch.autograd.grad(ref_out, leaves, g)
            dcap = (g * out).sum(dim=-1)
            bwd = (q, k, v, mask, lse, g, dcap, causal, *drop)
            dq = fa.flash_backward_dq(*bwd)
            dk, dv = fa.flash_backward_dkv(*bwd)
            # work of one call; the causal mask halves what is needed.
            # The forward reads q, k, v and the mask and writes out and
            # lse; the backward reads those but out, and dO and dcap
            pairs = b * h * tq * tk * (0.5 if causal else 1.0)
            qo, kv = 4 * b * h * tq * d, 4 * b * h * tk * d
            fwd_work = (4 * pairs * d, 2 * qo + 2 * kv + 4 * b * tk
                        + 4 * b * h * tq)
            bwd_read = 2 * qo + 2 * kv + 4 * b * tk + 8 * b * h * tq
            timing = {"fwd": {}, "dq": {}, "dkv": {}}
            if keep == 1.0 and case != "ragged":
                by_shape[case] = flash_backward_times(fa, q, k, v, g, mask,
                                                      causal)
            if timed:
                bias = torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
                lib_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                lib_out = F.scaled_dot_product_attention(*lib_leaves,
                                                         attn_mask=bias)
                # the plain and the library backward each compute dq, dk
                # and dv together: both backward rows show that one call
                timing = {
                    "fwd": timings(
                        lambda: fa.flash_forward(q, k, v, mask, causal, *drop),
                        lambda: fa.flash_forward_reference(q, k, v, mask,
                                                           causal, *drop),
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, attn_mask=bias)),
                    "dq": timings(
                        lambda: fa.flash_backward_dq(*bwd),
                        lambda: fa.flash_backward_reference(
                            q, k, v, mask, out, lse, g, causal, *drop),
                        lambda: torch.autograd.grad(
                            lib_out, lib_leaves, g, retain_graph=True))}
                timing["dkv"] = dict(
                    timing["dq"], ms=time_ms(lambda: fa.flash_backward_dkv(
                        *bwd)), call=lambda: fa.flash_backward_dkv(*bwd))
            err = max(max_err(out, ref_out.detach()),
                      max_err(lse, ref_lse.detach()))
            record("flash_attention_fwd", err, 1e-5, shape, work=fwd_work,
                   **timing["fwd"])

            def grad_err(got, want):
                return max(max_err(a, w) / max(1e-6, float(w.abs().max()))
                           for a, w in zip(got, want))
            record("flash_attention_bwd_dq", grad_err([dq], ref_grads[:1]),
                   1e-4, shape, work=(6 * pairs * d, bwd_read + qo),
                   **timing["dq"])
            record("flash_attention_bwd_dkv",
                   grad_err([dk, dv], ref_grads[1:]), 1e-4, shape,
                   work=(8 * pairs * d, bwd_read + 2 * kv), **timing["dkv"])
            if keep < 1.0 and tk <= d:
                check_dropout_mask(q, k, mask, causal, key_words, keep,
                                   shape)

    # a long source (ROADMAP's transformer_src512 shape): the forward
    # checked and timed with SDPA beside it, kept as extra fields of the
    # forward's entry
    b, h, t, d = 8, T_HEADS, 512, T_HEAD_DIM
    mask = lengths_mask(source_lengths(b, t), t)
    q, k, v = (randn(b, h, t, d) for _ in range(3))
    out, lse = fa.flash_forward(q, k, v, mask, False)
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, mask, False)
    record("flash_attention_fwd", max(max_err(out, ref_out),
                                      max_err(lse, ref_lse)), 1e-5,
           ("long source", b, h, t, t, d))
    bias = torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
    long = timings(
        lambda: fa.flash_forward(q, k, v, mask, False),
        lambda: fa.flash_forward_reference(q, k, v, mask, False),
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias))
    qkv = 4 * b * h * t * d
    long["bound_ms"], long["bound_by"] = bound(
        4 * b * h * t * t * d, 4 * qkv + 4 * b * t + 4 * b * h * t)
    long["call_ms"] = call_ms(long.pop("call"))
    long["shape"] = [b, h, t, t, d]
    log(f"flash_attention_fwd long source: {long}")
    # the backward there, checked and timed beside SDPA's
    g = randn(b, h, t, d)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref_out, _ = fa.flash_forward_reference(*leaves, mask, False)
    ref_grads = torch.autograd.grad(ref_out, leaves, g)
    grads = fa.flash_backward(q, k, v, mask, out, lse, g, False)
    for name, got, want in (("flash_attention_bwd_dq", grads[:1],
                             ref_grads[:1]),
                            ("flash_attention_bwd_dkv", grads[1:],
                             ref_grads[1:])):
        record(name, max(max_err(a, w) / max(1e-6, float(w.abs().max()))
                         for a, w in zip(got, want)), 1e-4,
               ("long source", b, h, t, t, d))
    by_shape["long source"] = flash_backward_times(fa, q, k, v, g, mask,
                                                   False)
    log(f"flash backward by shape: {by_shape}")

    # lineage attention: a beam step's self-attention over the K slots'
    # unpermuted caches at the full decode shape, windows 12, 24 and 48
    # positions; at B 1 (the lane split), at head dims 256 and 512, and at a
    # ragged shape (63 lanes: 4-byte copies); timed at the full window, with
    # L2 flushed there too, at the other windows, at B 1 and at head dim 512
    lineage_extra = {}
    for b, h, beam, t, d, windows in (
            (BATCH, T_HEADS, BEAM, TGT_LEN, T_HEAD_DIM, (12, 24, TGT_LEN)),
            (1, T_HEADS, BEAM, TGT_LEN, T_HEAD_DIM, (12, TGT_LEN)),
            (8, T_HEADS, BEAM, TGT_LEN, 256, (TGT_LEN,)),
            (8, T_HEADS, BEAM, TGT_LEN, 512, (TGT_LEN,)),
            (3, 2, 7, 9, 40, (5,))):
        q = randn(b, h, beam, d)
        kq = randn(b, h, d, beam * t)
        vq = randn(b, h, beam * t, d)
        for win in windows:
            anc = torch.randint(0, beam, (b, beam, t), generator=gen,
                                dtype=torch.int32).to(device)
            lanes = la.lane_window(win, beam, beam * t)
            bias = la.lineage_bias(anc, win - 1, win, beam, lanes, t)
            got = la.lineage_attention(q, kq, vq, bias)
            ref = la.lineage_attention_reference(q, kq, vq, bias)

            def call():
                return la.lineage_attention(q, kq, vq, bias)
            timing = {}
            if (b, d) == (BATCH, T_HEAD_DIM) and win == TGT_LEN:
                timing = timings(
                    call,
                    lambda: la.lineage_attention_reference(q, kq, vq, bias),
                    lambda: F.scaled_dot_product_attention(
                        q, kq[..., :lanes].transpose(-1, -2),
                        vq[:, :, :lanes], attn_mask=bias[:, None]))
                lineage_extra.update(
                    l2_flushed_ms=flushed_ms(call),
                    plan=la.lineage_plan(b, h, beam, d, beam * t, lanes,
                                         *kernel_config.device_limits(0)
                                         )._asdict())
            elif d == T_HEAD_DIM and b in (1, BATCH):
                lineage_extra[f"B{b} window {win} ms"] = time_ms(call)
                if b == 1:
                    lineage_extra[f"B{b} window {win} plan"] = la.lineage_plan(
                        b, h, beam, d, beam * t, lanes,
                        *kernel_config.device_limits(0))._asdict()
            elif d == 512:
                lineage_extra["B8 head dim 512 ms"] = time_ms(call)
            work = (4 * b * h * beam * lanes * d,
                    4 * (2 * b * h * beam * d + 2 * b * h * lanes * d
                         + b * beam * lanes))
            record("lineage_attention", max_err(got, ref), 1e-5,
                   (b, h, beam, t, d, f"window {win}"), work=work, **timing)
    log(f"lineage attention: {lineage_extra}")
    return long, by_shape, lineage_extra


# ---------------------------------------------------------------------- #
# phase 3b: the shapes past the kernels' limits
# ---------------------------------------------------------------------- #
def check_past_limits(device):
    """Shapes past the kernels' first limits that the JAX package runs,
    through the port's entry points on the card, each against the same
    call on the CPU: a GRU encoder's training step at H 8192 (K1
    forward, the plain BPTT), an LSTM's at H 8448 (the plain scan whole),
    multi-head attention at head dims 192 and 256 forward and backward
    (the flash kernels) and 320 and 512 (their chunked instances), the
    lineage attention at head dims 640 and 1024 (its chunked instance),
    K4 at beam 64 over the selector's first stage (n 15360, k 64) and
    k 65 (the plain top-k), and the lineage layout's switch. The training
    steps are held to phase 7's rule (the loss to 1e-5 relative, each
    gradient to 1e-3 of its largest entry), the attention to 1e-4, the
    top-k bit for bit; the fused cross-entropy on a bf16 W whose rows are
    not 16-byte aligned (PR 15's instances) to 1e-5 (loss), 1e-4 (dx, db)
    and one bf16 ulp of dW's largest entry, the bf16 lineage attention
    past its one-pass gate (the scratch design) by the kernel phase's
    row rule. Returns the report (with the launches of the kept designs)
    and the chunked instances' records
    (:func:`chunked_kernel_records`), with their launches on this path."""
    import torch

    from neuralmonkey_tpu_torch.models.decoders import transformer
    from neuralmonkey_tpu_torch.ops import (attention, beam_select,
                                            fused_xent, kernel_config,
                                            lineage_attention, nn, rnn)

    gen = torch.Generator().manual_seed(SEED + 11)
    report = {}

    def training_rule(name, got, want):
        (loss, grads), (ref_loss, ref_grads) = got, want
        err = abs(float(loss) - float(ref_loss)) / max(1e-30,
                                                       abs(float(ref_loss)))
        worst = max(float((g - ref_grads[k]).abs().max())
                    / max(1e-30, float(ref_grads[k].abs().max()))
                    for k, g in grads.items())
        report[name] = {"loss_rel_err": err, "grad_rel_err": worst}
        if not (err <= 1e-5 and worst <= 1e-3):
            raise AssertionError(f"{name}: loss {err}, gradients {worst}")

    batch, time_, width = 2, 4, 16
    inputs = torch.randn(batch, time_, width, generator=gen)
    mask = torch.tensor([[1.0, 1, 1, 1], [1, 1, 0, 0]])
    for name, cell, kernels in (
            ("gru H 8192", nn.GRUCell(width, 8192), ("gru_scan",)),
            ("lstm H 8448", nn.LSTMCell(width, 8448), ())):
        hidden = cell.hidden_dim
        g_out = torch.randn(batch, time_, hidden, generator=gen)
        g_final = torch.randn(batch, hidden, generator=gen)
        init = cell.init(torch.Generator().manual_seed(SEED))

        def step(dev):
            params = {k: v.detach().to(dev).requires_grad_()
                      for k, v in init.items()}
            x = inputs.detach().to(dev).requires_grad_()
            out, final = rnn.unidirectional_rnn(cell, params, x, mask.to(dev))
            loss = ((out * g_out.to(dev)).sum()
                    + (final * g_final.to(dev)).sum())
            loss.backward()
            return loss.detach().cpu(), {
                **{k: p.grad.cpu() for k, p in params.items()},
                "inputs": x.grad.cpu()}
        kernel_config.reset_launch_counts()
        got = step(device)
        torch.cuda.synchronize()
        counts = kernel_config.launch_counts()
        launched = sorted(k for k, n in counts.items() if n)
        if launched != sorted(kernels):
            raise AssertionError(f"{name}: launched {launched}")
        training_rule(name, got, step(torch.device("cpu")))
        report[name]["launched"] = launched

    # multi-head attention at head dims 192 and 256 (the flash kernels)
    # and 320 and 512 (their chunked instances), forward and backward;
    # the launches of the chunked instances are this path's
    chunked_launches = dict.fromkeys(CHUNKED_KERNELS, 0)
    for model_dim in (384, 512, 640, 1024):
        params = attention.mha_init(gen, model_dim, model_dim, model_dim)
        x = torch.randn(4, 9, model_dim, generator=gen)
        key_mask = torch.ones(4, 9)
        key_mask[1, 5:] = 0

        def attend(dev):
            p = {k: {n: t.detach().to(dev).requires_grad_()
                     for n, t in v.items()} for k, v in params.items()}
            xs = x.detach().to(dev).requires_grad_()
            out = attention.multi_head_attention(
                p, xs, xs, xs, 2, key_mask=key_mask.to(dev), causal=True)
            out.square().sum().backward()
            return {"out": out.detach().cpu(), "x": xs.grad.cpu(),
                    **{f"{k}/{n}": t.grad.cpu() for k, v in p.items()
                       for n, t in v.items()}}
        kernel_config.reset_launch_counts()
        got = attend(device)
        torch.cuda.synchronize()
        counts = kernel_config.launch_counts()
        head_dim = model_dim // 2
        suffix = "_chunked" if head_dim > 256 else ""
        names = [f"flash_attention_{k}{suffix}"
                 for k in ("fwd", "bwd_dq", "bwd_dkv")]
        launched = [counts[k] for k in names]
        if launched != [1, 1, 1]:
            raise AssertionError(f"head dim {head_dim}: launches {launched}")
        for k in names:
            if suffix:
                chunked_launches[k] += counts[k]
        ref = attend(torch.device("cpu"))

        def scale(key):
            """The largest entry of the CPU's ``key`` (of 1 where that is
            smaller); past 256 the key bias, whose exact gradient is 0 (it
            shifts every score of a row alike), against its key weight's,
            as phase 12 holds it."""
            if suffix and key == "k/b":
                key = "k/w"
            return max(1.0, float(ref[key].abs().max()))
        err = max(max_err(g, ref[k]) / scale(k) for k, g in got.items())
        name = f"attention head dim {head_dim}"
        report[name] = {"max_rel_err": err, "flash_launches": launched,
                        "kernels": names}
        if not err <= 1e-4:
            raise AssertionError(f"{name}: error {err}")

    # the lineage kernel past 512: its chunked instance at head dims 640
    # and 1024 (two column blocks each), a beam-10 step over 48 positions,
    # B 2 (the lane split) and B 8, against the same call on the CPU
    for b, d in ((2, 640), (8, 1024)):
        q = torch.randn(b, 2, BEAM, d, generator=gen)
        kq = torch.randn(b, 2, d, BEAM * TGT_LEN, generator=gen)
        vq = torch.randn(b, 2, BEAM * TGT_LEN, d, generator=gen)
        anc = torch.randint(0, BEAM, (b, BEAM, TGT_LEN), generator=gen,
                            dtype=torch.int32)
        bias = lineage_attention.lineage_bias(anc, TGT_LEN - 1, TGT_LEN, BEAM,
                                              BEAM * TGT_LEN, TGT_LEN)
        kernel_config.reset_launch_counts()
        got = lineage_attention.lineage_attention(
            *(t.to(device) for t in (q, kq, vq, bias)))
        torch.cuda.synchronize()
        counts = kernel_config.launch_counts()
        if (counts["lineage_attention_chunked"],
                counts["lineage_attention"]) != (1, 0):
            raise AssertionError(f"lineage head dim {d}: launches {counts}")
        chunked_launches["lineage_attention_chunked"] += 1
        ref = lineage_attention.lineage_attention(q, kq, vq, bias)
        err = max_err(got.cpu(), ref) / max(1.0, float(ref.abs().max()))
        name = f"lineage head dim {d}"
        report[name] = {"max_rel_err": err, "plan": lineage_attention.
                        lineage_plan(b, 2, BEAM, d, BEAM * TGT_LEN,
                                     BEAM * TGT_LEN,
                                     *kernel_config.device_limits(0)
                                     )._asdict()}
        if not err <= 1e-4:
            raise AssertionError(f"{name}: error {err}")

    # the bf16 lineage instance past its one-pass gate: head dim 320 (past
    # the tiles' 256) and an odd lane count (beam 10 over 9 positions with
    # a cache of 9 positions: 90 lanes, not a TMA stride) take the scratch
    # design, against the CPU by the kernel phase's row rule;
    # their launches are this path's
    scratch_launches = 0
    for b, d, t in ((2, 320, TGT_LEN), (4, T_HEAD_DIM, 9)):
        q = torch.randn(b, 2, BEAM, d, generator=gen)
        kq = torch.randn(b, 2, d, BEAM * t, generator=gen).to(torch.bfloat16)
        vq = torch.randn(b, 2, BEAM * t, d, generator=gen).to(torch.bfloat16)
        anc = torch.randint(0, BEAM, (b, BEAM, t), generator=gen,
                            dtype=torch.int32)
        bias = lineage_attention.lineage_bias(anc, t - 1, t, BEAM, BEAM * t,
                                              t)
        kernel_config.reset_launch_counts()
        got = lineage_attention.lineage_attention(
            *(x.to(device) for x in (q, kq, vq, bias)))
        torch.cuda.synchronize()
        counts = kernel_config.launch_counts()
        launched = sorted(k for k, c in counts.items() if c)
        if launched != [LINEAGE_SCRATCH]:
            raise AssertionError(f"lineage bf16 head dim {d}, {BEAM * t} "
                                 f"lanes: launched {launched}")
        scratch_launches += counts[LINEAGE_SCRATCH]
        ref = lineage_attention.lineage_attention(q, kq, vq, bias)
        vmax = float(vq.float().abs().max())
        apart, allowed = lineage_bf16_apart(got.cpu(), ref, vmax)
        name = f"lineage bf16 head dim {d}, {BEAM * t} lanes"
        report[name] = {"rows_apart": apart, "rows_allowed": allowed,
                        "launched": launched}
        if apart > allowed:
            raise AssertionError(f"{name}: {apart} rows apart, allowed "
                                 f"{allowed}")
    report["scratch launches"] = scratch_launches

    # K4 at beam 64 (the first stage's 64 x 240 groups) and k 65
    for k in (64, 65):
        scores = torch.round(torch.randn(BATCH, 64 * 240, generator=gen)
                             * 3.0).to(device)
        kernel_config.reset_launch_counts()
        got = beam_select.small_topk(scores, k)
        torch.cuda.synchronize()
        ref = beam_select.topk_reference(scores.cpu(), k)
        if not (torch.equal(got[0].cpu(), ref[0])
                and torch.equal(got[1].cpu(), ref[1])):
            raise AssertionError(f"small_topk k {k}: differs from the CPU")
        report[f"small_topk k {k}"] = {
            "launches": kernel_config.launch_counts()["small_topk"]}

    # the fused cross-entropy on a bf16 W whose rows are not 16-byte
    # aligned (tied D 130, untied V 1001): the widened instances (forward
    # and backward), through the
    # autograd Function forward and backward, against the CPU (dW is
    # rounded to bf16 on both, so it may differ by one bf16 ulp of its
    # largest entry); their launches are this path's
    widened = dict.fromkeys(WIDENED_KERNELS, 0)
    for n, d, v, transposed in ((333, 130, 1000, True),
                                (333, 128, 1001, False)):
        x = torch.randn(n, d, generator=gen) * 0.5
        w = (torch.randn(*((v, d) if transposed else (d, v)), generator=gen)
             * d ** -0.5).to(torch.bfloat16)
        b = torch.randn(v, generator=gen) * 0.1
        targets = torch.randint(0, v, (n,), generator=gen)

        def xent(dev):
            xs, ws, bs = (t.detach().to(dev).requires_grad_()
                          for t in (x, w, b))
            loss = fused_xent.fused_softmax_xent(
                xs, ws, bs, targets.to(dev), 0.1, transposed).sum()
            loss.backward()
            return loss.detach().cpu(), {"x": xs.grad.cpu(),
                                         "b": bs.grad.cpu(),
                                         "w": ws.grad.float().cpu()}
        kernel_config.reset_launch_counts()
        (loss, grads) = xent(device)
        torch.cuda.synchronize()
        counts = kernel_config.launch_counts()
        launched = sorted(k for k, c in counts.items() if c)
        if launched != sorted(WIDENED_KERNELS):
            raise AssertionError(f"bf16 W {(d, v, transposed)}: launched "
                                 f"{launched}")
        for k in WIDENED_KERNELS:
            widened[k] += counts[k]
        ref_loss, ref_grads = xent(torch.device("cpu"))
        errs = {k: max_err(g, ref_grads[k]) / max(
            1e-30, float(ref_grads[k].abs().max())) for k, g in grads.items()}
        errs["loss"] = abs(float(loss) - float(ref_loss)) / abs(
            float(ref_loss))
        layout = "tied" if transposed else "plain"
        name = f"fused xent bf16 W {(n, d, v, layout)}"
        report[name] = {"rel_errs": errs, "launched": launched}
        if not (errs["loss"] <= 1e-5 and errs["x"] <= 1e-4
                and errs["b"] <= 1e-4 and errs["w"] <= 2.0 ** -8):
            raise AssertionError(f"{name}: {errs}")
    report["widened launches"] = widened

    # the lineage layout: the kernel takes every head dim, so the switch
    # alone decides
    os.environ["NM_LINEAGE_KERNEL"] = "1"
    try:
        layout = transformer.lineage_kernel_layout()
    finally:
        os.environ.pop("NM_LINEAGE_KERNEL")
    if not layout or transformer.lineage_kernel_layout():
        raise AssertionError("lineage kernel layout does not follow "
                             "NM_LINEAGE_KERNEL")
    report["lineage layout"] = "NM_LINEAGE_KERNEL=1 at every head dim"
    chunked = chunked_kernel_records(device, gen)
    for name, n in chunked_launches.items():
        if n == 0:
            raise AssertionError(f"{name} never launched by phase 3b")
        chunked[name]["launches"] = n
    log(f"past the kernels' limits: {report}")
    return report, chunked


def chunked_kernel_records(device, gen):
    """Each chunked instance against its plain version on the card, timed
    beside it, beside one PyTorch call of the same function (SDPA; for
    the lineage attention SDPA with the lineage bias as its mask) and
    beside its bound: flash at B 8, H 4, 128 x 128 with ragged keys and
    head dims 512 (the record) and 320 (``head_dim_320``), the lineage
    attention at B 8, H 2, beam 10, 480 lanes and head dims 1024 (the
    record) and 640 (``head_dim_640``). Errors: the forward's and the
    lineage's absolute, the gradients' relative to their largest entry,
    to phase 8's 1e-5 and 1e-4."""
    import torch
    import torch.nn.functional as F

    from neuralmonkey_tpu_torch.ops import flash_attention as fa
    from neuralmonkey_tpu_torch.ops import kernel_config
    from neuralmonkey_tpu_torch.ops import lineage_attention as la

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(device)

    records = {}

    def keep(name, entry, err, tol):
        if not err <= tol:
            raise AssertionError(f"{name}: error {err} > {tol}")
        prior = records.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(prior["max_abs_err"], err)
        prior.update(entry)

    b, h, t = 8, 4, 128
    lengths = torch.randint(1, t + 1, (b,), generator=gen)
    mask = (torch.arange(t)[None] < lengths[:, None]).float().to(device)
    attn_bias = torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
    for d in (320, 512):
        q, k, v, g = (randn(b, h, t, d) for _ in range(4))
        out, lse = fa.flash_forward(q, k, v, mask, False)
        ref_out, ref_lse = fa.flash_forward_reference(q, k, v, mask, False)
        dcap = (g * out).sum(dim=-1)
        bwd = (q, k, v, mask, lse, g, dcap, False)
        dq = fa.flash_backward_dq(*bwd)
        dk, dv = fa.flash_backward_dkv(*bwd)
        want = fa.flash_backward_reference(q, k, v, mask, ref_out, ref_lse,
                                           g, False)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=attn_bias)
        pairs, qo = b * h * t * t, 4 * b * h * t * d
        read = 4 * qo + 4 * b * t + 8 * b * h * t
        plain_bwd = time_ms(lambda: fa.flash_backward_reference(
            q, k, v, mask, out, lse, g, False))
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            lib_out, leaves, g, retain_graph=True))
        cases = {
            "flash_attention_fwd_chunked": (
                max(max_err(out, ref_out), max_err(lse, ref_lse)), 1e-5,
                lambda: fa.flash_forward(q, k, v, mask, False),
                time_ms(lambda: fa.flash_forward_reference(
                    q, k, v, mask, False)),
                time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=attn_bias)),
                bound(4 * pairs * d, 4 * qo + 4 * b * t + 4 * b * h * t)),
            "flash_attention_bwd_dq_chunked": (
                max_err(dq, want[0]) / float(want[0].abs().max()), 1e-4,
                lambda: fa.flash_backward_dq(*bwd), plain_bwd, lib_bwd,
                bound(6 * pairs * d, read + qo)),
            "flash_attention_bwd_dkv_chunked": (
                max(max_err(dk, want[1]) / float(want[1].abs().max()),
                    max_err(dv, want[2]) / float(want[2].abs().max())),
                1e-4, lambda: fa.flash_backward_dkv(*bwd), plain_bwd,
                lib_bwd, bound(8 * pairs * d, read + 2 * qo))}
        for name, (err, tol, call, plain, lib, (bms, by)) in cases.items():
            entry = {"ms": time_ms(call), "plain_ms": plain,
                     "library_ms": lib, "bound_ms": bms, "bound_by": by,
                     "call_ms": call_ms(call), "shape": [b, h, t, t, d],
                     "plan": (fa.flash_forward_plan(b, h, t, t, d)._asdict()
                              if "fwd" in name else
                              fa.flash_backward_plan(b, h, t, t, d, False)
                              ._asdict()["dq" if "dq" in name else "dkv"]
                              ._asdict())}
            if d == 320:
                entry = {"head_dim_320": entry}
            log(f"{name} head dim {d}: error {err:.3g}")
            keep(name, entry, err, tol)

    b, h, lanes = 8, 2, BEAM * TGT_LEN
    for d in (640, 1024):
        q = randn(b, h, BEAM, d)
        kq, vq = randn(b, h, d, lanes), randn(b, h, lanes, d)
        anc = torch.randint(0, BEAM, (b, BEAM, TGT_LEN), generator=gen,
                            dtype=torch.int32).to(device)
        bias = la.lineage_bias(anc, TGT_LEN - 1, TGT_LEN, BEAM, lanes,
                               TGT_LEN)

        def call():
            return la.lineage_attention(q, kq, vq, bias)
        err = max_err(call(), la.lineage_attention_reference(q, kq, vq, bias))
        bms, by = bound(4 * b * h * BEAM * lanes * d,
                        4 * (2 * b * h * BEAM * d + 2 * b * h * lanes * d
                             + b * BEAM * lanes))
        entry = {"ms": time_ms(call),
                 "plain_ms": time_ms(lambda: la.lineage_attention_reference(
                     q, kq, vq, bias)),
                 "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                     q, kq.transpose(-1, -2), vq, attn_mask=bias[:, None])),
                 "bound_ms": bms, "bound_by": by, "call_ms": call_ms(call),
                 "shape": [b, h, BEAM, lanes, d],
                 "plan": la.lineage_plan(b, h, BEAM, d, lanes, lanes,
                                         *kernel_config.device_limits(0)
                                         )._asdict()}
        if d == 640:
            entry = {"head_dim_640": entry}
        log(f"lineage_attention_chunked head dim {d}: error {err:.3g}")
        keep("lineage_attention_chunked", entry, err, 1e-5)
    torch.cuda.synchronize()
    return records


def flash_backward_times(fa, q, k, v, g, mask, causal):
    """The flash backward at one shape, in device ms: the dq and dkv
    kernels, the whole backward as the autograd Function runs it (dcap =
    rowsum(dO * O), dq, dkv: ``backward_ms``) and SDPA's backward (one
    ``torch.autograd.grad`` through ``scaled_dot_product_attention``),
    with the bounds of each kernel and of the whole backward (reading q,
    k, v, the mask, O, dO and lse, writing dq, dk and dv)."""
    import torch
    import torch.nn.functional as F
    b, h, tq, d = q.shape
    tk = k.shape[2]
    out, lse = fa.flash_forward(q, k, v, mask, causal)
    dcap = (g * out).sum(dim=-1)
    bwd = (q, k, v, mask, lse, g, dcap, causal)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    if causal:  # every key valid, as in the decoder's self-attention
        lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    else:
        lib_out = F.scaled_dot_product_attention(
            *leaves, attn_mask=torch.where(mask > 0, 0.0, -1e9)[:, None,
                                                                 None, :])
    pairs = b * h * tq * tk * (0.5 if causal else 1.0)
    qo, kv = 4 * b * h * tq * d, 4 * b * h * tk * d
    read = 2 * qo + 2 * kv + 4 * b * tk + 8 * b * h * tq
    times = {
        "dq_ms": time_ms(lambda: fa.flash_backward_dq(*bwd)),
        "dkv_ms": time_ms(lambda: fa.flash_backward_dkv(*bwd)),
        "backward_ms": time_ms(lambda: fa.flash_backward(
            q, k, v, mask, out, lse, g, causal)),
        "sdpa_backward_ms": time_ms(lambda: torch.autograd.grad(
            lib_out, leaves, g, retain_graph=True)),
        "dq_bound_ms": bound(6 * pairs * d, read + qo)[0],
        "dkv_bound_ms": bound(8 * pairs * d, read + 2 * kv)[0],
        "backward_bound_ms": bound(10 * pairs * d, 4 * qo + 4 * kv
                                   + 4 * b * tk + 4 * b * h * tq)[0],
        "shape": [b, h, tq, tk, d, bool(causal)]}
    return times


def gru_backward_times(cuda_rnn, nn, device, batch, time_, width, hidden):
    """The whole GRU backward at the encoder's shape (a BiGRU over full
    sources), in device ms: autograd through ``cuda_rnn.gru_scan``
    (``gru_bptt``, the r recompute and the dW_gh and dW_ch products of
    ``_GRUScan.backward``, and the hoisted input's backward: the
    gradients of the inputs and of every GRU parameter;
    ``whole_backward_ms``), and the same through the plain scan
    (``whole_backward_plain_ms``), with the bound of that work (reading
    the inputs, weights, mask, saved hoisted inputs and carries and the
    output gradients once, writing the input and weight gradients
    once). cuDNN's GRU computes another function (r after the recurrent
    product), so there is no library row."""
    import torch
    gen = torch.Generator().manual_seed(SEED + 5)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(device)
    reverse = (False, True)
    params = [{k: v.to(device) for k, v in
               nn.GRUCell(width, hidden).init(gen).items()} for _ in reverse]
    mask = torch.ones(batch, time_, device=device)
    inputs = randn(batch, time_, width)

    def leaves_of():
        trees = [{k: v.clone().requires_grad_() for k, v in p.items()}
                 for p in params]
        x = inputs.clone().requires_grad_()
        return trees, [x, *(t for tree in trees for t in tree.values())]
    trees, leaves = leaves_of()
    out, final = cuda_rnn.gru_scan(list(zip(trees, reverse)), leaves[0],
                                   mask)
    gout, gfinal = randn(*out.shape), randn(*final.shape)
    p_trees, p_leaves = leaves_of()
    x = cuda_rnn.hoisted_inputs(p_trees, p_leaves[0])
    p_out, p_final, _ = cuda_rnn.gru_scan_reference(
        x, mask, torch.stack([p["gates_h"] for p in p_trees]),
        torch.stack([p["cand_h"] for p in p_trees]), reverse)
    n_dirs, gates = len(reverse), len(reverse) * 3 * hidden
    flops = (n_dirs * batch * time_ * (12 * hidden * hidden + 20 * hidden)
             + 2 * batch * time_ * hidden * gates
             + 4 * batch * time_ * width * gates)
    nbytes = 4 * (2 * batch * time_ * width + 2 * (width + hidden + 1) * gates
                  + batch * time_ + batch * time_ * gates
                  + 2 * batch * time_ * n_dirs * hidden
                  + batch * n_dirs * hidden)
    return {
        "whole_backward_ms": time_ms(lambda: torch.autograd.grad(
            (out, final), leaves, (gout, gfinal), retain_graph=True)),
        "whole_backward_plain_ms": time_ms(lambda: torch.autograd.grad(
            (p_out, p_final), p_leaves, (gout, gfinal), retain_graph=True)),
        "whole_backward_bound_ms": bound(flops, nbytes)[0]}


def cudnn_lstm(params, reverse, forget_bias):
    """``torch.nn.LSTM`` (cuDNN) computing what ``lstm_scan`` computes
    for the bidirectional ``params``: the gates permuted from TF1's i, j,
    f, o to PyTorch's i, f, g, o, the forget bias folded into the f
    slice of ``bias_ih``, ``bias_hh`` zero."""
    import torch
    width, gates = params[0]["kernel_x"].shape
    hidden = gates // 4
    lstm = torch.nn.LSTM(width, hidden, batch_first=True,
                         bidirectional=len(params) == 2).to(
                             params[0]["kernel_x"].device)
    perm = torch.cat([torch.arange(a * hidden, (a + 1) * hidden)
                      for a in (0, 2, 1, 3)])
    fold = torch.zeros(gates, device=lstm.weight_ih_l0.device)
    fold[hidden:2 * hidden] = forget_bias
    with torch.no_grad():
        for p, rev in zip(params, reverse):
            suffix = "_l0_reverse" if rev else "_l0"
            getattr(lstm, "weight_ih" + suffix).copy_(p["kernel_x"][:, perm].T)
            getattr(lstm, "weight_hh" + suffix).copy_(p["kernel_h"][:, perm].T)
            getattr(lstm, "bias_ih" + suffix).copy_(p["bias"][perm] + fold)
            getattr(lstm, "bias_hh" + suffix).zero_()
    return lstm


def lstm_backward_times(cuda_rnn, params, reverse, inputs, mask, lengths,
                        lstm, gen):
    """The whole LSTM backward at one shape, in device ms: autograd
    through ``cuda_rnn.lstm_scan`` (``lstm_bptt``, the dW_h products and
    the hoisted input's backward: the gradients of the inputs, kernel_x,
    kernel_h and bias; ``whole_backward_ms``), the same through the plain
    scan (``whole_backward_plain_ms``) and through cuDNN's ``lstm``, the
    same function on the packed sources (``cudnn_backward_ms``), with the
    bound of that work (reading the inputs, weights, mask, saved hoisted
    inputs and carries and the output gradients once, writing the input
    and weight gradients once)."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence
    batch, time_, width = inputs.shape
    hidden = params[0]["kernel_h"].shape[0]
    n_dirs = len(reverse)
    device = inputs.device

    def leaves_of(xs):
        trees = [{k: v.clone().requires_grad_() for k, v in p.items()}
                 for p in params]
        x = xs.clone().requires_grad_()
        return trees, [x, *(t for tree in trees for t in tree.values())]
    trees, leaves = leaves_of(inputs)
    out, final = cuda_rnn.lstm_scan(list(zip(trees, reverse)), leaves[0],
                                    mask)
    gout = torch.randn(out.shape, generator=gen).to(device)
    gfinal = torch.randn(final.shape, generator=gen).to(device)
    p_trees, p_leaves = leaves_of(inputs)
    xz = cuda_rnn.lstm_hoisted_inputs(p_trees, p_leaves[0])
    wh = torch.stack([p["kernel_h"] for p in p_trees])
    p_out, p_final, _, _ = cuda_rnn.lstm_scan_reference(xz, mask, wh, 1.0,
                                                        reverse)
    lib_leaves = [inputs.clone().requires_grad_(), *lstm.parameters()]
    lib_out = lstm(pack_padded_sequence(
        lib_leaves[0], torch.tensor(lengths), batch_first=True,
        enforce_sorted=False))[0].data
    lib_grad = torch.randn(lib_out.shape, generator=gen).to(device)
    gates = n_dirs * 4 * hidden
    flops = (n_dirs * batch * time_ * (16 * hidden * hidden + 40 * hidden)
             + 2 * batch * time_ * hidden * gates
             + 4 * batch * time_ * width * gates)
    nbytes = 4 * (2 * batch * time_ * width + 2 * (width + hidden + 1) * gates
                  + batch * time_ + batch * time_ * gates
                  + 3 * batch * time_ * n_dirs * hidden
                  + batch * n_dirs * hidden)
    return {
        "whole_backward_ms": time_ms(lambda: torch.autograd.grad(
            (out, final), leaves, (gout, gfinal), retain_graph=True)),
        "whole_backward_plain_ms": time_ms(lambda: torch.autograd.grad(
            (p_out, p_final), p_leaves, (gout, gfinal), retain_graph=True)),
        "cudnn_backward_ms": time_ms(lambda: torch.autograd.grad(
            lib_out, lib_leaves, lib_grad, retain_graph=True)),
        "whole_backward_bound_ms": bound(flops, nbytes)[0]}


def check_lstm_kernels(device, randn, lengths_mask, record):
    """``lstm_scan``, ``lstm_bptt`` and ``rowmax_lse`` against their plain
    versions: the LSTM encoder's shapes with ragged sources, a ragged odd
    shape, and the unfused beam step's logits."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

    from neuralmonkey_tpu_torch.ops import beam_select, cuda_rnn, nn

    gen = torch.Generator().manual_seed(SEED + 4)
    slice_lengths = torch.randint(1, SRC_LEN + 1, (BATCH,),
                                  generator=gen).tolist()
    # (batch, time, width, hidden, directions, lengths): the encoder's
    # BiLSTM, and one reversed direction of an odd size with a length of 1
    for batch, time_, width, hidden, reverse, lengths in (
            (BATCH, SRC_LEN, EMB, RNN, (False, True), slice_lengths),
            (5, 7, 24, 200, (True,), [7, 5, 3, 1, 6])):
        timed = batch == BATCH
        shape = (batch, time_, hidden, f"{len(reverse)} directions")
        params = [{k: v.to(device) for k, v in
                   nn.LSTMCell(width, hidden).init(gen).items()}
                  for _ in reverse]
        directions = list(zip(params, reverse))
        reverse_mask = sum(1 << d for d, rev in enumerate(reverse) if rev)
        inputs = randn(batch, time_, width)
        mask = lengths_mask(lengths, time_)
        xz = cuda_rnn.lstm_hoisted_inputs(params, inputs)
        wh = torch.stack([p["kernel_h"] for p in params])
        got = cuda_rnn.lstm_scan_forward(xz, mask, wh, 1.0, reverse_mask,
                                         True)
        ref = cuda_rnn.lstm_scan_reference(xz, mask, wh, 1.0, reverse)
        err = max(max_err(g, r) for g, r in zip(got, ref))
        # the wrapper's work, K1's convention: the hoisted input product
        # and the scan
        n_dirs = len(reverse)
        work = (2 * batch * time_ * width * n_dirs * 4 * hidden
                + n_dirs * time_ * batch * 8 * hidden * hidden,
                4 * (batch * time_ * width + n_dirs * (width + hidden + 1)
                     * 4 * hidden + batch * time_
                     + batch * time_ * n_dirs * hidden
                     + batch * n_dirs * hidden))
        timing = {}
        if timed:
            lstm = cudnn_lstm(params, reverse, 1.0)
            packed = pack_padded_sequence(inputs, torch.tensor(lengths),
                                          batch_first=True,
                                          enforce_sorted=False)
            with torch.no_grad():
                lib_out, (lib_h, _) = lstm(packed)
            lib_out = pad_packed_sequence(lib_out, batch_first=True,
                                          total_length=time_)[0]
            lib_err = max(max_err(lib_out, got[0]), max_err(
                lib_h.transpose(0, 1).reshape(batch, -1), got[1]))

            def library_forward():
                with torch.no_grad():
                    return lstm(packed)
            timing = timings(
                lambda: cuda_rnn.lstm_scan(directions, inputs, mask),
                lambda: cuda_rnn.lstm_scan_reference(
                    cuda_rnn.lstm_hoisted_inputs(params, inputs), mask, wh,
                    1.0, reverse),
                library_forward)
            timing["cudnn_max_abs_err"] = lib_err
            # the wrapper's two parts: the persistent scan (with its
            # scratch) and the hoisted input GEMM
            timing["scan_ms"] = time_ms(lambda: cuda_rnn.lstm_scan_forward(
                xz, mask, wh, 1.0, reverse_mask, False))
            timing["hoisted_gemm_ms"] = time_ms(
                lambda: cuda_rnn.lstm_hoisted_inputs(params, inputs))
            log(f"lstm_scan {shape}: cuDNN LSTM on the packed sources "
                f"differs from the kernel by {lib_err:.3g} (the same "
                "function; another order of float32 sums)")
        record("lstm_scan", err, 1e-5, shape, work=work, **timing)

        # BPTT: the pre-activation gradients grow through the reverse
        # steps, so the error is held against their largest entry
        cprev = randn(batch, time_, n_dirs * hidden)
        hprev = randn(batch, time_, n_dirs * hidden, scale=0.5)
        gout = randn(batch, time_, n_dirs * hidden)
        gfinal = randn(batch, n_dirs * hidden)
        args = (xz, mask, cprev, hprev, gout, gfinal, wh, 1.0)
        got = cuda_rnn.lstm_bptt(*args, reverse_mask)
        ref = cuda_rnn.lstm_bptt_reference(*args, reverse)
        work = (n_dirs * batch * time_ * (16 * hidden * hidden + 40 * hidden),
                4 * (2 * batch * time_ * n_dirs * 4 * hidden + batch * time_
                     + 3 * batch * time_ * n_dirs * hidden
                     + batch * n_dirs * hidden
                     + n_dirs * hidden * 4 * hidden))
        timing = {}
        if timed:
            # autograd through the same cuDNN call: the input, weight
            # and bias gradients together
            leaves = [inputs.clone().requires_grad_(), *lstm.parameters()]
            lib_out = lstm(pack_padded_sequence(
                leaves[0], torch.tensor(lengths), batch_first=True,
                enforce_sorted=False))[0].data
            lib_grad = torch.randn(lib_out.shape, generator=gen).to(device)
            timing = timings(
                lambda: cuda_rnn.lstm_bptt(*args, reverse_mask),
                lambda: cuda_rnn.lstm_bptt_reference(*args, reverse),
                lambda: torch.autograd.grad(lib_out, leaves, lib_grad,
                                            retain_graph=True))
            # like for like: the whole backward of the same function,
            # the port's against cuDNN's
            timing.update(lstm_backward_times(cuda_rnn, params, reverse,
                                              inputs, mask, lengths, lstm,
                                              gen))
        record("lstm_bptt", max_err(got, ref) / max(1.0, float(
            ref.abs().max())), 1e-4, shape, work=work, **timing)

    # rowmax_lse: an unfused beam step's logits (B·K rows, the vocabulary
    # padded with 4·NEG_INF to whole 128-column groups), and a small
    # ragged case
    vp = -(-VOCAB // 128) * 128
    for n, v_real, vp_ in ((BATCH * BEAM, VOCAB, vp), (13, 300, 384)):
        timed = n == BATCH * BEAM
        x = torch.full((n, vp_), -4e9, device=device)
        x[:, :v_real] = randn(n, v_real, scale=4.0)
        got = beam_select.rowmax_lse(x)
        ref = beam_select.rowmax_lse_reference(x)
        if not torch.equal(got[0], ref[0]):
            raise AssertionError(f"rowmax_lse {(n, vp_)}: the group maxima "
                                 "differ from the plain version")
        groups = vp_ // 128
        work = (4 * n * vp_, 4 * (n * vp_ + n * groups + n))
        timing = {}
        if timed:
            # no one PyTorch call computes both reductions; the plain
            # version is the two calls (amax over the groups, logsumexp)
            timing = dict(
                ms=time_ms(lambda: beam_select.rowmax_lse(x)),
                plain_ms=time_ms(lambda: beam_select.rowmax_lse_reference(x)),
                call=lambda: beam_select.rowmax_lse(x))
        record("rowmax_lse", float(((got[1] - ref[1]).abs()
                                    / ref[1].abs()).max()), 1e-5, (n, vp_),
               work=work, **timing)


def launch_plans():
    """The launch plans of the redesigned kernels at the smoke's shapes
    on this card."""
    from neuralmonkey_tpu_torch.ops import cuda_attention, cuda_rnn
    from neuralmonkey_tpu_torch.ops import flash_attention as fa
    from neuralmonkey_tpu_torch.ops import fused_xent, kernel_config
    limits = kernel_config.device_limits(0)
    return {
        "sm_count": limits[0], "smem_per_block_optin": limits[1],
        "fused_bahdanau_step": cuda_attention.bahdanau_plan(
            BATCH, SRC_LEN, ATT, 2 * RNN, *limits)._asdict(),
        "lstm_scan": cuda_rnn.lstm_scan_plan(BATCH, RNN, 2,
                                             *limits)._asdict(),
        "lstm_bptt": cuda_rnn.lstm_bptt_plan(BATCH, RNN, 2,
                                             *limits)._asdict(),
        "gru_scan": cuda_rnn.gru_scan_plan(BATCH, RNN, 2,
                                           *limits)._asdict(),
        "gru_bptt": cuda_rnn.gru_bptt_plan(BATCH, RNN, 2,
                                           *limits)._asdict(),
        **{name: {k: v for k, v in plan(
            XENT_N, XENT_D, VOCAB, *limits)._asdict().items()
            if k != "walks"} for name, plan in (
                ("fused_xent_bwd_dx", fused_xent.dx_plan),
                ("fused_xent_bwd_dw", fused_xent.dw_plan),
                ("fused_xent_bwd_dx_bf16w", fused_xent.wgmma_dx_plan),
                ("fused_xent_bwd_dw_bf16w", fused_xent.wgmma_dw_plan))},
        "flash_attention_fwd": {
            case: fa.flash_forward_plan(*shape[:5])._asdict()
            for case, shape in FLASH_SHAPES.items()},
        "flash_attention_bwd": {
            case: {kernel: launch._asdict() for kernel, launch in
                   fa.flash_backward_plan(*shape)._asdict().items()}
            for case, shape in FLASH_SHAPES.items()}}


def timings(kernel, plain, library):
    """``record``'s timing arguments: the device times of the kernel's
    wrapper, its plain version and the library call, and the wrapper to
    time alone."""
    return dict(ms=time_ms(kernel), plain_ms=time_ms(plain),
                library_ms=time_ms(library), call=kernel)


def kernel_times(kernel, plain):
    """``timings`` where no one PyTorch call computes the function."""
    return dict(ms=time_ms(kernel), plain_ms=time_ms(plain), call=kernel)


def check_dropout_mask(q, k, mask, causal, key_words, keep, shape):
    """With one-hot value rows the context shows which weights the
    forward kernel kept: they must be the hash's keep mask wherever a
    key is visible."""
    import torch

    from neuralmonkey_tpu_torch.ops import flash_attention as fa
    b, h, tq, d = q.shape
    tk = k.shape[2]
    onehot = torch.eye(tk, d, device=q.device).expand(b, h, tk,
                                                      d).contiguous()
    # small scores, so every visible weight is far from underflow
    out, _ = fa.flash_forward(q * 0.1, k * 0.1, onehot, mask, causal,
                              key_words, keep)
    visible = (mask > 0)[:, None, None, :]
    if causal:
        visible = visible & torch.ones(tq, tk, dtype=torch.bool,
                                       device=q.device).tril()
    want = fa.keep_mask_dense(key_words, b, h, tq, tk, keep,
                              q.device) & visible
    if not torch.equal(out[..., :tk] != 0, want):
        raise AssertionError(f"flash_attention_fwd {shape}: the kernel's "
                             "dropout mask differs from the keep hash")
    log(f"flash_attention_fwd {shape}: dropout mask equal to the hash "
        f"({float(want.float().mean()):.4f} of the weights kept)")


# ---------------------------------------------------------------------- #
# phase 4: the full-width slice through the run CLI
# ---------------------------------------------------------------------- #
EXPERIMENT_INI = """\
[main]
name="chip smoke"
tf_manager=<tf_manager>
output="{tmp}/output"
batch_size={batch}
runners=[<runner>, <bs_runner>]
random_seed={seed}

[tf_manager]
class=tf_manager.TensorFlowManager
num_sessions=1

[vocabulary]
class=vocabulary.from_wordlist
path="{tmp}/words.txt"

[encoder]
class=encoders.recurrent.SentenceEncoder
name="sentence_encoder"
rnn_size={rnn}
rnn_cell="{cell}"
max_input_len={src_len}
embedding_size={emb}
data_id="source"
vocabulary=<vocabulary>

[attention]
class=attention.feed_forward.Attention
name="attention"
encoder=<encoder>
state_size={att}

[decoder]
class=decoders.decoder.Decoder
name="decoder"
encoders=[<encoder>]
attentions=[<attention>]
rnn_size={rnn}
embedding_size={emb}
conditional_gru=True
data_id="target"
max_output_len={max_out}
vocabulary=<vocabulary>

[bs_decoder]
class=decoders.beam_search_decoder.BeamSearchDecoder
name="bs_decoder"
parent_decoder=<decoder>
beam_size={beam}
length_normalization=0.6

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
test_datasets=[<test_data>]

[test_data]
class=dataset.load_dataset_from_files
s_source="{tmp}/source.txt"
s_target_out="{tmp}/{prefix}greedy.txt"
s_target_beam_out="{tmp}/{prefix}beam.txt"
"""


def write_inputs(tmp: str, cell: str = "GRU", prefix: str = ""):
    """The words, the 128 sources, and the serving INIs of the model with
    ``cell`` in its encoder (``{prefix}exp.ini``, ``{prefix}data.ini``)."""
    import numpy as np
    words = [f"w{i}" for i in range(VOCAB - 4)]
    with open(os.path.join(tmp, "words.txt"), "w") as f:
        f.write("\n".join(words) + "\n")
    rng = np.random.RandomState(SEED)
    with open(os.path.join(tmp, "source.txt"), "w") as f:
        for _ in range(N_SENTENCES):
            f.write(" ".join(words[i] for i in rng.randint(
                0, len(words), SRC_LEN)) + "\n")
    exp_ini = os.path.join(tmp, f"{prefix}exp.ini")
    with open(exp_ini, "w") as f:
        f.write(EXPERIMENT_INI.format(
            tmp=tmp, batch=BATCH, seed=SEED, rnn=RNN, src_len=SRC_LEN,
            emb=EMB, att=ATT, max_out=MAX_OUT, beam=BEAM, cell=cell))
    data_ini = os.path.join(tmp, f"{prefix}data.ini")
    with open(data_ini, "w") as f:
        f.write(DATA_INI.format(tmp=tmp, prefix=prefix))
    return exp_ini, data_ini


def run_slice(tmp: str):
    from neuralmonkey_tpu_torch.experiment import Experiment

    exp_ini, data_ini = write_inputs(tmp)
    exp = Experiment(exp_ini, train_mode=False)
    exp.build_model()
    ckpt = exp.tf_manager.save(os.path.join(tmp, "params"))
    launches, outputs = serve_through_run(
        exp_ini, data_ini, ckpt, SERVING_KERNELS,
        [os.path.join(tmp, name) for name in ("greedy.txt", "beam.txt")],
        "slice")
    lengths = mean_lengths(outputs)
    # phase 24 decodes into the same files under the bf16 policy; phase 28
    # holds its decode against these
    for name in ("greedy", "beam"):
        shutil.copyfile(os.path.join(tmp, f"{name}.txt"),
                        os.path.join(tmp, f"phase4_{name}.txt"))
    speed = serving_speed(exp, ckpt, data_ini, exp.model.runners)
    log(f"slice: mean output tokens {lengths}, {speed}")
    return launches, lengths, speed, exp, ckpt, data_ini


def serve_through_run(exp_ini: str, data_ini: str, ckpt, expected,
                      outputs, label: str, flags=(), forbidden=(),
                      sentences: int = None):
    """One ``run`` CLI pass from ``ckpt`` (a path, or a list of them: an
    ensemble, or averaged with ``flags`` ``("--average",)``) with the
    launch counts set to 0 just before it: (its launches, the lines of
    each output file, ``sentences`` each, by default N_SENTENCES). Every
    kernel in ``expected``
    must have launched, none in ``forbidden``."""
    import torch

    from neuralmonkey_tpu_torch import run
    from neuralmonkey_tpu_torch.ops import kernel_config

    ckpts = [ckpt] if isinstance(ckpt, str) else list(ckpt)
    sentences = sentences or N_SENTENCES
    kernel_config.reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    if run.main([exp_ini, data_ini, *ckpts, *flags]) != 0:
        raise AssertionError(f"{label}: neuralmonkey_tpu_torch.run failed")
    torch.cuda.synchronize()
    run_seconds = time.perf_counter() - start
    launches = kernel_config.launch_counts()
    log(f"{label}: run CLI {run_seconds:.2f} s, launches {launches}")
    missing = [k for k in expected if launches[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched by the run: "
                             f"{missing}")
    wrong = [k for k in forbidden if launches[k]]
    if wrong:
        raise AssertionError(f"{label}: kernels that this path must not "
                             f"launch were launched: {wrong}")
    lines = {}
    for path in outputs:
        with open(path) as f:
            lines[os.path.basename(path)] = f.read().splitlines()
        if len(lines[os.path.basename(path)]) != sentences:
            raise AssertionError(f"{label}: {path} does not hold "
                                 f"{sentences} lines")
    return launches, lines


def mean_lengths(outputs):
    return {name: statistics.mean(len(x.split()) for x in lines)
            for name, lines in outputs.items()}


def serving_speed(exp, ckpt: str, data_ini: str, runners, suffix="",
                  batch: int = BATCH, warm_up: bool = True):
    """Sentences/s and peak memory of each runner over the test data on
    ``exp``'s model restored from ``ckpt`` in batches of ``batch``, after
    a warm-up pass (``warm_up=False`` where a ``run`` of the same runners
    in this process has just warmed them)."""
    import torch

    from neuralmonkey_tpu_torch import run

    exp.tf_manager.restore(ckpt)
    dataset = run.load_data_config(data_ini)[0]
    speed = {}
    for runner in runners:
        if warm_up:
            exp.tf_manager.execute(dataset, [runner], batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        exp.tf_manager.execute(dataset, [runner], batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        speed[runner.output_series + suffix] = {
            "sentences_per_s": N_SENTENCES / seconds,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
    return speed


# ---------------------------------------------------------------------- #
# phase 5: CPU (plain versions) against the card (kernels)
# ---------------------------------------------------------------------- #
def check_parity(exp_ini: str, data_ini: str, gpu_exp, ckpt,
                 dataset=None, margin: float = MARGIN, card=None,
                 keep=None):
    """Phase 5's rule on the first N_PARITY sentences of ``data_ini``, or
    on ``dataset``; the beam part where the model has a second (beam
    search) runner; ``margin`` the gap below which the devices may
    choose apart (``BF16_MARGIN`` under the bf16 policy). With a list of
    checkpoints (``gpu_exp`` restored from the same), the ensemble's:
    the greedy margins are the gaps of the CPU's averaged log-probs.
    With ``card`` in place of ``gpu_exp`` (None), the beam part alone,
    held against a search already run on the card: ``card`` is (each
    row's picks, a (K, 2) tensor a step; each row's best ids). ``keep``
    (a dict) receives the CPU's beam record for :func:`hold_beam`: each
    step's picks and gaps, and each row's best ids."""
    import torch

    from neuralmonkey_tpu_torch import run
    from neuralmonkey_tpu_torch.experiment import Experiment
    from neuralmonkey_tpu_torch.models.decoders import beam_search_decoder

    if dataset is None:
        dataset = run.load_data_config(data_ini)[0].subset(0, N_PARITY)
    n = len(dataset)
    cpu_exp = Experiment(exp_ini, train_mode=False,
                         config_changes=['tf_manager.device="cpu"'])
    cpu_exp.build_model()
    cpu_exp.tf_manager.restore(ckpt)

    # per step, on the CPU: greedy's top-two logit gap per row, and the
    # beam's gaps between neighbours among the top K+1 candidate scores
    # over the whole vocabulary of every beam, (rows, K); on both devices:
    # the beam's (parent, token) picks, (rows, K, 2)
    greedy_margins, beam_gaps = [], []
    picks = {"cpu": [], "gpu": []}
    decoder = cpu_exp.model.runners[0].decoder
    # a single model's greedy step gives its logits; an ensemble's models
    # each take the step, and the averaged log-probs reach ``_mask_unk``
    # once a step
    hooked = ("_mask_unk" if len(cpu_exp.tf_manager.params_list) > 1
              else "decode_step")
    plain_step = getattr(decoder, hooked)

    def recording_step(*args):
        out = plain_step(*args)
        scores = out if hooked == "_mask_unk" else out[1]
        top2 = scores.topk(2, dim=-1).values
        greedy_margins.append(top2[:, 0] - top2[:, 1])
        return out

    plain_topk = beam_search_decoder.small_topk
    # per step, the best score of the column groups stage 1 left out: the
    # (K+1)-th group maximum
    left_out = []

    def recording_topk(x, k):
        top = torch.sort(x, dim=1, descending=True).values[:, :k + 1]
        if x.shape[1] == k * beam_search_decoder.LANE:  # stage 2
            # candidate K+1 is the better of stage 2's and the best one
            # in a group that stage 1 left out
            after = top[:, 1:].clone()
            after[:, -1] = torch.maximum(after[:, -1], left_out[-1])
            beam_gaps.append(top[:, :-1] - after)
        else:  # stage 1: the column groups' maxima
            left_out.append(top[:, k])
        return plain_topk(x, k)

    def record_picks(exp, log, gaps=False):
        """Record each step's picks of the beam search; with ``gaps``
        (the CPU's flat selector) also the gaps between neighbours among
        its top K+1 candidates, from the sort it selects by."""
        search = exp.model.runners[1].decoder
        plain_select = getattr(search, selector)

        def select(x, state, batch, **kwargs):
            plain_sort, sorted_scores = torch.sort, []

            def recording_sort(*args, **sort_kwargs):
                out = plain_sort(*args, **sort_kwargs)
                sorted_scores.append(out.values)
                return out
            if gaps:
                torch.sort = recording_sort
            try:
                out = plain_select(x, state, batch, **kwargs)
            finally:
                torch.sort = plain_sort
            if gaps:
                top = sorted_scores[0][:, :search.beam_size + 1]
                beam_gaps.append(top[:, :-1] - top[:, 1:])
            log.append(torch.stack(out[:2], dim=-1).cpu())
            return out
        setattr(search, selector, select)

    exps = [e for e in (cpu_exp, gpu_exp) if e is not None]
    has_beam = len(exps[-1].model.runners) > 1
    # the hierarchical selector's gaps come from its two K4 stages, the
    # flat one's (``use_approx_top_k``, small vocabularies) from its sort
    flat = has_beam and exps[-1].model.runners[1].decoder._method() == "flat"
    selector = "_select_flat" if flat else "_select_hier"

    def decode(exp):
        # three padding rows (all-zero masks) ride along, as in the last
        # batch of a dataset
        batch, _ = exp.tf_manager.build_batch(dataset, n + 3)
        with torch.inference_mode():
            fetched = exp.tf_manager.fetch(
                exp.model.runners[:1 + has_beam], batch)
        greedy = fetched[0]["decoded"][:n].cpu()
        if not has_beam:
            return greedy, None
        return greedy, fetched[1]["token_ids"][:n, 0].cpu()

    setattr(decoder, hooked, recording_step)
    beam_search_decoder.small_topk = recording_topk
    if has_beam:
        record_picks(cpu_exp, picks["cpu"], gaps=flat)
        if gpu_exp is not None:
            record_picks(gpu_exp, picks["gpu"])
    try:
        cpu_greedy, cpu_beam = decode(cpu_exp)
        if gpu_exp is not None:
            gpu_greedy, gpu_beam = decode(gpu_exp)
    finally:
        beam_search_decoder.small_topk = plain_topk
        delattr(decoder, hooked)
        if has_beam:
            for exp in exps:
                delattr(exp.model.runners[1].decoder, selector)

    report = {}
    same = 0
    for row in range(n if gpu_exp is not None else 0):
        diff = (cpu_greedy[row] != gpu_greedy[row]).nonzero()
        if len(diff) == 0:
            same += 1
            continue
        # greedy diverges exactly where its ids do
        step = int(diff[0])
        top_gap = float(greedy_margins[step][row])
        log(f"parity greedy: sentence {row} first differs at step {step}; "
            f"CPU top-two margin {top_gap:.3g}")
        if not top_gap < margin:
            raise AssertionError(
                f"greedy ids of sentence {row} differ at step {step}, "
                f"where the CPU's top-two margin is {top_gap} >= {margin}")
    if gpu_exp is not None:
        report["greedy"] = f"{same}/{n} identical"
    if not has_beam:
        log(f"parity: {report}")
        return report

    if keep is not None:
        keep.update(picks=picks["cpu"], gaps=beam_gaps, ids=cpu_beam)
    if card is None:
        card_picks = [[p[row] for p in picks["gpu"]] for row in range(n)]

        def same_ids(row):
            return torch.equal(cpu_beam[row], gpu_beam[row])
    else:
        card_picks, card_ids = card
        vocabulary = cpu_exp.model.runners[1].decoder.vocabulary

        def same_ids(row):
            # the card's ids as its runner collected them: the words to
            # the first </s>
            return (vocabulary.vectors_to_sentences(cpu_beam[row:row + 1])
                    == vocabulary.vectors_to_sentences(card_ids[row][None]))
    report["beam"] = hold_beam(picks["cpu"], beam_gaps, card_picks,
                               same_ids, margin)
    log(f"parity: {report}")
    return report


def hold_beam(cpu_picks, gaps, card_picks, same_ids,
              margin: float = MARGIN) -> str:
    """Phase 5's beam rule: a search on the card that first picks a
    different (parent, token) than the CPU's at some step and slot j
    must do so at a near-tie of the CPU's, its gap between candidates j
    and j + 1 below ``margin``; one that never does must give the CPU's
    best ids. ``cpu_picks`` and ``gaps`` hold a (rows, K, 2) and a
    (rows, K) tensor a step, ``card_picks`` each row's (K, 2) picks a
    step, ``same_ids(row)`` whether a row's best ids agree."""
    def first_divergence(row):
        # the steps both searches ran (a finished hypothesis is a fixed
        # point of the step, so a batch may run on past another's end)
        for step, (c, g) in enumerate(zip(cpu_picks, card_picks[row])):
            slots = (c[row] != g).any(-1).nonzero()
            if len(slots):
                return step, int(slots[0, 0])
        return None

    n = len(card_picks)
    same = diverged = 0
    for row in range(n):
        first = first_divergence(row)
        ids_same = bool(same_ids(row))
        same += ids_same
        if first is None:
            if not ids_same:
                raise AssertionError(
                    f"beam ids of sentence {row} differ though every "
                    "step picked the same candidates")
            continue
        diverged += 1
        step, slot = first
        gap = float(gaps[step][row, slot])
        log(f"parity beam: sentence {row}: the searches first pick "
            f"differently at step {step}, slot {slot}; CPU gap to the "
            f"next candidate {gap:.3g}; best ids "
            f"{'identical' if ids_same else 'differ'}")
        if not gap < margin:
            raise AssertionError(
                f"beam search of sentence {row} diverges at step {step}, "
                f"slot {slot}, where the CPU's gap is {gap} >= {margin}")
    return (f"{same}/{n} identical, {diverged} searches diverged at a "
            "near-tie")


# ---------------------------------------------------------------------- #
# phase 17: the HTTP server at full width
# ---------------------------------------------------------------------- #
N_REQUESTS, WINDOW_MS = 32, 10.0


def serve_over_http(tmp: str, exp_ini: str, data_ini: str, ckpt: str):
    """Phase 4's model from its checkpoint behind ``ModelService`` and
    ``ThreadingHTTPServer`` on 127.0.0.1 (window 10 ms): after one
    warm-up request, 32 concurrent ``POST /run`` requests of 1-8 of phase
    4's sentences each, the launch counts set to 0 just before them.
    Every answer (greedy and beam 10) must equal phase 4's output for its
    sentence, or: a greedy answer may first differ at a step where the
    CPU, fed the common prefix, scores the two tokens less than 1e-3
    apart (:func:`greedy_gap`); a sentence whose beam answer differs is
    held to phase 5's rule. K1-K4 must have launched. Returns (launches,
    report)."""
    import random
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import torch

    from neuralmonkey_tpu_torch import server
    from neuralmonkey_tpu_torch.dataset import from_dict
    from neuralmonkey_tpu_torch.experiment import Experiment
    from neuralmonkey_tpu_torch.ops import kernel_config

    def lines(name):
        with open(os.path.join(tmp, name)) as f:
            return f.read().splitlines()
    sources = lines("source.txt")
    expected = {"target": [line.split() for line in lines("greedy.txt")],
                "target_beam": [line.split() for line in lines("beam.txt")]}
    rng = random.Random(SEED)
    requests = [rng.sample(range(N_SENTENCES), rng.randint(1, 8))
                for _ in range(N_REQUESTS)]

    exp = Experiment(exp_ini, train_mode=False)
    exp.build_model()
    exp.restore_variables([ckpt])
    service = server.ModelService(exp, batch_window_ms=WINDOW_MS)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler(service))
    port = httpd.server_address[1]
    serving = threading.Thread(target=httpd.serve_forever, daemon=True)
    serving.start()

    def post(rows):
        body = json.dumps({"source": [sources[i] for i in rows]}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/run", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json.loads(resp.read())

    answers, latency, errors = {}, {}, []

    def client(i):
        start = time.perf_counter()
        try:
            answers[i] = post(requests[i])
        except Exception as exc:  # reported below, the phase fails
            errors.append(repr(exc))
        latency[i] = (time.perf_counter() - start) * 1e3

    try:
        post([0])  # warm-up
        torch.cuda.synchronize()
        calls_before = service.stats["model_calls"]
        kernel_config.reset_launch_counts()
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(N_REQUESTS)]
        start = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        seconds = time.perf_counter() - start
        launches = kernel_config.launch_counts()
        calls = service.stats["model_calls"] - calls_before
    finally:
        service.close()
        httpd.shutdown()
        httpd.server_close()
    if errors:
        raise AssertionError(f"server: requests failed: {errors[:3]}")
    missing = [k for k in SERVING_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"server: kernels never launched: {missing}")
    differ = {series: {row: answers[i][series][j]
                       for i, rows in enumerate(requests)
                       for j, row in enumerate(rows)
                       if answers[i][series][j] != want[row]}
              for series, want in expected.items()}
    greedy_gaps = {row: greedy_gap(exp_ini, ckpt, sources[row].split(),
                                   expected["target"][row], got)
                   for row, got in differ["target"].items()}
    if any(not gap < MARGIN for gap in greedy_gaps.values()):
        raise AssertionError(f"server: greedy answers differ from phase 4's "
                             f"where the CPU's gap is not below {MARGIN}: "
                             f"{greedy_gaps}")
    parity = None
    if differ["target_beam"]:
        rows = sorted(differ["target_beam"])
        log(f"server: beam answers of sentences {rows} differ from phase "
            "4's; holding them to phase 5's rule")
        parity = check_parity(exp_ini, data_ini, exp, ckpt, from_dict(
            {"source": [sources[i].split() for i in rows]}))
    times = sorted(latency.values())
    sentences = sum(len(rows) for rows in requests)
    report = {
        "requests": N_REQUESTS, "sentences": sentences,
        "model_calls": calls, "batch_window_ms": WINDOW_MS,
        "p50_latency_ms": statistics.median(times),
        "p99_latency_ms": times[min(len(times) - 1,
                                    int(0.99 * len(times)))],
        "sentences_per_s": sentences / seconds,
        "greedy_differing_from_phase_4": greedy_gaps,
        "beam_differing_from_phase_4": sorted(differ["target_beam"]),
        "beam_parity": parity,
        "launches": {k: launches[k] for k in SERVING_KERNELS}}
    print(json.dumps({"server": report}))
    log(f"server: {report}")
    return launches, report


def greedy_gap(exp_ini: str, ckpt: str, source, want, got) -> float:
    """Where two greedy decodes of ``source`` first differ, the CPU's
    logit gap between their two tokens, the decoder fed their common
    prefix (phase 5's top-two margin at that step when one of them is
    the CPU's pick)."""
    import torch

    from neuralmonkey_tpu_torch.dataset import from_dict
    from neuralmonkey_tpu_torch.experiment import Experiment
    from neuralmonkey_tpu_torch.model.part import Context
    from neuralmonkey_tpu_torch.vocabulary import (END_TOKEN,
                                                   START_TOKEN_INDEX)

    step = next(i for i in range(max(len(want), len(got)) + 1)
                if want[i:i + 1] != got[i:i + 1])
    exp = Experiment(exp_ini, train_mode=False,
                     config_changes=['tf_manager.device="cpu"'])
    exp.build_model()
    exp.tf_manager.restore(ckpt)
    decoder = exp.model.runners[0].decoder
    ids = [decoder.vocabulary.word_to_index[w] for w in want[:step]]
    batch, _ = exp.tf_manager.build_batch(from_dict({"source": [source]}), 1)
    with torch.inference_mode():
        ctx = Context(exp.tf_manager.params, batch)
        constants = decoder.decode_constants(ctx)
        state = decoder.decode_initial_state(ctx, constants)
        for t, prev in enumerate([START_TOKEN_INDEX] + ids):
            state, logits, _ = decoder.decode_step(
                constants, state, torch.tensor([prev], dtype=torch.int32), t)
    pick = [decoder.vocabulary.word_to_index[seq[step]]
            if step < len(seq) else decoder.vocabulary.word_to_index[
                END_TOKEN] for seq in (want, got)]
    return abs(float(logits[0, pick[0]] - logits[0, pick[1]]))


# ---------------------------------------------------------------------- #
# phase 6: training through the train CLI
# ---------------------------------------------------------------------- #
TRAIN_INI = """\
[main]
name="chip smoke training"
tf_manager=<tf_manager>
output="{out}"
overwrite_output_dir=True
batch_size={batch}
epochs=1
train_dataset=<train_data>
val_dataset=<val_data>
trainer=<trainer>
runners=[<runner>, <bs_runner>]
evaluation=[("target", evaluators.bleu.BLEU)]
logging_period=5
validation_period=1000
random_seed={seed}

[tf_manager]
class=tf_manager.TensorFlowManager
num_sessions=1

[vocabulary]
class=vocabulary.from_wordlist
path="{tmp}/words.txt"

[train_data]
class=dataset.load_dataset_from_files
s_source="{tmp}/train.src"
s_target="{tmp}/train.tgt"
lazy=False

[val_data]
class=dataset.load_dataset_from_files
s_source="{tmp}/val.src"
s_target="{tmp}/val.tgt"

[encoder]
class=encoders.recurrent.SentenceEncoder
name="sentence_encoder"
rnn_size={rnn}
rnn_cell="{cell}"
max_input_len={src_len}
embedding_size={emb}
dropout_keep_prob={keep}
data_id="source"
vocabulary=<vocabulary>

[attention]
class=attention.feed_forward.Attention
name="attention"
encoder=<encoder>
state_size={att}
dropout_keep_prob={keep}

[decoder]
class=decoders.decoder.Decoder
name="decoder"
encoders=[<encoder>]
attentions=[<attention>]
rnn_size={rnn}
embedding_size={emb}
maxout_size={emb}
conditional_gru=True
dropout_keep_prob={keep}
data_id="target"
max_output_len={tgt_len}
vocabulary=<vocabulary>

[bs_decoder]
class=decoders.beam_search_decoder.BeamSearchDecoder
name="bs_decoder"
parent_decoder=<decoder>
beam_size={beam}
length_normalization=0.6

[trainer]
class=trainers.cross_entropy_trainer.CrossEntropyTrainer
decoders=[<decoder>]
clip_norm=1.0
optimizer=<adam>

[adam]
class=tf.train.AdamOptimizer
learning_rate=0.001

[runner]
class=runners.runner.GreedyRunner
decoder=<decoder>
output_series="target"

[bs_runner]
class=runners.beam_search_runner.BeamSearchRunner
decoder=<bs_decoder>
output_series="target_beam"
"""

TRAIN_DATA_INI = """\
[main]
test_datasets=[<test_data>]

[test_data]
class=dataset.load_dataset_from_files
s_source="{tmp}/val.src"
s_target_out="{out}/greedy.txt"
s_target_beam_out="{out}/beam.txt"
"""


def write_training_inputs(tmp: str, cell: str = "GRU",
                          name: str = "train.ini") -> str:
    """Synthetic pairs (the words of ``write_inputs``): a source of 32
    words from the first 2000, and as its target the source and its
    first 15 words again, each through a fixed map onto the whole
    vocabulary, so 47 words and </s> fill the 48 decoder steps; and the
    training INI of the model with ``cell`` in its encoder."""
    import numpy as np
    n_words = VOCAB - 4
    rng = np.random.RandomState(SEED + 2)
    for split, count in (("train", N_TRAIN), ("val", N_VAL)):
        src = rng.randint(0, SOURCE_WORDS, (count, SRC_LEN))
        tgt = (np.concatenate([src, src[:, :TGT_LEN - SRC_LEN - 1]], axis=1)
               * 7919 + 13) % n_words
        for side, ids in (("src", src), ("tgt", tgt)):
            with open(os.path.join(tmp, f"{split}.{side}"), "w") as f:
                f.writelines(" ".join(f"w{i}" for i in row) + "\n"
                             for row in ids)
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        f.write(TRAIN_INI.format(
            tmp=tmp, out=os.path.join(tmp, "train_out"), batch=BATCH,
            seed=SEED, rnn=RNN, src_len=SRC_LEN, emb=EMB, att=ATT,
            tgt_len=TGT_LEN, beam=BEAM, keep=KEEP_PROB, cell=cell))
    return path


XENT_KERNELS = ("fused_xent_fwd", "fused_xent_bwd_dx", "fused_xent_bwd_dw")


def run_training(tmp: str, train_ini: str, fused: bool, name: str = "train",
                 expected=("gru_scan", "gru_bptt", "fused_bahdanau_step"),
                 data_template: str = None, falling: bool = True,
                 xent=XENT_KERNELS):
    """One epoch through the train CLI, then ``run`` from its best
    checkpoint over the data INI ``data_template`` (by default the
    validation sources of phase 6); returns the launch counts of the
    training run, its record and the checkpoint. Every kernel in
    ``expected`` must launch in the training run, the cross-entropy
    kernels ``xent`` exactly when ``fused``; with ``falling`` the loss
    must fall."""
    import torch

    from neuralmonkey_tpu_torch import run, train
    from neuralmonkey_tpu_torch.ops import kernel_config

    out = os.path.join(tmp, f"{name}_fused" if fused else f"{name}_plain")
    if fused:
        os.environ["NM_FUSED_XENT"] = "1"
    try:
        kernel_config.reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        if train.main([train_ini, f'main.output="{out}"']) != 0:
            raise AssertionError("neuralmonkey_tpu_torch.train failed")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = kernel_config.launch_counts()
    finally:
        os.environ.pop("NM_FUSED_XENT", None)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    windows = [r for r in records if r["kind"] == "train"]
    losses = [r["loss"] for r in windows]
    if falling and not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")
    missing = [k for k in expected if launches[k] == 0]
    wrong = [k for k in xent if (launches[k] > 0) != fused]
    if missing or wrong:
        raise AssertionError(f"training launches {launches}: never "
                             f"launched {missing}, cross-entropy kernels "
                             f"wrong for fused={fused}: {wrong}")
    best = os.path.join(out, "variables.data.best")
    data_ini = os.path.join(tmp, f"{name}_data.ini")
    with open(data_ini, "w") as f:
        f.write((data_template or TRAIN_DATA_INI).format(tmp=tmp, out=out))
    if run.main([train_ini, data_ini, best]) != 0:
        raise AssertionError("neuralmonkey_tpu_torch.run failed")
    for output in ("greedy.txt", "beam.txt"):
        with open(os.path.join(out, output)) as f:
            if len(f.read().splitlines()) != N_VAL:
                raise AssertionError(f"run from {best}: {output} is short")
    # tokens/s of the logging windows after the first (the first holds
    # the warm-up)
    rates = [r["tokens_per_sec"] for r in windows]
    record = {"fused_xent": fused, "steps": windows[-1]["step"],
              "seconds": seconds, "losses": losses,
              "tokens_per_sec_windows": rates,
              "train_tokens_per_sec": statistics.mean(rates[1:]),
              "val": {k: v for r in records if r["kind"] == "val"
                      for k, v in r.items() if k not in ("kind", "time")},
              "launches": launches}
    log(f"{name} (fused xent {fused}): {record}")
    return launches, record, best


# ---------------------------------------------------------------------- #
# phase 7: one training step on the card against the CPU
# ---------------------------------------------------------------------- #
def check_train_parity(train_ini: str, ckpt: str,
                       parts=("encoder", "attention", "decoder"),
                       float64: bool = False, check: bool = True,
                       hook=None, changes=()):
    """Loss and every parameter gradient of one step from ``ckpt`` on 8
    sentences, the dropout of ``parts`` off (attention dropout, where a
    part has it, stays on: the keep hash draws the same mask on both
    devices): card (kernels) against CPU (plain).

    A ReLU is not differentiable at 0: a pre-activation within rounding
    of 0 may fall on the other side on the card, and one such unit moves
    a weight's gradient by one token's share. So the card's passes record
    which units are on, the CPU's passes take the card's (the same
    piecewise-linear branch), and every unit where the devices'
    pre-activations differ in sign must be a near-tie: at most
    ``RELU_MARGIN`` from 0 on the CPU.

    Each gradient on the card must lie within 1e-3 of its largest entry
    of the CPU's. With ``float64`` the CPU also takes the step in
    float64, and the card's gradient must lie within 1e-3 of the largest
    entry of that one, or no further from it than ``GRAD_SPREAD`` times
    the CPU's float32 gradient lies: where a gradient is a small
    difference of large float32 sums (the softmax backward's dq cancels
    the keys' common part), both devices' rounding is amplified alike.
    The report gives, for each pass, the least spread it would pass
    under (``spread_needed``); ``check=False`` reports without raising
    (``scripts/grad_rule_faults.py`` reads planted faults so);
    ``hook(experiment)`` runs on each pass's model before its step, the
    card's passes first; ``changes`` are further configuration changes of
    every pass."""
    import torch

    from neuralmonkey_tpu_torch.dataset import BatchingScheme
    from neuralmonkey_tpu_torch.experiment import Experiment
    from neuralmonkey_tpu_torch.utils.saving import flatten_tree

    changes = [f"{part}.dropout_keep_prob=1.0" for part in parts] + list(
        changes)
    plain_relu = torch.relu

    def cast(tree, dtype):
        if isinstance(tree, dict):
            return {k: cast(v, dtype) for k, v in tree.items()}
        return tree.to(dtype) if tree.is_floating_point() else tree

    def loss_and_grads(device_change, fused, relu, dtype=torch.float32):
        exp = Experiment(train_ini, train_mode=True,
                         config_changes=changes + device_change)
        exp.build_model()
        if hook is not None:
            hook(exp)
        manager = exp.tf_manager
        manager.restore(ckpt)
        manager.params = cast(manager.params, dtype)
        dataset = next(exp.model.train_dataset.batches(
            BatchingScheme(batch_size=N_PARITY), shuffled=False))
        batch = cast(manager.build_batch(dataset, N_PARITY, train=True)[0],
                     dtype)
        flat = flatten_tree(manager.params)
        for p in flat.values():
            p.requires_grad_(True)
        if fused:
            os.environ["NM_FUSED_XENT"] = "1"
        torch.relu = relu
        try:
            total, _ = exp.model.trainer.total_loss(manager.params, batch,
                                                    rng=0)
            total.backward()
        finally:
            torch.relu = plain_relu
            os.environ.pop("NM_FUSED_XENT", None)
        # a parameter the step does not reach (a frozen CNN's) has the
        # zero gradient, as the trainer takes it
        return (total.item(), {k: (torch.zeros_like(p) if p.grad is None
                                   else p.grad).detach().cpu().double()
                               for k, p in flat.items()})

    def recording(masks):
        def relu(x):
            masks.append((x > 0).cpu())
            return plain_relu(x)
        return relu

    flipped = []

    def following(masks):
        calls = iter(masks)

        def relu(x):
            on = next(calls)
            flipped.append(x.detach()[on != (x > 0)].abs().float())
            return torch.where(on, x, 0.0)
        return relu

    card, card_masks = {}, {}
    for fused in (False, True):
        card_masks[fused] = []
        card[fused] = loss_and_grads([], fused, recording(card_masks[fused]))
    if not all(torch.equal(a, b) for a, b in zip(*card_masks.values())):
        raise AssertionError("the card's two passes switched different "
                             "ReLU units on")
    cpu = ['tf_manager.device="cpu"']
    ref_loss, ref_grads = loss_and_grads(cpu, False,
                                         following(card_masks[False]))
    truth = ref_grads
    if float64:
        truth = loss_and_grads(cpu, False, following(card_masks[False]),
                               torch.float64)[1]
    flips = torch.cat([f.flatten() for f in flipped] + [torch.zeros(1)])
    units = sum(m.numel() for m in card_masks[False])
    # the float32 pass's flips (the float64 pass follows in ``flipped``)
    n_flips = sum(len(f) for f in flipped[:len(card_masks[False])])
    log(f"training parity: {n_flips} of {units} ReLU units differ in sign "
        f"between the card and the CPU, at most {float(flips.max()):.3g} "
        "from 0 on the CPU")
    if not float(flips.max()) <= RELU_MARGIN:
        raise AssertionError(f"a ReLU unit {float(flips.max())} from 0 on the "
                             "CPU is off on one device and on on the other")

    def scale(key):
        """The largest entry of the reference gradient of ``key``; for an
        attention key bias, whose exact gradient is 0 (it shifts every
        score of a row alike) so that its entries are rounding noise,
        that of its key weight."""
        if key.endswith("/k/b"):
            key = key[:-1] + "w"
        return max(float(truth[key].abs().max()), 1e-30)

    # the CPU's float32 gradients' deviation from the reference (0 when
    # the reference is the CPU's float32 step itself)
    cpu_dev = {k: max_err(g, truth[k]) / scale(k) for k, g in ref_grads.items()}
    report = {"relu_units": units, "relu_units_flipped": n_flips,
              "reference": "cpu float64" if float64 else "cpu float32"}
    for fused in (False, True):
        loss, grads = card[fused]
        loss_err = abs(loss - ref_loss) / abs(ref_loss)
        dev = {k: max_err(g, truth[k]) / scale(k) for k, g in grads.items()}
        worst = max(dev, key=lambda k: dev[k] / max(1e-3,
                                                    GRAD_SPREAD * cpu_dev[k]))
        # the pass holds iff every leaf beyond 1e-3 lies within
        # GRAD_SPREAD times the CPU float32's deviation
        beyond = {k: dev[k] / max(cpu_dev[k], 1e-30) for k in dev
                  if dev[k] > 1e-3}
        spread = max(beyond.values(), default=0.0)
        log(f"training parity (fused xent {fused}): loss {loss:.6f} vs "
            f"CPU {ref_loss:.6f} (relative {loss_err:.3g}); against the "
            f"{report['reference']} gradient the card's largest deviation "
            f"{max(dev.values()):.3g} of the largest entry, relative to the "
            f"limit at {worst}: card {dev[worst]:.3g}, CPU float32 "
            f"{cpu_dev[worst]:.3g}; least spread that passes {spread:.3g}")
        if check and not (loss_err <= 1e-5 and spread <= GRAD_SPREAD):
            raise AssertionError(
                f"training step on the card differs from the CPU: loss "
                f"{loss_err}, gradient {dev[worst]} at {worst} (CPU float32 "
                f"{cpu_dev[worst]})")
        report["fused" if fused else "plain"] = {
            "loss": loss, "cpu_loss": ref_loss, "loss_rel_err": loss_err,
            "grad_rel_err_max": max(dev.values()),
            "grad_rel_err_max_at": max(dev, key=dev.get),
            "closest_to_limit": worst, "grad_rel_err": dev[worst],
            "cpu_float32_grad_rel_err": cpu_dev[worst],
            "spread_needed": spread,
            "spread_needed_at": max(beyond, key=beyond.get, default=None)}
    return report


# ---------------------------------------------------------------------- #
# phases 9-12: bench.py's Transformer
# ---------------------------------------------------------------------- #
T_MODEL_INI = """\
[tf_manager]
class=tf_manager.TensorFlowManager
num_sessions=1

[vocabulary]
class=vocabulary.from_wordlist
path="{tmp}/words.txt"

[encoder]
class=encoders.transformer.TransformerEncoder
name="encoder"
embedding_size={dim}
ff_hidden_size={ff}
depth={depth}
n_heads={heads}
max_input_len={src_len}
dropout_keep_prob={keep}
attention_dropout_keep_prob={att_keep}
data_id="source"
vocabulary=<vocabulary>

[decoder]
class=decoders.transformer.TransformerDecoder
name="decoder"
encoders=[<encoder>]
embedding_size={dim}
ff_hidden_size={ff}
depth={depth}
n_heads_self={heads}
n_heads_enc={heads}
tie_embeddings=True
label_smoothing=0.1
dropout_keep_prob={keep}
attention_dropout_keep_prob={att_keep}
data_id="target"
max_output_len={max_out}
vocabulary=<vocabulary>

[bs_decoder]
class=decoders.beam_search_decoder.BeamSearchDecoder
name="bs_decoder"
parent_decoder=<decoder>
beam_size={beam}
length_normalization=0.6

[runner]
class=runners.runner.GreedyRunner
decoder=<decoder>
output_series="target"

[bs_runner]
class=runners.beam_search_runner.BeamSearchRunner
decoder=<bs_decoder>
output_series="target_beam"
"""

T_SERVING_MAIN = """\
[main]
name="chip smoke transformer"
tf_manager=<tf_manager>
output="{tmp}/t_output"
batch_size={batch}
runners=[<runner>, <bs_runner>]
random_seed={seed}

"""

T_TRAINING_MAIN = """\
[main]
name="chip smoke transformer training"
tf_manager=<tf_manager>
output="{tmp}/t_train_out"
overwrite_output_dir=True
batch_size={batch}
epochs=1
train_dataset=<train_data>
val_dataset=<val_data>
trainer=<trainer>
runners=[<runner>, <bs_runner>]
evaluation=[("target", evaluators.bleu.BLEU)]
logging_period=5
validation_period=1000
random_seed={seed}

[train_data]
class=dataset.load_dataset_from_files
s_source="{tmp}/train.src"
s_target="{tmp}/train.tgt"
lazy=False

[val_data]
class=dataset.load_dataset_from_files
s_source="{tmp}/val.src"
s_target="{tmp}/val.tgt"

[trainer]
class=trainers.delayed_update_trainer.DelayedUpdateTrainer
batches_per_update=2
decoders=[<decoder>]
clip_norm=1.0
optimizer=<adam>

[adam]
class=tf.train.AdamOptimizer
learning_rate=<noam>
beta1=0.9
beta2=0.98
epsilon=1.0e-9

[noam]
class=functions.noam_decay
learning_rate=0.2
model_dimension={dim}
warmup_steps=10

"""


def write_transformer_ini(tmp: str, name: str, main_section: str,
                          keep: float, att_keep: float,
                          depth: int = T_DEPTH) -> str:
    """bench.py's Transformer (``build_transformer``) as an INI over the
    smoke's 30000 words: 512 wide, FFN 2048, 6 + 6 layers, 8 heads,
    tied target embeddings, label smoothing 0.1, beam 10 with length
    normalisation 0.6, 48 output steps."""
    path = os.path.join(tmp, name)
    sizes = dict(tmp=tmp, batch=BATCH, seed=SEED, dim=T_DIM, ff=T_FF,
                 depth=depth, heads=T_HEADS, src_len=SRC_LEN,
                 max_out=MAX_OUT, beam=BEAM, keep=keep, att_keep=att_keep)
    with open(path, "w") as f:
        f.write(main_section.format(**sizes) + T_MODEL_INI.format(**sizes))
    return path


def run_transformer_serving(tmp: str):
    """Phase 9: 128 sentences through ``run``, greedy and beam 10 with
    the einsum lineage step, then again with ``NM_LINEAGE_KERNEL=1``."""
    from neuralmonkey_tpu_torch.experiment import Experiment

    exp_ini = write_transformer_ini(tmp, "t_exp.ini", T_SERVING_MAIN, 1.0,
                                    1.0)
    data_ini = os.path.join(tmp, "t_data.ini")
    with open(data_ini, "w") as f:
        f.write(DATA_INI.format(tmp=tmp, prefix="t_"))
    exp = Experiment(exp_ini, train_mode=False)
    exp.build_model()
    ckpt = exp.tf_manager.save(os.path.join(tmp, "t_params"))
    outputs = [os.path.join(tmp, f"t_{name}.txt")
               for name in ("greedy", "beam")]
    launches, einsum_out = serve_through_run(
        exp_ini, data_ini, ckpt, T_SERVING_KERNELS, outputs,
        "transformer serving")
    # phase 29 holds its tensor-parallel decode against these
    for name, lines in einsum_out.items():
        with open(os.path.join(tmp, f"phase9_{name}"), "w") as f:
            f.writelines(line + "\n" for line in lines)
    os.environ["NM_LINEAGE_KERNEL"] = "1"
    try:
        lineage_launches, kernel_out = serve_through_run(
            exp_ini, data_ini, ckpt, T_SERVING_KERNELS + ("lineage_attention",),
            outputs, "transformer serving, NM_LINEAGE_KERNEL=1")
        speed = serving_speed(exp, ckpt, data_ini, exp.model.runners[1:],
                              " (lineage kernel)")
    finally:
        os.environ.pop("NM_LINEAGE_KERNEL")
    speed.update(serving_speed(exp, ckpt, data_ini, exp.model.runners))
    launches = {k: n + lineage_launches[k] for k, n in launches.items()}
    # the two lineage forms on the card: equal ids unless a near-tie
    # falls the other way (phase 10 holds each form to the CPU's)
    same = sum(a == b for a, b in zip(einsum_out["t_beam.txt"],
                                      kernel_out["t_beam.txt"]))
    report = {"mean_output_tokens": mean_lengths(einsum_out),
              "speed": speed,
              "beam_forms_identical": f"{same}/{N_SENTENCES}"}
    log(f"transformer serving: {report}")
    return launches, report, exp, exp_ini, data_ini, ckpt


# ---------------------------------------------------------------------- #
# phases 13-16: the flagship model with an LSTM encoder
# ---------------------------------------------------------------------- #
def run_lstm_serving(tmp: str):
    """Phase 13: 128 sentences through ``run``, greedy and beam 10 with
    the fused logit projection, then again with ``NM_FUSED_LOGITS=0``,
    where the selector reduces the plain logits with ``rowmax_lse``."""
    from neuralmonkey_tpu_torch.experiment import Experiment

    exp_ini, data_ini = write_inputs(tmp, "LSTM", "lstm_")
    exp = Experiment(exp_ini, train_mode=False)
    exp.build_model()
    ckpt = exp.tf_manager.save(os.path.join(tmp, "lstm_params"))
    outputs = [os.path.join(tmp, f"lstm_{name}.txt")
               for name in ("greedy", "beam")]
    launches, fused_out = serve_through_run(
        exp_ini, data_ini, ckpt, LSTM_SERVING_KERNELS, outputs,
        "lstm serving")
    speed = serving_speed(exp, ckpt, data_ini, exp.model.runners)
    os.environ["NM_FUSED_LOGITS"] = "0"
    try:
        unfused, unfused_out = serve_through_run(
            exp_ini, data_ini, ckpt, LSTM_UNFUSED_KERNELS, outputs,
            "lstm serving, NM_FUSED_LOGITS=0")
        speed.update(serving_speed(exp, ckpt, data_ini, exp.model.runners[1:],
                                   " (NM_FUSED_LOGITS=0)"))
    finally:
        os.environ.pop("NM_FUSED_LOGITS")
    wrong = [k for k, n in (("gru_scan", launches["gru_scan"]
                             + unfused["gru_scan"]),
                            ("rowmax_lse", launches["rowmax_lse"]),
                            ("fused_logits_rowmax_lse",
                             unfused["fused_logits_rowmax_lse"])) if n]
    if wrong:
        raise AssertionError(f"lstm serving launched {wrong}: the GRU scan "
                             "in the LSTM model, or the reductions of the "
                             "other selection form")
    launches = {k: n + unfused[k] for k, n in launches.items()}
    # the two selection forms on the card: equal ids unless a near-tie
    # falls the other way (phase 14 holds each form to the CPU's)
    same = sum(a == b for a, b in zip(fused_out["lstm_beam.txt"],
                                      unfused_out["lstm_beam.txt"]))
    report = {"mean_output_tokens": mean_lengths(fused_out), "speed": speed,
              "beam_forms_identical": f"{same}/{N_SENTENCES}"}
    log(f"lstm serving: {report}")
    return launches, report, exp, exp_ini, data_ini, ckpt


def check_lstm_parity(exp_ini: str, data_ini: str, gpu_exp, ckpt: str):
    """Phase 14: phase 5's rule for the LSTM model, with the fused logit
    projection and under ``NM_FUSED_LOGITS=0``."""
    report = {"fused": check_parity(exp_ini, data_ini, gpu_exp, ckpt)}
    os.environ["NM_FUSED_LOGITS"] = "0"
    try:
        report["unfused"] = check_parity(exp_ini, data_ini, gpu_exp, ckpt)
    finally:
        os.environ.pop("NM_FUSED_LOGITS")
    return report


# ---------------------------------------------------------------------- #
# phase 18: the task heads
# ---------------------------------------------------------------------- #
HEADS_INI = """\
[main]
name="chip smoke task heads"
tf_manager=<tf_manager>
output="{out}"
batch_size={batch}
epochs=1
train_dataset=<train_data>
trainer=<trainer>
runners=[<runner>]
random_seed={seed}

[tf_manager]
class=tf_manager.TensorFlowManager
num_sessions=1

[vocabulary]
class=vocabulary.from_wordlist
path="{tmp}/words.txt"

[tag_vocabulary]
class=vocabulary.from_wordlist
path="{tmp}/tags.txt"

[train_data]
class=dataset.load_dataset_from_files
s_source="{tmp}/train.src"
s_target="{tmp}/train.tgt"
s_tags="{tmp}/train.tags"
s_align="{tmp}/train.align"
lazy=False

[encoder]
class=encoders.recurrent.SentenceEncoder
name="sentence_encoder"
rnn_size={rnn}
max_input_len={src_len}
embedding_size={emb}
data_id="source"
vocabulary=<vocabulary>

[attention]
class=attention.feed_forward.Attention
name="attention"
encoder=<encoder>
state_size={att}

[decoder]
class=decoders.decoder.Decoder
name="decoder"
encoders=[<encoder>]
attentions=[<attention>]
rnn_size={rnn}
embedding_size={emb}
maxout_size={emb}
conditional_gru=True
data_id="target"
max_output_len={tgt_len}
vocabulary=<vocabulary>

[labeler]
class=decoders.sequence_labeler.SequenceLabeler
name="labeler"
encoder=<encoder>
data_id="tags"
vocabulary=<tag_vocabulary>
hidden_dim={rnn}

[alignment_decoder]
class=decoders.word_alignment_decoder.WordAlignmentDecoder
name="alignment_decoder"
encoder=<encoder>
decoder=<decoder>
data_id="align"

[trainer]
class=trainers.cross_entropy_trainer.CrossEntropyTrainer
decoders=[<decoder>, <labeler>, <alignment_decoder>]
decoder_weights=[1.0, 1.0, 0.5]
clip_norm=1.0
optimizer=<adam>

[adam]
class=tf.train.AdamOptimizer
learning_rate=0.001

[runner]
class=runners.label_runner.LabelRunner
decoder=<labeler>
output_series="tags"
"""
N_TAGS = 16
# tests/test_capability_inis.py's gates: INI, metric, comparison, limit,
# and the kernels its model must launch on the card
INI_GATES = (
    ("labeler.ini", "tags/Accuracy", ">", 0.5, ("gru_scan", "gru_bptt")),
    ("language_model.ini", "xents", ">", 0.0, ()),
    ("post_edit.ini", "edits_out/BLEU-4", ">", 10.0,
     ("gru_scan", "gru_bptt", "fused_bahdanau_step")),
    ("regressor.ini", "score/MSE", "<", 0.01, ("gru_scan", "gru_bptt")),
    ("alignment.ini", "target/BLEU-4", ">", 20.0,
     ("gru_scan", "gru_bptt", "fused_bahdanau_step")),
    ("str.ini", "target/MSE", "<", 2.0, ()))


def check_task_heads(tmp: str):
    """The labeler and the word-alignment decoder over the flagship
    encoder and decoder at full width, on phase 6's synthetic pairs with
    a tag for each source word (its id modulo 16) and the alignment of
    each target word to the source word it maps from: the loss and
    every gradient of one training step on the card against the CPU by
    phase 7's rule, with phase 12's float64 reference (the labeler's ReLU
    followed as there), and the
    labeler's tags on the card equal to the CPU's or different only
    where the CPU's top-two logit gap is below 1e-3. Then the six
    task-head INIs of tests/configs train on the card, each to its gate
    of tests/test_capability_inis.py with a falling loss, launching the
    kernels its model runs. Returns (the INI runs' launches, report)."""
    import torch

    from neuralmonkey_tpu_torch.experiment import Experiment
    from neuralmonkey_tpu_torch.model.part import Context

    with open(os.path.join(tmp, "tags.txt"), "w") as f:
        f.write("\n".join(f"t{i}" for i in range(N_TAGS)) + "\n")
    with open(os.path.join(tmp, "train.src")) as f:
        sources = f.read().splitlines()
    with open(os.path.join(tmp, "train.tags"), "w") as f:
        f.writelines(" ".join(f"t{int(w[1:]) % N_TAGS}" for w in line.split())
                     + "\n" for line in sources)
    # phase 6's target word j maps from source word j, then from j - 32
    with open(os.path.join(tmp, "train.align"), "w") as f:
        f.writelines(" ".join(f"{j % SRC_LEN}-{j}"
                              for j in range(TGT_LEN - 1)) + "\n"
                     for _ in sources)
    ini = os.path.join(tmp, "heads.ini")
    with open(ini, "w") as f:
        f.write(HEADS_INI.format(
            tmp=tmp, out=os.path.join(tmp, "heads_out"), batch=BATCH,
            seed=SEED, rnn=RNN, src_len=SRC_LEN, emb=EMB, att=ATT,
            tgt_len=TGT_LEN))
    exp = Experiment(ini, train_mode=True)
    exp.build_model()
    ckpt = exp.tf_manager.save(os.path.join(tmp, "heads_params"))
    del exp
    # against a float64 CPU step, as phase 12: the attention key bias's
    # gradient under the alignment loss is a small difference of large
    # float32 sums (the softmax backward's rows sum to 0)
    report = {"training_parity": check_train_parity(
        ini, ckpt, ("encoder", "attention", "decoder", "labeler"),
        float64=True)}

    def tag_logits(device_change):
        exp = Experiment(ini, train_mode=False, config_changes=device_change)
        exp.build_model()
        exp.tf_manager.restore(ckpt)
        dataset = exp.model.train_dataset.subset(0, N_PARITY)
        batch, _ = exp.tf_manager.build_batch(dataset, N_PARITY)
        labeler = exp.model.runners[0].decoder
        with torch.inference_mode():
            ctx = Context(exp.tf_manager.params, batch)
            return (labeler.logits(ctx).cpu(),
                    labeler.input_mask(ctx).cpu() > 0)
    gpu_logits, valid = tag_logits([])
    cpu_logits, _ = tag_logits(['tf_manager.device="cpu"'])
    differ = (gpu_logits.argmax(-1) != cpu_logits.argmax(-1)) & valid
    top2 = cpu_logits.topk(2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1])[differ]
    report["labeler_tags"] = {"positions": int(valid.sum()),
                              "differing": int(differ.sum()),
                              "largest_gap_where_differing":
                                  float(gaps.max()) if len(gaps) else None}
    if len(gaps) and not float(gaps.max()) < MARGIN:
        raise AssertionError(f"labeler tags differ where the CPU's top-two "
                             f"gap is {float(gaps.max())} >= {MARGIN}")

    return train_to_gates(tmp, INI_GATES, report), report


def train_to_gates(tmp: str, gates, report):
    """Train each INI of tests/configs in ``gates`` (INI, metric,
    comparison, limit, kernels) on the card with the launch counts set to
    0 just before it: a falling loss, its last validation's metric past
    the limit, every kernel named launched. Adds each run's record to
    ``report``; returns the runs' summed launches."""
    import torch

    from neuralmonkey_tpu_torch.experiment import Experiment
    from neuralmonkey_tpu_torch.ops import kernel_config

    compare = {">": lambda a, b: a > b, "<": lambda a, b: a < b,
               ">=": lambda a, b: a >= b}
    launches = None
    cwd = os.getcwd()
    os.chdir(REPO)  # the INIs name their data relative to the checkout
    try:
        for name, metric, op, limit, kernels in gates:
            out = os.path.join(tmp, f"ini_{name}")
            exp = Experiment(os.path.join(REPO, "tests", "configs", name),
                             train_mode=True, config_changes=[
                                 f'main.output="{out}"',
                                 "main.logging_period=10"])
            kernel_config.reset_launch_counts()
            start = time.perf_counter()
            exp.train()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            counts = kernel_config.launch_counts()
            launches = counts if launches is None else {
                k: n + counts[k] for k, n in launches.items()}
            with open(os.path.join(out, "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f]
            train = [r for r in records if r["kind"] == "train"]
            val = [r for r in records if r["kind"] == "val"]
            value = val[-1][metric]
            report[name] = {metric: value, "first_loss": train[0]["loss"],
                            "last_loss": train[-1]["loss"],
                            "seconds": seconds,
                            "launches": {k: counts[k] for k in kernels}}
            log(f"task head {name}: {report[name]}")
            if not train[-1]["loss"] < train[0]["loss"]:
                raise AssertionError(f"{name}: the loss did not fall")
            if not compare[op](value, limit):
                raise AssertionError(f"{name}: {metric} {value} not {op} "
                                     f"{limit}")
            missing = [k for k in kernels if counts[k] == 0]
            if missing:
                raise AssertionError(f"{name}: kernels never launched: "
                                     f"{missing}")
    finally:
        os.chdir(cwd)
    return launches


# ---------------------------------------------------------------------- #
# phase 19: multimodal MT and captioning at full width
# ---------------------------------------------------------------------- #
MMT_VOCAB, CAP_VOCAB, MMT_OUT, CAP_OUT = 20000, 15000, 50, 24
IMAGE = (14, 14, 512)
N_MMT_TRAIN = 4 * BATCH
MMT_KERNELS = ("gru_scan", "fused_bahdanau_step", "fused_logits_rowmax_lse",
               "small_topk")
MMT_TRAINING_KERNELS = ("gru_scan", "gru_bptt", "fused_bahdanau_step",
                        "fused_logits_rowmax_lse", "small_topk")

# examples/multimodal_mt.ini's model: a BiGRU 512 over the text, a 14 x 14
# x 512 map projected to 512, a Bahdanau attention of 512 over each and a
# hierarchical attention of 512 over both, a GRU decoder of 512
MMT_INI = """\
[main]
name="chip smoke multimodal"
tf_manager=<tf_manager>
output="{out}"
overwrite_output_dir=True
batch_size={batch}
epochs=1
train_dataset=<train_data>
val_dataset=<val_data>
trainer=<trainer>
runners=[<runner>, <bs_runner>]
evaluation=[("target", evaluators.bleu.BLEU)]
logging_period=2
validation_period=1000
random_seed={seed}

[tf_manager]
class=tf_manager.TensorFlowManager
num_sessions=1

[vocabulary]
class=vocabulary.from_wordlist
path="{tmp}/mmt_words.txt"

[train_data]
class=dataset.load_dataset_from_files
s_source="{tmp}/mmt_train.src"
s_target="{tmp}/mmt_train.tgt"
s_feats=("{tmp}/mmt_train_feats.npy", readers.numpy_reader.single_tensor)

[val_data]
class=dataset.load_dataset_from_files
s_source="{tmp}/mmt_val.src"
s_target="{tmp}/mmt_val.tgt"
s_feats=("{tmp}/mmt_val_feats.npy", readers.numpy_reader.single_tensor)

[text_encoder]
class=encoders.recurrent.SentenceEncoder
name="text_encoder"
rnn_size={rnn}
max_input_len=50
embedding_size={emb}
dropout_keep_prob=0.8
data_id="source"
vocabulary=<vocabulary>

[image_encoder]
class=encoders.numpy_stateful_filler.SpatialFiller
name="image_encoder"
input_shape=[{h}, {w}, {c}]
projection_dim={att}
data_id="feats"

[text_attention]
class=attention.feed_forward.Attention
name="text_attention"
encoder=<text_encoder>
state_size={att}

[image_attention]
class=attention.feed_forward.Attention
name="image_attention"
encoder=<image_encoder>
state_size={att}

[attention]
class=attention.combination.HierarchicalMultiAttention
name="hier_attention"
attentions=[<text_attention>, <image_attention>]
attention_state_size={att}

[decoder]
class=decoders.decoder.Decoder
name="decoder"
encoders=[<text_encoder>, <image_encoder>]
attentions=[<attention>]
rnn_size={rnn}
embedding_size={emb}
dropout_keep_prob=0.8
data_id="target"
max_output_len={max_out}
vocabulary=<vocabulary>

[bs_decoder]
class=decoders.beam_search_decoder.BeamSearchDecoder
name="bs_decoder"
parent_decoder=<decoder>
beam_size={beam}
length_normalization=0.6

[trainer]
class=trainers.cross_entropy_trainer.CrossEntropyTrainer
decoders=[<decoder>]
clip_norm=1.0
optimizer=<adam>

[adam]
class=tf.train.AdamOptimizer
learning_rate=0.001

[runner]
class=runners.runner.GreedyRunner
decoder=<decoder>
output_series="target"

[bs_runner]
class=runners.beam_search_runner.BeamSearchRunner
decoder=<bs_decoder>
output_series="target_beam"
"""

MMT_DATA_INI = """\
[main]
test_datasets=[<test_data>]

[test_data]
class=dataset.load_dataset_from_files
s_source="{tmp}/mmt_{split}.src"
s_feats=("{tmp}/mmt_{split}_feats.npy", readers.numpy_reader.single_tensor)
s_target_out="{out}/greedy.txt"
s_target_beam_out="{out}/beam.txt"
"""

# examples/captioning.ini's model: the 14 x 14 x 512 map as it is, a
# Bahdanau attention of 512, a GRU decoder of 512, greedy
CAPTIONING_INI = """\
[main]
name="chip smoke captioning"
tf_manager=<tf_manager>
output="{tmp}/cap_out"
batch_size={batch}
runners=[<runner>]
random_seed={seed}

[tf_manager]
class=tf_manager.TensorFlowManager
num_sessions=1

[vocabulary]
class=vocabulary.from_wordlist
path="{tmp}/cap_words.txt"

[encoder]
class=encoders.numpy_stateful_filler.SpatialFiller
name="encoder"
data_id="feats"
input_shape=[{h}, {w}, {c}]

[attention]
class=attention.feed_forward.Attention
name="attention"
encoder=<encoder>
state_size={att}

[decoder]
class=decoders.decoder.Decoder
name="decoder"
vocabulary=<vocabulary>
data_id="caption"
max_output_len={max_out}
rnn_size={rnn}
embedding_size={emb}
encoders=[<encoder>]
attentions=[<attention>]

[runner]
class=runners.runner.GreedyRunner
decoder=<decoder>
output_series="caption"
"""

CAPTIONING_DATA_INI = """\
[main]
test_datasets=[<test_data>]

[test_data]
class=dataset.load_dataset_from_files
s_feats=("{tmp}/mmt_test_feats.npy", readers.numpy_reader.single_tensor)
s_caption_out="{tmp}/caption.txt"
"""


def write_multimodal_inputs(tmp: str):
    """Synthetic multimodal data from the seed: the 20000- and 15000-word
    vocabularies; 128 test, 256 training and 64 validation sentences of
    32 words from the first 2000, each with a 14 x 14 x 512 map of
    uniform features in [0, 1) and, for training, the target of phase 6
    (the source and its first 15 words through a fixed map); the INIs.
    Returns (the MMT INI, its serving data INI, the captioning INI, its
    data INI)."""
    import numpy as np
    rng = np.random.RandomState(SEED + 19)
    for name, size in (("mmt_words.txt", MMT_VOCAB),
                       ("cap_words.txt", CAP_VOCAB)):
        with open(os.path.join(tmp, name), "w") as f:
            f.write("\n".join(f"w{i}" for i in range(size - 4)) + "\n")
    for split, count in (("test", N_SENTENCES), ("train", N_MMT_TRAIN),
                         ("val", N_VAL)):
        src = rng.randint(0, SOURCE_WORDS, (count, SRC_LEN))
        tgt = (np.concatenate([src, src[:, :TGT_LEN - SRC_LEN - 1]], axis=1)
               * 7919 + 13) % (MMT_VOCAB - 4)
        for name, ids in (("src", src), ("tgt", tgt)):
            with open(os.path.join(tmp, f"mmt_{split}.{name}"), "w") as f:
                f.writelines(" ".join(f"w{i}" for i in row) + "\n"
                             for row in ids)
        np.save(os.path.join(tmp, f"mmt_{split}_feats.npy"),
                rng.rand(count, *IMAGE).astype(np.float32))
    os.makedirs(os.path.join(tmp, "mmt_serve"), exist_ok=True)
    widths = dict(tmp=tmp, batch=BATCH, seed=SEED, rnn=RNN, emb=EMB,
                  att=ATT, beam=BEAM, h=IMAGE[0], w=IMAGE[1], c=IMAGE[2])
    paths = []
    for name, text in (
            ("mmt.ini", MMT_INI.format(out=os.path.join(tmp, "mmt_out"),
                                       max_out=MMT_OUT, **widths)),
            ("mmt_data.ini", MMT_DATA_INI.format(
                tmp=tmp, split="test", out=os.path.join(tmp, "mmt_serve"))),
            ("cap.ini", CAPTIONING_INI.format(max_out=CAP_OUT, **widths)),
            ("cap_data.ini", CAPTIONING_DATA_INI.format(tmp=tmp))):
        paths.append(os.path.join(tmp, name))
        with open(paths[-1], "w") as f:
            f.write(text)
    return paths


def image_attention_records(device):
    """K2 at the image shapes against its plain version: T 196 (14 x 14),
    A 512, D 512 at B 64 (greedy) and B 640 (the hierarchical children's
    constants tiled to B·K rows under beam 10): weights to 1e-5 and the
    context to 1e-4, each timed back to back, with the L2 cache flushed,
    beside its plain version and its bound."""
    import torch

    from neuralmonkey_tpu_torch.ops import cuda_attention, kernel_config

    gen = torch.Generator().manual_seed(SEED + 190)
    records = {}
    time_, dim = IMAGE[0] * IMAGE[1], ATT
    for batch in (BATCH, BATCH * BEAM):
        def randn(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen) * scale).to(device)
        args = (randn(batch, time_, ATT), randn(batch, time_, dim),
                torch.ones(batch, time_, device=device), randn(batch, ATT),
                randn(ATT, scale=ATT ** -0.5))
        got = cuda_attention.fused_bahdanau_step(*args)
        ref = cuda_attention.bahdanau_reference(*args)
        errs = (max_err(got[1], ref[1]), max_err(got[0], ref[0]))
        log(f"fused_bahdanau_step image ({batch}, {time_}, {ATT}, {dim}): "
            f"max_abs_err weights {errs[0]:.3g}, context {errs[1]:.3g}")
        if not (errs[0] <= 1e-5 and errs[1] <= 1e-4):
            raise AssertionError(f"fused_bahdanau_step at the image shape "
                                 f"B {batch}: errors {errs}")

        def step():
            return cuda_attention.fused_bahdanau_step(*args)
        bound_ms, bound_by = bound(
            batch * time_ * (4 * ATT + 2 * dim),
            4 * (batch * time_ * (ATT + dim + 2) + batch * ATT + ATT
                 + batch * dim))
        records[f"B{batch}_T{time_}_A{ATT}_D{dim}"] = {
            "max_abs_err": max(errs), "ms": time_ms(step),
            "l2_flushed_ms": flushed_ms(step),
            "plain_ms": time_ms(
                lambda: cuda_attention.bahdanau_reference(*args)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "plan": cuda_attention.bahdanau_plan(
                batch, time_, ATT, dim,
                *kernel_config.device_limits(device.index or 0))._asdict()}
        log(f"fused_bahdanau_step image B {batch}: "
            f"{records[f'B{batch}_T{time_}_A{ATT}_D{dim}']}")
    return records


def check_multimodal(tmp: str, device):
    """Phase 19. The MMT model decodes the 128 test sentences greedily
    and with beam 10 through ``run``, the captioning model greedily; the
    MMT model trains 4 steps through ``train`` (one epoch, one validation,
    ``run`` from its checkpoint); each run must launch its kernels. 8
    sentences of each serving model against the CPU by phase 5's rule,
    one training step of the MMT model by phase 12's float64 rule, and
    K2 at the image shapes against its plain version. Returns (the
    launches of the runs, the report, K2's records)."""
    from neuralmonkey_tpu_torch.experiment import Experiment
    from neuralmonkey_tpu_torch.models.attention import feed_forward

    mmt_ini, mmt_data_ini, cap_ini, cap_data_ini = write_multimodal_inputs(
        tmp)
    report = {}
    launches = None
    # K2's launches in the runs below by (B, T): each call of its wrapper
    # on the card's tensors is one launch
    by_shape = {}
    plain_step = feed_forward.fused_bahdanau_step

    def tallied_step(keys, *args):
        shape = "B{}_T{}".format(*keys.shape[:2])
        by_shape[shape] = by_shape.get(shape, 0) + 1
        return plain_step(keys, *args)
    for label, ini, data_ini, expected, outputs in (
            ("multimodal", mmt_ini, mmt_data_ini, MMT_KERNELS,
             ("mmt_serve/greedy.txt", "mmt_serve/beam.txt")),
            ("captioning", cap_ini, cap_data_ini, ("fused_bahdanau_step",),
             ("caption.txt",))):
        exp = Experiment(ini, train_mode=False)
        exp.build_model()
        ckpt = exp.tf_manager.save(os.path.join(tmp, f"{label}_params"))
        feed_forward.fused_bahdanau_step = tallied_step
        try:
            counts, lines = serve_through_run(
                ini, data_ini, ckpt, expected,
                [os.path.join(tmp, name) for name in outputs], label)
        finally:
            feed_forward.fused_bahdanau_step = plain_step
        launches = counts if launches is None else {
            k: n + counts[k] for k, n in launches.items()}
        report[label] = {
            "mean_output_tokens": mean_lengths(lines),
            "speed": serving_speed(exp, ckpt, data_ini, exp.model.runners),
            "launches": {k: counts[k] for k in expected}}
        report[label]["parity"] = check_parity(ini, data_ini, exp, ckpt)
        log(f"{label}: {report[label]}")
        del exp
    feed_forward.fused_bahdanau_step = tallied_step
    try:
        counts, record, best = run_training(
            tmp, mmt_ini, False, "mmt_train", MMT_TRAINING_KERNELS,
            MMT_DATA_INI.replace("{split}", "val"))
    finally:
        feed_forward.fused_bahdanau_step = plain_step
    launches = {k: n + counts[k] for k, n in launches.items()}
    report["training"] = record
    report["fused_bahdanau_step_launches_by_shape"] = by_shape
    log(f"multimodal: K2 launches by shape {by_shape}")
    report["training_parity"] = check_train_parity(
        mmt_ini, best, ("text_encoder", "decoder"), float64=True)
    return launches, report, image_attention_records(device)


# ---------------------------------------------------------------------- #
# phase 20: self-critical training of the flagship model
# ---------------------------------------------------------------------- #
N_SC_TRAIN = 4 * BATCH
SC_TRAINER = """\
[trainer]
class=trainers.rl_trainer.ReinforceTrainer
decoders=[<decoder>]
self_critical=True
xent_weight=0.5
clip_norm=1.0
optimizer=<adam>
"""


def sampling_replay():
    """A ``check_train_parity`` hook: the first pass (the card's) records
    the decoder's sampled and greedy ids; every later pass takes those
    ids instead of drawing or decoding its own, so each device scores
    the same sequences."""
    recorded = {}

    def hook(exp):
        decoder = exp.model.trainer.objectives[0].decoder
        if not recorded:
            draws, plain_draw = [], decoder.draw_samples
            plain_greedy = decoder.greedy_ids

            def draw(log_probs, generator):
                ids = plain_draw(log_probs, generator)
                draws.append(ids.cpu())
                return ids

            def greedy(ctx):
                recorded["greedy"] = plain_greedy(ctx).cpu()
                return recorded["greedy"].to(ctx.batch[
                    decoder.target_ids_key].device)
            recorded["draws"] = draws
            decoder.draw_samples, decoder.greedy_ids = draw, greedy
            return
        columns = iter(recorded["draws"])
        decoder.draw_samples = lambda log_probs, generator: next(
            columns).to(log_probs.device)
        decoder.greedy_ids = lambda ctx: recorded["greedy"].to(
            ctx.batch[decoder.target_ids_key].device)
    return hook


def check_self_critical(tmp: str):
    """Phase 20. The flagship model of phase 6 trains 4 steps through
    ``train`` with ``ReinforceTrainer`` (self-critical, the greedy decode
    as baseline, GLEU rewards on the host, cross-entropy at 0.5, clip
    1.0, Adam) on the first 256 of phase 6's pairs, with one validation
    and ``run`` from its checkpoint, launching K1, the BPTT, K2, K3 and
    K4; its losses must be finite. Then one step on 8 sentences against
    the CPU, the card's sampled and greedy ids replayed there, by phase
    12's float64 rule. Returns (the training's launches, report)."""
    import math

    for name in ("src", "tgt"):
        with open(os.path.join(tmp, f"train.{name}")) as f:
            lines = f.readlines()[:N_SC_TRAIN]
        with open(os.path.join(tmp, f"sc_train.{name}"), "w") as f:
            f.writelines(lines)
    with open(os.path.join(tmp, "train.ini")) as f:
        text = f.read()
    trainer = text[text.index("[trainer]"):text.index("[adam]")]
    text = (text.replace(trainer, SC_TRAINER + "\n")
            .replace(f'"{tmp}/train.', f'"{tmp}/sc_train.')
            .replace("logging_period=5", "logging_period=2"))
    sc_ini = os.path.join(tmp, "sc_train.ini")
    with open(sc_ini, "w") as f:
        f.write(text)
    launches, record, best = run_training(
        tmp, sc_ini, False, "sc_train", MMT_TRAINING_KERNELS, falling=False)
    if not all(math.isfinite(loss) for loss in record["losses"]):
        raise AssertionError(f"self-critical losses {record['losses']}")
    report = {"training": record, "training_parity": check_train_parity(
        sc_ini, best, float64=True, hook=sampling_replay())}
    return launches, report

# ---------------------------------------------------------------------- #
# phases 21-23: the CNN encoders, the MoE Transformer and CTC speech
# ---------------------------------------------------------------------- #
def swap_section(text: str, name: str, section: str) -> str:
    """``text`` with its INI section ``[name]`` replaced by ``section``."""
    start = text.index(f"[{name}]\n")
    end = text.find("\n[", start)
    return text[:start] + section + (text[end + 1:] if end >= 0 else "")


def first_lines(tmp: str, names, count: int, prefix: str) -> None:
    """Copy the first ``count`` lines of each file ``names`` under ``tmp``
    to ``{prefix}{name}``."""
    for name in names:
        with open(os.path.join(tmp, name)) as f:
            lines = f.readlines()[:count]
        with open(os.path.join(tmp, prefix + name), "w") as f:
            f.writelines(lines)


def timed(seconds, key: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall seconds stored as
    ``seconds[key]``."""
    start = time.perf_counter()
    out = fn(*args, **kwargs)
    seconds[key] = time.perf_counter() - start
    return out


def add_launches(total, counts):
    return counts if total is None else {k: n + counts[k]
                                         for k, n in total.items()}


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def relative_err(got, ref) -> float:
    return max_err(got, ref) / max(float(ref.abs().max()), 1e-30)


# Lee, Cho & Hofmann (2017): filter widths 1-8, 2100 filters in all
LEE_FILTERS = [(1, 200), (2, 200), (3, 250), (4, 250), (5, 300), (6, 300),
               (7, 300), (8, 300)]
CNN_TRAINING_KERNELS = ("gru_scan", "gru_bptt", "fused_bahdanau_step")
CNN_ENCODER = """\
[encoder]
class=encoders.sentence_cnn_encoder.SentenceCNNEncoder
name="sentence_encoder"
filters={filters}
highway_depth=4
rnn_size={rnn}
max_input_len={src_len}
embedding_size={emb}
dropout_keep_prob={keep}
data_id="source"
vocabulary=<vocabulary>

"""
N_KIM_LABELS = 5
# Kim (2014): embeddings 300, widths 3, 4 and 5 with 100 filters each,
# dropout 0.5 before the softmax
KIM_INI = """\
[main]
name="chip smoke classifier"
tf_manager=<tf_manager>
output="{tmp}/kim_out"
batch_size={batch}
runners=[<runner>]
random_seed={seed}

[tf_manager]
class=tf_manager.TensorFlowManager
num_sessions=1

[vocabulary]
class=vocabulary.from_wordlist
path="{tmp}/words.txt"

[labels]
class=vocabulary.from_wordlist
path="{tmp}/kim_labels.txt"

[encoder]
class=encoders.sequence_cnn_encoder.SequenceCNNEncoder
name="encoder"
embedding_size=300
filters=[(3, 100), (4, 100), (5, 100)]
max_input_len={src_len}
data_id="source"
vocabulary=<vocabulary>

[classifier]
class=decoders.classifier.Classifier
name="classifier"
encoders=[<encoder>]
data_id="label"
vocabulary=<labels>
dropout_keep_prob=0.5

[runner]
class=runners.plain_runner.PlainRunner
decoder=<classifier>
output_series="label"
"""
# a VGG-style stack over 224 x 224 x 3 images
CNN_IMAGE, CNN_SPEC = (224, 224, 3), [("C", 3, 1, 64), ("C", 3, 1, 64),
                                      ("M", 2, 2), ("C", 3, 2, 128)]


def kim_labels(tmp: str):
    """Kim's classifier over phase 4's first 64 sentences: the labels on
    the card equal to the CPU's, or different only where the CPU's
    top-two logit gap is below 1e-3."""
    import torch

    from neuralmonkey_tpu_torch import run
    from neuralmonkey_tpu_torch.experiment import Experiment
    from neuralmonkey_tpu_torch.model.part import Context

    with open(os.path.join(tmp, "kim_labels.txt"), "w") as f:
        f.write("\n".join(f"l{i}" for i in range(N_KIM_LABELS)) + "\n")
    ini = os.path.join(tmp, "kim.ini")
    with open(ini, "w") as f:
        f.write(KIM_INI.format(tmp=tmp, batch=BATCH, seed=SEED,
                               src_len=SRC_LEN))
    dataset = run.load_data_config(os.path.join(tmp, "data.ini"))[0].subset(
        0, BATCH)
    ckpt = None

    def logits(change):
        nonlocal ckpt
        exp = Experiment(ini, train_mode=False, config_changes=change)
        exp.build_model()
        if ckpt is None:
            ckpt = exp.tf_manager.save(os.path.join(tmp, "kim_params"))
        exp.tf_manager.restore(ckpt)
        batch, _ = exp.tf_manager.build_batch(dataset, BATCH)
        classifier = exp.model.runners[0].decoder
        with torch.inference_mode():
            return classifier.logits(Context(exp.tf_manager.params,
                                             batch)).cpu()
    gpu, cpu = logits([]), logits(['tf_manager.device="cpu"'])
    differ = gpu.argmax(-1) != cpu.argmax(-1)
    top2 = cpu.topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1])[differ]
    report = {"sentences": BATCH, "differing": int(differ.sum()),
              "logits_max_abs_err": max_err(gpu, cpu),
              "largest_gap_where_differing":
                  float(gaps.max()) if len(gaps) else None}
    log(f"kim classifier: {report}")
    if len(gaps) and not float(gaps.max()) < MARGIN:
        raise AssertionError(f"Kim classifier labels differ where the CPU's "
                             f"top-two gap is {float(gaps.max())}")
    return report


def cnn_images_forward(device):
    """One ``CNNEncoder`` forward over 64 images of 224 x 224 x 3 on the
    card against the CPU: the states and the pooled output within 1e-4
    of their largest entry; the card's forward timed."""
    import torch

    from neuralmonkey_tpu_torch.model.part import (Context, collect_parts,
                                                   init_all_params)
    from neuralmonkey_tpu_torch.models.encoders.cnn_encoder import CNNEncoder

    enc = CNNEncoder(name="cnn", data_id="images", convolutions=CNN_SPEC,
                     image_height=CNN_IMAGE[0], image_width=CNN_IMAGE[1],
                     pixel_dim=CNN_IMAGE[2], batch_normalize=True)
    params = init_all_params(collect_parts([enc]), seed=SEED)
    images = torch.rand(BATCH, *CNN_IMAGE,
                        generator=torch.Generator().manual_seed(SEED + 21))

    def forward(dev_params, dev_images):
        with torch.inference_mode():
            ctx = Context(dev_params, {"cnn.images": dev_images})
            return enc.spatial_states(ctx), enc.output(ctx)
    gpu_params = to_device(params, device)
    gpu_images = images.to(device)
    states, out = forward(gpu_params, gpu_images)
    ref_states, ref_out = forward(params, images)
    errs = {"spatial_states": relative_err(states.cpu(), ref_states),
            "output": relative_err(out.cpu(), ref_out)}
    report = {"images": list((BATCH, *CNN_IMAGE)),
              "states": list(states.shape), "relative_err": errs,
              "ms": time_ms(lambda: forward(gpu_params, gpu_images), runs=5)}
    log(f"cnn encoder forward: {report}")
    if not max(errs.values()) <= 1e-4:
        raise AssertionError(f"CNNEncoder on the card differs from the CPU: "
                             f"{errs}")
    return report


def check_cnn(tmp: str, device):
    """Phase 21. Returns (the launches of its runs, report)."""
    from neuralmonkey_tpu_torch.experiment import Experiment

    widths = dict(rnn=RNN, src_len=SRC_LEN, emb=EMB, filters=LEE_FILTERS)
    with open(os.path.join(tmp, "exp.ini")) as f:
        text = f.read()
    exp_ini = os.path.join(tmp, "cnn_exp.ini")
    with open(exp_ini, "w") as f:
        f.write(swap_section(text, "encoder",
                             CNN_ENCODER.format(keep=1.0, **widths)))
    data_ini = os.path.join(tmp, "cnn_data.ini")
    with open(data_ini, "w") as f:
        f.write(DATA_INI.format(tmp=tmp, prefix="cnn_"))
    seconds = {}
    exp = Experiment(exp_ini, train_mode=False)
    exp.build_model()
    ckpt = exp.tf_manager.save(os.path.join(tmp, "cnn_params"))
    launches, lines = timed(
        seconds, "run", serve_through_run, exp_ini, data_ini, ckpt,
        SERVING_KERNELS,
        [os.path.join(tmp, f"cnn_{name}.txt") for name in ("greedy", "beam")],
        "cnn serving")
    report = {"seconds": seconds, "serving": {
        "mean_output_tokens": mean_lengths(lines),
        "speed": serving_speed(exp, ckpt, data_ini, exp.model.runners,
                               warm_up=False),
        "launches": {k: launches[k] for k in SERVING_KERNELS}}}
    report["parity"] = timed(seconds, "parity", check_parity, exp_ini,
                             data_ini, exp, ckpt)
    del exp

    first_lines(tmp, ("train.src", "train.tgt"), 4 * BATCH, "cnn_")
    with open(os.path.join(tmp, "train.ini")) as f:
        text = f.read()
    text = (swap_section(text, "encoder",
                         CNN_ENCODER.format(keep=KEEP_PROB, **widths))
            .replace(f'"{tmp}/train.', f'"{tmp}/cnn_train.')
            .replace("logging_period=5", "logging_period=2"))
    train_ini = os.path.join(tmp, "cnn_train.ini")
    with open(train_ini, "w") as f:
        f.write(text)
    counts, report["training"], best = timed(
        seconds, "training", run_training, tmp, train_ini, False,
        "cnn_train", CNN_TRAINING_KERNELS)
    launches = add_launches(launches, counts)
    report["training_parity"] = timed(seconds, "training_parity",
                                      check_train_parity, train_ini, best,
                                      float64=True)
    report["kim_classifier"] = timed(seconds, "kim", kim_labels, tmp)
    report["cnn_encoder_images"] = timed(seconds, "cnn_encoder",
                                         cnn_images_forward, device)
    gates = (("sentence_cnn.ini", "target/BLEU-4", ">=", 0.0,
              CNN_TRAINING_KERNELS),
             ("classifier.ini", "label/AccuracySeqLevel", ">=", 0.0, ()))
    launches = add_launches(launches, timed(
        seconds, "gates", train_to_gates, tmp, gates, report))
    return launches, report


# the MoE Transformer's depth cut from bench.py's 6 + 6 to keep the
# smoke's time (its width and experts as they are)
MOE_EXPERTS, MOE_TRAIN_STEPS, MOE_DEPTH = 8, 8, 2
MOE_OPTIONS = """\
moe_experts={experts}
moe_top_k=2
moe_capacity_factor=1.5
moe_router_noise={noise}
moe_z_loss_weight=0.001
"""


def write_moe_ini(tmp: str, name: str, main_section: str, keep: float,
                  att_keep: float, noise: float) -> str:
    """bench.py's Transformer (``write_transformer_ini``) at MOE_DEPTH
    layers a part with a mixture of 8 experts, top-2 at capacity factor
    1.5, in every FFN."""
    path = write_transformer_ini(tmp, name, main_section, keep, att_keep,
                                 MOE_DEPTH)
    return add_part_options(path, MOE_OPTIONS.format(experts=MOE_EXPERTS,
                                                     noise=noise))


def add_part_options(path: str, options: str) -> str:
    """Add ``options`` (INI lines) to both Transformer parts of the INI at
    ``path``."""
    with open(path) as f:
        text = f.read()
    for key in ("n_heads", "n_heads_self"):
        line = f"\n{key}={T_HEADS}\n"
        if text.count(line) != 1:
            raise AssertionError(f"{path}: no single {line.strip()}")
        text = text.replace(line, line + options)
    with open(path, "w") as f:
        f.write(text)
    return path


def check_moe(tmp: str):
    """Phase 22. Returns (the launches of its runs, report)."""
    from neuralmonkey_tpu_torch.experiment import Experiment

    exp_ini = write_moe_ini(tmp, "moe_exp.ini", T_SERVING_MAIN, 1.0, 1.0, 0.0)
    data_ini = os.path.join(tmp, "moe_data.ini")
    with open(data_ini, "w") as f:
        f.write(DATA_INI.format(tmp=tmp, prefix="moe_"))
    seconds = {}
    exp = Experiment(exp_ini, train_mode=False)
    exp.build_model()
    ckpt = exp.tf_manager.save(os.path.join(tmp, "moe_params"))
    outputs = [os.path.join(tmp, f"moe_{name}.txt")
               for name in ("greedy", "beam")]
    launches, einsum_out = timed(
        seconds, "run", serve_through_run, exp_ini, data_ini, ckpt,
        T_SERVING_KERNELS, outputs, "moe serving")
    speed = serving_speed(exp, ckpt, data_ini, exp.model.runners,
                          warm_up=False)
    parity = {"einsum": timed(seconds, "parity", check_parity, exp_ini,
                              data_ini, exp, ckpt)}
    os.environ["NM_LINEAGE_KERNEL"] = "1"
    try:
        counts, kernel_out = timed(
            seconds, "run_lineage_kernel", serve_through_run, exp_ini,
            data_ini, ckpt, T_SERVING_KERNELS + ("lineage_attention",),
            outputs, "moe serving, NM_LINEAGE_KERNEL=1")
        speed.update(serving_speed(exp, ckpt, data_ini,
                                   exp.model.runners[1:],
                                   " (lineage kernel)", warm_up=False))
        parity["lineage_kernel"] = timed(
            seconds, "parity_lineage_kernel", check_parity, exp_ini,
            data_ini, exp, ckpt)
    finally:
        os.environ.pop("NM_LINEAGE_KERNEL")
    launches = add_launches(launches, counts)
    same = sum(a == b for a, b in zip(einsum_out["moe_beam.txt"],
                                      kernel_out["moe_beam.txt"]))
    report = {"experts": MOE_EXPERTS, "seconds": seconds, "serving": {
        "mean_output_tokens": mean_lengths(einsum_out), "speed": speed,
        "beam_forms_identical": f"{same}/{N_SENTENCES}"}, "parity": parity}
    del exp

    first_lines(tmp, ("train.src", "train.tgt"), MOE_TRAIN_STEPS * BATCH,
                "moe_")
    train_ini = write_moe_ini(tmp, "moe_train.ini", T_TRAINING_MAIN, 0.9,
                              T_ATT_KEEP, 0.01)
    with open(train_ini) as f:
        text = f.read()
    with open(train_ini, "w") as f:
        f.write(text.replace(f'"{tmp}/train.', f'"{tmp}/moe_train.')
                .replace("logging_period=5", "logging_period=2"))
    counts, report["training"], best = timed(
        seconds, "training", run_training, tmp, train_ini, False,
        "moe_train", FLASH_KERNELS)
    launches = add_launches(launches, counts)
    # the router noise off: each framework draws its own numbers
    report["training_parity"] = timed(
        seconds, "training_parity", check_train_parity, train_ini, best,
        ("encoder", "decoder"), True,
        changes=[f"{part}.moe_router_noise=0.0"
                 for part in ("encoder", "decoder")])
    gates = (("moe.ini", "target/BLEU-4", ">=", 0.0, FLASH_KERNELS),)
    launches = add_launches(launches, timed(
        seconds, "gates", train_to_gates, tmp, gates, report))
    return launches, report


S_FEATS, S_FRAMES, S_BATCH, S_BEAM, S_CHARS = 40, 400, 32, 8, 28
S_LABELS = 40  # symbols in each transcript
SPEECH_KERNELS = ("gru_scan", "gru_bptt")
SPEECH_INI = """\
[main]
name="chip smoke speech"
tf_manager=<tf_manager>
output="{tmp}/speech_out"
overwrite_output_dir=True
batch_size={batch}
epochs=1
train_dataset=<train_data>
val_dataset=<val_data>
trainer=<trainer>
runners=[<runner>, <bs_runner>]
evaluation=[("transcript", evaluators.wer.WER)]
logging_period=2
validation_period=1000
random_seed={seed}

[tf_manager]
class=tf_manager.TensorFlowManager
num_sessions=1
minimize_metric=True

[vocabulary]
class=vocabulary.from_wordlist
path="{tmp}/chars.txt"

[train_data]
class=dataset.load_dataset_from_files
s_speech=("{tmp}/speech_train.npy", readers.numpy_reader.single_tensor)
s_transcript="{tmp}/speech_train.txt"
lazy=False

[val_data]
class=dataset.load_dataset_from_files
s_speech=("{tmp}/speech_val.npy", readers.numpy_reader.single_tensor)
s_transcript="{tmp}/speech_val.txt"

[encoder]
class=encoders.raw_rnn_encoder.RawRNNEncoder
name="encoder"
data_id="speech"
input_size={feats}
rnn_size={rnn}

[decoder]
class=decoders.ctc_decoder.CTCDecoder
name="decoder"
encoder=<encoder>
vocabulary=<vocabulary>
data_id="transcript"

[bs_decoder]
class=decoders.ctc_decoder.CTCDecoder
name="bs_decoder"
reuse=<decoder>
encoder=<encoder>
vocabulary=<vocabulary>
data_id="transcript"
beam_width={beam}

[trainer]
class=trainers.cross_entropy_trainer.CrossEntropyTrainer
decoders=[<decoder>]
clip_norm=1.0
optimizer=<adam>

[adam]
class=tf.train.AdamOptimizer
learning_rate=0.005

[runner]
class=runners.plain_runner.PlainRunner
decoder=<decoder>
output_series="transcript"

[bs_runner]
class=runners.plain_runner.PlainRunner
decoder=<bs_decoder>
output_series="transcript_beam"
"""
SPEECH_DATA_INI = """\
[main]
test_datasets=[<test_data>]

[test_data]
class=dataset.load_dataset_from_files
s_speech=("{tmp}/speech_{split}.npy", readers.numpy_reader.single_tensor)
s_transcript_out="{out}/greedy.txt"
s_transcript_beam_out="{out}/beam.txt"
"""


def write_speech_inputs(tmp: str):
    """Synthetic utterances from the seed: 400 frames of 40 standard
    normal features each (4 s at a 10 ms hop, log-mel-sized), 128 to
    decode, 128 to train on (4 steps) and 64 to validate on, the latter
    two with transcripts of 40 symbols of 28 (one length, so that the
    batches' losses compare); the INI and the serving data INI."""
    import numpy as np
    rng = np.random.RandomState(SEED + 23)
    with open(os.path.join(tmp, "chars.txt"), "w") as f:
        f.write("\n".join(f"c{i}" for i in range(S_CHARS)) + "\n")
    for split, count in (("test", N_SENTENCES), ("train", 4 * S_BATCH),
                         ("val", N_VAL)):
        np.save(os.path.join(tmp, f"speech_{split}.npy"),
                rng.randn(count, S_FRAMES, S_FEATS).astype(np.float32))
        with open(os.path.join(tmp, f"speech_{split}.txt"), "w") as f:
            f.writelines(" ".join(f"c{i}" for i in rng.randint(
                0, S_CHARS, S_LABELS)) + "\n" for _ in range(count))
    ini = os.path.join(tmp, "speech.ini")
    with open(ini, "w") as f:
        f.write(SPEECH_INI.format(tmp=tmp, batch=S_BATCH, seed=SEED,
                                  feats=S_FEATS, rnn=RNN, beam=S_BEAM))
    os.makedirs(os.path.join(tmp, "speech_serve"), exist_ok=True)
    data_ini = os.path.join(tmp, "speech_data.ini")
    with open(data_ini, "w") as f:
        f.write(SPEECH_DATA_INI.format(tmp=tmp, split="test", out=os.path.join(
            tmp, "speech_serve")))
    return ini, data_ini


class SortLog:
    """Stands in for ``torch`` in the CTC decoder's module and keeps the
    values and indices of every sort over rows of ``width`` entries (the
    prefix beam search's candidates), on the host."""

    def __init__(self, width: int) -> None:
        import torch
        self._torch, self.width, self.log = torch, width, []

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def sort(self, x, *args, **kwargs):
        out = self._torch.sort(x, *args, **kwargs)
        if x.dim() == 2 and x.shape[1] == self.width:
            self.log.append((out.values.cpu(), out.indices.cpu()))
        return out


def check_speech_parity(ini: str, data_ini: str, gpu_exp, ckpt: str):
    """The first 32 utterances on the card and the CPU: greedy ids equal,
    or their first differing frame argmax a near-tie on the CPU (top-two
    gap below 1e-3); the beam's best prefixes equal, or the searches
    first choosing differently (a valid frame, slot j) where the CPU's
    gap between its candidates j and j + 1 is below 1e-3."""
    import torch

    from neuralmonkey_tpu_torch import run
    from neuralmonkey_tpu_torch.experiment import Experiment
    from neuralmonkey_tpu_torch.model.part import Context
    from neuralmonkey_tpu_torch.models.decoders import ctc_decoder

    dataset = run.load_data_config(data_ini)[0].subset(0, S_BATCH)
    cpu_exp = Experiment(ini, train_mode=False,
                         config_changes=['tf_manager.device="cpu"'])
    cpu_exp.build_model()
    cpu_exp.tf_manager.restore(ckpt)
    width = S_BEAM * (1 + S_CHARS + 4)

    def decode(exp):
        batch, _ = exp.tf_manager.build_batch(dataset, S_BATCH)
        greedy, beam = (r.decoder for r in exp.model.runners)
        sorts = SortLog(width)
        ctc_decoder.torch = sorts
        try:
            with torch.inference_mode():
                ctx = Context(exp.tf_manager.params, batch)
                out = (greedy.logits(ctx), greedy.decoded(ctx),
                       beam.beam_search(ctx)[0][:, 0],
                       greedy.encoder.temporal_mask(ctx) > 0)
                out = tuple(x.cpu() for x in out)
        finally:
            ctc_decoder.torch = torch
        return out + (sorts.log,)
    gpu = decode(gpu_exp)
    cpu = decode(cpu_exp)
    (cpu_logits, cpu_greedy, cpu_best, valid, cpu_sorts) = cpu
    (gpu_logits, gpu_greedy, gpu_best, _, gpu_sorts) = gpu
    report = {"utterances": S_BATCH,
              "logits_max_abs_err": max_err(gpu_logits, cpu_logits)}
    same = 0
    for row in range(S_BATCH):
        if torch.equal(cpu_greedy[row], gpu_greedy[row]):
            same += 1
            continue
        frames = ((cpu_logits[row].argmax(-1) != gpu_logits[row].argmax(-1))
                  & valid[row]).nonzero()
        if not len(frames):
            raise AssertionError(f"greedy CTC ids of utterance {row} differ "
                                 "though every frame's argmax is the same")
        frame = int(frames[0])
        top2 = cpu_logits[row, frame].topk(2).values
        gap = float(top2[0] - top2[1])
        log(f"speech parity greedy: utterance {row} first differs at frame "
            f"{frame}; CPU top-two gap {gap:.3g}")
        if not gap < MARGIN:
            raise AssertionError(f"greedy CTC ids of utterance {row} differ at "
                                 f"frame {frame}, CPU gap {gap} >= {MARGIN}")
    report["greedy"] = f"{same}/{S_BATCH} identical"
    same = diverged = 0
    for row in range(S_BATCH):
        ids_same = torch.equal(cpu_best[row], gpu_best[row])
        same += ids_same
        first = next(((t, int((c[1][row, :S_BEAM] != g[1][row, :S_BEAM])
                               .nonzero()[0]))
                      for t, (c, g) in enumerate(zip(cpu_sorts, gpu_sorts))
                      if valid[row, t] and not torch.equal(
                          c[1][row, :S_BEAM], g[1][row, :S_BEAM])), None)
        if first is None:
            if not ids_same:
                raise AssertionError(
                    f"beam prefixes of utterance {row} differ though every "
                    "frame chose the same candidates")
            continue
        diverged += 1
        frame, slot = first
        values = cpu_sorts[frame][0][row]
        gap = float(values[slot] - values[slot + 1])
        log(f"speech parity beam: utterance {row}: the searches first choose "
            f"differently at frame {frame}, slot {slot}; CPU gap {gap:.3g}; "
            f"best prefixes {'identical' if ids_same else 'differ'}")
        if not gap < MARGIN:
            raise AssertionError(
                f"beam search of utterance {row} diverges at frame {frame}, "
                f"slot {slot}, where the CPU's gap is {gap} >= {MARGIN}")
    report["beam"] = (f"{same}/{S_BATCH} identical, {diverged} searches "
                      "diverged at a near-tie")
    log(f"speech parity: {report}")
    return report


def beam_ops_per_frame(exp, data_ini: str) -> float:
    """Tensor operations a frame of the prefix beam search on one batch
    of the card: a count of the dispatched operations (views included)
    over the search, divided by its frames."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from neuralmonkey_tpu_torch import run
    from neuralmonkey_tpu_torch.model.part import Context
    from neuralmonkey_tpu_torch.models.decoders import ctc_decoder

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            return func(*args, **(kwargs or {}))
    dataset = run.load_data_config(data_ini)[0].subset(0, S_BATCH)
    batch, _ = exp.tf_manager.build_batch(dataset, S_BATCH)
    decoder = exp.model.runners[1].decoder
    with torch.inference_mode():
        ctx = Context(exp.tf_manager.params, batch)
        log_probs = torch.log_softmax(decoder.logits(ctx), dim=-1)
        valid = decoder.encoder.temporal_mask(ctx) > 0
        count = Count()
        with count:
            ctc_decoder.ctc_beam_search(log_probs, valid, S_BEAM)
    return count.ops / log_probs.shape[1]


def check_speech(tmp: str):
    """Phase 23. Returns (the launches of its runs, report)."""
    from neuralmonkey_tpu_torch.experiment import Experiment

    seconds = {}
    ini, data_ini = write_speech_inputs(tmp)
    exp = Experiment(ini, train_mode=False)
    exp.build_model()
    ckpt = exp.tf_manager.save(os.path.join(tmp, "speech_params"))
    launches, lines = timed(
        seconds, "run", serve_through_run, ini, data_ini, ckpt, ("gru_scan",),
        [os.path.join(tmp, "speech_serve", name)
         for name in ("greedy.txt", "beam.txt")], "speech serving")
    speed = serving_speed(exp, ckpt, data_ini, exp.model.runners,
                          batch=S_BATCH, warm_up=False)
    report = {"batch": S_BATCH, "frames": S_FRAMES, "features": S_FEATS,
              "beam": S_BEAM, "seconds": seconds, "serving": {
                  "mean_output_symbols": mean_lengths(lines),
                  "utterances_per_s": {k: v["sentences_per_s"]
                                       for k, v in speed.items()},
                  "speed": speed}}
    report["parity"] = timed(seconds, "parity", check_speech_parity, ini,
                             data_ini, exp, ckpt)
    report["serving"]["beam_ops_per_frame"] = beam_ops_per_frame(exp,
                                                                 data_ini)
    del exp
    counts, report["training"], best = timed(
        seconds, "training", run_training, tmp, ini, False, "speech_train",
        SPEECH_KERNELS, SPEECH_DATA_INI.replace("{split}", "val"))
    launches = add_launches(launches, counts)
    with open(os.path.join(tmp, "speech_train_plain", "metrics.jsonl")) as f:
        windows = [w for w in map(json.loads, f) if w["kind"] == "train"]
    report["training"]["train_frames_per_sec"] = statistics.mean(
        w["examples_per_sec"] * S_FRAMES for w in windows[1:])
    report["training_parity"] = timed(seconds, "training_parity",
                                      check_train_parity, ini, best,
                                      ("encoder",), float64=True)
    gates = (("ctc.ini", "transcript/WER", "<", 0.8, SPEECH_KERNELS),
             ("audio_classifier.ini", "label/AccuracySeqLevel", ">", 0.5,
              SPEECH_KERNELS))
    launches = add_launches(launches, timed(
        seconds, "gates", train_to_gates, tmp, gates, report))
    log(f"speech: {report}")
    return launches, report


# ---------------------------------------------------------------------- #
# phase 24: the bf16 compute policy
# ---------------------------------------------------------------------- #
def bf16_step_losses(train_ini: str, ckpt: str, parts, fused: bool):
    """One step's loss from ``ckpt`` on 8 sentences, the dropout of
    ``parts`` off: on the card and on the CPU under the bf16 policy, and
    on the card in float32 (``NM_COMPUTE_DTYPE`` read at each step)."""
    import torch

    from neuralmonkey_tpu_torch.dataset import BatchingScheme
    from neuralmonkey_tpu_torch.experiment import Experiment

    changes = [f"{part}.dropout_keep_prob=1.0" for part in parts]
    losses = {}
    for label, device_change, dtype in (
            ("card", [], "bfloat16"),
            ("cpu", ['tf_manager.device="cpu"'], "bfloat16"),
            ("card float32", [], "float32")):
        os.environ["NM_COMPUTE_DTYPE"] = dtype
        if fused:
            os.environ["NM_FUSED_XENT"] = "1"
        try:
            exp = Experiment(train_ini, train_mode=True,
                             config_changes=changes + device_change)
            exp.build_model()
            manager = exp.tf_manager
            manager.restore(ckpt)
            dataset = next(exp.model.train_dataset.batches(
                BatchingScheme(batch_size=N_PARITY), shuffled=False))
            batch = manager.build_batch(dataset, N_PARITY, train=True)[0]
            with torch.no_grad():
                total, _ = exp.model.trainer.total_loss(manager.params,
                                                        batch, rng=0)
            losses[label] = total.item()
        finally:
            os.environ.pop("NM_FUSED_XENT", None)
            os.environ["NM_COMPUTE_DTYPE"] = "bfloat16"
    err = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    tracks = (abs(losses["card"] - losses["card float32"])
              / abs(losses["card float32"]))
    if not err <= BF16_LOSS_RTOL:
        raise AssertionError(f"bf16 step loss: card {losses['card']} "
                             f"against CPU {losses['cpu']} ({err:.3g} > "
                             f"{BF16_LOSS_RTOL:.3g} relative)")
    if not tracks <= BF16_TRACKS_RTOL:
        raise AssertionError(f"bf16 step loss {losses['card']} against "
                             f"float32 {losses['card float32']}")
    return {**losses, "card_cpu_relative": err,
            "bf16_float32_relative": tracks}


def bf16_beam_scores(exp, ckpt: str, data_ini: str):
    """The beam runner's scores of the first N_PARITY sentences on the
    card under the bf16 policy and in float32: their largest difference,
    held to ``BF16_SCORES_ATOL`` plus ``BF16_SCORES_RTOL`` of the float32
    score."""
    import torch

    from neuralmonkey_tpu_torch import run
    from neuralmonkey_tpu_torch.model.part import Context

    exp.tf_manager.restore(ckpt)
    dataset = run.load_data_config(data_ini)[0].subset(0, N_PARITY)
    batch, _ = exp.tf_manager.build_batch(dataset, N_PARITY)
    scores = {}
    for dtype in ("float32", "bfloat16"):
        os.environ["NM_COMPUTE_DTYPE"] = dtype
        with torch.inference_mode():
            scores[dtype] = exp.model.runners[1].fetches(Context(
                exp.tf_manager.params, batch))["scores"].float().cpu()
    excess = ((scores["bfloat16"] - scores["float32"]).abs()
              - BF16_SCORES_RTOL * scores["float32"].abs())
    diff = float((scores["bfloat16"] - scores["float32"]).abs().max())
    if not float(excess.max()) <= BF16_SCORES_ATOL:
        raise AssertionError(f"bf16 beam scores differ from float32's by "
                             f"up to {diff}: past {BF16_SCORES_ATOL} + "
                             f"{BF16_SCORES_RTOL} of a score")
    return {"max_abs_diff": diff,
            "max_relative_diff": float(
                ((scores["bfloat16"] - scores["float32"]).abs()
                 / scores["float32"].abs()).max())}


def check_bf16_policy(tmp: str, rnn, transformer):
    """Phase 24: the bf16 compute policy (``NM_COMPUTE_DTYPE=bfloat16``)
    through the entry points at full width. ``rnn`` and ``transformer``
    are (experiment INI, data INI, checkpoint, training INI, trained
    checkpoint) of phases 4-6 and 9-11. The RNN: 128 sentences greedily
    and with beam 10 through ``run`` (K1-K4 launch; K3 on the bf16 table
    widened to float32, as the JAX package arms it), 8 against the CPU
    under the policy by phase 5's rule at ``BF16_MARGIN``, beam scores
    against float32, a training epoch (20 steps) through ``train``, one
    step's loss against the CPU and float32; the Transformer: beam 10 in
    both lineage forms (the lineage attention's bf16 instance in the
    kernel form, never its float32 one), the kernel form against the CPU,
    beam scores against float32, 20 training steps with
    ``NM_FUSED_XENT=1`` (the bf16-W cross-entropy kernels, never the
    float32 ones), one fused step's loss against the CPU and float32.
    K3 launches on a bf16 W (widened exactly) and matches its plain
    version. Returns (the launches of the main-path runs, the report)."""
    import torch

    from neuralmonkey_tpu_torch.experiment import Experiment
    from neuralmonkey_tpu_torch.ops import beam_select, kernel_config, policy

    launches = dict.fromkeys(kernel_config.launch_counts(), 0)
    report = {}
    os.environ["NM_COMPUTE_DTYPE"] = "bfloat16"
    try:
        exp_ini, data_ini, ckpt, train_ini, trained = rnn
        run_launches, _ = serve_through_run(
            exp_ini, data_ini, ckpt, SERVING_KERNELS,
            [os.path.join(tmp, name) for name in ("greedy.txt", "beam.txt")],
            "bf16 slice")
        launches = add_launches(launches, run_launches)
        exp = Experiment(exp_ini, train_mode=False)
        exp.build_model()
        if policy.compute_dtype() != torch.bfloat16:
            raise AssertionError("NM_COMPUTE_DTYPE=bfloat16 did not set "
                                 "the policy")
        rnn_report = {"speed": serving_speed(exp, ckpt, data_ini,
                                             exp.model.runners,
                                             warm_up=False)}
        rnn_report["parity"] = check_parity(exp_ini, data_ini, exp, ckpt,
                                            margin=BF16_MARGIN)
        rnn_report["beam_scores_bf16_against_float32"] = bf16_beam_scores(
            exp, ckpt, data_ini)
        del exp
        train_launches, rnn_report["training"], _ = run_training(
            tmp, train_ini, False, "bf16_train")
        launches = add_launches(launches, train_launches)
        rnn_report["step_loss"] = bf16_step_losses(
            train_ini, trained, ("encoder", "attention", "decoder"), False)
        report["rnn"] = rnn_report

        t_ini, t_data_ini, t_ckpt, t_train_ini, t_trained = transformer
        outputs = [os.path.join(tmp, f"t_{name}.txt")
                   for name in ("greedy", "beam")]
        run_launches, _ = serve_through_run(
            t_ini, t_data_ini, t_ckpt, T_SERVING_KERNELS, outputs,
            "bf16 transformer serving")
        launches = add_launches(launches, run_launches)
        t_exp = Experiment(t_ini, train_mode=False)
        t_exp.build_model()
        t_report = {"speed": serving_speed(t_exp, t_ckpt, t_data_ini,
                                           t_exp.model.runners[1:])}
        os.environ["NM_LINEAGE_KERNEL"] = "1"
        try:
            run_launches, _ = serve_through_run(
                t_ini, t_data_ini, t_ckpt,
                T_SERVING_KERNELS + ("lineage_attention_bf16",), outputs,
                "bf16 transformer serving, NM_LINEAGE_KERNEL=1")
            if run_launches["lineage_attention"]:
                raise AssertionError("the float32 lineage attention ran on "
                                     "bf16 caches")
            if run_launches[LINEAGE_SCRATCH]:
                raise AssertionError("the beam step's bf16 caches took the "
                                     "scratch lineage design")
            launches = add_launches(launches, run_launches)
            t_report["speed"].update(serving_speed(
                t_exp, t_ckpt, t_data_ini, t_exp.model.runners[1:],
                " (lineage kernel)", warm_up=False))
            t_report["parity"] = check_parity(t_ini, t_data_ini, t_exp,
                                              t_ckpt, margin=BF16_MARGIN)
            t_report["beam_scores_bf16_against_float32"] = \
                bf16_beam_scores(t_exp, t_ckpt, t_data_ini)
        finally:
            os.environ.pop("NM_LINEAGE_KERNEL")
        del t_exp
        train_launches, t_report["training"], _ = run_training(
            tmp, t_train_ini, True, "bf16_t_train", FLASH_KERNELS,
            xent=BF16_KERNELS[1:])
        if any(train_launches[k] for k in XENT_KERNELS):
            raise AssertionError("the float32 cross-entropy kernels ran on "
                                 "the bf16 table")
        if any(train_launches[k] for k in WIDENED_KERNELS):
            raise AssertionError("the bf16 table took the widened "
                                 "cross-entropy designs")
        launches = add_launches(launches, train_launches)
        t_report["step_loss"] = bf16_step_losses(
            t_train_ini, t_trained, ("encoder", "decoder"), True)
        report["transformer"] = t_report

        # K3 computes in float32: a bf16 W is widened and K3 launches
        gen = torch.Generator().manual_seed(SEED)
        x = torch.randn(BATCH, EMB, generator=gen).cuda()
        w = torch.randn(EMB, 1024, generator=gen).to(torch.bfloat16).cuda()
        bias = torch.zeros(1024, device="cuda")
        before = kernel_config.launch_counts()["fused_logits_rowmax_lse"]
        got = beam_select.fused_logits_rowmax_lse(x, w, bias)
        if (kernel_config.launch_counts()["fused_logits_rowmax_lse"]
                != before + 1):
            raise AssertionError("K3 did not launch on a bf16 W")
        ref = beam_select.fused_logits_reference(x, w.float(), bias)
        err = max(max_err(g, r) / max(float(r.abs().max()), 1.0)
                  for g, r in zip(got, ref))
        if not err <= 1e-4:
            raise AssertionError(f"K3 on a bf16 W: relative error {err}")
        report["k3_bf16_w"] = f"K3 launched, relative error {err:.3g}"
    finally:
        os.environ.pop("NM_COMPUTE_DTYPE", None)
        policy.set_compute_dtype(None)
    missing = [k for k in BF16_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"bf16 policy: never launched {missing}")
    log(f"bf16 policy: {report}")
    return launches, report


# ---------------------------------------------------------------------- #
# phase 25: checkpoint ensembles, averaging and grid decoding
# ---------------------------------------------------------------------- #
ENSEMBLE_SEED = SEED + 25
# the Transformer ensemble's members have 2 + 2 layers (as phase 22's MoE
# model), which keeps the smoke within its time
ENSEMBLE_DEPTH = 2
ENSEMBLE_KERNELS = ("gru_scan", "fused_bahdanau_step", "small_topk")
T_ENSEMBLE_KERNELS = ("flash_attention_fwd", "small_topk")
# an ensemble selects on averaged log-probs: the fused logit projection
# is never armed and the selector reduces no raw logits; its loop states
# stay plainly row-tiled, never in the lineage kernel's layout
NOT_IN_ENSEMBLES = ("fused_logits_rowmax_lse", "rowmax_lse")
LINEAGE_KERNELS = ("lineage_attention", "lineage_attention_chunked",
                   "lineage_attention_bf16", LINEAGE_SCRATCH)
GRID_LENGTHS = (80, 200)
GRID_KERNELS = ("gru_scan",)

GRID_TRAINER = """\
[trainer]
class=trainers.cross_entropy_trainer.CrossEntropyTrainer
decoders=[<labeler>]
clip_norm=1.0
optimizer=<adam>

"""
GRID_DATA_INI = """\
[main]
test_datasets=[<grid_data>]

[grid_data]
class=dataset.load_dataset_from_files
s_source="{tmp}/grid.src"
s_tags_out="{tmp}/grid.tags"
"""


def second_checkpoint(exp_ini: str, tmp: str, name: str) -> str:
    """The model of ``exp_ini`` initialised from ``ENSEMBLE_SEED``,
    saved under ``tmp``: the ensemble's second member."""
    from neuralmonkey_tpu_torch.experiment import Experiment

    exp = Experiment(exp_ini, train_mode=False, config_changes=[
        f"main.random_seed={ENSEMBLE_SEED}"])
    exp.build_model()
    return exp.tf_manager.save(os.path.join(tmp, name))


class OpCounter:
    """Counts the ATen operations dispatched while it is entered (each
    launches one or more device kernels on the card's tensors)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self
        self.count = 0

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counter.count += 1
                return func(*args, **(kwargs or {}))
        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def launches_per_step(exp, ckpt, data_ini: str, count_ops: bool = False):
    """One pass of each runner of ``exp`` over the first batch of
    ``data_ini``'s data from ``ckpt`` (a list: an ensemble), with the
    hand-written kernels' launches counted from 0 and the decode steps
    counted at the step's selection (greedy: ``_mask_unk``, once a step
    for one model or an ensemble; beam: the selector); with
    ``count_ops`` also the ATen operations of the pass a step."""
    import contextlib

    import torch

    from neuralmonkey_tpu_torch import run
    from neuralmonkey_tpu_torch.ops import kernel_config

    exp.tf_manager.restore(ckpt)
    dataset = run.load_data_config(data_ini)[0].subset(0, BATCH)
    report = {}
    for runner in exp.model.runners:
        search = runner.decoder
        name = ("_select_hier" if hasattr(search, "beam_size")
                else "_mask_unk")
        plain = getattr(search, name)
        steps = []

        def counting(*args, **kwargs):
            steps.append(1)
            return plain(*args, **kwargs)
        setattr(search, name, counting)
        ops = OpCounter() if count_ops else contextlib.nullcontext()
        try:
            kernel_config.reset_launch_counts()
            with ops:
                exp.tf_manager.execute(dataset, [runner], BATCH)
            torch.cuda.synchronize()
            counts = kernel_config.launch_counts()
        finally:
            delattr(search, name)
        report[runner.output_series] = {
            "steps": len(steps),
            "launches_per_step": sum(counts.values()) / len(steps),
            "by_kernel": {k: n for k, n in counts.items() if n}}
        if count_ops:
            report[runner.output_series]["aten_ops_per_step"] = \
                ops.count / len(steps)
    return report


def check_ensembles(tmp: str, data_ini: str, ckpt: str, single_speed):
    """Phase 25. The RNN of phase 4 with a second member initialised
    from another seed: both through ``run`` as a logit ensemble (greedy
    and beam 10; K1, K2 and K4 launch, K3 and ``rowmax_lse`` never), 8
    sentences against the CPU's ensemble by phase 5's rule; the
    checkpoints averaged by ``utils.average_checkpoints`` (bitwise the
    numpy mean on the host), ``run --average`` giving the ids of ``run``
    on that file. Phase 9's Transformer at ENSEMBLE_DEPTH layers a side,
    two members from two seeds: beam 10 as an ensemble by default and
    under ``NM_LINEAGE_KERNEL=1`` (the flash
    forward and K4 launch, the lineage attention never), 8 sentences
    against the CPU. Phase 18's labeler (``max_input_len`` 32) labels
    128 sentences of 80-200 words through ``run --grid`` (K1 launches),
    each output line as long as its sentence. The rates and the launches
    per decode step beside phase 4's single model. Returns (the main-path
    runs' launches, report)."""
    import numpy as np
    import torch

    from neuralmonkey_tpu_torch import run
    from neuralmonkey_tpu_torch.experiment import Experiment
    from neuralmonkey_tpu_torch.ops import kernel_config
    from neuralmonkey_tpu_torch.utils import average_checkpoints
    from neuralmonkey_tpu_torch.utils.saving import load_flat

    report = {}
    exp_ini = os.path.join(tmp, "exp.ini")
    ckpts = [ckpt, second_checkpoint(exp_ini, tmp, "params_b")]
    e_data = os.path.join(tmp, "e_data.ini")
    with open(e_data, "w") as f:
        f.write(DATA_INI.format(tmp=tmp, prefix="e_"))
    outputs = [os.path.join(tmp, f"e_{n}.txt") for n in ("greedy", "beam")]
    launches, _ = serve_through_run(
        exp_ini, e_data, ckpts, ENSEMBLE_KERNELS, outputs, "rnn ensemble",
        forbidden=NOT_IN_ENSEMBLES)
    exp = Experiment(exp_ini, train_mode=False)
    exp.build_model()
    exp.tf_manager.restore(ckpts)
    rnn = {"parity": check_parity(exp_ini, e_data, exp, ckpts),
           "speed": serving_speed(exp, ckpts, e_data, exp.model.runners,
                                  " (ensemble of 2)"),
           "single model speed (phase 4)": single_speed,
           "launches_per_step": launches_per_step(exp, ckpts, e_data),
           "single model launches_per_step": launches_per_step(
               exp, ckpt, e_data)}

    # --average: one parameter set, the checkpoints' mean
    averaged = os.path.join(tmp, "params_avg.npz")
    if average_checkpoints.main([averaged, *ckpts]) != 0:
        raise AssertionError("utils.average_checkpoints failed")
    flats = [load_flat(path) for path in ckpts]
    written = load_flat(averaged)
    if set(written) != set(flats[0]):
        raise AssertionError("the averaged checkpoint's keys differ")
    for key, value in written.items():
        host = np.mean(np.stack([flat[key] for flat in flats]), axis=0,
                       dtype=np.float32).astype(flats[0][key].dtype)
        if value.dtype != host.dtype or not np.array_equal(value, host):
            raise AssertionError(f"averaged '{key}' is not the numpy mean")
    a_launches, from_flag = serve_through_run(
        exp_ini, e_data, ckpts, SERVING_KERNELS, outputs, "rnn --average",
        flags=("--average",))
    f_launches, from_file = serve_through_run(
        exp_ini, e_data, averaged, SERVING_KERNELS, outputs,
        "rnn on the averaged checkpoint")
    if from_flag != from_file:
        raise AssertionError("run --average and run on the averaged "
                             "checkpoint decode differently")
    launches = add_launches(add_launches(launches, a_launches), f_launches)
    rnn["average"] = {"bitwise_numpy_mean": True,
                      "ids_equal_single_run_on_file": True,
                      "speed": serving_speed(exp, averaged, e_data,
                                             exp.model.runners,
                                             " (--average)")}
    report["rnn"] = rnn
    del exp

    # the Transformer: plain caches in both lineage forms
    t_ini = write_transformer_ini(tmp, "te_exp.ini", T_SERVING_MAIN, 1.0,
                                  1.0, ENSEMBLE_DEPTH)
    t_exp = Experiment(t_ini, train_mode=False)
    t_exp.build_model()
    t_ckpt = t_exp.tf_manager.save(os.path.join(tmp, "te_params_a"))
    del t_exp
    t_ckpts = [t_ckpt, second_checkpoint(t_ini, tmp, "te_params_b")]
    t_data = os.path.join(tmp, "te_data.ini")
    with open(t_data, "w") as f:
        f.write(DATA_INI.format(tmp=tmp, prefix="te_"))
    t_outputs = [os.path.join(tmp, f"te_{n}.txt")
                 for n in ("greedy", "beam")]
    beams = {}
    for form in ("einsum", "NM_LINEAGE_KERNEL=1"):
        if form != "einsum":
            os.environ["NM_LINEAGE_KERNEL"] = "1"
        try:
            t_launches, out = serve_through_run(
                t_ini, t_data, t_ckpts, T_ENSEMBLE_KERNELS, t_outputs,
                f"transformer ensemble ({form})",
                forbidden=NOT_IN_ENSEMBLES + LINEAGE_KERNELS)
        finally:
            os.environ.pop("NM_LINEAGE_KERNEL", None)
        launches = add_launches(launches, t_launches)
        beams[form] = out["te_beam.txt"]
    if beams["einsum"] != beams["NM_LINEAGE_KERNEL=1"]:
        raise AssertionError("the Transformer ensemble's beam ids depend "
                             "on NM_LINEAGE_KERNEL (both forms must run the "
                             "same plain caches)")
    t_exp = Experiment(t_ini, train_mode=False)
    t_exp.build_model()
    t_exp.tf_manager.restore(t_ckpts)
    report["transformer"] = {
        "parity": check_parity(t_ini, t_data, t_exp, t_ckpts),
        "speed": serving_speed(t_exp, t_ckpts, t_data, t_exp.model.runners,
                               " (ensemble of 2)"),
        "launches_per_step": launches_per_step(t_exp, t_ckpts, t_data),
        "single model launches_per_step": launches_per_step(
            t_exp, t_ckpt, t_data)}
    del t_exp

    # --grid: phase 18's labeler over sentences longer than its windows,
    # alone (the alignment decoder would ask the windows for alignments)
    heads_ini = os.path.join(tmp, "grid.ini")
    text = HEADS_INI.format(
        tmp=tmp, out=os.path.join(tmp, "grid_out"), batch=BATCH, seed=SEED,
        rnn=RNN, src_len=SRC_LEN, emb=EMB, att=ATT, tgt_len=TGT_LEN)
    for name in ("attention", "decoder", "alignment_decoder"):
        text = swap_section(text, name, "")
    with open(heads_ini, "w") as f:
        f.write(swap_section(text, "trainer", GRID_TRAINER))
    h_exp = Experiment(heads_ini, train_mode=False)
    h_exp.build_model()
    h_ckpt = h_exp.tf_manager.save(os.path.join(tmp, "grid_params"))
    rng = np.random.RandomState(SEED + 26)
    lengths = rng.randint(GRID_LENGTHS[0], GRID_LENGTHS[1] + 1, N_SENTENCES)
    with open(os.path.join(tmp, "grid.src"), "w") as f:
        f.writelines(" ".join(f"w{i}" for i in rng.randint(
            0, VOCAB - 4, n)) + "\n" for n in lengths)
    grid_data = os.path.join(tmp, "grid_data.ini")
    with open(grid_data, "w") as f:
        f.write(GRID_DATA_INI.format(tmp=tmp))
    g_launches, tags = serve_through_run(
        heads_ini, grid_data, h_ckpt, GRID_KERNELS,
        [os.path.join(tmp, "grid.tags")], "labeler --grid",
        flags=("--grid",))
    launches = add_launches(launches, g_launches)
    short = [i for i, (line, n) in enumerate(zip(tags["grid.tags"], lengths))
             if len(line.split()) != n]
    if short:
        raise AssertionError(f"grid decoding: sentences {short[:5]} got "
                             "labels not as many as their words")
    dataset = run.load_data_config(grid_data)[0]
    run.grid_decode(h_exp, dataset)  # warm-up
    kernel_config.reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    run.grid_decode(h_exp, dataset)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    report["grid"] = {"sentences": N_SENTENCES,
                      "words": int(lengths.sum()),
                      "window": SRC_LEN,
                      "sentences_per_s": N_SENTENCES / seconds,
                      "k1_launches_a_pass": kernel_config.launch_counts()[
                          "gru_scan"]}
    log(f"ensembles, --average and --grid: {report}")
    return launches, report


# ---------------------------------------------------------------------- #
# phase 26: the model and trainer long tail
# ---------------------------------------------------------------------- #
N_LT_TRAIN = 8 * BATCH  # the training pairs of each long-tail run
# the step-scanned encoders never reach the GRU kernels
NOT_IN_STEP_SCANS = ("gru_scan", "gru_bptt")
LT_TRAINING_KERNELS = ("fused_bahdanau_step",)
APPROX_KERNELS = ("gru_scan", "fused_bahdanau_step")
# the flat selector arms no fused projection and reduces nothing itself
NOT_IN_FLAT = ("fused_logits_rowmax_lse", "rowmax_lse", "small_topk")
LT_OPTIMIZERS = {
    "adam": "[optimizer]\nclass=tf.train.AdamOptimizer\nlearning_rate=0.001"
            "\n\n",
    # without a rate Adafactor steps by the parameters' own scale, which
    # throws the random-weight model far off in 8 steps (a loss of 13
    # from 9.7), where one step's parity is ill-conditioned on both devices
    "adafactor": "[optimizer]\nclass=trainers.optimizers.AdafactorOptimizer"
                 "\nlearning_rate=0.01\n\n",
    "rmsprop": "[optimizer]\nclass=tf.train.RMSPropOptimizer\n"
               "learning_rate=0.001\n\n",
    "adadelta": "[optimizer]\nclass=tf.train.AdadeltaOptimizer\n\n",
}
# (encoder cell, optimizer, which runner writes attention maps)
LT_RUNS = (("LayerNormGRU", "adafactor", "runner"),
           ("NoisyGRU", "rmsprop", "bs_runner"),
           ("NoisyGRU", "adadelta", None))
# the first update on the card against the CPU's from the card's
# gradients: each updated parameter within one float32 spacing of the
# CPU's (the rounding of p + u), or within this share of the update's
# largest entry
UPDATE_ERR = 1e-4
# attention maps on the card against the CPU's where the ids agree
ATTENTION_ERR = 1e-5


def write_long_tail_ini(tmp: str, cell: str, optimizer: str,
                        attention_runner) -> str:
    """Phase 6's training INI over the first ``N_LT_TRAIN`` pairs, logging
    every 2 steps, the encoder's cell ``cell``,
    ``LT_OPTIMIZERS[optimizer]``, and ``visualize_attention`` on
    ``attention_runner`` (the beam runner validates only then)."""
    first_lines(tmp, ("train.src", "train.tgt"), N_LT_TRAIN, "lt_")
    with open(os.path.join(tmp, "train.ini")) as f:
        text = f.read()
    text = swap_section(text.replace("optimizer=<adam>",
                                     "optimizer=<optimizer>"),
                        "adam", LT_OPTIMIZERS[optimizer])
    text = text.replace(f'{tmp}/train.', f'{tmp}/lt_train.').replace(
        'rnn_cell="GRU"', f'rnn_cell="{cell}"').replace(
        "logging_period=5", "logging_period=2")
    if attention_runner != "bs_runner":
        text = text.replace("runners=[<runner>, <bs_runner>]",
                            "runners=[<runner>]")
    if attention_runner is not None:
        text = text.replace(f"[{attention_runner}]\n",
                            f"[{attention_runner}]\nvisualize_attention=True\n")
    path = os.path.join(tmp, f"lt_{cell}_{optimizer}.ini")
    with open(path, "w") as f:
        f.write(text)
    return path


def train_through_cli(train_ini: str, out: str, label: str):
    """One epoch through the train CLI with the launch counts set to 0
    just before it: (its launches, its record with the rate of the
    logging windows after the first, the best checkpoint)."""
    import torch

    from neuralmonkey_tpu_torch import train
    from neuralmonkey_tpu_torch.ops import kernel_config

    kernel_config.reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    if train.main([train_ini, f'main.output="{out}"']) != 0:
        raise AssertionError(f"{label}: neuralmonkey_tpu_torch.train failed")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = kernel_config.launch_counts()
    with open(os.path.join(out, "metrics.jsonl")) as f:
        windows = [r for r in map(json.loads, f) if r["kind"] == "train"]
    losses = [r["loss"] for r in windows]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{label}: losses {losses}")
    rates = [r["tokens_per_sec"] for r in windows]
    record = {"steps": windows[-1]["step"], "seconds": seconds,
              "losses": losses, "tokens_per_sec_windows": rates,
              "train_tokens_per_sec": statistics.mean(rates[1:]),
              "launches": {k: n for k, n in launches.items() if n}}
    log(f"{label}: {record}")
    return launches, record, os.path.join(out, "variables.data.best")


def noise_replay():
    """A ``check_train_parity`` hook: the first card pass records the
    noise every noisy-activation cell draws, and the CPU's passes replay
    it (the card's generator draws other numbers than the CPU's)."""
    from neuralmonkey_tpu_torch.ops.nn import NoisyGRUCell

    drawn = []

    def hook(exp):
        cells = [cell for part in exp.tf_manager.parts
                 for pair in getattr(part, "_cells", ())
                 for cell in pair if isinstance(cell, NoisyGRUCell)]
        on_cpu = exp.tf_manager.device.type == "cpu"
        record, replay = not on_cpu and not drawn, iter(list(drawn))
        for cell in cells:
            plain = cell.draw_noise

            def draw(steps, batch, generator, device, plain=plain):
                if on_cpu:
                    return next(replay).to(device)
                out = plain(steps, batch, generator, device)
                if record:
                    drawn.append(out.cpu())
                return out
            cell.draw_noise = draw
    hook.drawn = drawn
    return hook


def check_first_update(train_ini: str, ckpt: str):
    """The trainer's first update of one step from ``ckpt`` (8
    sentences, dropout off): applied on the card to the card's gradients
    and on the CPU, by the optimizer's plain arithmetic, to the same
    gradients; every updated parameter within one float32 spacing of
    the CPU's, or ``UPDATE_ERR`` of its update's largest entry."""
    import torch

    from neuralmonkey_tpu_torch.dataset import BatchingScheme
    from neuralmonkey_tpu_torch.experiment import Experiment
    from neuralmonkey_tpu_torch.utils.saving import flatten_tree

    exp = Experiment(train_ini, train_mode=True, config_changes=[
        f"{part}.dropout_keep_prob=1.0"
        for part in ("encoder", "attention", "decoder")])
    exp.build_model()
    manager = exp.tf_manager
    manager.restore(ckpt)
    dataset = next(exp.model.train_dataset.batches(
        BatchingScheme(batch_size=N_PARITY), shuffled=False))
    batch = manager.build_batch(dataset, N_PARITY, train=True)[0]
    flat = flatten_tree(manager.params)
    for p in flat.values():
        p.requires_grad_(True)
    trainer = exp.model.trainer
    total, _ = trainer.total_loss(manager.params, batch, rng=0)
    total.backward()
    grads = {k: p.grad.detach() for k, p in flat.items()}
    before = {k: p.detach().to("cpu", copy=True) for k, p in flat.items()}
    params = {k: p.detach() for k, p in flat.items()}
    card = trainer.make_update()
    card.apply(params, grads, card.init(params))
    cpu_params = {k: v.clone() for k, v in before.items()}
    cpu = trainer.make_update()
    cpu.apply(cpu_params, {k: g.cpu() for k, g in grads.items()},
              cpu.init(cpu_params))
    def err(key):
        """The worst entry's distance beyond one spacing, over the
        update's largest entry."""
        ref = cpu_params[key]
        spacing = torch.nextafter(ref.abs(), torch.tensor(math.inf)) \
            - ref.abs()
        beyond = ((params[key].cpu() - ref).abs() - spacing).clamp_min(0)
        return float(beyond.max()) / max(
            float((ref - before[key]).abs().max()), 1e-30)
    errs = {k: err(k) for k in flat}
    worst = max(errs, key=errs.get)
    log(f"first update: the card's {errs[worst]:.3g} of the largest "
        f"update entry beyond one spacing from the CPU's at {worst}")
    if not errs[worst] <= UPDATE_ERR:
        raise AssertionError(f"the first update on the card differs from "
                             f"the CPU's: {errs[worst]} at {worst}")
    return {"max_rel_err": errs[worst], "at": worst}


def check_opt_resume(train_ini: str, tmp: str, ckpt: str):
    """From ``ckpt``: six steps on the card over fixed batches, saving
    (parameters and ``.opt``) after the third; a fresh model restored
    from that checkpoint and ``.opt`` must continue with the same
    losses (1e-5 relative)."""
    from neuralmonkey_tpu_torch.dataset import BatchingScheme
    from neuralmonkey_tpu_torch.experiment import Experiment

    def model():
        exp = Experiment(train_ini, train_mode=True)
        exp.build_model()
        return exp
    exp = model()
    manager = exp.tf_manager
    batches = list(exp.model.train_dataset.batches(
        BatchingScheme(batch_size=BATCH), shuffled=False))[:6]
    manager.restore(ckpt)

    def steps(exp, some):
        return [exp.tf_manager.train_on_batch(exp.model.trainer, b,
                                              BATCH)["loss"] for b in some]
    losses = steps(exp, batches[:3])
    base = os.path.join(tmp, "lt_resume")
    saved = manager.save(base)
    losses += steps(exp, batches[3:])
    resumed = model()
    resumed.tf_manager.restore(saved)
    resumed.tf_manager.load_optimizer_state(base)
    continued = steps(resumed, batches[3:])
    err = max(abs(a - b) / abs(b) for a, b in zip(continued, losses[3:]))
    log(f"resume from .opt: uninterrupted {losses}, continued {continued}")
    if not err <= 1e-5:
        raise AssertionError(f"the resumed run's losses {continued} leave "
                             f"the uninterrupted run's {losses[3:]}")
    return {"uninterrupted": losses, "continued": continued,
            "max_rel_err": err}


def check_warm_start(train_ini: str, ckpt: str):
    """Phase 6's model (GRU encoder) with its decoder warm-started from
    ``ckpt`` by part: the decoder's tensors equal the file's, the
    encoder's keep their initialization."""
    from neuralmonkey_tpu_torch.experiment import Experiment
    from neuralmonkey_tpu_torch.utils.saving import flatten_tree, load_flat

    exp = Experiment(train_ini, train_mode=True, config_changes=[
        f'decoder.load_checkpoint="{ckpt}"'])
    exp.build_model()
    saved = load_flat(ckpt)
    params = exp.tf_manager.params
    decoder = flatten_tree(params["decoder"])
    differ = [k for k, v in decoder.items()
              if not (v.cpu().numpy() == saved[f"decoder/{k}"]).all()]
    if differ or not decoder:
        raise AssertionError(f"warm start: decoder tensors {differ} differ "
                             "from the checkpoint's")
    encoder = flatten_tree(params["sentence_encoder"])
    if all(f"sentence_encoder/{k}" in saved
           and (v.cpu().numpy() == saved[f"sentence_encoder/{k}"]).all()
           for k, v in encoder.items()):
        raise AssertionError("warm start: the encoder was restored too")
    return {"decoder_tensors_equal_file": len(decoder)}


def optimizer_update_ms(exp_ini: str, ckpt: str):
    """Milliseconds (wall, synchronized) of one clipped update of each
    optimizer over the flagship's parameters on the card, with random
    gradients: the median of 10 after 3 warm-up updates."""
    import torch

    from neuralmonkey_tpu_torch.experiment import Experiment
    from neuralmonkey_tpu_torch.trainers import optimizers
    from neuralmonkey_tpu_torch.trainers.generic_trainer import Update
    from neuralmonkey_tpu_torch.utils.saving import flatten_tree

    exp = Experiment(exp_ini, train_mode=False)
    exp.build_model()
    exp.tf_manager.restore(ckpt)
    flat = {k: v.clone() for k, v in flatten_tree(exp.tf_manager.params)
            .items()}
    device = exp.tf_manager.device
    gen = torch.Generator(device=device).manual_seed(SEED)
    grads = {k: torch.randn(v.shape, generator=gen, device=device) * 1e-3
             for k, v in flat.items()}
    report = {"parameters": sum(v.numel() for v in flat.values())}
    for name, factory in (
            ("adam", optimizers.AdamOptimizer(1e-3)),
            ("adadelta", optimizers.AdadeltaOptimizer()),
            ("rmsprop", optimizers.RMSPropOptimizer()),
            ("adafactor", optimizers.AdafactorOptimizer())):
        update = Update(factory.make(), 1.0)
        state = update.init(flat)
        times = []
        for i in range(13):
            torch.cuda.synchronize()
            start = time.perf_counter()
            update.apply(flat, grads, state)
            torch.cuda.synchronize()
            if i >= 3:
                times.append((time.perf_counter() - start) * 1e3)
        report[f"{name}_ms"] = statistics.median(times)
    log(f"ms per update: {report}")
    return report


def sync_batches(manager, dataset, batching_scheme, batch_size,
                 train=False, shuffled=None, prefetch_depth=2):
    """The training loop's batches without the prefetch worker: each one
    built on the consumer's thread when it is needed (the loop before
    the worker)."""
    del prefetch_depth
    for dataset_batch in dataset.batches(
            batching_scheme, shuffled=train if shuffled is None else shuffled):
        yield manager.build_batch(dataset_batch, batch_size, train=train)


def attention_maps(exp_ini: str, data_ini: str, ckpt: str, tmp: str,
                   label: str = "lt"):
    """The model of ``exp_ini`` (phase 4's, phase 9's) with
    ``visualize_attention`` on both runners: 8 sentences' greedy and
    beam-10 maps on the card against the CPU's, where the devices decode
    the same ids, and the card's written as PNGs by the training loop's
    writer (files under ``tmp`` named by ``label``)."""
    import numpy as np
    import torch

    from neuralmonkey_tpu_torch import learning_utils, run
    from neuralmonkey_tpu_torch.experiment import Experiment

    with open(exp_ini) as f:
        text = f.read()
    path = os.path.join(tmp, f"{label}_attention.ini")
    with open(path, "w") as f:
        f.write(text.replace("output_series=", "visualize_attention=True\n"
                             "output_series="))
    dataset = run.load_data_config(data_ini)[0].subset(0, N_PARITY)
    results = {}
    for device, changes in (("cuda", []),
                            ("cpu", ['tf_manager.device="cpu"'])):
        exp = Experiment(path, train_mode=False, config_changes=changes)
        exp.build_model()
        exp.tf_manager.restore(ckpt)
        results[device] = exp.tf_manager.run_on_batch(
            exp.model.runners, dataset, N_PARITY)
    report = {}
    for i, kind in enumerate(("greedy", "beam")):
        card, cpu = results["cuda"][i], results["cpu"][i]
        same = [row for row in range(N_PARITY)
                if card.outputs[row] == cpu.outputs[row]]
        err = max((float(np.abs(np.asarray(card.aux["attention"][row])
                                - np.asarray(cpu.aux["attention"][row]))
                         .max()) for row in same), default=0.0)
        if not same or not err <= ATTENTION_ERR:
            raise AssertionError(f"{kind} attention maps: {err} apart over "
                                 f"the sentences {same}")
        out = os.path.join(tmp, f"{label}_maps_{kind}")
        learning_utils._write_attention_maps([card], out, step=0)
        pngs = os.listdir(os.path.join(out, "attention_maps"))
        if len(pngs) != 3:
            raise AssertionError(f"{kind}: PNG maps written: {pngs}")
        report[kind] = {"sentences_compared": len(same), "max_abs_err": err,
                        "shape": list(np.shape(card.aux["attention"][0])),
                        "pngs": len(pngs)}
    log(f"attention maps: {report}")
    return report


def check_long_tail(tmp: str, exp_ini: str, data_ini: str, ckpt: str,
                    gru_record):
    """Phase 26. Phase 6's flagship trains 8 steps through ``train`` with
    the encoder's cell and optimizer of each ``LT_RUNS`` entry (the
    prefetch worker on): K2 must launch, K1 and ``gru_bptt`` never; one
    step from its checkpoint against the CPU by phase 7's rule with phase
    12's float64 reference (the NoisyGRU's noise drawn on the card and
    replayed on the CPU), and the first update against the CPU's from
    the same gradients. From the NoisyGRU and RMSProp checkpoint a
    resumed run (parameters and ``.opt``) must continue the
    uninterrupted card run's losses, and phase 6's model must warm-start
    its decoder by part. Phase 4's model decodes the 128 sentences
    through ``run`` under ``align_logits`` (K3 launches on the aligned
    table) and under ``use_approx_top_k`` (the flat selector: K3,
    ``rowmax_lse`` and K4 never), 8 of them against the CPU by phase 5's
    rule; with ``visualize_attention`` its greedy and beam maps against
    the CPU's. Rates: each run's train tokens/s beside phase 6's GRU,
    each optimizer's ms per update, phase 6's training with the prefetch
    worker beside the loop without it, beam 10 under ``align_logits``
    beside the default. Returns (the main-path runs' launches,
    report)."""
    import torch

    from neuralmonkey_tpu_torch.experiment import Experiment
    from neuralmonkey_tpu_torch.models.decoders import autoregressive
    from neuralmonkey_tpu_torch.runtime import CUDAManager

    launches, report = None, {"runs": {}}
    checkpoints = {}
    for cell, optimizer, maps in LT_RUNS:
        label = f"{cell} + {optimizer}"
        ini = write_long_tail_ini(tmp, cell, optimizer, maps)
        out = os.path.join(tmp, f"lt_{cell}_{optimizer}_out")
        run_launches, record, best = train_through_cli(ini, out, label)
        missing = [k for k in LT_TRAINING_KERNELS if not run_launches[k]]
        wrong = [k for k in NOT_IN_STEP_SCANS if run_launches[k]]
        if missing or wrong:
            raise AssertionError(f"{label}: never launched {missing}, "
                                 f"launched {wrong}")
        launches = add_launches(launches, run_launches)
        if maps is not None:
            pngs = os.listdir(os.path.join(out, "attention_maps"))
            if not pngs:
                raise AssertionError(f"{label}: no attention maps written")
            record["attention_pngs"] = len(pngs)
        hook = noise_replay()
        record["parity"] = check_train_parity(ini, best, float64=True,
                                              hook=hook)
        if cell == "NoisyGRU" and not hook.drawn:
            raise AssertionError(f"{label}: no noise drawn in training")
        record["noise_draws_replayed"] = len(hook.drawn)
        record["first_update"] = check_first_update(ini, best)
        report["runs"][label] = record
        checkpoints[(cell, optimizer)] = (ini, best)
    report["gru_train_tokens_per_sec (phase 6)"] = gru_record[
        "train_tokens_per_sec"]

    ini, best = checkpoints[("NoisyGRU", "rmsprop")]
    report["resume"] = check_opt_resume(ini, tmp, best)
    report["warm_start"] = check_warm_start(
        os.path.join(tmp, "train.ini"), best)
    report["ms_per_update"] = optimizer_update_ms(exp_ini, ckpt)

    # phase 6's model (GRU, Adam) over the same 8 steps with and without
    # the prefetch worker, in turns
    gru_ini = write_long_tail_ini(tmp, "GRU", "adam", None)
    plain_iter = CUDAManager.iter_prepared_batches
    prefetch = {"with the worker": [], "without": []}
    for turn in ("with the worker", "without", "without",
                 "with the worker"):
        if turn == "without":
            CUDAManager.iter_prepared_batches = sync_batches
        try:
            gru_launches, record, _ = train_through_cli(
                gru_ini, os.path.join(tmp, f"lt_prefetch_{len(prefetch[turn])}_"
                                      + turn.replace(" ", "_")),
                f"phase 6's model, {turn}")
        finally:
            CUDAManager.iter_prepared_batches = plain_iter
        launches = add_launches(launches, gru_launches)
        prefetch[turn].append(record["train_tokens_per_sec"])
    report["train_tokens_per_sec_prefetch"] = prefetch
    gru_rate = statistics.mean(prefetch["with the worker"])
    for record in report["runs"].values():
        record["vs GRU + Adam, same steps"] = (
            record["train_tokens_per_sec"] / gru_rate)

    # serving: align_logits and use_approx_top_k on phase 4's model
    with open(exp_ini) as f:
        text = f.read()
    serving = {}
    for knob, expected, forbidden in (
            ("align_logits", SERVING_KERNELS, ()),
            ("use_approx_top_k", APPROX_KERNELS, NOT_IN_FLAT)):
        path = os.path.join(tmp, f"lt_{knob}.ini")
        with open(path, "w") as f:
            f.write(text.replace("length_normalization=0.6\n",
                                 f"length_normalization=0.6\n{knob}=True\n"))
        knob_data = os.path.join(tmp, f"lt_{knob}_data.ini")
        with open(knob_data, "w") as f:
            f.write(DATA_INI.format(tmp=tmp, prefix=f"lt_{knob}_"))
        widths = {"aligned": set(), "K3": set()}
        plain_align = autoregressive.AutoregressiveDecoder \
            .align_logits_for_selection
        plain_k3 = autoregressive.fused_logits_rowmax_lse

        def aligning(self, constants, *args):
            out = plain_align(self, constants, *args)
            widths["aligned"].add(out["params"]["logit"]["w"].shape[1])
            return out

        def k3(x, w, b):
            widths["K3"].add(w.shape[1])
            return plain_k3(x, w, b)
        autoregressive.AutoregressiveDecoder.align_logits_for_selection = \
            aligning
        autoregressive.fused_logits_rowmax_lse = k3
        try:
            knob_launches, _ = serve_through_run(
                path, knob_data, ckpt, expected,
                [os.path.join(tmp, f"lt_{knob}_{name}.txt")
                 for name in ("greedy", "beam")], knob, forbidden=forbidden)
        finally:
            autoregressive.AutoregressiveDecoder \
                .align_logits_for_selection = plain_align
            autoregressive.fused_logits_rowmax_lse = plain_k3
        launches = add_launches(launches, knob_launches)
        if knob == "align_logits" and widths["aligned"] != {
                -(-VOCAB // 128) * 128}:
            raise AssertionError(f"align_logits: tables {widths}")
        exp = Experiment(path, train_mode=False)
        exp.build_model()
        exp.tf_manager.restore(ckpt)
        serving[knob] = {
            "table_widths": {k: sorted(v) for k, v in widths.items()},
            "launches": {k: n for k, n in knob_launches.items() if n},
            "parity": check_parity(path, knob_data, exp, ckpt)}
        serving[knob]["exp"] = exp
    # beam 10 under align_logits beside the default, in turns
    default = Experiment(exp_ini, train_mode=False)
    default.build_model()
    rates = {"default": [], "align_logits": []}
    for name in ("default", "align_logits", "align_logits", "default") * 2:
        exp = default if name == "default" else serving[name]["exp"]
        rates[name].append(serving_speed(
            exp, ckpt, data_ini, exp.model.runners[1:])[
                "target_beam"]["sentences_per_s"])
    for knob in serving:
        del serving[knob]["exp"]
    serving["beam10_sentences_per_s"] = rates
    report["serving"] = serving
    report["attention_maps"] = attention_maps(exp_ini, data_ini, ckpt, tmp)
    torch.cuda.synchronize()
    log(f"long tail: {report}")
    return launches, report


# ---------------------------------------------------------------------- #
# phase 27: the host and image tail
# ---------------------------------------------------------------------- #
# ImageNet(vgg_16) in the graph under examples/captioning.ini's decoder
INET_IMAGE = (224, 224, 3)
N_INET_TRAIN, N_INET_TUNE, RESNET_BATCH = 4 * BATCH, 2 * BATCH, 32
INET_SERVING_KERNELS = ("fused_bahdanau_step", "fused_logits_rowmax_lse",
                        "small_topk")
# the card's forward of a CNN over these images within this share of the
# largest entry of the CPU's (float32, TF32 off), as phase 21's CNNEncoder
INET_REL_ERR = 1e-4
INET_CPU_IMAGES = 16
# the native host library: a merge table learned from a seeded corpus of
# 20000 sentences of 20 words (Zipf over 3000 words of 3-10 letters), the
# flagship's 30000-word vocabulary over 20000 of its sentences
BPE_MERGES, BPE_SENTENCES, BPE_WORDS, BPE_SENTENCE_LEN = 8000, 20000, 3000, 20
N_NATIVE_BUILDERS = 4
INET_INI = """\
[main]
name="chip smoke imagenet captioning"
tf_manager=<tf_manager>
output="{out}"
overwrite_output_dir=True
batch_size={batch}
epochs=1
train_dataset=<train_data>
val_dataset=<val_data>
trainer=<trainer>
runners=[<runner>, <bs_runner>]
evaluation=[("caption", evaluators.bleu.BLEU)]
logging_period=1
validation_period=1000
random_seed={seed}

[tf_manager]
class=tf_manager.TensorFlowManager
num_sessions=1

[vocabulary]
class=vocabulary.from_wordlist
path="{tmp}/cap_words.txt"

[train_data]
class=dataset.load_dataset_from_files
s_images=("{tmp}/{train}_images.npy", readers.numpy_reader.single_tensor)
s_caption="{tmp}/{train}.caption"
lazy=False

[val_data]
class=dataset.load_dataset_from_files
s_images=("{tmp}/inet_val_images.npy", readers.numpy_reader.single_tensor)
s_caption="{tmp}/inet_val.caption"

[encoder]
class=encoders.imagenet_encoder.ImageNet
name="imagenet"
data_id="images"
network_type="vgg_16"
fine_tune={fine_tune}

[attention]
class=attention.feed_forward.Attention
name="attention"
encoder=<encoder>
state_size={att}
dropout_keep_prob={keep}

[decoder]
class=decoders.decoder.Decoder
name="decoder"
vocabulary=<vocabulary>
data_id="caption"
max_output_len={max_out}
rnn_size={rnn}
embedding_size={emb}
dropout_keep_prob={keep}
encoders=[<encoder>]
attentions=[<attention>]

[bs_decoder]
class=decoders.beam_search_decoder.BeamSearchDecoder
name="bs_decoder"
parent_decoder=<decoder>
beam_size={beam}
length_normalization=0.6

[trainer]
class=trainers.cross_entropy_trainer.CrossEntropyTrainer
decoders=[<decoder>]
clip_norm=1.0
optimizer=<adam>

[adam]
class=tf.train.AdamOptimizer
learning_rate=0.0005

[runner]
class=runners.runner.GreedyRunner
decoder=<decoder>
output_series="caption"

[bs_runner]
class=runners.beam_search_runner.BeamSearchRunner
decoder=<bs_decoder>
output_series="caption_beam"
"""
INET_DATA_INI = """\
[main]
test_datasets=[<test_data>]

[test_data]
class=dataset.load_dataset_from_files
s_images=("{tmp}/{split}_images.npy", readers.numpy_reader.single_tensor)
s_caption_out="{out}/greedy.txt"
s_caption_beam_out="{out}/beam.txt"
"""
LEARN_BPE = """\
import sys
sys.path.insert(0, sys.argv[1])
from neuralmonkey_tpu_torch.processors.bpe import learn_bpe, save_merges
with open(sys.argv[2], encoding="utf-8") as f:
    corpus = [line.split() for line in f]
save_merges(learn_bpe(corpus, int(sys.argv[4])), sys.argv[3])
"""
NATIVE_BUILDER = """\
import os, sys, time
sys.path.insert(0, sys.argv[1])
while not os.path.exists(sys.argv[2]):
    time.sleep(0.005)
from neuralmonkey_tpu_torch import native
vocab = native.NativeVocab(native.get_lib(), ["<pad>", "<s>", "</s>",
                                              "<unk>", "x"])
ids, _ = vocab.encode([["x", "y"]], 2, None, False, False)
assert ids.tolist() == [[4, 3]], ids
print(native.library_path())
"""


def write_inet_inputs(tmp: str):
    """Seeded 224 x 224 x 3 images in [0, 1) (128 test, 256 training, 64
    validation) with captions of 16 words from the first 2000 of the
    15000-word captioning vocabulary (training and validation), and the
    INIs: the serving model (frozen), its data INI, the frozen training
    INI (4 steps) and the fine-tuning INI (2 steps)."""
    import numpy as np
    rng = np.random.RandomState(SEED + 27)
    with open(os.path.join(tmp, "cap_words.txt"), "w") as f:
        f.write("\n".join(f"w{i}" for i in range(CAP_VOCAB - 4)) + "\n")
    for split, count in (("inet_test", N_SENTENCES),
                         ("inet_train", N_INET_TRAIN), ("inet_val", N_VAL)):
        np.save(os.path.join(tmp, f"{split}_images.npy"),
                rng.rand(count, *INET_IMAGE).astype(np.float32))
        with open(os.path.join(tmp, f"{split}.caption"), "w") as f:
            f.writelines(" ".join(f"w{i}" for i in row) + "\n"
                         for row in rng.randint(0, SOURCE_WORDS, (count, 16)))
    images = np.load(os.path.join(tmp, "inet_train_images.npy"))
    np.save(os.path.join(tmp, "inet_tune_images.npy"), images[:N_INET_TUNE])
    first_lines(tmp, ("inet_train.caption",), N_INET_TUNE, "tune_")
    os.replace(os.path.join(tmp, "tune_inet_train.caption"),
               os.path.join(tmp, "inet_tune.caption"))
    widths = dict(tmp=tmp, batch=BATCH, seed=SEED, rnn=RNN, emb=EMB,
                  att=ATT, beam=BEAM, max_out=CAP_OUT)
    paths = {}
    for name, text in (
            ("inet.ini", INET_INI.format(
                out=os.path.join(tmp, "inet_serve"), train="inet_train",
                fine_tune=False, keep=1.0, **widths)),
            ("inet_data.ini", INET_DATA_INI.format(
                tmp=tmp, split="inet_test",
                out=os.path.join(tmp, "inet_serve"))),
            ("inet_train.ini", INET_INI.format(
                out=os.path.join(tmp, "inet_runs", "inet_train"),
                train="inet_train", fine_tune=False, keep=KEEP_PROB,
                **widths)),
            ("inet_tune.ini", INET_INI.format(
                out=os.path.join(tmp, "inet_runs", "inet_tune"),
                train="inet_tune", fine_tune=True, keep=KEEP_PROB,
                **widths))):
        paths[name] = os.path.join(tmp, name)
        with open(paths[name], "w") as f:
            f.write(text)
    for name in ("inet_serve", "inet_runs"):
        os.makedirs(os.path.join(tmp, name), exist_ok=True)
    return paths


def cnn_forward_record(network: str, batch: int, device, cpu_images: int):
    """One ``ImageNet(network)`` forward over ``batch`` seeded images of
    224 x 224 x 3 on the card against the CPU on its first
    ``cpu_images``: the spatial states and the output within
    ``INET_REL_ERR`` of their largest entry; the card's forward timed,
    with its images/s."""
    import torch

    from neuralmonkey_tpu_torch.model.part import (Context, collect_parts,
                                                   init_all_params)
    from neuralmonkey_tpu_torch.models.encoders.imagenet_encoder import \
        ImageNet

    enc = ImageNet(name="cnn", data_id="images", network_type=network)
    params = init_all_params(collect_parts([enc]), seed=SEED)
    images = torch.rand(batch, *INET_IMAGE,
                        generator=torch.Generator().manual_seed(SEED + 270))

    def forward(dev_params, dev_images):
        with torch.inference_mode():
            ctx = Context(dev_params, {"cnn.images": dev_images})
            return enc.spatial_states(ctx), enc.output(ctx)
    gpu_params = to_device(params, device)
    gpu_images = images.to(device)
    states, out = forward(gpu_params, gpu_images)
    ref_states, ref_out = forward(params, images[:cpu_images])
    errs = {"spatial_states": relative_err(states[:cpu_images].cpu(),
                                           ref_states),
            "output": relative_err(out[:cpu_images].cpu(), ref_out)}
    ms = time_ms(lambda: forward(gpu_params, gpu_images), runs=5)
    report = {"images": [batch, *INET_IMAGE], "cpu_images": cpu_images,
              "states": list(states.shape), "relative_err": errs, "ms": ms,
              "images_per_s": batch / (ms / 1000.0)}
    log(f"{network} forward: {report}")
    if not max(errs.values()) <= INET_REL_ERR:
        raise AssertionError(f"{network} on the card differs from the CPU: "
                             f"{errs}")
    return report


def runner_launches(exp, ckpt: str, data_ini: str):
    """Each runner of ``exp`` alone over the 128 test inputs from
    ``ckpt`` with the launch counts set to 0 just before it: its launches
    and sentences/s (after a warm-up pass)."""
    import torch

    from neuralmonkey_tpu_torch import run
    from neuralmonkey_tpu_torch.ops import kernel_config

    exp.tf_manager.restore(ckpt)
    dataset = run.load_data_config(data_ini)[0]
    report = {}
    for runner in exp.model.runners:
        exp.tf_manager.execute(dataset, [runner], BATCH)
        torch.cuda.synchronize()
        kernel_config.reset_launch_counts()
        start = time.perf_counter()
        exp.tf_manager.execute(dataset, [runner], BATCH)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = kernel_config.launch_counts()
        report[runner.output_series] = {
            "sentences_per_s": N_SENTENCES / seconds,
            "launches": {k: n for k, n in counts.items() if n}}
    return report


def decode_both(exp_ini: str, data_ini: str, ckpt: str):
    """The first N_PARITY inputs of ``data_ini`` decoded by each runner
    (greedy, beam) on the card and on the CPU: ((card greedy, card beam),
    (CPU greedy, CPU beam)) captions."""
    from neuralmonkey_tpu_torch import run
    from neuralmonkey_tpu_torch.experiment import Experiment

    dataset = run.load_data_config(data_ini)[0].subset(0, N_PARITY)
    outputs = []
    for changes in ([], ['tf_manager.device="cpu"']):
        exp = Experiment(exp_ini, train_mode=False, config_changes=changes)
        exp.build_model()
        exp.tf_manager.restore(ckpt)
        outputs.append(tuple(
            result.outputs for result in exp.tf_manager.run_on_batch(
                exp.model.runners, dataset, N_PARITY)))
        del exp
    return outputs


def evaluator_scores(card, cpu):
    """chrF3, TER, SacreBLEU and F1 (over tags that a word's index and
    position give)
    of each device's greedy captions against its beam captions, over the
    images whose captions both devices decode alike (``card`` and
    ``cpu``: (greedy, beam) captions); the scores must be equal."""
    from neuralmonkey_tpu_torch.evaluators import chrf, f1_bio, sacrebleu, ter

    same = [i for i in range(len(card[0]))
            if card[0][i] == cpu[0][i] and card[1][i] == cpu[1][i]]
    if not same:
        raise AssertionError("no caption decodes alike on both devices")

    def tags(sentences):
        # by the word's index and its position, so that a caption that
        # repeats one word still has entities
        return [[("O", "B-X", "I-X")[(int(w[1:]) + j) % 3]
                 for j, w in enumerate(s)] for s in sentences]
    report = {"sentences": len(same)}
    for name, evaluator, prepare in (
            ("chrF3", chrf.ChrF3, list), ("TER", ter.TER, list),
            ("SacreBLEU", sacrebleu.SacreBLEU, list),
            ("F1", f1_bio.F1, tags)):
        scores = [evaluator(prepare([greedy[i] for i in same]),
                            prepare([beam[i] for i in same]))
                  for greedy, beam in (card, cpu)]
        if scores[0] != scores[1]:
            raise AssertionError(f"{name}: card {scores[0]}, CPU {scores[1]}")
        report[name] = scores[0]
    log(f"evaluators over the decoded captions: {report}")
    return report


def check_logbook(logdir: str, experiment: str):
    """The port's logbook (``python -m neuralmonkey_tpu_torch.logbook``)
    over ``logdir`` on a free local port: ``/`` lists ``experiment`` and
    ``/experiment/<experiment>`` its files; the server is stopped."""
    import socket
    import urllib.request

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "neuralmonkey_tpu_torch.logbook", "--logdir",
         logdir, "--port", str(port)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=dict(os.environ, PYTHONPATH=REPO))
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 60
        while True:
            try:
                index = urllib.request.urlopen(base + "/", timeout=5).read()
                break
            except OSError:
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        page = urllib.request.urlopen(f"{base}/experiment/{experiment}",
                                      timeout=5).read().decode()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    if experiment not in index.decode() or "metrics.jsonl" not in page:
        raise AssertionError(f"logbook over {logdir}: {index[:500]!r} "
                             f"{page[:500]!r}")
    report = {"index_bytes": len(index), "experiment_bytes": len(page)}
    log(f"logbook: {report}")
    return report


def write_bpe_corpus(tmp: str) -> str:
    """BPE_SENTENCES seeded sentences of BPE_SENTENCE_LEN words drawn by
    Zipf's law from BPE_WORDS words of 3-10 letters."""
    import numpy as np
    rng = np.random.RandomState(SEED + 271)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = ["".join(rng.choice(letters, rng.randint(3, 11)))
             for _ in range(BPE_WORDS)]
    p = 1.0 / np.arange(1, BPE_WORDS + 1)
    ids = rng.choice(BPE_WORDS, (BPE_SENTENCES, BPE_SENTENCE_LEN),
                     p=p / p.sum())
    path = os.path.join(tmp, "bpe_corpus.txt")
    with open(path, "w") as f:
        f.writelines(" ".join(words[i] for i in row) + "\n" for row in ids)
    return path


def check_native(tmp: str, corpus: str, merges: str):
    """The native host library on this machine: BPE over the corpus with
    the learned merges through the native codec and the Python loop
    (``NM_NATIVE=0``), each from a cold cache, byte-equal, sentences/s of
    each, and every distinct word once (the merge loop alone, words/s);
    the flagship's vocabulary over 20000 of its sentences in batches of
    64 both ways, equal ``(ids, mask)``, sentences/s of each; the paths
    timed in turns (native, Python, Python, native); and
    N_NATIVE_BUILDERS processes building into one fresh
    ``NM_NATIVE_CACHE`` at once, every one of them loading."""
    import numpy as np

    from neuralmonkey_tpu_torch import native
    from neuralmonkey_tpu_torch.processors.bpe import BPECodec
    from neuralmonkey_tpu_torch.vocabulary import from_wordlist

    with open(corpus, encoding="utf-8") as f:
        sentences = [line.split() for line in f]
    unique = list(dict.fromkeys(w for s in sentences for w in s))
    flagship = np.random.RandomState(SEED + 272).randint(
        0, VOCAB - 4, (BPE_SENTENCES, SRC_LEN))
    flagship = [[f"w{i}" for i in row] for row in flagship]
    vocabulary = from_wordlist(os.path.join(tmp, "words.txt"))
    report = {"merges": None, "bpe": {}, "vocabulary": {}}
    outputs = {}
    rates = {}
    for path in ("native", "python", "python", "native"):
        if path == "python":
            os.environ["NM_NATIVE"] = "0"
        try:
            codec = BPECodec(merges)
            report["merges"] = len(codec.bpe_codes)
            if (codec._native_codec() is None) != (path == "python"):
                raise AssertionError(f"BPE took the wrong path for {path}")
            start = time.perf_counter()
            encoded = [codec.encode(s) for s in sentences]
            seconds = time.perf_counter() - start
            # the merge loop alone: every distinct word once, from a cold
            # cache, as one sentence
            cold = BPECodec(merges)
            start = time.perf_counter()
            cold.encode(unique)
            unique_seconds = time.perf_counter() - start
            vocabulary._invalidate_native()
            start = time.perf_counter()
            tensors = [vocabulary.sentences_to_tensor(
                flagship[i:i + BATCH], add_end_symbol=True)
                for i in range(0, len(flagship), BATCH)]
            vocab_seconds = time.perf_counter() - start
            if (vocabulary._native is False) != (path == "python"):
                raise AssertionError(f"the vocabulary took the wrong path "
                                     f"for {path}")
        finally:
            os.environ.pop("NM_NATIVE", None)
        outputs.setdefault(path, (encoded, tensors))
        for key, rate in (
                (("bpe", "sentences_per_s"), len(sentences) / seconds),
                (("bpe", "cold_words_per_s"), len(unique) / unique_seconds),
                (("vocabulary", "sentences_per_s"),
                 len(flagship) / vocab_seconds)):
            rates.setdefault((*key, path), []).append(rate)
    for (part, metric, path), values in rates.items():
        report[part][f"{path}_{metric}"] = values
    if outputs["native"][0] != outputs["python"][0]:
        raise AssertionError("native BPE differs from the Python loop")
    for (ids_n, mask_n), (ids_p, mask_p) in zip(outputs["native"][1],
                                                outputs["python"][1]):
        if not (np.array_equal(ids_n, ids_p)
                and np.array_equal(mask_n, mask_p)):
            raise AssertionError("native vocabulary encoding differs from "
                                 "the Python loop")
    report["bpe"]["subwords"] = sum(len(s) for s in outputs["native"][0])
    report["bpe"]["distinct_words"] = len(unique)
    cache = os.path.join(tmp, "native_cache")
    go = os.path.join(tmp, "native_go")
    env = dict(os.environ, NM_NATIVE_CACHE=cache)
    procs = [subprocess.Popen([sys.executable, "-c", NATIVE_BUILDER, REPO,
                               go], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(N_NATIVE_BUILDERS)]
    start = time.perf_counter()
    with open(go, "w"):
        pass
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [err[-2000:] for p, (_, err) in zip(procs, outs)
              if p.returncode != 0]
    libraries = sorted(os.listdir(cache))
    if failed or len({out.strip() for out, _ in outs}) != 1 \
            or len(libraries) != 1:
        raise AssertionError(f"concurrent native builds: failures {failed}, "
                             f"files {libraries}")
    report["concurrent_build"] = {
        "processes": N_NATIVE_BUILDERS, "files": libraries,
        "seconds": time.perf_counter() - start,
        "library": os.path.basename(native.library_path())}
    log(f"native host library: {report}")
    return report


def check_image_tail(tmp: str, device, t_ini: str, t_data_ini: str,
                     t_ckpt: str):
    """Phase 27. Returns (the launches of its main-path runs, report)."""
    from neuralmonkey_tpu_torch.experiment import Experiment
    from neuralmonkey_tpu_torch.utils.saving import flatten_tree, load_flat

    seconds = {}
    report = {"seconds": seconds}
    corpus = write_bpe_corpus(tmp)
    merges = os.path.join(tmp, "bpe_merges.txt")
    # the merge table is learned in a process of its own while the card
    # works on the captioning model
    learner = subprocess.Popen(
        [sys.executable, "-c", LEARN_BPE, REPO, corpus, merges,
         str(BPE_MERGES)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    learn_start = time.perf_counter()
    try:
        paths = timed(seconds, "inputs", write_inet_inputs, tmp)
        exp = Experiment(paths["inet.ini"], train_mode=False)
        exp.build_model()
        ckpt = exp.tf_manager.save(os.path.join(tmp, "inet_params"))
        launches, lines = timed(
            seconds, "run", serve_through_run, paths["inet.ini"],
            paths["inet_data.ini"], ckpt, INET_SERVING_KERNELS,
            [os.path.join(tmp, "inet_serve", name)
             for name in ("greedy.txt", "beam.txt")], "imagenet captioning")
        serving = timed(seconds, "runners", runner_launches, exp, ckpt,
                        paths["inet_data.ini"])
        if not (serving["caption"]["launches"].get("fused_bahdanau_step")
                and all(serving["caption_beam"]["launches"].get(k)
                        for k in ("fused_logits_rowmax_lse",
                                  "small_topk"))):
            raise AssertionError(f"captioning launches: {serving}")
        report["serving"] = {"mean_output_tokens": mean_lengths(lines),
                             "runners": serving,
                             "launches": {k: launches[k]
                                          for k in INET_SERVING_KERNELS}}
        report["serving"]["parity"] = timed(
            seconds, "parity", check_parity, paths["inet.ini"],
            paths["inet_data.ini"], exp, ckpt)
        del exp
        card, cpu = timed(seconds, "decode_both", decode_both,
                          paths["inet.ini"], paths["inet_data.ini"], ckpt)
        report["evaluators"] = evaluator_scores(card, cpu)
        report["vgg_16"] = timed(seconds, "vgg_16", cnn_forward_record,
                                 "vgg_16", BATCH, device, INET_CPU_IMAGES)
        report["resnet_v2_50"] = timed(
            seconds, "resnet_v2_50", cnn_forward_record, "resnet_v2_50",
            RESNET_BATCH, device, RESNET_BATCH)

        report["training"] = {}
        for name in ("inet_train", "inet_tune"):
            ini = paths[f"{name}.ini"]
            # the CNN's initial tensors: the frozen run must leave them,
            # the fine-tuning run move them
            exp = Experiment(ini, train_mode=False)
            exp.build_model()
            initial = {k: v.detach().cpu().clone() for k, v in flatten_tree(
                exp.tf_manager.params["imagenet"]).items()}
            del exp
            # run_training writes under tmp/inet_runs/<name>_plain
            counts, record, best = timed(
                seconds, name, run_training, tmp, ini, False,
                f"inet_runs/{name}", ("fused_bahdanau_step",),
                INET_DATA_INI.replace("{split}", "inet_val"),
                name == "inet_train")
            launches = add_launches(launches, counts)
            trained = load_flat(best)
            moved = sum(not torch_equal(trained[f"imagenet/{k}"], v)
                        for k, v in initial.items())
            frozen = name == "inet_train"
            if (moved == 0) != frozen:
                raise AssertionError(f"{name}: {moved} of {len(initial)} CNN "
                                     "tensors moved")
            record["cnn_tensors_moved"] = moved
            report["training"][name] = record
            if frozen:
                report["training_parity"] = timed(
                    seconds, "training_parity", check_train_parity, ini,
                    best, ("attention", "decoder"), True)

        report["logbook"] = timed(
            seconds, "logbook", check_logbook,
            os.path.join(tmp, "inet_runs"), "inet_train_plain")

        with open(t_ini) as f:
            text = f.read()
        maps_ini = os.path.join(tmp, "t_maps.ini")
        with open(maps_ini, "w") as f:
            f.write(text.replace("output_series=",
                                 "visualize_attention=True\noutput_series="))
        report["transformer_maps"] = timed(
            seconds, "transformer_maps", attention_maps, t_ini, t_data_ini,
            t_ckpt, tmp, "t")
        per_step = {}
        for label, ini in (("without maps", t_ini), ("with maps", maps_ini)):
            exp = Experiment(ini, train_mode=False)
            exp.build_model()
            per_step[label] = launches_per_step(exp, t_ckpt, t_data_ini,
                                                count_ops=True)
            del exp
        for series, step in per_step["without maps"].items():
            mapped = per_step["with maps"][series]
            if step["by_kernel"] != mapped["by_kernel"] \
                    or not mapped["aten_ops_per_step"] \
                    > step["aten_ops_per_step"]:
                raise AssertionError(f"transformer steps with and without "
                                     f"maps: {per_step}")
        report["transformer_maps"]["per_step"] = per_step
        log(f"transformer steps with and without maps: {per_step}")

        _, err = learner.communicate(timeout=900)
        seconds["bpe_learning"] = time.perf_counter() - learn_start
        if learner.returncode != 0:
            raise AssertionError(f"learn_bpe failed: {err[-2000:]}")
        report["native"] = timed(seconds, "native", check_native, tmp,
                                 corpus, merges)
        if report["native"]["merges"] != BPE_MERGES:
            raise AssertionError(f"{report['native']['merges']} merges "
                                 "learned")
    finally:
        if learner.poll() is None:
            learner.kill()
            learner.wait()
    log(f"image tail: {report}")
    return launches, report


# ---------------------------------------------------------------------- #
# phase 28: data parallelism, ZeRO-1 and FSDP on the card
# ---------------------------------------------------------------------- #
DP_STEPS = 4
DP_KERNELS = ("gru_scan", "gru_bptt", "fused_bahdanau_step")
DP_MODES = {"replicated": (), "zero1": ("tf_manager.shard_optimizer_state"
                                        "=True",),
            "fsdp": ("tf_manager.fsdp=True",)}
DP_TIMEOUT = 420.0
DP_LOSS_ATOL = 1e-5
# ZeRO-1's optimizer state and FSDP's parameters and state on each of two
# ranks, as a share of the replicated bytes
DP_AT_REST_SHARE = 0.55


def write_dp_inputs(tmp: str):
    """Phase 6's model for DP_STEPS steps: its first DP_STEPS * BATCH
    training pairs, dropout off (so two ranks compute one process's
    function), a loss logged every step, no validation (phase 28 decodes
    on its own)."""
    first_lines(tmp, ("train.src", "train.tgt"), DP_STEPS * BATCH, "dp_")
    with open(os.path.join(tmp, "train.ini")) as f:
        text = f.read()
    text = text.replace(f'"{tmp}/train.src"', f'"{tmp}/dp_train.src"')
    text = text.replace(f'"{tmp}/train.tgt"', f'"{tmp}/dp_train.tgt"')
    text = text.replace(f"dropout_keep_prob={KEEP_PROB}",
                        "dropout_keep_prob=1.0")
    text = text.replace("logging_period=5", "logging_period=1")
    text = text.replace("val_dataset=<val_data>\n", "")
    dp_ini = os.path.join(tmp, "dp_train.ini")
    with open(dp_ini, "w") as f:
        f.write(text)
    data_ini = os.path.join(tmp, "dp_data.ini")
    with open(data_ini, "w") as f:
        f.write(DATA_INI.format(tmp=tmp, prefix="dp_"))
    return dp_ini, data_ini


def card_settings() -> None:
    """A rank's process takes the smoke's settings: float32 products
    without TF32."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def at_rest_bytes(manager) -> dict:
    """The bytes of this rank's parameters and optimizer state."""
    from neuralmonkey_tpu_torch.utils.saving import flatten_tree
    return {"params": sum(v.numel() * v.element_size() for v in
                          flatten_tree(manager.params).values()),
            "optimizer": sum(v.numel() * v.element_size()
                             for state in manager._opt_states.values()
                             for v in state.values())}


def dp_train(dp_ini: str, out: str, extra) -> dict:
    """DP_STEPS steps of ``dp_ini`` through the train CLI's ``main``, the
    launch counts and the card's memory peak set to 0 just before, what
    earlier runs of the process left collected first: every step's loss
    (as this rank computed it), launches, the bytes allocated before the
    run and its peak, seconds, and train tokens/s: the global batch's
    target tokens of steps 2 to DP_STEPS over the time from the end of
    step 1 to the end of the last (the first step holds the warm-up)."""
    import gc

    import torch

    from neuralmonkey_tpu_torch import runtime, train
    from neuralmonkey_tpu_torch.ops import kernel_config

    losses, tokens, ends = [], [], []
    step = runtime.CUDAManager.train_on_prepared

    def recording(self, trainer, batch):
        out_ = step(self, trainer, batch)
        losses.append(out_["loss"])
        tokens.append(out_["target_tokens"])
        # the loop reads every step's loss (logging_period=1) anyway
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        return out_

    runtime.CUDAManager.train_on_prepared = recording
    try:
        gc.collect()
        torch.cuda.empty_cache()
        kernel_config.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        allocated = torch.cuda.memory_allocated()
        start = time.perf_counter()
        if train.main([dp_ini, f'main.output="{out}"', *extra]) != 0:
            raise AssertionError("neuralmonkey_tpu_torch.train failed")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    finally:
        runtime.CUDAManager.train_on_prepared = step
    return {"losses": [float(v) for v in losses], "seconds": seconds,
            "launches": kernel_config.launch_counts(),
            "allocated_before": allocated,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "train_tokens_per_sec": (float(sum(tokens[1:]))
                                     / (ends[-1] - ends[0])),
            "written": sorted(os.listdir(out))}


def dp_continue(dp_ini: str, ckpt_dir: str, extra) -> dict:
    """A manager of ``dp_ini`` (with ``extra`` overrides) restored from
    ``ckpt_dir``'s checkpoint of step DP_STEPS and its optimizer state:
    the loss of one more step on the first BATCH pairs, and the bytes
    it holds at rest after it."""
    from neuralmonkey_tpu_torch.experiment import Experiment

    exp = Experiment(dp_ini, config_changes=list(extra))
    exp.build_model()
    path = os.path.join(ckpt_dir, "variables.data")
    exp.tf_manager.restore(f"{path}-{DP_STEPS}")
    exp.tf_manager.load_optimizer_state(path)
    batch = exp.model.train_dataset.subset(0, BATCH)
    loss = exp.tf_manager.train_on_batch(exp.model.trainer, batch,
                                         BATCH)["loss"]
    return {"loss": loss, "at_rest_bytes": at_rest_bytes(exp.tf_manager)}


def dp_nccl_rank(tmp: str, dp_ini: str, port: int, result: str) -> None:
    """Phase 28 (a): one rank over NCCL, joined by the train CLI from the
    NM_* environment; DP_STEPS steps under each of DP_MODES."""
    card_settings()
    os.environ.update({"NM_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                       "NM_NUM_PROCESSES": "1", "NM_PROCESS_ID": "0"})
    report = {}
    for mode, extra in DP_MODES.items():
        report[mode] = dp_train(dp_ini, os.path.join(tmp, f"dp_a_{mode}"),
                                extra)
    import torch.distributed as dist
    report["backend"] = dist.get_backend()
    report["world"] = dist.get_world_size()
    dist.destroy_process_group()
    with open(result, "w") as f:
        json.dump(report, f)


def dp_gloo_rank(rank: int, tmp: str, dp_ini: str, port: int, exp_ini: str,
                 data_ini: str, ckpt: str, result: str) -> None:
    """Phase 28 (b): rank ``rank`` of two sharing the card over gloo:
    DP_STEPS steps under each of DP_MODES (each rank into its own output
    directory, so that what it writes shows), one step more from rank
    0's checkpoint, then phase 4's 128 sentences decoded under fsdp."""
    import torch

    from neuralmonkey_tpu_torch import run
    from neuralmonkey_tpu_torch.experiment import Experiment
    from neuralmonkey_tpu_torch.ops import kernel_config
    from neuralmonkey_tpu_torch.parallel import distributed

    card_settings()
    distributed.maybe_initialize(f"127.0.0.1:{port}", 2, rank,
                                 backend="gloo")
    on_card = ['tf_manager.device="cuda:0"']
    report = {}
    for mode, extra in DP_MODES.items():
        record = dp_train(dp_ini, os.path.join(tmp, f"dp_b_{mode}_r{rank}"),
                          on_card + list(extra))
        record["continued"] = dp_continue(
            dp_ini, os.path.join(tmp, f"dp_b_{mode}_r0"),
            on_card + list(extra) + [
                f'main.output="{tmp}/dp_b_{mode}_cont_r{rank}"'])
        report[mode] = record
    exp = Experiment(exp_ini, train_mode=False,
                     config_changes=on_card + ["tf_manager.fsdp=True"])
    exp.build_model()
    exp.restore_variables([ckpt])
    picks, ids = record_beam(exp)
    kernel_config.reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for dataset in run.load_data_config(data_ini):
        exp.run_model(dataset, write_out=True)
    torch.cuda.synchronize()
    report["decode"] = {"seconds": time.perf_counter() - start,
                        "launches": kernel_config.launch_counts()}
    torch.save({"picks": picks, "ids": ids},
               os.path.join(tmp, f"dp_beam_r{rank}.pt"))
    torch.distributed.destroy_process_group()
    with open(result, "w") as f:
        json.dump(report, f)


def record_beam(exp):
    """Hook ``exp``'s beam search to record, a batch each, the picks of
    this rank's rows (its selector's (parent, token), a (rows, K, 2)
    tensor a step) and the best hypotheses' ids of the whole batch as
    its runner collects them (every rank's rows gathered)."""
    import numpy as np
    import torch

    manager, runner = exp.tf_manager, exp.model.runners[1]
    search = runner.decoder
    selector = ("_select_flat" if search._method() == "flat"
                else "_select_hier")
    plain_select = getattr(search, selector)
    plain_run, plain_collect = manager.run_on_batch, runner.collect_results
    picks, ids = [], []

    def select(*args, **kwargs):
        out = plain_select(*args, **kwargs)
        picks[-1].append(torch.stack(out[:2], dim=-1).cpu())
        return out

    def run_on_batch(*args, **kwargs):
        picks.append([])
        return plain_run(*args, **kwargs)

    def collect_results(fetched, num_examples):
        ids.append(np.asarray(fetched["token_ids"])[:num_examples, 0])
        return plain_collect(fetched, num_examples)

    setattr(search, selector, select)
    manager.run_on_batch = run_on_batch
    runner.collect_results = collect_results
    return picks, ids


def run_ranks(targets, timeout: float = DP_TIMEOUT):
    """Start each (function, args) of ``targets`` as a process of its
    own (spawn) and wait for all; a process that fails, or any left
    after ``timeout`` seconds, kills the others and raises."""
    import multiprocessing

    context = multiprocessing.get_context("spawn")
    procs = [context.Process(target=fn, args=args) for fn, args in targets]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if (any(p.exitcode not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.1)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=60)
    codes = [p.exitcode for p in procs]
    if codes != [0] * len(procs):
        raise AssertionError(f"data-parallel ranks exited with {codes} "
                             f"(a rank failed, or the group outlived "
                             f"{timeout:.0f} s and was killed)")


def check_data_parallel(tmp: str, exp_ini: str, data_ini: str, ckpt: str,
                        smi: str):
    """Phase 28. Returns (the launches of its main-path runs, report)."""
    import numpy as np
    import torch

    from neuralmonkey_tpu_torch.dataset import from_dict

    seconds = {}
    report = {"seconds": seconds, "device": smi}
    dp_ini, dp_data_ini = write_dp_inputs(tmp)
    base = timed(seconds, "one process", dp_train, dp_ini,
                 os.path.join(tmp, "dp_base"), ())
    result_a = os.path.join(tmp, "dp_a.json")
    timed(seconds, "(a) nccl world 1", run_ranks, [
        (dp_nccl_rank, (tmp, dp_ini, free_port(), result_a))])
    with open(result_a) as f:
        nccl = json.load(f)
    port = free_port()
    results_b = [os.path.join(tmp, f"dp_b{r}.json") for r in range(2)]
    timed(seconds, "(b) two gloo ranks on one card", run_ranks, [
        (dp_gloo_rank, (r, tmp, dp_ini, port, exp_ini, dp_data_ini, ckpt,
                        results_b[r])) for r in range(2)])
    ranks = []
    for path in results_b:
        with open(path) as f:
            ranks.append(json.load(f))
    one_rank = timed(seconds, "fsdp checkpoint in one process",
                     dp_continue, dp_ini, os.path.join(tmp, "dp_b_fsdp_r0"),
                     [f'main.output="{tmp}/dp_one_cont"'])

    failures = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    def close(a, b) -> bool:
        return len(a) == len(b) and all(
            abs(x - y) <= DP_LOSS_ATOL for x, y in zip(a, b))

    check(nccl["backend"] == "nccl" and nccl["world"] == 1,
          f"(a) ran {nccl['backend']} at world {nccl['world']}")
    check(len(base["losses"]) == DP_STEPS, f"one process: {base['losses']}")
    for mode in DP_MODES:
        a, b0, b1 = nccl[mode], ranks[0][mode], ranks[1][mode]
        check(close(a["losses"], base["losses"]),
              f"(a) {mode}: losses {a['losses']} against one process's "
              f"{base['losses']}")
        check(b0["losses"] == b1["losses"],
              f"(b) {mode}: the ranks' losses differ: {b0['losses']}, "
              f"{b1['losses']}")
        check(close(b0["losses"], a["losses"]),
              f"(b) {mode}: losses {b0['losses']} against (a)'s "
              f"{a['losses']}")
        for label, record in (("(a)", a), ("(b) rank 0", b0),
                              ("(b) rank 1", b1)):
            missing = [k for k in DP_KERNELS if not record["launches"][k]]
            check(not missing, f"{label} {mode}: never launched {missing}")
        check(any(n.startswith("variables.data-") for n in b0["written"])
              and "variables.data.opt" in b0["written"],
              f"(b) {mode}: rank 0 wrote {b0['written']}")
        check(b1["written"] == ["experiment.log.p1"],
              f"(b) {mode}: rank 1 wrote {b1['written']}")
    for rank, result in enumerate(ranks):
        replicated = result["replicated"]["continued"]["at_rest_bytes"]
        zero1 = result["zero1"]["continued"]["at_rest_bytes"]
        fsdp = result["fsdp"]["continued"]["at_rest_bytes"]
        check(zero1["optimizer"] <= DP_AT_REST_SHARE
              * replicated["optimizer"]
              and zero1["params"] == replicated["params"],
              f"(b) rank {rank} ZeRO-1 at rest {zero1} against {replicated}")
        check(all(fsdp[k] <= DP_AT_REST_SHARE * replicated[k]
                  for k in replicated),
              f"(b) rank {rank} FSDP at rest {fsdp} against {replicated}")
        decode = result["decode"]["launches"]
        missing = [k for k in SERVING_KERNELS if not decode[k]]
        check(not missing, f"(b) rank {rank} decode: never launched "
                           f"{missing}")
        # FSDP gathers at use: the whole tree and all its gradients never
        # live at once, so each rank's peak falls below ZeRO-1's
        check(result["fsdp"]["max_memory_allocated"]
              < result["zero1"]["max_memory_allocated"],
              f"(b) rank {rank}: FSDP peak "
              f"{result['fsdp']['max_memory_allocated']} not below ZeRO-1's "
              f"{result['zero1']['max_memory_allocated']}")
    fsdp_cont = [r["fsdp"]["continued"]["loss"] for r in ranks]
    check(fsdp_cont[0] == fsdp_cont[1]
          and abs(one_rank["loss"] - fsdp_cont[0]) <= DP_LOSS_ATOL,
          f"FSDP checkpoint: one process continues at {one_rank['loss']}, "
          f"two ranks at {fsdp_cont}")

    # the two-rank decode against phase 4's by phase 5's rule
    with open(os.path.join(tmp, "source.txt")) as f:
        sources = f.read().splitlines()
    differ = {}
    for name in ("greedy", "beam"):
        with open(os.path.join(tmp, f"phase4_{name}.txt")) as f:
            want = f.read().splitlines()
        with open(os.path.join(tmp, f"dp_{name}.txt")) as f:
            got = f.read().splitlines()
        check(len(got) == len(want) == N_SENTENCES,
              f"decode: {len(got)} {name} lines")
        differ[name] = {i: (w, g) for i, (w, g) in enumerate(zip(want, got))
                        if w != g}
    greedy_gaps = {i: greedy_gap(exp_ini, ckpt, sources[i].split(),
                                 w.split(), g.split())
                   for i, (w, g) in differ["greedy"].items()}
    check(all(gap < MARGIN for gap in greedy_gaps.values()),
          f"decode: greedy ids differ from phase 4's where the CPU's gap "
          f"is not below {MARGIN}: {greedy_gaps}")
    # the beam: where the two-rank search's best ids differ from phase
    # 4's, the CPU's gap where that search first picks apart from the
    # CPU's (each rank's picks of its rows as it recorded them, the ids
    # every rank collected)
    logs = [torch.load(os.path.join(tmp, f"dp_beam_r{r}.pt"),
                       weights_only=False) for r in range(2)]
    check(len(logs[0]["ids"]) == len(logs[1]["ids"]) and all(
        np.array_equal(a, b) for a, b in zip(logs[0]["ids"],
                                              logs[1]["ids"])),
          "decode: the ranks collected different beam ids")
    beam_parity = None
    if differ["beam"] and not failures:
        rows = sorted(differ["beam"])
        half = BATCH // 2
        card_picks, card_ids = [], []
        for i in rows:
            j, within = divmod(i, BATCH)
            rank, local = divmod(within, half)
            card_picks.append([p[local] for p in logs[rank]["picks"][j]])
            card_ids.append(logs[0]["ids"][j][within])
        beam_parity = check_parity(
            exp_ini, data_ini, None, ckpt,
            from_dict({"source": [sources[i].split() for i in rows]}),
            card=(card_picks, card_ids))
    if failures:
        raise AssertionError("data parallel: " + "; ".join(failures))

    launches = add_launches(add_launches(base["launches"], ranks[0][
        "decode"]["launches"]), ranks[1]["decode"]["launches"])
    for result in ranks:
        for mode in DP_MODES:
            launches = add_launches(launches, result[mode]["launches"])
    for mode in DP_MODES:
        launches = add_launches(launches, nccl[mode]["launches"])
    report.update({
        "steps": DP_STEPS, "batch": BATCH,
        "one_process_losses": base["losses"],
        "a_nccl_world_1": {mode: {k: nccl[mode][k] for k in (
            "losses", "train_tokens_per_sec", "allocated_before",
            "max_memory_allocated")} for mode in DP_MODES},
        "b_two_gloo_ranks_on_one_card": [{mode: {
            "losses": r[mode]["losses"],
            "allocated_before": r[mode]["allocated_before"],
            "max_memory_allocated": r[mode]["max_memory_allocated"],
            "at_rest_bytes": r[mode]["continued"]["at_rest_bytes"],
            "continued_loss": r[mode]["continued"]["loss"],
            "train_tokens_per_sec": r[mode]["train_tokens_per_sec"]}
            for mode in DP_MODES} for r in ranks],
        "b_peak_bytes_per_rank": [{mode: r[mode]["max_memory_allocated"]
                                   for mode in ("zero1", "fsdp")}
                                  for r in ranks],
        "fsdp_checkpoint_one_process_continued_loss": one_rank["loss"],
        "train_tokens_per_sec": {
            "one process": base["train_tokens_per_sec"],
            **{f"(a) nccl world 1, {mode}":
               nccl[mode]["train_tokens_per_sec"] for mode in DP_MODES},
            **{f"(b) two ranks time-sharing one card (not scaling), "
               f"{mode}": ranks[0][mode]["train_tokens_per_sec"]
               for mode in DP_MODES}},
        "decode": {"seconds": [r["decode"]["seconds"] for r in ranks],
                   "greedy_differing_from_phase_4": greedy_gaps,
                   "beam_differing_from_phase_4": sorted(differ["beam"]),
                   "beam_parity": beam_parity},
    })
    log(f"data parallel ({smi}; (b) is two ranks time-sharing one card, "
        f"not scaling): {report}")
    return launches, report


# ---------------------------------------------------------------------- #
# phase 29: tensor, sequence and context parallelism on the card
# ---------------------------------------------------------------------- #
MA_STEPS = 4
MA_TIMEOUT = 420.0
# (d): the full-width Transformer over two data ranks
MA_ZERO_STEPS = 2
MA_ZERO_MODES = {"zero1": "tf_manager.shard_optimizer_state=True",
                 "fsdp": "tf_manager.fsdp=True"}
MA_LOCAL_HEADS = T_HEADS // 2
MA_TRAIN_KERNELS = FLASH_KERNELS
MA_DECODE_KERNELS = ("flash_attention_fwd", "small_topk")
# each rank's parameter bytes at rest, as a share of one process's
MA_AT_REST_SHARE = 0.6
# Adam's epsilon raised from 1e-9: the key biases' exact gradient is 0,
# and a small epsilon turns their rounding noise into steps of the
# learning rate, which a comparison of the parameters after a step to
# 1e-5 would count
MA_MAIN = """\
[main]
name="chip smoke model axes"
tf_manager=<tf_manager>
output="{tmp}/ma_out"
overwrite_output_dir=True
batch_size={batch}
epochs=1
train_dataset=<train_data>
trainer=<trainer>
runners=[<runner>, <bs_runner>]
random_seed={seed}

[train_data]
class=dataset.load_dataset_from_files
s_source="{tmp}/train.src"
s_target="{tmp}/train.tgt"
lazy=False

[trainer]
class=trainers.cross_entropy_trainer.CrossEntropyTrainer
decoders=[<decoder>]
clip_norm=1.0
optimizer=<adam>

[adam]
class=tf.train.AdamOptimizer
learning_rate=1.0e-4
epsilon=1.0e-4

"""
MA_DATA_INI = """\
[main]
test_datasets=[<test_data>]

[test_data]
class=dataset.load_dataset_from_files
s_source="{tmp}/ma_source.txt"
s_target_out="{tmp}/ma_greedy.txt"
s_target_beam_out="{tmp}/ma_beam.txt"
"""


_MA_REF = {}


def ma_train(ini: str, changes, ref: str = None, peak_without_sp=False,
             steps: int = MA_STEPS):
    """``steps`` steps of ``ini``'s model on its first ``steps`` batches,
    the launch counts set to 0 just before: every step's loss and peak
    bytes, the bytes at rest, train tokens/s of steps 2 on, and
    after step 1 the parameters' largest gap to ``ref``'s (one process's,
    saved there), or with no ``ref`` saved there. With
    ``peak_without_sp`` one more step with the sequence split off, its
    peak. Returns (the record, the experiment)."""
    import torch

    from neuralmonkey_tpu_torch.experiment import Experiment
    from neuralmonkey_tpu_torch.ops import kernel_config
    from neuralmonkey_tpu_torch.utils.saving import flatten_tree

    exp = Experiment(ini, config_changes=list(changes))
    exp.build_model()
    manager, trainer = exp.tf_manager, exp.model.trainer
    data = exp.model.train_dataset
    batches = [data.subset(i * BATCH, BATCH) for i in range(steps + 1)]
    losses, peaks, tokens, ends = [], [], [], []
    gap = None
    kernel_config.reset_launch_counts()
    for step, batch in enumerate(batches[:steps]):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = manager.train_on_batch(trainer, batch, BATCH)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        losses.append(out["loss"])
        tokens.append(out["target_tokens"])
        peaks.append(torch.cuda.max_memory_allocated())
        if step == 0:
            whole = {k: v.detach().cpu() for k, v in
                     flatten_tree(manager.whole_params()).items()}
            if ref is None:
                torch.save(whole, ref_path(ini))
            else:
                if ref not in _MA_REF:
                    _MA_REF[ref] = torch.load(ref, weights_only=True)
                want = _MA_REF[ref]
                gap = max(float((whole[k] - want[k]).abs().max())
                          for k in want)
            del whole
    launches = kernel_config.launch_counts()
    record = {"losses": losses, "peak_bytes": peaks,
              "at_rest_bytes": at_rest_bytes(manager),
              "train_tokens_per_sec": float(sum(tokens[1:]))
              / (ends[-1] - ends[0]),
              "param_gap_after_step_1": gap, "launches": launches}
    if peak_without_sp:
        manager.mesh.sequence = False
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        manager.train_on_batch(trainer, batches[steps], BATCH)
        torch.cuda.synchronize()
        record["peak_bytes_without_sp"] = torch.cuda.max_memory_allocated()
    return record, exp


def ref_path(ini: str) -> str:
    """Where one process's parameters after step 1 of ``ini`` are kept."""
    return os.path.splitext(ini)[0] + "_ref_params.pt"


def ma_rank(rank: int, tmp: str, ini: str, port: int, t_ini: str,
            t_ckpt: str, result: str) -> None:
    """Phase 29 on rank ``rank`` of two sharing the card over gloo: (a)
    MA_STEPS steps under TP 2 with sequence sharding (and one without,
    for its peak), (b) phase 9's first batch decoded (greedy and beam
    10) under TP 2 from its checkpoint (phase 9's model, restored into
    (a)'s), (c) MA_STEPS steps under CP 2, (d) MA_ZERO_STEPS steps over
    two data ranks under ZeRO-1 and under FSDP, then under FSDP phase
    9's first batch decoded (greedy and beam 10) from its checkpoint,
    each step gathering the decoder's layers."""
    import torch

    from neuralmonkey_tpu_torch import run
    from neuralmonkey_tpu_torch.ops import kernel_config
    from neuralmonkey_tpu_torch.parallel import distributed

    card_settings()
    distributed.maybe_initialize(f"127.0.0.1:{port}", 2, rank,
                                 backend="gloo")
    on_card = ['tf_manager.device="cuda:0"']
    ref = ref_path(ini)
    report = {}
    report["tp_sp"], exp = ma_train(
        ini, on_card + ["tf_manager.num_model_shards=2",
                        "tf_manager.sequence_sharding=True"],
        ref, peak_without_sp=True)
    # the sequence split stays off for the decode (TP 2 alone)
    exp.tf_manager.restore(t_ckpt)
    picks, ids = record_beam(exp)
    kernel_config.reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    data_ini = os.path.join(tmp, "ma_data.ini")
    for dataset in run.load_data_config(data_ini):
        exp.run_model(dataset, write_out=True)
    torch.cuda.synchronize()
    report["decode"] = {"seconds": time.perf_counter() - start,
                        "launches": kernel_config.launch_counts(),
                        "heads": exp.tf_manager.params["decoder"]["layer_0"][
                            "self_att"]["q"]["w"].shape[1] // T_HEAD_DIM}
    torch.save({"picks": picks, "ids": ids},
               os.path.join(tmp, f"ma_beam_r{rank}.pt"))
    del exp
    gc_card()
    report["cp"], exp = ma_train(
        ini, on_card + ["tf_manager.num_context_shards=2"], ref)
    del exp
    gc_card()
    # (d) ZeRO-1 and FSDP over two data ranks, FSDP gathering each
    # layer's unit at use
    for mode, extra in MA_ZERO_MODES.items():
        report[mode], exp = ma_train(ini, on_card + [extra], ref,
                                     steps=MA_ZERO_STEPS)
        if mode == "fsdp":
            exp.tf_manager.restore(t_ckpt)
            picks, ids = record_beam(exp)
            kernel_config.reset_launch_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            for dataset in run.load_data_config(
                    os.path.join(tmp, "mf_data.ini")):
                exp.run_model(dataset, write_out=True)
            torch.cuda.synchronize()
            report["fsdp_decode"] = {
                "seconds": time.perf_counter() - start,
                "launches": kernel_config.launch_counts()}
            torch.save({"picks": picks, "ids": ids},
                       os.path.join(tmp, f"mf_beam_r{rank}.pt"))
        del exp
        gc_card()
    torch.distributed.destroy_process_group()
    with open(result, "w") as f:
        json.dump(report, f)


def local_heads_records(device):
    """Flash attention's forward, dq and dkv at a rank's 4 of the 8
    heads (the encoder's, the decoder's causal and the cross-attention's
    shapes) and K4 at the beam selection's, against their plain versions;
    the encoder shape timed beside its plain version."""
    import torch

    from neuralmonkey_tpu_torch.ops import beam_select
    from neuralmonkey_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(SEED + 29)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(device)

    records = {name: {"shapes": []} for name in MA_TRAIN_KERNELS}
    for case, tq, tk, causal in (("encoder", SRC_LEN, SRC_LEN, False),
                                 ("decoder self", TGT_LEN, TGT_LEN, True),
                                 ("cross", TGT_LEN, SRC_LEN, False)):
        b, h, d = BATCH, MA_LOCAL_HEADS, T_HEAD_DIM
        lengths = torch.randint(1, tk + 1, (b,), generator=gen)
        mask = (torch.arange(tk)[None] < lengths[:, None]).float().to(device)
        if causal:
            mask = torch.ones(b, tk, device=device)
        q, k, v, g = (randn(b, h, t, d) for t in (tq, tk, tk, tq))
        out, lse = fa.flash_forward(q, k, v, mask, causal)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ref_out, _ = fa.flash_forward_reference(*leaves, mask, causal)
        ref_dq, ref_dk, ref_dv = torch.autograd.grad(ref_out, leaves, g)
        bwd = (q, k, v, mask, lse, g, (g * out).sum(dim=-1), causal)
        dq = fa.flash_backward_dq(*bwd)
        dk, dv = fa.flash_backward_dkv(*bwd)
        ref_out = ref_out.detach()
        errs = {"flash_attention_fwd": max_err(out, ref_out),
                "flash_attention_bwd_dq": max_err(dq, ref_dq),
                "flash_attention_bwd_dkv": max(max_err(dk, ref_dk),
                                               max_err(dv, ref_dv))}
        for name, err in errs.items():
            if err > 2e-4:
                raise AssertionError(f"{name} at B {b}, H {h}, Tq {tq}, Tk "
                                     f"{tk} ({case}): max_abs_err {err}")
            entry = {"case": case, "shape": [b, h, tq, tk, d, causal],
                     "max_abs_err": err}
            if case == "encoder":
                entry.update(local_heads_times(name, q, k, v, g, mask, out,
                                               lse, bwd))
            records[name]["shapes"].append(entry)
    # K4 at the beam selection's group stage over the gathered vocabulary
    vp = -(-VOCAB // 128) * 128
    x = torch.round(randn(BATCH, BEAM * vp // 128) * 3.0)
    got = beam_select.small_topk(x, BEAM)
    want = beam_select.topk_reference(x, BEAM)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("small_topk at the decode's group stage: "
                             "differs from the plain version")
    ms, by = bound(x.shape[0] * x.shape[1] * BEAM,
                   4 * x.numel() + 8 * x.shape[0] * BEAM)
    records["small_topk"] = {"shapes": [{
        "shape": list(x.shape) + [BEAM], "max_abs_err": 0.0,
        "ms": time_ms(lambda: beam_select.small_topk(x, BEAM), 10),
        "plain_ms": time_ms(lambda: beam_select.topk_reference(x, BEAM),
                            10),
        "bound_ms": ms, "bound_by": by,
        "library_ms": time_ms(lambda: torch.topk(x, BEAM, dim=1), 10)}]}
    return records


def local_heads_times(name, q, k, v, g, mask, out, lse, bwd):
    """Device ms of one flash kernel at a rank's heads (the encoder's
    shape), of its plain version and of SDPA's same function, and its
    bound (as ``check_transformer_kernels`` counts them)."""
    import torch
    import torch.nn.functional as F

    from neuralmonkey_tpu_torch.ops import flash_attention as fa

    b, h, tq, d = q.shape
    tk = k.shape[2]
    pairs = b * h * tq * tk
    qo, kv = 4 * b * h * tq * d, 4 * b * h * tk * d
    bias = torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
    if name == "flash_attention_fwd":
        work = (4 * pairs * d, 2 * qo + 2 * kv + 4 * b * tk + 4 * b * h * tq)
        kernel = lambda: fa.flash_forward(q, k, v, mask, False)  # noqa: E731
        plain = lambda: fa.flash_forward_reference(  # noqa: E731
            q, k, v, mask, False)
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=bias)
    else:
        read = 2 * qo + 2 * kv + 4 * b * tk + 8 * b * h * tq
        work = ((6 * pairs * d, read + qo) if name.endswith("dq")
                else (8 * pairs * d, read + 2 * kv))
        kernel = ((lambda: fa.flash_backward_dq(*bwd))
                  if name.endswith("dq")
                  else (lambda: fa.flash_backward_dkv(*bwd)))
        # the plain backward and SDPA's each compute dq, dk and dv at once
        plain = lambda: fa.flash_backward_reference(  # noqa: E731
            q, k, v, mask, out, lse, g, False)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=bias)
        library = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, leaves, g, retain_graph=True)
    ms, by = bound(*work)
    return {"ms": time_ms(kernel, 10), "plain_ms": time_ms(plain, 10),
            "library_ms": time_ms(library, 10), "bound_ms": ms,
            "bound_by": by}


def phase9_decode(tmp: str, prefix: str, t_ini: str, t_ckpt: str,
                  failures) -> dict:
    """Two ranks' decode of phase 9's first batch (``{prefix}greedy.txt``,
    ``{prefix}beam.txt`` and each rank's ``{prefix}beam_r<r>.pt``)
    against phase 9's by phase 5's rule; each fault appended to
    ``failures``. Returns the rows that differ and the beam's parity."""
    import numpy as np
    import torch

    from neuralmonkey_tpu_torch.dataset import from_dict

    with open(os.path.join(tmp, f"{prefix}source.txt")) as f:
        sources = f.read().splitlines()
    differ = {}
    for name in ("greedy", "beam"):
        with open(os.path.join(tmp, f"{prefix}phase9_t_{name}.txt")) as f:
            want = f.read().splitlines()
        with open(os.path.join(tmp, f"{prefix}{name}.txt")) as f:
            got = f.read().splitlines()
        if not len(got) == len(want) == BATCH:
            failures.append(f"decode: {len(got)} {name} lines")
        differ[name] = {i: (w, g) for i, (w, g) in enumerate(zip(want, got))
                        if w != g}
    greedy_gaps = {i: greedy_gap(t_ini, t_ckpt, sources[i].split(),
                                 w.split(), g.split())
                   for i, (w, g) in differ["greedy"].items()}
    if not all(gap < MARGIN for gap in greedy_gaps.values()):
        failures.append(f"decode: greedy ids differ from phase 9's where "
                        f"the CPU's gap is not below {MARGIN}: "
                        f"{greedy_gaps}")
    logs = [torch.load(os.path.join(tmp, f"{prefix}beam_r{r}.pt"),
                       weights_only=False) for r in range(2)]
    if not (len(logs[0]["ids"]) == len(logs[1]["ids"]) and all(
            np.array_equal(a, b) for a, b in zip(logs[0]["ids"],
                                                  logs[1]["ids"]))):
        failures.append("decode: the ranks collected different beam ids")
    beam_parity = None
    if differ["beam"] and not failures:
        rows = sorted(differ["beam"])
        beam_parity = check_parity(
            t_ini, None, None, t_ckpt,
            from_dict({"source": [sources[i].split() for i in rows]}),
            card=([[p[i] for p in logs[0]["picks"][0]] for i in rows],
                  [logs[0]["ids"][0][i] for i in rows]))
    return {"greedy_differing_from_phase_9": greedy_gaps,
            "beam_differing_from_phase_9": sorted(differ["beam"]),
            "beam_parity": beam_parity}


def check_model_axes(tmp: str, t_ini: str, t_ckpt: str, smi: str, device):
    """Phase 29. Returns (the launches of its main-path runs, report)."""
    import numpy as np

    del device
    seconds = {}
    report = {"seconds": seconds, "device": smi}
    ini = write_transformer_ini(tmp, "ma_train.ini", MA_MAIN, 1.0, 1.0)
    # phase 9's first batch, decoded under TP 2 (``ma_``) and FSDP
    # (``mf_``)
    for prefix in ("ma_", "mf_"):
        first_lines(tmp, ("source.txt", "phase9_t_greedy.txt",
                          "phase9_t_beam.txt"), BATCH, prefix)
        with open(os.path.join(tmp, f"{prefix}data.ini"), "w") as f:
            f.write(MA_DATA_INI.format(tmp=tmp).replace("/ma_",
                                                        f"/{prefix}"))
    base, exp = timed(seconds, "one process", ma_train, ini,
                      ['tf_manager.device="cuda:0"'])
    del exp
    gc_card()
    port = free_port()
    results = [os.path.join(tmp, f"ma{r}.json") for r in range(2)]
    timed(seconds, "two gloo ranks on one card", run_ranks, [
        (ma_rank, (r, tmp, ini, port, t_ini, t_ckpt, results[r]))
        for r in range(2)], MA_TIMEOUT)
    ranks = []
    for path in results:
        with open(path) as f:
            ranks.append(json.load(f))

    failures = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    for name in ("tp_sp", "cp") + tuple(MA_ZERO_MODES):
        for rank, result in enumerate(ranks):
            got = result[name]
            check(abs(got["losses"][0] - base["losses"][0]) <= DP_LOSS_ATOL,
                  f"{name} rank {rank}: step-1 loss {got['losses'][0]} "
                  f"against one process's {base['losses'][0]}")
            check(got["param_gap_after_step_1"] <= DP_LOSS_ATOL,
                  f"{name} rank {rank}: parameters after step 1 "
                  f"{got['param_gap_after_step_1']} from one process's")
            check(all(np.isfinite(got["losses"])), f"{name}: {got['losses']}")
        check(ranks[0][name]["losses"] == ranks[1][name]["losses"],
              f"{name}: the ranks' losses differ")
    for rank, result in enumerate(ranks):
        for name in ("tp_sp",) + tuple(MA_ZERO_MODES):
            missing = [k for k in MA_TRAIN_KERNELS
                       if not result[name]["launches"][k]]
            check(not missing, f"rank {rank} {name}: never launched "
                               f"{missing}")
        peaks = {mode: max(result[mode]["peak_bytes"])
                 for mode in MA_ZERO_MODES}
        check(peaks["fsdp"] < peaks["zero1"],
              f"rank {rank}: the Transformer's FSDP peak {peaks['fsdp']} "
              f"not below ZeRO-1's {peaks['zero1']}")
        for name in ("decode", "fsdp_decode"):
            missing = [k for k in MA_DECODE_KERNELS
                       if not result[name]["launches"][k]]
            check(not missing, f"rank {rank} {name}: never launched "
                               f"{missing}")
        check(result["decode"]["launches"]["fused_logits_rowmax_lse"] == 0,
              f"rank {rank} decode: K3 launched under a model axis")
        check(result["decode"]["heads"] == MA_LOCAL_HEADS,
              f"rank {rank} decode: {result['decode']['heads']} heads")
        check(result["tp_sp"]["at_rest_bytes"]["params"]
              <= MA_AT_REST_SHARE * base["at_rest_bytes"]["params"],
              f"rank {rank} TP at rest {result['tp_sp']['at_rest_bytes']} "
              f"against {base['at_rest_bytes']}")

    decode = phase9_decode(tmp, "ma_", t_ini, t_ckpt, failures)
    fsdp_decode = phase9_decode(tmp, "mf_", t_ini, t_ckpt, failures)
    if failures:
        raise AssertionError("model axes: " + "; ".join(failures))

    runs = ("tp_sp", "cp", "decode", "fsdp_decode") + tuple(MA_ZERO_MODES)
    launches = None
    for result in ranks:
        for name in runs:
            launches = add_launches(launches, result[name]["launches"])
    launches = add_launches(launches, base["launches"])
    launches_by_kernel = {name: sum(
        r[key]["launches"][name] for r in ranks for key in runs)
        for name in MA_TRAIN_KERNELS + ("small_topk",)}
    keys = ("losses", "peak_bytes", "at_rest_bytes", "train_tokens_per_sec",
            "param_gap_after_step_1")
    report.update({
        "steps": MA_STEPS, "batch": BATCH, "source": SRC_LEN,
        "target": TGT_LEN,
        "one_process": {k: base[k] for k in keys if k in base},
        "tp2_sp": [{**{k: r["tp_sp"][k] for k in keys},
                    "peak_bytes_without_sp":
                    r["tp_sp"]["peak_bytes_without_sp"],
                    "loss_gaps_steps_2_to_4": [
                        abs(a - b) for a, b in zip(r["tp_sp"]["losses"][1:],
                                                   base["losses"][1:])]}
                   for r in ranks],
        "cp2": [{**{k: r["cp"][k] for k in keys},
                 "loss_gaps_steps_2_to_4": [
                     abs(a - b) for a, b in zip(r["cp"]["losses"][1:],
                                                base["losses"][1:])]}
                for r in ranks],
        "zero1_fsdp": [{mode: {
            **{k: r[mode][k] for k in keys},
            "peak": max(r[mode]["peak_bytes"]),
            "flash_launches": {k: r[mode]["launches"][k]
                               for k in MA_TRAIN_KERNELS}}
            for mode in MA_ZERO_MODES} for r in ranks],
        "train_tokens_per_sec_note": "two ranks time-sharing one card: "
                                     "not scaling",
        "decode": {"seconds": [r["decode"]["seconds"] for r in ranks],
                   **decode},
        "fsdp_decode": {"seconds": [r["fsdp_decode"]["seconds"]
                                    for r in ranks], **fsdp_decode}})
    report["launches_on_the_ranks"] = launches_by_kernel
    log(f"model axes ({smi}; two ranks time-sharing one card, not "
        f"scaling): {report}")
    return launches, report


# ---------------------------------------------------------------------- #
# phase 30: the pipe and expert axes
# ---------------------------------------------------------------------- #
PE_STAGES, PE_MICROBATCHES, PE_EXPERT_SHARDS = 2, 4, 2
PE_TIMEOUT = 300.0
PE_DECODE_KERNELS = ("flash_attention_fwd", "fused_logits_rowmax_lse",
                     "small_topk")
# each rank's parameter bytes at rest, as a share of one process's: the
# two 30000 x 512 embedding tables stay whole on every rank
PE_AT_REST_SHARE = 0.75
PE_MAIN = MA_MAIN.replace("chip smoke model axes",
                          "chip smoke pipe and expert axes").replace(
                              "ma_out", "pe_out")
PE_DATA_INI = MA_DATA_INI.replace("ma_", "pe_")
PP_OPTIONS = """\
pipeline_stages={stages}
pipeline_microbatches={micro}
"""


def stack_checkpoint(src: str, dst: str) -> str:
    """Phase 9's checkpoint in the pipeline's stacked layout: each part's
    ``layer_<i>/<leaf>`` stacked into ``layers/<leaf>`` (the JAX package's
    keys for ``pipeline_stages``)."""
    import re

    import numpy as np

    from neuralmonkey_tpu_torch.utils.saving import load_flat

    flat = load_flat(src)
    stacked, layers = {}, {}
    for key, value in flat.items():
        match = re.fullmatch(r"(.+)/layer_(\d+)/(.+)", key)
        if match is None:
            stacked[key] = value
        else:
            part, index, leaf = match.groups()
            layers.setdefault(f"{part}/layers/{leaf}", {})[int(index)] = value
    for key, by_index in layers.items():
        stacked[key] = np.stack([by_index[i] for i in sorted(by_index)])
    with open(dst, "wb") as f:
        np.savez(f, **stacked)
    return dst


def split_bytes(manager) -> int:
    """The bytes of this rank's parts of the parameters split over the
    pipe or expert axis."""
    from neuralmonkey_tpu_torch.utils.saving import flatten_tree
    return sum(v.numel() * v.element_size() for name, v in
               flatten_tree(manager.params).items()
               if manager._split[name])


def pe_rank(rank: int, tmp: str, pp_ini: str, moe_ini: str, port: int,
            stacked_ckpt: str, result: str) -> None:
    """Phase 30 on rank ``rank`` of two sharing the card over gloo: (a)
    MA_STEPS steps of the stacked Transformer over a pipe axis of two,
    (b) phase 9's first batch decoded (greedy and beam 10) by it from
    phase 9's checkpoint in the stacked layout, (c) MA_STEPS steps of the
    MoE Transformer over an expert axis of two."""
    import torch

    from neuralmonkey_tpu_torch import run
    from neuralmonkey_tpu_torch.ops import kernel_config
    from neuralmonkey_tpu_torch.parallel import distributed

    card_settings()
    distributed.maybe_initialize(f"127.0.0.1:{port}", 2, rank,
                                 backend="gloo")
    on_card = ['tf_manager.device="cuda:0"']
    report = {}
    report["pp"], exp = ma_train(
        pp_ini, on_card + [f"tf_manager.num_pipeline_stages={PE_STAGES}"],
        ref_path(pp_ini))
    report["pp"]["layers_at_rest"] = exp.tf_manager.params["encoder"][
        "layers"]["att"]["q"]["w"].shape[0]
    report["pp"]["split_bytes"] = split_bytes(exp.tf_manager)
    exp.tf_manager.restore(stacked_ckpt)
    picks, ids = record_beam(exp)
    kernel_config.reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for dataset in run.load_data_config(os.path.join(tmp, "pe_data.ini")):
        exp.run_model(dataset, write_out=True)
    torch.cuda.synchronize()
    report["decode"] = {"seconds": time.perf_counter() - start,
                        "launches": kernel_config.launch_counts()}
    torch.save({"picks": picks, "ids": ids},
               os.path.join(tmp, f"pe_beam_r{rank}.pt"))
    del exp
    gc_card()
    report["ep"], exp = ma_train(
        moe_ini, on_card + [f"tf_manager.num_expert_shards="
                            f"{PE_EXPERT_SHARDS}"], ref_path(moe_ini))
    report["ep"]["experts_at_rest"] = exp.tf_manager.params["encoder"][
        "layer_0"]["ff"]["in"]["w"].shape[0]
    report["ep"]["split_bytes"] = split_bytes(exp.tf_manager)
    del exp
    torch.distributed.destroy_process_group()
    with open(result, "w") as f:
        json.dump(report, f)


def check_pipe_and_expert_axes(tmp: str, t_ini: str, t_ckpt: str,
                               smi: str):
    """Phase 30. Returns (the launches of its main-path runs, report)."""
    import numpy as np

    seconds = {}
    report = {"seconds": seconds, "device": smi}
    pp_ini = add_part_options(
        write_transformer_ini(tmp, "pe_pp.ini", PE_MAIN, 1.0, 1.0),
        PP_OPTIONS.format(stages=PE_STAGES, micro=PE_MICROBATCHES))
    moe_ini = write_moe_ini(tmp, "pe_moe.ini", PE_MAIN, 1.0, 1.0, 0.0)
    stacked = stack_checkpoint(t_ckpt, os.path.join(tmp, "pe_stacked.npz"))
    first_lines(tmp, ("source.txt", "phase9_t_greedy.txt",
                      "phase9_t_beam.txt"), BATCH, "pe_")
    with open(os.path.join(tmp, "pe_data.ini"), "w") as f:
        f.write(PE_DATA_INI.format(tmp=tmp))
    base = {}
    for name, ini in (("pp", pp_ini), ("ep", moe_ini)):
        base[name], exp = timed(seconds, f"one process ({name})", ma_train,
                                ini, ['tf_manager.device="cuda:0"'])
        del exp
        gc_card()
    port = free_port()
    results = [os.path.join(tmp, f"pe{r}.json") for r in range(2)]
    timed(seconds, "two gloo ranks on one card", run_ranks, [
        (pe_rank, (r, tmp, pp_ini, moe_ini, port, stacked, results[r]))
        for r in range(2)], PE_TIMEOUT)
    ranks = []
    for path in results:
        with open(path) as f:
            ranks.append(json.load(f))

    failures = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    for name in ("pp", "ep"):
        for rank, result in enumerate(ranks):
            got = result[name]
            check(abs(got["losses"][0] - base[name]["losses"][0])
                  <= DP_LOSS_ATOL,
                  f"{name} rank {rank}: step-1 loss {got['losses'][0]} "
                  f"against one process's {base[name]['losses'][0]}")
            check(got["param_gap_after_step_1"] <= DP_LOSS_ATOL,
                  f"{name} rank {rank}: parameters after step 1 "
                  f"{got['param_gap_after_step_1']} from one process's")
            check(all(np.isfinite(got["losses"])), f"{name}: {got['losses']}")
            missing = [k for k in FLASH_KERNELS if not got["launches"][k]]
            check(not missing, f"{name} rank {rank}: never launched "
                               f"{missing}")
            # the split parameters halved, the rest whole
            check(got["at_rest_bytes"]["params"] + got["split_bytes"]
                  == base[name]["at_rest_bytes"]["params"]
                  and got["at_rest_bytes"]["params"] <= PE_AT_REST_SHARE
                  * base[name]["at_rest_bytes"]["params"],
                  f"{name} rank {rank}: at rest {got['at_rest_bytes']}, "
                  f"split {got['split_bytes']}, against "
                  f"{base[name]['at_rest_bytes']}")
        check(ranks[0][name]["losses"] == ranks[1][name]["losses"],
              f"{name}: the ranks' losses differ")
    for rank, result in enumerate(ranks):
        check(result["pp"]["layers_at_rest"] == T_DEPTH // PE_STAGES,
              f"rank {rank}: {result['pp']['layers_at_rest']} layers")
        check(result["ep"]["experts_at_rest"]
              == MOE_EXPERTS // PE_EXPERT_SHARDS,
              f"rank {rank}: {result['ep']['experts_at_rest']} experts")
        missing = [k for k in PE_DECODE_KERNELS
                   if not result["decode"]["launches"][k]]
        check(not missing, f"rank {rank} decode: never launched {missing}")

    decode = phase9_decode(tmp, "pe_", t_ini, t_ckpt, failures)
    if failures:
        raise AssertionError("pipe and expert axes: " + "; ".join(failures))

    launches = None
    for result in ranks:
        for name in ("pp", "ep", "decode"):
            launches = add_launches(launches, result[name]["launches"])
    for record in base.values():
        launches = add_launches(launches, record["launches"])
    launches_by_kernel = {name: sum(
        r[key]["launches"][name] for r in ranks
        for key in ("pp", "ep", "decode"))
        for name in FLASH_KERNELS + PE_DECODE_KERNELS[1:]}
    keys = ("losses", "peak_bytes", "at_rest_bytes", "train_tokens_per_sec",
            "param_gap_after_step_1")

    def share(rank_record, name, key):
        return (rank_record[key]["params"] / base[name][key]["params"]
                if key == "at_rest_bytes"
                else max(rank_record[key]) / max(base[name][key]))
    report.update({
        "steps": MA_STEPS, "batch": BATCH, "source": SRC_LEN,
        "target": TGT_LEN, "stages": PE_STAGES,
        "microbatches": PE_MICROBATCHES, "experts": MOE_EXPERTS,
        "expert_shards": PE_EXPERT_SHARDS,
        "one_process": {name: {k: record[k] for k in keys if k in record}
                        for name, record in base.items()},
        **{f"{name}2": [{**{k: r[name][k] for k in keys},
                         "params_at_rest_share": share(
                             r[name], name, "at_rest_bytes"),
                         "peak_share": share(r[name], name, "peak_bytes"),
                         "loss_gaps_steps_2_to_4": [
                             abs(a - b) for a, b in zip(
                                 r[name]["losses"][1:],
                                 base[name]["losses"][1:])]}
                        for r in ranks]
           for name in ("pp", "ep")},
        "train_tokens_per_sec_note": "two ranks time-sharing one card: "
                                     "not scaling",
        "decode": {"seconds": [r["decode"]["seconds"] for r in ranks],
                   **decode}})
    report["launches_on_the_ranks"] = launches_by_kernel
    log(f"pipe and expert axes ({smi}; two ranks time-sharing one card, "
        f"not scaling): {report}")
    return launches, report


# ---------------------------------------------------------------------- #
# phase 31: beam search by the physical per-step reorder (NM_LINEAGE=0)
# ---------------------------------------------------------------------- #
PHYSICAL_KERNELS = ("fused_logits_rowmax_lse", "small_topk")
LINEAGE_KERNELS = ("lineage_attention", "lineage_attention_chunked",
                   "lineage_attention_bf16", LINEAGE_SCRATCH)
# each model's runs: (label, checkpoint's INI key, extra environment)
PHYSICAL_RUNS = (("rnn", "rnn", {}),
                 ("transformer", "transformer", {}),
                 ("transformer, NM_LINEAGE_KERNEL=1", "transformer",
                  {"NM_LINEAGE_KERNEL": "1"}))


def physical_run(tmp: str, exp_ini: str, ckpt: str, label: str, env,
                 expected):
    """One ``run`` pass over phase 4's first batch (``phys_data.ini``)
    under ``NM_LINEAGE=0`` and ``env``, the launch counts set to 0 just
    before it: (its launches, K2's launches by (B, T), each step's
    (parent, token) picks of the beam search, (B, K, 2) a step, and its
    best ids, (B, L)). Every kernel of ``expected`` must launch, no
    lineage attention."""
    import numpy as np
    import torch

    from neuralmonkey_tpu_torch.models.attention import feed_forward
    from neuralmonkey_tpu_torch.models.decoders.beam_search_decoder import \
        BeamSearchDecoder
    from neuralmonkey_tpu_torch.runners.beam_search_runner import \
        BeamSearchRunner

    picks, ids, by_shape = [], [], {}
    plain = (BeamSearchDecoder._select_hier, BeamSearchDecoder._select_flat,
             BeamSearchRunner.collect_results,
             feed_forward.fused_bahdanau_step)

    def recording(select):
        def select_and_record(self, *args, **kwargs):
            out = select(self, *args, **kwargs)
            picks.append(torch.stack(out[:2], dim=-1).cpu())
            return out
        return select_and_record

    def collect_results(self, fetched, num_examples):
        ids.append(np.asarray(fetched["token_ids"])[:num_examples, 0])
        return plain[2](self, fetched, num_examples)

    def tallied_step(keys, *args):
        shape = "B{}_T{}".format(*keys.shape[:2])
        by_shape[shape] = by_shape.get(shape, 0) + 1
        return plain[3](keys, *args)

    env = {"NM_LINEAGE": "0", **env}
    os.environ.update(env)
    BeamSearchDecoder._select_hier = recording(plain[0])
    BeamSearchDecoder._select_flat = recording(plain[1])
    BeamSearchRunner.collect_results = collect_results
    feed_forward.fused_bahdanau_step = tallied_step
    try:
        launches, lines = serve_through_run(
            exp_ini, os.path.join(tmp, "phys_data.ini"), ckpt, expected,
            [os.path.join(tmp, f"phys_{name}.txt")
             for name in ("greedy", "beam")], f"physical reorder, {label}",
            forbidden=LINEAGE_KERNELS, sentences=BATCH)
    finally:
        for name in env:
            os.environ.pop(name)
        (BeamSearchDecoder._select_hier, BeamSearchDecoder._select_flat,
         BeamSearchRunner.collect_results,
         feed_forward.fused_bahdanau_step) = plain
    if len(ids) != 1:
        raise AssertionError(f"physical reorder, {label}: {len(ids)} beam "
                             "batches, not one")
    del lines
    return launches, by_shape, picks, ids[0]


def beam_rates(exp_ini: str, ckpt: str, data_ini: str) -> dict:
    """Beam-10 sentences/s over the first batch in both forms of the
    search, lineage decoding and ``NM_LINEAGE=0``, from one model: the
    median of 3 timed passes each after a warm-up pass."""
    import torch

    from neuralmonkey_tpu_torch import run
    from neuralmonkey_tpu_torch.experiment import Experiment

    exp = Experiment(exp_ini, train_mode=False)
    exp.build_model()
    exp.tf_manager.restore(ckpt)
    dataset = run.load_data_config(data_ini)[0]
    search = exp.model.runners[1]
    rates = {}
    for form, env in (("lineage", None), ("physical", "0")):
        if env is not None:
            os.environ["NM_LINEAGE"] = env
        try:
            exp.tf_manager.execute(dataset, [search], BATCH)
            seconds = []
            for _ in range(3):
                torch.cuda.synchronize()
                start = time.perf_counter()
                exp.tf_manager.execute(dataset, [search], BATCH)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - start)
        finally:
            os.environ.pop("NM_LINEAGE", None)
        rates[form] = len(dataset) / statistics.median(seconds)
    del exp
    gc_card()
    return rates


def check_physical_reorder(tmp: str, models, cpu_records):
    """Phase 31. ``models`` maps "rnn" and "transformer" to (INI,
    checkpoint): phase 4's and phase 9's; ``cpu_records`` to the CPU's
    beam record of phases 5 and 10 (``check_parity``'s ``keep``).
    Returns (the launches of its runs, report)."""
    import numpy as np

    first_lines(tmp, ("source.txt",), BATCH, "phys_")
    with open(os.path.join(tmp, "phys_data.ini"), "w") as f:
        f.write(MA_DATA_INI.format(tmp=tmp).replace("/ma_", "/phys_"))
    report, launches = {}, None
    for label, model, env in PHYSICAL_RUNS:
        exp_ini, ckpt = models[model]
        expected = PHYSICAL_KERNELS + (
            ("fused_bahdanau_step",) if model == "rnn" else ())
        counts, by_shape, picks, ids = physical_run(
            tmp, exp_ini, ckpt, label, env, expected)
        launches = add_launches(launches, counts)
        beam_rows = f"B{BATCH * BEAM}_"
        if model == "rnn" and not any(shape.startswith(beam_rows)
                                      for shape in by_shape):
            raise AssertionError(f"physical reorder, {label}: K2 never "
                                 f"launched at {BATCH * BEAM} rows: "
                                 f"{by_shape}")
        cpu = cpu_records[model]
        parity = hold_beam(
            cpu["picks"], cpu["gaps"],
            [[p[row] for p in picks] for row in range(N_PARITY)],
            lambda row: np.array_equal(cpu["ids"][row].numpy(), ids[row]))
        report[label] = {
            "launches": {k: counts[k] for k in expected},
            "lineage_attention_launches": {k: counts[k]
                                           for k in LINEAGE_KERNELS},
            "fused_bahdanau_step_launches_by_shape": by_shape,
            "beam_parity_against_the_cpu": parity}
        log(f"physical reorder, {label}: {report[label]}")
    for model in ("rnn", "transformer"):
        rates = beam_rates(*models[model], os.path.join(tmp, "phys_data.ini"))
        report[model]["beam10_sentences_per_s"] = rates
        log(f"physical reorder, {model}: beam-10 sentences/s {rates}")
    return launches, report


def gc_card() -> None:
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def torch_equal(a, b) -> bool:
    import torch
    return bool(torch.equal(torch.as_tensor(a).cpu(), torch.as_tensor(b)))


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "neuralmonkey_tpu_torch")):
        log("neuralmonkey_tpu_torch not found beside chip_smoke.py: run "
            "it from the root of a checkout of the repository")
        return 1
    try:
        import torch
    except ImportError:
        log("PyTorch is not installed")
        return 1
    if not torch.cuda.is_available():
        log("no CUDA device: this smoke test needs an NVIDIA GPU")
        return 1
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    capability = torch.cuda.get_device_capability(device)
    if capability < (9, 0):
        log(f"compute capability {capability}; the kernels need >= 9.0")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"capability {capability}")

    from neuralmonkey_tpu_torch.ops import kernel_config
    start = time.perf_counter()
    kernel_config.library()
    log(f"build: {time.perf_counter() - start:.1f} s "
        f"({kernel_config.library_path()})")

    seconds = {"build": time.perf_counter() - start}

    def phase(name, fn, *args):
        begin = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - begin
        log(f"phase {name}: {seconds[name]:.1f} s")
        return out

    kernels = phase("kernels", check_kernels, device)
    # the kernels phase 29's ranks launch, at a rank's heads
    local_heads = phase("kernels at a rank's heads", local_heads_records,
                        device)
    for name, record in local_heads.items():
        kernels[name]["local_heads"] = record
    past_limits, chunked = phase("past the kernels' limits",
                                 check_past_limits, device)
    kernels.update(chunked)
    plans = launch_plans()
    log(f"launch plans: {plans}")
    with tempfile.TemporaryDirectory() as tmp:
        # launches: the sum over the main-path runs (each counted from 0)
        launches, lengths, speed, gpu_exp, ckpt, data_ini = phase(
            "slice", run_slice, tmp)
        # the CPU's beam records of phases 5 and 10, for phase 31
        cpu_records = {"rnn": {}, "transformer": {}}
        parity = phase("parity", lambda: check_parity(
            os.path.join(tmp, "exp.ini"), data_ini, gpu_exp, ckpt,
            keep=cpu_records["rnn"]))
        del gpu_exp
        train_ini = write_training_inputs(tmp)
        training = []
        for fused in (False, True):
            train_launches, record, best = phase(
                f"training (fused xent {fused})", run_training, tmp,
                train_ini, fused)
            training.append(record)
            launches = {k: n + train_launches[k]
                        for k, n in launches.items()}
            if not fused:
                train_parity = phase("training parity", check_train_parity,
                                     train_ini, best)

        t_launches, t_serving, t_exp, t_ini, t_data_ini, t_ckpt = phase(
            "transformer serving", run_transformer_serving, tmp)
        launches = {k: n + t_launches[k] for k, n in launches.items()}
        os.environ["NM_LINEAGE_KERNEL"] = "1"
        try:
            t_serving["parity"] = phase(
                "transformer parity", lambda: check_parity(
                    t_ini, t_data_ini, t_exp, t_ckpt,
                    keep=cpu_records["transformer"]))
        finally:
            os.environ.pop("NM_LINEAGE_KERNEL")
        del t_exp
        t_train_ini = write_transformer_ini(
            tmp, "t_train.ini", T_TRAINING_MAIN, 0.9, T_ATT_KEEP)
        t_launches, t_record, t_best = phase(
            "transformer training", run_training, tmp, t_train_ini, False,
            "t_train", FLASH_KERNELS)
        launches = {k: n + t_launches[k] for k, n in launches.items()}
        t_train_parity = phase("transformer training parity",
                               check_train_parity, t_train_ini, t_best,
                               ("encoder", "decoder"), True)

        l_launches, l_serving, l_exp, l_ini, l_data_ini, l_ckpt = phase(
            "lstm serving", run_lstm_serving, tmp)
        launches = {k: n + l_launches[k] for k, n in launches.items()}
        l_serving["parity"] = phase("lstm parity", check_lstm_parity, l_ini,
                                    l_data_ini, l_exp, l_ckpt)
        del l_exp
        l_train_ini = write_training_inputs(tmp, "LSTM", "lstm_train.ini")
        l_launches, l_record, l_best = phase(
            "lstm training", run_training, tmp, l_train_ini, False,
            "lstm_train", LSTM_TRAINING_KERNELS)
        launches = {k: n + l_launches[k] for k, n in launches.items()}
        l_train_parity = phase("lstm training parity", check_train_parity,
                               l_train_ini, l_best)

        s_launches, served = phase("server", serve_over_http, tmp,
                                   os.path.join(tmp, "exp.ini"), data_ini,
                                   ckpt)
        launches = {k: n + s_launches[k] for k, n in launches.items()}
        h_launches, heads = phase("task heads", check_task_heads, tmp)
        launches = {k: n + h_launches[k] for k, n in launches.items()}
        m_launches, multimodal, image_k2 = phase(
            "multimodal", check_multimodal, tmp, device)
        launches = {k: n + m_launches[k] for k, n in launches.items()}
        kernels["fused_bahdanau_step"]["image_shapes"] = image_k2
        r_launches, self_critical = phase("self-critical",
                                          check_self_critical, tmp)
        launches = {k: n + r_launches[k] for k, n in launches.items()}
        c_launches, cnn = phase("cnn", check_cnn, tmp, device)
        launches = add_launches(launches, c_launches)
        e_launches, moe = phase("moe", check_moe, tmp)
        launches = add_launches(launches, e_launches)
        a_launches, speech = phase("speech", check_speech, tmp)
        launches = add_launches(launches, a_launches)
        b_launches, bf16 = phase(
            "bf16 policy", check_bf16_policy, tmp,
            (os.path.join(tmp, "exp.ini"), data_ini, ckpt, train_ini, best),
            (t_ini, t_data_ini, t_ckpt, t_train_ini, t_best))
        launches = add_launches(launches, b_launches)
        n_launches, ensembles = phase(
            "ensembles", check_ensembles, tmp, data_ini, ckpt, speed)
        launches = add_launches(launches, n_launches)
        lt_launches, long_tail = phase(
            "long tail", check_long_tail, tmp, os.path.join(tmp, "exp.ini"),
            data_ini, ckpt, training[0])
        launches = add_launches(launches, lt_launches)
        it_launches, image_tail = phase(
            "host and image tail", check_image_tail, tmp, device, t_ini,
            t_data_ini, t_ckpt)
        launches = add_launches(launches, it_launches)
        dp_launches, data_parallel = phase(
            "data parallel", check_data_parallel, tmp,
            os.path.join(tmp, "exp.ini"), data_ini, ckpt, smi)
        launches = add_launches(launches, dp_launches)
        ma_launches, model_axes = phase(
            "model axes", check_model_axes, tmp, t_ini, t_ckpt, smi, device)
        launches = add_launches(launches, ma_launches)
        for name, count in model_axes["launches_on_the_ranks"].items():
            local_heads[name]["launches_in_phase_29"] = count
        pe_launches, pipe_expert = phase(
            "pipe and expert axes", check_pipe_and_expert_axes, tmp, t_ini,
            t_ckpt, smi)
        launches = add_launches(launches, pe_launches)
        for name, count in pipe_expert["launches_on_the_ranks"].items():
            kernels[name]["launches_in_phase_30"] = count
        ph_launches, physical = phase(
            "physical reorder", check_physical_reorder, tmp,
            {"rnn": (os.path.join(tmp, "exp.ini"), ckpt),
             "transformer": (t_ini, t_ckpt)}, cpu_records)
        launches = add_launches(launches, ph_launches)
        # the rates of the same paths in float32 (phases 4, 6, 9, 11) and
        # under the bf16 policy (phase 24), from this run
        bf16["rates"] = {
            "rnn serving": {"float32": speed,
                            "bfloat16": bf16["rnn"]["speed"]},
            "rnn train tokens/s": {
                "float32": training[0]["train_tokens_per_sec"],
                "bfloat16": bf16["rnn"]["training"][
                    "train_tokens_per_sec"]},
            "transformer serving": {
                "float32": t_serving["speed"],
                "bfloat16": bf16["transformer"]["speed"]},
            "transformer train tokens/s": {
                "float32 (unfused)": t_record["train_tokens_per_sec"],
                "bfloat16 (NM_FUSED_XENT=1)": bf16["transformer"][
                    "training"]["train_tokens_per_sec"]}}
        log(f"float32 and bf16 rates: {bf16['rates']}")
        for name in CHUNKED_KERNELS:
            launches[name] += chunked[name].pop("launches")
        for name in WIDENED_KERNELS:
            launches[name] += past_limits["widened launches"][name]
        launches[LINEAGE_SCRATCH] += past_limits["scratch launches"]

    print(json.dumps({"plans": plans}))
    print(smi)
    print(json.dumps({
        "device": smi,
        "phase_seconds": seconds,
        "slice": {"sentences": N_SENTENCES, "batch": BATCH, "beam": BEAM,
                  "mean_output_tokens": lengths, "speed": speed,
                  "parity": parity},
        "training": {"batch": BATCH, "source": SRC_LEN, "target": TGT_LEN,
                     "runs": training, "parity": train_parity},
        "transformer": {"serving": t_serving, "training": t_record,
                        "training_parity": t_train_parity},
        "lstm": {"serving": l_serving, "training": l_record,
                 "training_parity": l_train_parity},
        "lstm_scan_cudnn_max_abs_err": kernels["lstm_scan"][
            "cudnn_max_abs_err"],
        "past_the_kernels_limits": past_limits,
        "server": served,
        "task_heads": heads,
        "multimodal": multimodal,
        "self_critical": self_critical,
        "cnn": cnn,
        "moe": moe,
        "speech": speech,
        "bf16_policy": bf16,
        "ensembles": ensembles,
        "long_tail": long_tail,
        "host_and_image_tail": image_tail,
        "data_parallel": data_parallel,
        "model_axes": model_axes,
        "pipe_and_expert_axes": pipe_expert,
        "physical_reorder": physical,
    }))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         **{key: kernels[name][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "call_ms")},
         **kernels[name]}
        for name, (source, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
