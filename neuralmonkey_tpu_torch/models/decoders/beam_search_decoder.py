"""Beam search (counterpart of
``neuralmonkey_tpu/models/decoders/beam_search_decoder.py``): one
model's search, or a checkpoint ensemble's (``ensemble_search``).

Batch and beam are flattened to one leading axis so the parent
decoder's step runs all beams at once. Each step scores candidates
with the Wu et al. (2016) length penalty and keeps the best K:

- ``hierarchical`` selection (the default at vocabularies of 2048 and
  more) reduces each beam's vocabulary to per-128-column maxima, takes
  the top K of those (K4), then the exact top K over the chosen
  columns (K4 again). The reductions come from the fused logit
  projection (K3), which the search arms for every hierarchical
  search, or under ``NM_FUSED_LOGITS=0`` from ``rowmax_lse`` over the
  plain logits padded to whole 128-column groups. Exact: a column group
  holding a top-K element ranks in the top K groups by its maximum;
- ``flat`` selection takes the top K over the whole (B, K·V) matrix
  (a stable sort; it is also ``use_approx_top_k``'s selector: the JAX
  package's ``lax.approx_max_k`` is exact off the TPU).

``align_logits`` pads the single-model hierarchical search's logit
projection to whole 128-column groups once per search
(``align_logits_for_selection``), so that the selector never pads the
logits; the fused projection then runs on the padded table.
``search(ctx, with_attention=True)`` also returns each final
hypothesis's first-attention weights at every step (single model only),
moved with the hypotheses as the search selects them.

The search has two forms, as in the JAX package (``lineage``, which
``NM_LINEAGE`` overrides, read at each search):

- lineage decoding, the default for a parent that supports it (the RNN
  and Transformer decoders do): its beam-invariant constants stay
  untiled, shared by the K beams, the loop state is never reordered,
  and the search carries the composed ancestry ``anc`` (B, K, T) that
  each step reads: the Transformer resolves its unpermuted caches in
  score space; the RNN gathers its state by the previous parents,
  column ``step - 1``, so for it the search writes only that column;
- the physical per-step reorder (``lineage="off"``, ``NM_LINEAGE=0``,
  or "auto" over a parent without lineage decoding): the constants are
  tiled to B·K rows (``tile_decode_constants``), each step is the
  parent's plain ``decode_step`` over the B·K rows, and every tensor of
  the loop state is then gathered by the chosen parents
  (``_gather_beams``), so that each hypothesis carries its own caches.
  The JAX package holds lineage decoding to this form.
The loop asks the device whether every hypothesis has finished only
every ``FINISHED_CHECK_PERIOD`` steps: a finished hypothesis is a fixed
point of the step (it emits PAD at zero cost and keeps its length and
score).

An ensemble's models each take the step on their own loop state, tiled
plainly row by row (never a kernel layout, as the JAX package stacks
them), and the search selects on their float32 log-probs averaged as
probabilities: ``logsumexp`` over the models minus ``log n``. Those are
normalised scores, so the selectors skip their own normalisation, and
the fused logit projection is never armed.
"""

from __future__ import annotations

import os
from typing import Any, List, NamedTuple, Optional

import torch

from ...model.part import Context, ModelPart
from ...ops.beam_select import LANE, rowmax_lse, small_topk
from ...vocabulary import END_TOKEN_INDEX, PAD_TOKEN_INDEX, START_TOKEN_INDEX
from .autoregressive import FINISHED_CHECK_PERIOD, AutoregressiveDecoder

NEG_INF = -1e9


class SearchState(NamedTuple):
    """Per-(batch, beam) search bookkeeping."""
    logprob_sum: torch.Tensor   # (B, K) raw summed log-probs
    lengths: torch.Tensor       # (B, K) int32, tokens emitted (incl </s>)
    finished: torch.Tensor      # (B, K) bool
    token_ids: torch.Tensor     # (B, K, L) int32 emitted tokens


class BeamSearchOutput(NamedTuple):
    token_ids: torch.Tensor     # (B, K, L) sorted best first
    lengths: torch.Tensor       # (B, K)
    scores: torch.Tensor        # (B, K) length-normalized
    # (B, K, L, T_src): with_attention and a parent emitting weights
    attention: Optional[torch.Tensor] = None


def length_penalty(lengths: torch.Tensor, alpha: float) -> torch.Tensor:
    """Wu et al. (2016) GNMT length normalization."""
    if alpha == 0.0:
        return torch.ones_like(lengths, dtype=torch.float32)
    return torch.pow((5.0 + lengths.float()) / 6.0, alpha)


def _gather(arr: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(arr, index, axis=1)`` with any index dtype."""
    return torch.gather(arr, 1, index.long())


def _map_tree(tree: Any, fn) -> Any:
    """``fn`` on every tensor of ``tree``; None and other leaves pass."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn) for v in tree)
    return tree


def _tile_beam(tree: Any, beam: int) -> Any:
    """Every tensor of ``tree`` with its rows repeated K times: (B, ...)
    -> (B·K, ...), row ``b·K + k``."""
    return _map_tree(tree, lambda x: x.repeat_interleave(beam, dim=0))


def _gather_beams(tree: Any, parents: torch.Tensor, beam: int) -> Any:
    """The physical reorder: every tensor of the (B·K, ...) ``tree``
    with row ``b·K + k`` taken from row ``b·K + parents[b, k]``, one
    ``index_select`` a tensor (fresh tensors, which a step may write in
    place)."""
    rows = (torch.arange(parents.shape[0], device=parents.device)[:, None]
            * beam + parents.long()).reshape(-1)
    return _map_tree(tree, lambda x: x.index_select(0, rows))


class BeamSearchDecoder(ModelPart):

    def __init__(self, name: str,
                 parent_decoder: AutoregressiveDecoder,
                 beam_size: int,
                 length_normalization: float = 0.6,
                 max_steps: int = None,
                 use_approx_top_k: bool = False,
                 selection_method: str = "auto",
                 align_logits: bool = False,
                 lineage: str = "auto",
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        ModelPart.__init__(self, name, reuse, save_checkpoint,
                           load_checkpoint)
        if selection_method not in ("auto", "flat", "hierarchical"):
            raise ValueError(
                f"Unknown selection_method: {selection_method}")
        if lineage not in ("auto", "on", "off"):
            raise ValueError(f"Unknown lineage mode: {lineage}")
        self.parent_decoder = parent_decoder
        self.beam_size = beam_size
        self.length_normalization = length_normalization
        self.max_steps = min(max_steps or parent_decoder.max_output_len,
                             parent_decoder.max_output_len)
        self.selection_method = selection_method
        self.use_approx_top_k = use_approx_top_k
        self.align_logits = align_logits
        self.lineage = lineage

    def _use_lineage(self) -> bool:
        """The JAX package's switch: ``lineage``, overridden by
        ``NM_LINEAGE`` (read at each search); lineage decoding where the
        parent supports it and the mode is not "off", else the physical
        reorder. "on" over a parent without it raises."""
        env = os.environ.get("NM_LINEAGE")
        if env:
            mode = "off" if env in ("0", "off") else "on"
        else:
            mode = self.lineage
        supported = getattr(self.parent_decoder, "lineage_decode", False)
        if mode == "on" and not supported:
            raise ValueError(
                f"lineage='on' but {type(self.parent_decoder).__name__} "
                "does not implement lineage decoding")
        return mode != "off" and supported

    @property
    def vocabulary(self):
        return self.parent_decoder.vocabulary

    def _method(self) -> str:
        if self.selection_method != "auto":
            return self.selection_method
        # hierarchical wins once full-vocabulary passes dominate
        return ("flat" if len(self.vocabulary) < 2048
                or self.use_approx_top_k else "hierarchical")

    # ------------------------------------------------------------------ #
    # per-step candidate selection. Both selectors take scores ``x``
    # (B·K, V), raw logits or, with ``normalized``, log-probs (an
    # ensemble's average), and the SearchState and return (parents (B,
    # K), tokens (B, K), new unnormalized logprob sums (B, K), normalized
    # scores (B, K)), best first. A finished beam contributes exactly
    # one candidate: PAD at zero incremental cost.
    # ------------------------------------------------------------------ #
    def _select_flat(self, x, search: SearchState, batch: int,
                     precomputed=None, normalized: bool = False):
        del precomputed
        beam = self.beam_size
        vocab = x.shape[-1]
        logprobs = (x if normalized
                    else torch.log_softmax(x.float(), dim=-1)).reshape(
            batch, beam, vocab)
        pad_only = torch.full((vocab,), NEG_INF, device=x.device)
        pad_only[PAD_TOKEN_INDEX] = 0.0
        logprobs = torch.where(search.finished[..., None], pad_only,
                               logprobs)
        total = search.logprob_sum[..., None] + logprobs
        new_lengths = search.lengths + (~search.finished).int()
        normed = total / length_penalty(
            new_lengths, self.length_normalization)[..., None]
        # a stable sort keeps lax.top_k's lowest-index tie rule
        top_scores, top_idx = torch.sort(normed.reshape(batch, -1), dim=1,
                                         descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :beam], top_idx[:, :beam]
        parents = (top_idx // vocab).int()
        tokens = (top_idx % vocab).int()
        new_logprob = _gather(total.reshape(batch, -1), top_idx)
        return parents, tokens, new_logprob, top_scores

    def _select_hier(self, x, search: SearchState, batch: int,
                     precomputed=None, normalized: bool = False):
        """Exact two-stage selection without (B, K, V) intermediates;
        ``precomputed`` carries (rowmax, lse) from the fused logit
        projection when the decode step emitted them, and ``rowmax_lse``
        computes them otherwise. Normalised scores take a plain maximum
        over each column group and an lse of exactly 0."""
        beam = self.beam_size
        vocab = x.shape[-1]
        rows_per_beam = -(-vocab // LANE)
        vp = rows_per_beam * LANE
        if vp != vocab:
            # 4·NEG_INF keeps padding strictly below even "dead" beam
            # continuations (logprob_sum = NEG_INF + finite logprob)
            x = torch.nn.functional.pad(x, (0, vp - vocab),
                                        value=4 * NEG_INF)
        x = x.float()
        if normalized:
            rowmax2 = x.reshape(batch * beam, rows_per_beam, LANE).amax(
                dim=2)
            lse2 = x.new_zeros(batch, beam)
        elif precomputed is not None \
                and precomputed[0].shape[-1] == rows_per_beam:
            rowmax2, lse2 = precomputed
        else:
            rowmax2, lse2 = rowmax_lse(x)
        rowmax = rowmax2.reshape(batch, beam, rows_per_beam)
        lse = lse2.reshape(batch, beam)

        new_lengths = search.lengths + (~search.finished).int()
        inv_pen = 1.0 / length_penalty(new_lengths,
                                       self.length_normalization)
        # finished beams keep their lengths, so inv_pen is theirs too
        fin_score = search.logprob_sum * inv_pen
        srow = ((rowmax - lse[..., None] + search.logprob_sum[..., None])
                * inv_pen[..., None])
        srow = torch.where(search.finished[..., None], NEG_INF, srow)
        srow[..., 0] = torch.where(search.finished, fin_score,
                                   srow[..., 0])

        # stage 1: top-K column groups across all beams of a sentence
        n_rows = beam * rows_per_beam
        _, row_idx = small_topk(srow.reshape(batch, n_rows), beam)
        row_idx = row_idx.long()

        # stage 2: exact scores for the chosen groups only
        cand = torch.gather(
            x.reshape(batch, n_rows, LANE), 1,
            row_idx[..., None].expand(batch, beam, LANE))
        parent_of_row = row_idx // rows_per_beam

        def g(arr):
            return torch.gather(arr, 1, parent_of_row)

        total_cand = (cand - g(lse)[..., None]
                      + g(search.logprob_sum)[..., None])
        scores_cand = total_cand * g(inv_pen)[..., None]
        v_cand = ((row_idx % rows_per_beam)[..., None] * LANE
                  + torch.arange(LANE, device=x.device))
        fin_g = g(search.finished)[..., None]
        is_pad = v_cand == PAD_TOKEN_INDEX
        scores_cand = torch.where(
            fin_g, torch.where(is_pad, g(fin_score)[..., None], NEG_INF),
            scores_cand)
        total_cand = torch.where(
            fin_g, torch.where(is_pad, g(search.logprob_sum)[..., None],
                               NEG_INF),
            total_cand)

        top_scores, idx2 = small_topk(
            scores_cand.reshape(batch, beam * LANE).contiguous(), beam)
        idx2 = idx2.long()
        sel_row = idx2 // LANE
        parents = torch.gather(parent_of_row, 1, sel_row).int()
        tokens = (torch.gather(row_idx % rows_per_beam, 1, sel_row) * LANE
                  + idx2 % LANE).int()
        new_logprob = torch.gather(total_cand.reshape(batch, -1), 1, idx2)
        return parents, tokens, new_logprob, top_scores

    # ------------------------------------------------------------------ #
    def search(self, ctx: Context,
               with_attention: bool = False) -> BeamSearchOutput:
        """Single-model beam search; ``with_attention`` records the
        attention weights of the final hypotheses, where the parent
        emits them (``emits_attention``)."""
        lineage = self._use_lineage()
        parent = self.parent_decoder
        with_attention = with_attention and parent.emits_attention
        constants = parent.decode_constants(ctx)
        if with_attention:
            constants = parent.with_attention_maps(constants)
        state = parent.decode_initial_state(ctx, constants)
        if self._method() == "hierarchical":
            if self.align_logits:
                constants = parent.align_logits_for_selection(constants)
            # a no-op under NM_FUSED_LOGITS=0
            constants = parent.prepare_selection_fusion(constants)
        return self._search_impl(
            ctx, [constants], [parent.tile_decode_state(
                state, self.beam_size, lineage)], lineage,
            with_attention=with_attention)

    def ensemble_search(self, contexts: List[Context]) -> BeamSearchOutput:
        """Beam search of the models of ``contexts`` (one a parameter
        set), their distributions averaged at every step."""
        lineage = self._use_lineage()
        parent = self.parent_decoder
        constants = [parent.decode_constants(c) for c in contexts]
        states = [_tile_beam(parent.decode_initial_state(c, k),
                             self.beam_size)
                  for c, k in zip(contexts, constants)]
        return self._search_impl(contexts[0], constants, states, lineage)

    def _search_impl(self, ctx: Context, constants_list: List[Any],
                     states: List[Any], lineage: bool,
                     with_attention: bool = False) -> BeamSearchOutput:
        """The search over the models' untiled constants and beam-tiled
        loop states, by lineage decoding or, without ``lineage``, by the
        physical reorder; ``ctx`` gives the batch size and the device.
        With ``with_attention`` (one model) the first attention's weights
        of each step are kept, moved with the hypotheses they extend."""
        parent = self.parent_decoder
        beam = self.beam_size
        vocab = len(parent.vocabulary)
        batch = parent._batch_size(ctx)
        device = parent._device(ctx)
        select_fn = (self._select_hier if self._method() == "hierarchical"
                     else self._select_flat)
        tile = (parent.tile_decode_constants_lineage if lineage
                else parent.tile_decode_constants)
        constants_list = [tile(c, beam) for c in constants_list]
        ensemble = len(constants_list) > 1
        if ensemble:
            log_n = torch.tensor(float(len(constants_list))).log().to(
                device)

        # beam 0 live, the others dead (standard first-step trick)
        logprob0 = torch.full((batch, beam), NEG_INF, device=device)
        logprob0[:, 0] = 0.0
        search = SearchState(
            logprob_sum=logprob0,
            lengths=torch.zeros(batch, beam, dtype=torch.int32,
                                device=device),
            finished=torch.zeros(batch, beam, dtype=torch.bool,
                                 device=device),
            token_ids=torch.full((batch, beam, self.max_steps),
                                 PAD_TOKEN_INDEX, dtype=torch.int32,
                                 device=device))
        prev_ids = torch.full((batch * beam,), START_TOKEN_INDEX,
                              dtype=torch.int32, device=device)
        anc = None
        if lineage:
            # the ancestry starts as the identity: every position of
            # every slot is (to be) written by that slot itself
            cache_len = parent.max_output_len
            anc0 = torch.arange(beam, dtype=torch.int32, device=device)[
                None, :, None].expand(batch, beam, cache_len)
            anc = anc0 if parent.reads_ancestry else anc0.clone()
            positions = torch.arange(cache_len, device=device)
        history = None

        def take_step(constants, state, step):
            if lineage:
                return parent.decode_step_lineage(
                    constants, state, prev_ids, step, anc, beam,
                    window=step + 1)
            return parent.decode_step(constants, state, prev_ids, step)

        for step in range(self.max_steps):
            if step and step % FINISHED_CHECK_PERIOD == 0 \
                    and ctx.all_finished(search.finished):
                break
            if ensemble:
                log_probs = []
                for i, constants in enumerate(constants_list):
                    states[i], logits, _ = take_step(constants, states[i],
                                                     step)
                    log_probs.append(torch.log_softmax(logits.float(),
                                                       dim=-1))
                x = torch.logsumexp(torch.stack(log_probs), dim=0) - log_n
                sel = None
            else:
                states[0], x, aux = take_step(constants_list[0], states[0],
                                              step)
                sel = ((aux["sel_rowmax"], aux["sel_lse"])
                       if "sel_rowmax" in aux else None)
            parents, tokens, new_logprob, _ = select_fn(
                x, search, batch, precomputed=sel, normalized=ensemble)
            weights = () if ensemble else aux.get("attention_weights", ())
            if with_attention and weights:
                w = weights[0].float().reshape(batch, beam, -1)
                if history is None:
                    history = w.new_zeros(batch, beam, self.max_steps,
                                          w.shape[-1])
                index = parents.long()
                history = torch.gather(history, 1, index[..., None, None]
                                       .expand_as(history))
                history[:, :, step] = torch.gather(
                    w, 1, index[..., None].expand_as(w))
            if not lineage:
                # each model's states move with the hypotheses they carry
                states = [_gather_beams(s, parents, beam) for s in states]
            # lineage decoding never reorders the state; it composes the
            # ancestry: written positions inherit the parent's lineage,
            # later ones stay the identity. Column ``step`` holds the
            # parents either way, and it is all a decoder that does not
            # read the ancestry needs.
            elif parent.reads_ancestry:
                inherited = torch.gather(
                    anc, 1, parents.long()[..., None].expand_as(anc))
                anc = torch.where(positions <= step, inherited, anc0)
            else:
                anc[:, :, step] = parents

            old_finished = _gather(search.finished, parents)
            old_lengths = _gather(search.lengths, parents)
            token_ids = torch.gather(
                search.token_ids, 1,
                parents.long()[..., None].expand_as(search.token_ids))
            # an emitted id must index the real vocabulary (the fused
            # projection's pad columns can never win, but stay safe)
            tokens = tokens.clamp_max(vocab - 1)
            emit = torch.where(old_finished, PAD_TOKEN_INDEX, tokens)
            token_ids[:, :, step] = emit
            search = SearchState(
                logprob_sum=new_logprob,
                lengths=old_lengths + (~old_finished).int(),
                finished=old_finished | (emit == END_TOKEN_INDEX),
                token_ids=token_ids)
            prev_ids = emit.reshape(-1)

        final_scores = search.logprob_sum / length_penalty(
            search.lengths, self.length_normalization)
        # best first; a stable sort keeps equal scores in slot order
        _, order = torch.sort(final_scores, dim=1, descending=True,
                              stable=True)
        return BeamSearchOutput(
            token_ids=torch.gather(
                search.token_ids, 1,
                order[..., None].expand_as(search.token_ids)),
            lengths=torch.gather(search.lengths, 1, order),
            scores=torch.gather(final_scores, 1, order),
            attention=None if history is None else torch.gather(
                history, 1, order[..., None, None].expand_as(history)))

