"""Beam search (counterpart of
``neuralmonkey_tpu/models/decoders/beam_search_decoder.py``,
single-model search).

Batch and beam are flattened to one leading axis so the parent
decoder's step runs all beams at once. Each step scores candidates
with the Wu et al. (2016) length penalty and keeps the best K:

- ``hierarchical`` selection (the default at vocabularies of 2048 and
  more) reduces each beam's vocabulary to per-128-column maxima, takes
  the top K of those (K4), then the exact top K over the chosen
  columns (K4 again). The reductions come from the fused logit
  projection (K3), which the search arms for every hierarchical
  search. Exact: a column group holding a top-K element ranks in the
  top K groups by its maximum;
- ``flat`` selection takes the top K over the whole (B, K·V) matrix.

The parent decoder must support lineage decoding (the RNN decoder
does): its attention constants stay untiled, shared by the K beams, and
each step gathers the recurrent state by the previous step's parents.
The loop asks the device whether every hypothesis has finished only
every ``FINISHED_CHECK_PERIOD`` steps: a finished hypothesis is a fixed
point of the step (it emits PAD at zero cost and keeps its length and
score).
"""

from __future__ import annotations

from typing import List, NamedTuple

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


def length_penalty(lengths: torch.Tensor, alpha: float) -> torch.Tensor:
    """Wu et al. (2016) GNMT length normalization."""
    if alpha == 0.0:
        return torch.ones_like(lengths, dtype=torch.float32)
    return torch.pow((5.0 + lengths.float()) / 6.0, alpha)


def _gather(arr: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(arr, index, axis=1)`` with any index dtype."""
    return torch.gather(arr, 1, index.long())


class BeamSearchDecoder(ModelPart):

    def __init__(self, name: str,
                 parent_decoder: AutoregressiveDecoder,
                 beam_size: int,
                 length_normalization: float = 0.6,
                 max_steps: int = None,
                 use_approx_top_k: bool = False,
                 selection_method: str = "auto",
                 align_logits: bool = False,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        ModelPart.__init__(self, name, reuse, save_checkpoint,
                           load_checkpoint)
        if use_approx_top_k or align_logits:
            raise NotImplementedError(
                "use_approx_top_k and align_logits are not ported to "
                "neuralmonkey_tpu_torch yet")
        if selection_method not in ("auto", "flat", "hierarchical"):
            raise ValueError(
                f"Unknown selection_method: {selection_method}")
        if not parent_decoder.lineage_decode:
            raise NotImplementedError(
                f"beam search over {type(parent_decoder).__name__}: only "
                "decoders with lineage decoding are ported to "
                "neuralmonkey_tpu_torch")
        self.parent_decoder = parent_decoder
        self.beam_size = beam_size
        self.length_normalization = length_normalization
        self.max_steps = min(max_steps or parent_decoder.max_output_len,
                             parent_decoder.max_output_len)
        self.selection_method = selection_method

    @property
    def vocabulary(self):
        return self.parent_decoder.vocabulary

    def _method(self) -> str:
        if self.selection_method != "auto":
            return self.selection_method
        # hierarchical wins once full-vocabulary passes dominate
        return ("flat" if len(self.vocabulary) < 2048
                else "hierarchical")

    # ------------------------------------------------------------------ #
    # per-step candidate selection. Both selectors take raw logits
    # ``x`` (B·K, V) and the SearchState and return (parents (B, K),
    # tokens (B, K), new unnormalized logprob sums (B, K), normalized
    # scores (B, K)), best first. A finished beam contributes exactly
    # one candidate: PAD at zero incremental cost.
    # ------------------------------------------------------------------ #
    def _select_flat(self, x, search: SearchState, batch: int,
                     precomputed=None):
        del precomputed
        beam = self.beam_size
        vocab = x.shape[-1]
        logprobs = torch.log_softmax(x.float(), dim=-1).reshape(
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
                     precomputed=None):
        """Exact two-stage selection without (B, K, V) intermediates;
        ``precomputed`` carries (rowmax, lse) from the fused logit
        projection when the decode step emitted them."""
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
        if precomputed is not None \
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
    def search(self, ctx: Context) -> BeamSearchOutput:
        """Single-model beam search."""
        parent = self.parent_decoder
        beam = self.beam_size
        vocab = len(parent.vocabulary)
        constants = parent.decode_constants(ctx)
        state = parent.decode_initial_state(ctx, constants)
        batch = parent._batch_size(ctx)
        device = parent._device(ctx)
        method = self._method()
        select_fn = (self._select_hier if method == "hierarchical"
                     else self._select_flat)
        if method == "hierarchical":
            constants = parent.prepare_selection_fusion(constants)
        constants = parent.tile_decode_constants_lineage(constants, beam)
        state = state.repeat_interleave(beam, dim=0)

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
        # every beam slot starts as its own parent
        parents = torch.arange(beam, dtype=torch.int32,
                               device=device).expand(batch, beam)

        for step in range(self.max_steps):
            if step and step % FINISHED_CHECK_PERIOD == 0 \
                    and bool(search.finished.all()):
                break
            state, x, aux = parent.decode_step_lineage(
                constants, state, prev_ids, step, parents, beam)
            sel = ((aux["sel_rowmax"], aux["sel_lse"])
                   if "sel_rowmax" in aux else None)
            parents, tokens, new_logprob, _ = select_fn(
                x, search, batch, precomputed=sel)

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
            scores=torch.gather(final_scores, 1, order))

    def ensemble_search(self, contexts: List[Context]) -> BeamSearchOutput:
        raise NotImplementedError(
            "checkpoint ensembles (n_models > 1) are not ported to "
            "neuralmonkey_tpu_torch yet")
