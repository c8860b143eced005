"""CTC decoder (counterpart of
``neuralmonkey_tpu/models/decoders/ctc_decoder.py``, reference
nm/decoders/ctc_decoder.py): the CTC loss over a TemporalStateful
encoder, decoded by greedy collapse or by prefix beam search.

The loss is ``F.ctc_loss`` per sequence, then a plain mean over the
sequences, as the JAX package takes ``optax.ctc_loss`` (its log-softmax
included) and ``jnp.mean``; both compute it outside any kernel of their
own. A target that no alignment reaches (longer than its frames allow)
costs 0 here, where optax's ``log_epsilon`` gives a large finite number
(ROADMAP queue C).

``beam_width > 1`` switches ``decoded`` to the prefix beam search
(Hannun et al. 2014): a loop over the frames on the device, with no
host synchronisation inside it, keeping K prefixes per sentence with
their blank-ending and symbol-ending log-probabilities, and merging an
extension that re-creates a prefix already in the beam. Every
selection breaks ties by the lowest index (stable sorts), as
``lax.top_k`` and ``jnp.argsort`` do. The blank is the vocabulary's
<pad> = 0.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ...model.part import Context, ModelPart, tensor
from ...model.stateful import TemporalStateful
from ...ops import nn
from ...parallel.distributed import global_mean
from ...vocabulary import PAD_TOKEN_INDEX, Vocabulary

BLANK = PAD_TOKEN_INDEX  # = 0
NEG = -1.0e30  # a minus infinity that stays NaN-free under arithmetic


def ctc_loss_per_sequence(logits: torch.Tensor, frame_mask: torch.Tensor,
                          labels: torch.Tensor, label_mask: torch.Tensor
                          ) -> torch.Tensor:
    """(B,) negative log-likelihoods of ``labels`` (B, L) under the CTC
    model of ``logits`` (B, T, V), lengths read from the masks; an
    unreachable target costs 0."""
    log_probs = torch.log_softmax(logits, dim=-1).transpose(0, 1)
    return F.ctc_loss(log_probs, labels.long(),
                      frame_mask.sum(1).long(), label_mask.sum(1).long(),
                      blank=BLANK, reduction="none", zero_infinity=True)


def ctc_beam_search(lp_frames: torch.Tensor, valid_frames: torch.Tensor,
                    k: int):
    """CTC prefix beam search over log-probabilities ``lp_frames``
    (B, T, V) with the frame mask ``valid_frames`` (B, T, bool).

    Returns (prefixes (B, K, T) padded with the blank, best first; their
    total log-probabilities (B, K))."""
    batch, time, vocab = lp_frames.shape
    device = lp_frames.device
    prefixes = torch.zeros(batch, k, time, dtype=torch.long, device=device)
    lengths = torch.zeros(batch, k, dtype=torch.long, device=device)
    last = torch.full((batch, k), -1, dtype=torch.long, device=device)
    # slot 0 is the empty prefix, all its mass ending in a blank; the
    # other slots are dead
    lp_b = torch.full((batch, k), NEG, device=device)
    lp_b[:, 0] = 0.0
    lp_nb = torch.full((batch, k), NEG, device=device)
    t_iota = torch.arange(time, device=device)
    v_iota = torch.arange(vocab, device=device)

    for t in range(time):
        valid = valid_frames[:, t]
        lp = torch.where(valid[:, None], lp_frames[:, t], NEG)   # (B, V)
        total = torch.logaddexp(lp_b, lp_nb)                     # (B, K)
        # the prefix stays and now ends in a blank
        stay_b = total + lp[:, BLANK, None]
        # the prefix stays: a repeat of its last symbol collapses
        last_safe = last.clamp_min(0)
        stay_nb = torch.where(last >= 0, lp_nb + lp.gather(1, last_safe),
                              NEG)
        # the prefix grows by symbol c (never the blank); repeating the
        # last symbol must pass through a blank
        base = torch.where(v_iota == last[..., None], lp_b[..., None],
                           total[..., None])                     # (B, K, V)
        append = base + lp[:, None, :]
        append[..., BLANK] = NEG

        # exact merge: the extension (k1, c) equal to the prefix in slot
        # k2 adds its mass to k2's stay bucket and dies
        len_ok = lengths[:, :, None] + 1 == lengths[:, None, :]
        cut = prefixes[:, None, :, :] * (
            t_iota != lengths[:, :, None, None])
        same = (prefixes[:, :, None, :] == cut).all(dim=3)
        match = len_ok & same & (last[:, None, :] >= 0)          # (B, K, K)
        app_at_last = append.gather(
            2, last_safe[:, None, :].expand(batch, k, k))
        contrib = torch.logsumexp(torch.where(match, app_at_last, NEG),
                                  dim=1)
        stay_nb = torch.logaddexp(stay_nb, contrib)
        kill = (match[..., None]
                & (v_iota == last[:, None, :, None])).any(dim=2)
        append = torch.where(kill, NEG, append)

        # candidates: K stays, then K·V extensions
        stay_score = torch.logaddexp(stay_b, stay_nb)
        cand = torch.cat([stay_score, append.reshape(batch, k * vocab)],
                         dim=1)
        idx = torch.sort(cand, dim=1, descending=True,
                         stable=True).indices[:, :k]
        is_stay = idx < k
        grown = (idx - k).clamp_min(0)
        parent = torch.where(is_stay, idx, grown // vocab)
        symbol = torch.where(is_stay, 0, grown % vocab)

        old_prefix = prefixes.gather(1, parent[..., None].expand(-1, -1,
                                                                 time))
        old_len = lengths.gather(1, parent)
        new_prefix = torch.where(
            (t_iota == old_len[..., None]) & ~is_stay[..., None],
            symbol[..., None], old_prefix)
        new_len = old_len + (~is_stay).long()
        new_last = torch.where(is_stay, last.gather(1, parent), symbol)
        app_val = append.reshape(batch, k * vocab).gather(1, grown)
        new_lp_b = torch.where(is_stay, stay_b.gather(1, parent), NEG)
        new_lp_nb = torch.where(is_stay, stay_nb.gather(1, parent), app_val)

        # a masked frame leaves the beam as it was
        keep = valid[:, None]
        prefixes = torch.where(keep[..., None], new_prefix, prefixes)
        lengths = torch.where(keep, new_len, lengths)
        last = torch.where(keep, new_last, last)
        lp_b = torch.where(keep, new_lp_b, lp_b)
        lp_nb = torch.where(keep, new_lp_nb, lp_nb)

    scores = torch.logaddexp(lp_b, lp_nb)
    order = torch.sort(-scores, dim=1, stable=True).indices
    return (prefixes.gather(1, order[..., None].expand(-1, -1, time)),
            scores.gather(1, order))


def ctc_greedy(logits: torch.Tensor, mask: torch.Tensor,
               merge_repeated: bool = True) -> torch.Tensor:
    """Greedy CTC: argmax per frame (the first maximum), collapse
    repeats, drop blanks, left-pack the kept symbols (B, T)."""
    frames = torch.where(mask > 0, logits.argmax(dim=-1), BLANK)
    if merge_repeated:
        prev = F.pad(frames[:, :-1], (1, 0), value=BLANK)
        keep = (frames != BLANK) & (frames != prev)
    else:
        keep = frames != BLANK
    time = frames.shape[1]
    # a stable left-pack: sort on (not kept, position)
    order = torch.sort((~keep).long() * time + torch.arange(
        time, device=frames.device), dim=1, stable=True).indices
    packed = frames.gather(1, order)
    return torch.where(keep.gather(1, order), packed, BLANK)


class CTCDecoder(ModelPart):

    def __init__(self, name: str,
                 encoder: TemporalStateful,
                 vocabulary: Vocabulary,
                 data_id: str,
                 max_length: int = None,
                 merge_repeated_targets: bool = False,
                 merge_repeated_outputs: bool = True,
                 beam_width: int = 1,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        ModelPart.__init__(self, name, reuse, save_checkpoint,
                           load_checkpoint)
        if merge_repeated_targets:
            # the JAX package takes this knob and ignores it
            raise ValueError(
                f"{name}: merge_repeated_targets=True has no effect in the "
                "reference; the port refuses it (ROADMAP queue C)")
        self.encoder = encoder
        self.vocabulary = vocabulary
        self.data_id = data_id
        self.max_length = max_length
        self.merge_repeated_targets = merge_repeated_targets
        self.merge_repeated_outputs = merge_repeated_outputs
        self.beam_width = beam_width

    @property
    def labels_key(self) -> str:
        return f"{self.name}.labels"

    @property
    def labels_mask_key(self) -> str:
        return f"{self.name}.labels_mask"

    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        return {"logit": nn.linear_init(gen, self.encoder.state_dim,
                                        len(self.vocabulary))}

    def featurize(self, dataset, train: bool = False
                  ) -> Dict[str, np.ndarray]:
        if not dataset.has_series(self.data_id):
            return {}
        ids, mask = self.vocabulary.sentences_to_tensor(
            dataset.get_series(self.data_id), max_len=self.max_length)
        return {self.labels_key: ids, self.labels_mask_key: mask}

    # ------------------------------------------------------------------ #
    @tensor
    def logits(self, ctx: Context):
        return nn.linear(ctx.get_params(self)["logit"],
                         self.encoder.temporal_states(ctx))

    @tensor
    def train_loss(self, ctx: Context):
        return global_mean(ctc_loss_per_sequence(
            self.logits(ctx), self.encoder.temporal_mask(ctx),
            ctx.batch[self.labels_key],
            ctx.batch[self.labels_mask_key]))

    def cost(self, ctx: Context):
        return self.train_loss(ctx)

    runtime_loss = train_loss

    @tensor
    def decoded(self, ctx: Context):
        """The best label sequence (B, T): prefix beam search when
        beam_width > 1, greedy collapse otherwise."""
        if self.beam_width > 1:
            return self.beam_search(ctx)[0][:, 0, :]
        return self.greedy_decoded(ctx)

    @tensor
    def beam_search(self, ctx: Context):
        """(prefixes (B, K, T), scores (B, K)), best first."""
        return ctc_beam_search(
            torch.log_softmax(self.logits(ctx), dim=-1),
            self.encoder.temporal_mask(ctx) > 0, self.beam_width)

    @tensor
    def greedy_decoded(self, ctx: Context):
        return ctc_greedy(self.logits(ctx), self.encoder.temporal_mask(ctx),
                          self.merge_repeated_outputs)
