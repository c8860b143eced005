"""Self-critical sequence training (counterpart of
``neuralmonkey_tpu/trainers/self_critical_objective.py``, reference
nm/trainers/self_critical_objective.py; Rennie et al. 2017).

REINFORCE with the greedy decode as the baseline: sample a sequence,
score the sample and the greedy output against the reference with a
sentence-level metric (GLEU or BLEU), and weigh the sample's log-prob
by the advantage. The rewards are computed on the host once a step,
from one device-to-host copy of the sampled, greedy and reference ids,
where the JAX package's ``pure_callback`` copies them. The greedy
baseline runs without gradient, and the advantage carries none.
"""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch

from ..evaluators.bleu import BLEUEvaluator
from ..evaluators.gleu import gleu_sentence
from ..model.part import Context
from ..parallel.distributed import global_mean
from ..vocabulary import END_TOKEN_INDEX, PAD_TOKEN_INDEX
from .generic_trainer import Objective


def _ids_to_lists(ids: np.ndarray) -> List[List[int]]:
    """Each row's ids up to its END, without PAD."""
    out = []
    for row in ids:
        sent: List[int] = []
        for token in row:
            token = int(token)
            if token == END_TOKEN_INDEX:
                break
            if token != PAD_TOKEN_INDEX:
                sent.append(token)
        out.append(sent)
    return out


def sentence_gleu(hyp_ids: Any, ref_ids: Any) -> float:
    return gleu_sentence([str(i) for i in hyp_ids],
                         [str(i) for i in ref_ids])


def sentence_bleu(hyp_ids: Any, ref_ids: Any) -> float:
    return BLEUEvaluator.bleu(
        [[str(i) for i in hyp_ids]], [[[str(i) for i in ref_ids]]])


def _batch_rewards(reward_function: Callable,
                   hyp: np.ndarray, ref: np.ndarray) -> np.ndarray:
    return np.array([reward_function(h, r) for h, r in zip(
        _ids_to_lists(hyp), _ids_to_lists(ref))], np.float32)


def _rewards(reward_function: Callable, ref: torch.Tensor,
             *hyps: torch.Tensor) -> List[torch.Tensor]:
    """The (B,) rewards of each of ``hyps`` against ``ref``, computed on
    the host from one copy of all their ids, on ``ref``'s device."""
    ids = torch.cat([ref, *hyps], dim=1).cpu().numpy()
    ref_ids, start = ids[:, :ref.shape[1]], ref.shape[1]
    rewards = []
    for hyp in hyps:
        rewards.append(torch.from_numpy(_batch_rewards(
            reward_function, ids[:, start:start + hyp.shape[1]],
            ref_ids)).to(ref.device))
        start += hyp.shape[1]
    return rewards


def self_critical_objective(decoder,
                            reward_function: Callable = sentence_gleu,
                            weight: float = 1.0,
                            name: str = None) -> Objective:

    def loss(ctx: Context) -> torch.Tensor:
        targets = ctx.batch[decoder.target_ids_key]
        # the sample first: its pass keeps the gradient of the memoized
        # encoder states and attention constants the greedy pass reuses
        sampled, sampled_logprob = decoder.sample_outputs(ctx)
        with torch.no_grad():
            greedy = decoder.greedy_ids(ctx)
        sampled_reward, greedy_reward = _rewards(reward_function, targets,
                                                 sampled, greedy)
        advantage = sampled_reward - greedy_reward
        return -global_mean(advantage * sampled_logprob)

    return Objective(
        name=name or f"{decoder.name} - self-critical",
        decoder=decoder, loss=loss, weight=weight)


def reinforce_objective(decoder,
                        reward_function: Callable = sentence_gleu,
                        subtract_baseline: bool = True,
                        weight: float = 1.0,
                        name: str = None) -> Objective:
    """Plain REINFORCE (reference nm/trainers/rl_trainer.py): the
    sampled reward, less the batch's mean reward with
    ``subtract_baseline``."""

    def loss(ctx: Context) -> torch.Tensor:
        targets = ctx.batch[decoder.target_ids_key]
        sampled, sampled_logprob = decoder.sample_outputs(ctx)
        (reward,) = _rewards(reward_function, targets, sampled)
        if subtract_baseline:
            # the global batch's mean reward
            reward = reward - global_mean(reward)
        return -global_mean(reward * sampled_logprob)

    return Objective(
        name=name or f"{decoder.name} - reinforce",
        decoder=decoder, loss=loss, weight=weight)


# the reference's module name for it
rl_objective = reinforce_objective
