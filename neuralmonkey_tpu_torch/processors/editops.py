"""Edit-operation encoding for automatic post-editing (counterpart of
``neuralmonkey_tpu/processors/editops.py``, reference
nm/processors/editops.py): represent a target sentence as a
sequence of keep/delete/insert ops relative to the source, and convert
back. Used by the post-edit milestone config."""

from __future__ import annotations

from difflib import SequenceMatcher
from typing import List

KEEP = "<keep>"
DELETE = "<delete>"


class Preprocess:
    """(source, target) pair -> edit-op sequence. Configured with the
    names of the two series; called on a zipped pair by the dataset
    preprocessing hook, or directly with two token lists."""

    def __init__(self, source_id: str = None, target_id: str = None) -> None:
        self.source_id = source_id
        self.target_id = target_id

    def __call__(self, pair) -> List[str]:
        source, target = pair
        return convert_to_edits(source, target)


class Postprocess:
    """(source, edit-ops) -> reconstructed target sentence."""

    def __init__(self, source_id: str = None, edits_id: str = None,
                 result_postprocess=None) -> None:
        self.source_id = source_id
        self.edits_id = edits_id
        self.result_postprocess = result_postprocess

    def __call__(self, pair) -> List[str]:
        source, edits = pair
        result = reconstruct(source, edits)
        if self.result_postprocess is not None:
            result = self.result_postprocess([result])[0]
        return result


def convert_to_edits(source: List[str], target: List[str]) -> List[str]:
    matcher = SequenceMatcher(a=source, b=target, autojunk=False)
    edits: List[str] = []
    for tag, i1, i2, j1, j2 in matcher.get_opcodes():
        if tag == "equal":
            edits.extend([KEEP] * (i2 - i1))
        elif tag == "delete":
            edits.extend([DELETE] * (i2 - i1))
        elif tag == "insert":
            edits.extend(target[j1:j2])
        elif tag == "replace":
            edits.extend([DELETE] * (i2 - i1))
            edits.extend(target[j1:j2])
    return edits


def reconstruct(source: List[str], edits: List[str]) -> List[str]:
    target: List[str] = []
    pos = 0
    for edit in edits:
        if edit == KEEP:
            if pos < len(source):
                target.append(source[pos])
            pos += 1
        elif edit == DELETE:
            pos += 1
        else:
            target.append(edit)
    # ops exhausted before source: keep the remainder (reference behavior)
    target.extend(source[pos:])
    return target
