"""Coverage attention (counterpart of
``neuralmonkey_tpu/models/attention/coverage.py``, reference
nm/attention/coverage.py): the implementation lives in feed_forward.py
beside the ``Attention`` it extends."""

from .feed_forward import CoverageAttention

__all__ = ["CoverageAttention"]
