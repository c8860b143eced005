"""Module alias matching the reference layout
(nm/encoders/sequence_cnn_encoder.py); the implementation lives in
sentence_cnn_encoder.py."""

from .sentence_cnn_encoder import SequenceCNNEncoder

__all__ = ["SequenceCNNEncoder"]
