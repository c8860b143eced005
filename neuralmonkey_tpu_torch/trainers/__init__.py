"""Trainers: objectives -> losses -> optimizer updates (counterpart of
``neuralmonkey_tpu/trainers/``)."""
