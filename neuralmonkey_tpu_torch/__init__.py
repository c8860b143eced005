"""neuralmonkey_tpu_torch: the RNN translation model of
neuralmonkey_tpu, served and trained on PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a) in ``csrc/``.

It mirrors the JAX package's layout and names, keeps its parameter
names and layouts (checkpoints move between the two as ``.npz``
files), and imports neither JAX nor the JAX package. The JAX package
stays the reference the port is tested against.
"""
