"""Parallelism over processes, one device each (counterpart of
``neuralmonkey_tpu/parallel``): the process group and its collectives
(``distributed.py``), the rank grid of the JAX package's mesh axes
(``mesh.py``), the ZeRO-1 and FSDP layouts over the data axis
(``zero.py``), tensor parallelism's collectives over the model axis and
the time axis's gathers and scatters (``tensor.py``), the ring
attention of context parallelism (``ring_attention.py``) and the GPipe
executor of pipeline parallelism (``pipeline.py``); expert parallelism
splits the MoE FFN's experts (``ops/moe.py``)."""

from .distributed import (broadcast_flags, data_count, data_index,
                          fetch_to_host, is_main_process, local_rows,
                          maybe_initialize, process_count, process_index,
                          sync_processes)
from .mesh import Mesh

__all__ = [
    "Mesh",
    "broadcast_flags",
    "data_count",
    "data_index",
    "fetch_to_host",
    "is_main_process",
    "local_rows",
    "maybe_initialize",
    "process_count",
    "process_index",
    "sync_processes",
]
