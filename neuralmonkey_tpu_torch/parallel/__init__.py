"""Data parallelism over processes, one device each (counterpart of
``neuralmonkey_tpu/parallel``): the process group and its collectives
(``distributed.py``) and the ZeRO-1 and FSDP layouts (``zero.py``).
The model axes (tensor, sequence, expert, pipeline and context
parallelism, the ring attention) are not ported yet (ROADMAP queue
A15, part 2)."""

from .distributed import (broadcast_flags, fetch_to_host, is_main_process,
                          local_rows, maybe_initialize, process_count,
                          process_index, sync_processes)

__all__ = [
    "broadcast_flags",
    "fetch_to_host",
    "is_main_process",
    "local_rows",
    "maybe_initialize",
    "process_count",
    "process_index",
    "sync_processes",
]
