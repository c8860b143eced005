"""Hand-written Hopper kernels: build, load, launch and count.

Counterpart of ``neuralmonkey_tpu/ops/kernel_config.py``. The kernels
are CUDA C++ in ``neuralmonkey_tpu_torch/csrc/`` with a plain C
interface. At first use ``nvcc`` compiles them for ``sm_90a``, one
process per source, all at once, and links them into
``build/neuralmonkey_tpu_torch/``, in a library whose
file name carries a hash of the sources and flags, and ``ctypes`` loads
it. That build, together with the status check after every launch, is
what the JAX package's Mosaic probe ``_pallas_compiles`` did: it finds
out whether kernels build and run on this host.

No switch selects between a kernel and its plain version. Each kernel
wrapper takes the kernel's plain PyTorch version for a tensor on the CPU
and launches the kernel for a CUDA tensor. On a CUDA device below
compute capability 9.0, when the build fails, or when a launch returns a
CUDA error, the wrapper raises; nothing falls back quietly. Only a shape
that the JAX package sends past its kernel to its plain path takes the
plain path on the card: each family's gate is a function of shapes,
decided before any launch (``cuda_rnn.scan_fits``, ``bptt_fits`` and
``lstm_scan_fits``, ``beam_select.topk_kernel_takes``), and
:func:`log_plain_path` logs each (kernel, reason) once. Wherever the JAX
package runs its kernel the port runs its own: the flash and lineage
kernels take every head dim (past their single-pass widths in chunked
instances, counted under their own names). The switches
that remain choose between two paths of the model, each with its own
kernels, as in the JAX package (``use_fused_logits``).

Each kernel has one launch counter, raised by one where its wrapper
launches it, so a run can show that its main path went through the
kernels (``launch_counts``/``reset_launch_counts``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Set, Tuple

import torch

from ..logging import log

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build",
                         "neuralmonkey_tpu_torch")
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# kernel name -> the C entry point its wrapper launches
ENTRY_POINTS = {
    "gru_scan": "nm_gru_scan",
    "gru_bptt": "nm_gru_bptt",
    "fused_bahdanau_step": "nm_bahdanau_step",
    "fused_logits_rowmax_lse": "nm_fused_logits",
    "small_topk": "nm_small_topk",
    "fused_xent_fwd": "nm_xent_fwd",
    "fused_xent_bwd_dx": "nm_xent_bwd_dx",
    "fused_xent_bwd_dw": "nm_xent_bwd_dw",
    "flash_attention_fwd": "nm_flash_fwd",
    "flash_attention_bwd_dq": "nm_flash_bwd_dq",
    "flash_attention_bwd_dkv": "nm_flash_bwd_dkv",
    "lineage_attention": "nm_lineage_attention",
    # the chunked instances past the single-pass head dims: the same entry
    # points, counted apart
    "flash_attention_fwd_chunked": "nm_flash_fwd",
    "flash_attention_bwd_dq_chunked": "nm_flash_bwd_dq",
    "flash_attention_bwd_dkv_chunked": "nm_flash_bwd_dkv",
    "lineage_attention_chunked": "nm_lineage_attention",
    # the bf16 instances (the bf16 compute policy): lineage attention on bf16
    # caches, the fused cross-entropy reading a bf16 W
    "lineage_attention_bf16": "nm_lineage_attention_bf16",
    "fused_xent_fwd_bf16w": "nm_xent_fwd_bf16w",
    "fused_xent_bwd_dx_bf16w": "nm_xent_bwd_dx_bf16w",
    "fused_xent_bwd_dw_bf16w": "nm_xent_bwd_dw_bf16w",
    "lstm_scan": "nm_lstm_scan",
    "lstm_bptt": "nm_lstm_bptt",
    "rowmax_lse": "nm_rowmax_lse",
}
_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # pointers..., sizes and flags..., stream
    "nm_gru_scan": [_PTR] * 9 + [_INT] * 11 + [_PTR],
    "nm_gru_bptt": [_PTR] * 12 + [_INT] * 10 + [_PTR],
    "nm_bahdanau_step": [_PTR] * 7 + [_INT] * 10 + [_PTR],
    "nm_fused_logits": [_PTR] * 7 + [_INT] * 3 + [_PTR],
    "nm_small_topk": [_PTR] * 3 + [_INT] * 8 + [_PTR],
    "nm_xent_fwd": [_PTR] * 10 + [_INT] * 4 + [_FLOAT, _PTR],
    "nm_xent_bwd_dx": [_PTR] * 8 + [_INT] * 6 + [_FLOAT, _PTR],
    "nm_xent_bwd_dw": [_PTR] * 10 + [_INT] * 6 + [_FLOAT, _PTR],
    "nm_flash_fwd": [_PTR] * 6 + [_INT] * 10 + [_FLOAT] * 2 + [_PTR],
    "nm_flash_bwd_dq": [_PTR] * 8 + [_INT] * 10 + [_FLOAT] * 2 + [_PTR],
    "nm_flash_bwd_dkv": [_PTR] * 9 + [_INT] * 10 + [_FLOAT] * 2 + [_PTR],
    "nm_lineage_attention": [_PTR] * 7 + [_INT] * 15 + [_FLOAT, _PTR],
    "nm_lineage_attention_bf16": [_PTR] * 7 + [_INT] * 8 + [_FLOAT, _PTR],
    "nm_xent_fwd_bf16w": [_PTR] * 10 + [_INT] * 4 + [_FLOAT, _PTR],
    "nm_xent_bwd_dx_bf16w": [_PTR] * 8 + [_INT] * 6 + [_FLOAT, _PTR],
    "nm_xent_bwd_dw_bf16w": [_PTR] * 10 + [_INT] * 6 + [_FLOAT, _PTR],
    "nm_lstm_scan": [_PTR] * 9 + [_INT] * 11 + [_FLOAT, _PTR],
    "nm_lstm_bptt": [_PTR] * 11 + [_INT] * 11 + [_FLOAT, _PTR],
    "nm_rowmax_lse": [_PTR] * 4 + [_INT] * 2 + [_PTR],
}

_LOCK = threading.Lock()
_LIBRARY: Optional[ctypes.CDLL] = None
_LAUNCHES: Dict[str, int] = dict.fromkeys(ENTRY_POINTS, 0)
# (kernel, reason) pairs whose plain path has been logged
_PLAIN_PATHS: Set[Tuple[str, str]] = set()


def use_fused_logits() -> bool:
    """Whether beam search arms the decode constants for the fused logit
    projection (``beam_select.fused_logits_rowmax_lse``); when off, the
    hierarchical selector takes its reductions from ``rowmax_lse`` over
    the plain logits. ``NM_FUSED_LOGITS=0``/``1`` decides, read as the
    JAX package reads it; unset means on, as on the TPU, where the
    kernels always build."""
    env = os.environ.get("NM_FUSED_LOGITS")
    if env is not None:
        return env not in ("0", "false", "False", "")
    return True


def kernel_sources() -> List[str]:
    return sorted(os.path.join(CSRC_DIR, name)
                  for name in os.listdir(CSRC_DIR)
                  if name.endswith((".cu", ".cuh")))


def library_path() -> str:
    """Where the build of the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in kernel_sources():
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libnm_kernels_{digest.hexdigest()[:16]}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(NVCC_DEFAULT):
        return NVCC_DEFAULT
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "of neuralmonkey_tpu_torch cannot be built on this host")


def _run_nvcc(cmds: List[List[str]]) -> None:
    """Run the ``nvcc`` commands all at once; raise if any fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{stderr[-4000:]}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> str:
    """Compile every kernel source into one shared library, unless a
    build of exactly these sources exists: one ``nvcc`` per source, all
    started together, then one link. Returns its path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    sources = [p for p in kernel_sources() if p.endswith(".cu")]
    objects = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
               for src in sources]
    try:
        _run_nvcc([[nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
                   for src, obj in zip(sources, objects)])
        _run_nvcc([[nvcc, *NVCC_FLAGS, "-shared", "-o", f"{path}.{tag}",
                    *objects]])
    finally:
        for obj in objects:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(f"{path}.{tag}", path)
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIBRARY
    with _LOCK:
        if _LIBRARY is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.nm_error_string.argtypes = [ctypes.c_int]
            lib.nm_error_string.restype = ctypes.c_char_p
            _LIBRARY = lib
    return _LIBRARY


@functools.lru_cache(maxsize=None)
def device_limits(index: int) -> Tuple[int, int]:
    """(SM count, opt-in shared bytes per block) of CUDA device
    ``index``, which the persistent kernels' plans read."""
    props = torch.cuda.get_device_properties(index)
    return (props.multi_processor_count,
            getattr(props, "shared_memory_per_block_optin", 227 * 1024))


def tensor_device_limits(tensor: torch.Tensor) -> Tuple[int, int]:
    """:func:`device_limits` of the CUDA device ``tensor`` lies on."""
    index = tensor.device.index
    return device_limits(torch.cuda.current_device() if index is None
                         else index)


def check_cuda_inputs(kernel: str,
                      dtypes: Optional[Dict[str, torch.dtype]] = None,
                      **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous tensor on one CUDA
    device of compute capability >= 9.0, of the dtype its kernel takes:
    ``dtypes[name]`` where given (the bf16 instances' bf16 operands),
    float32 otherwise. So a bf16 operand that reaches a float32 kernel
    raises."""
    dtypes = dtypes or {}
    device = None
    for name, tensor in tensors.items():
        if not tensor.is_cuda:
            raise ValueError(f"{kernel}: '{name}' is on {tensor.device}, "
                             "expected the CUDA device of the others")
        expected = dtypes.get(name, torch.float32)
        if tensor.dtype != expected:
            raise ValueError(f"{kernel}: '{name}' is {tensor.dtype}, "
                             f"expected {expected}")
        if not tensor.is_contiguous():
            raise ValueError(f"{kernel}: '{name}' is not contiguous")
        if device is None:
            device = tensor.device
        elif tensor.device != device:
            raise ValueError(f"{kernel}: '{name}' is on {tensor.device}, "
                             f"the others on {device}")
    capability = torch.cuda.get_device_capability(device)
    if capability < (9, 0):
        raise RuntimeError(
            f"{kernel}: {torch.cuda.get_device_name(device)} has compute "
            f"capability {capability}; the kernels are built for sm_90a")


def launch(kernel: str, *args) -> None:
    """Launch ``kernel`` on the current stream of the device of the
    first tensor argument. Tensors pass as pointers (``None`` as a null
    pointer), numbers as the entry point declares them.
    Raises on a nonzero cudaError_t; counts the launch otherwise."""
    lib = library()
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = getattr(lib, ENTRY_POINTS[kernel])(*c_args, stream)
    if status != 0:
        message = lib.nm_error_string(status).decode()
        raise RuntimeError(f"{kernel}: launch failed with CUDA error "
                           f"{status} ({message})")
    _LAUNCHES[kernel] += 1


def log_plain_path(kernel: str, reason: str) -> None:
    """Log, once per (kernel, reason), that a shape gate sent a call to
    the kernel's plain path (on the card's tensors too), as the JAX
    package takes its plain path past a kernel's gate."""
    if (kernel, reason) not in _PLAIN_PATHS:
        _PLAIN_PATHS.add((kernel, reason))
        log(f"{kernel}: {reason}: the kernel does not take this shape; "
            "the plain PyTorch path runs instead")


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0
