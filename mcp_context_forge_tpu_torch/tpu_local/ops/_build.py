"""Kernel build: ``nvcc`` compiles each ``csrc/<name>.cu`` into its own
shared library with a plain C interface, loaded with :mod:`ctypes`.

The library lands in ``build/kernels/`` at the checkout root, named by a
hash of every source under ``csrc/`` and the compiler flags, so an edited
source rebuilds and an unchanged one is reused. Building happens at first
use (or all at once, in parallel, through :func:`build`). A missing
``nvcc`` or a failed compile raises: nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..compile_events import record_event

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("flash_attention_mma", "flash_attention_tc", "paged_chunk_attention_mma",
           "paged_chunk_attention_tc", "paged_decode_attention", "grouped_moe",
           "grouped_moe_tc", "kv_quant_store")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

PTR = ctypes.c_void_p
INT = ctypes.c_int

_lock = threading.Lock()
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_libs: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        candidates.insert(0, os.path.join(cuda_home, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (searched CUDA_HOME, PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build(names: tuple[str, ...] = KERNELS) -> dict[str, str]:
    """Build every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns each kernel's compiler output
    (``-Xptxas=-v``: registers, shared memory, spills), read back from the
    log beside the library when it was already built. Each ``nvcc`` run is
    a ``kernel_build`` event (``compile_events``) of the calling thread."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    started: dict[str, tuple[subprocess.Popen, Path]] = {}
    t0 = time.monotonic()
    logs: dict[str, str] = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            log = lib.with_suffix(".log")
            logs[name] = log.read_text() if log.exists() else ""
            continue
        nvcc = nvcc or find_nvcc()
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        started[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         tmp)
    failed = []
    for name, (proc, tmp) in started.items():
        output, _ = proc.communicate()
        record_event("kernel_build", time.monotonic() - t0)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{output}")
            continue
        lib = library_path(name)
        lib.with_suffix(".log").write_text(output)
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
        logs[name] = output
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def kernel_fn(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of kernel ``name``, building it on first use.
    Every entry returns ``cudaGetLastError()`` as an int."""
    key = (name, symbol)
    fn = _fns.get(key)
    if fn is not None:
        return fn
    with _lock:
        if key not in _fns:
            lib = _libs.get(name)
            if lib is None:
                build((name,))
                lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[key] = fn
    return _fns[key]


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


# dtype codes of the C entries (bf16 0, f32 1 in every csrc/ source that
# takes both)
DTYPE_CODES = {"torch.bfloat16": 0, "torch.float32": 1}


def check_inputs(name: str, data: dict, ints: dict,
                 int8: dict | None = None, scales: dict | None = None) -> int:
    """Validate the tensors handed to a kernel: one CUDA device, contiguous,
    16-byte aligned (the kernels load 8 elements at a time), ``data`` all of
    one supported float dtype, ``ints`` int32 (bool for ``valid``),
    ``int8`` (quantized weights or KV pages) int8. ``scales`` share the
    ``data`` dtype but are read one element at a time, so they need only
    element alignment: one layer's slice of a pool's [L, N, KV] scales is
    rarely 16-byte aligned. Returns the dtype code."""
    int8 = int8 or {}
    scales = scales or {}
    tensors = {**data, **ints, **int8, **scales}
    device = next(iter(tensors.values())).device
    dtypes = {str(t.dtype) for t in [*data.values(), *scales.values()]}
    if len(dtypes) != 1 or next(iter(dtypes)) not in DTYPE_CODES:
        raise TypeError(f"{name}: {'/'.join([*data, *scales])} must share one "
                        f"dtype of {sorted(DTYPE_CODES)}, got {sorted(dtypes)}")
    for arg, t in tensors.items():
        if t.device != device or device.type != "cuda":
            raise ValueError(f"{name}: {arg} must be on {device} (a CUDA "
                             f"device), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    for arg, t in {**data, **int8}.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    for arg, t in scales.items():
        if t.data_ptr() % t.element_size():
            raise ValueError(f"{name}: {arg} must be element aligned")
    for arg, t in ints.items():
        want = "torch.bool" if arg == "valid" else "torch.int32"
        if str(t.dtype) != want:
            raise TypeError(f"{name}: {arg} must be {want}, got {t.dtype}")
    for arg, t in int8.items():
        if str(t.dtype) != "torch.int8":
            raise TypeError(f"{name}: {arg} must be torch.int8, got {t.dtype}")
    return DTYPE_CODES[next(iter(dtypes))]


def check_head_dim(name: str, hd: int) -> None:
    if hd <= 0 or hd > 256 or hd % 8:
        raise ValueError(f"{name}: head_dim must be a multiple of 8 up to 256, "
                         f"got {hd}")
