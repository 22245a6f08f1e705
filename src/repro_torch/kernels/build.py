"""Builds the hand-written CUDA kernels under ``csrc/`` and binds them.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, under ``build/kernels/`` at
the repository root (git-ignored), and loaded with ``ctypes``.  All
sources compile at once, one ``nvcc`` process each, at the first use of
any kernel (or through ``build_all()``).  A library's file name carries a
hash of its sources and flags, so an edited kernel is rebuilt and a
stale one is never loaded.

Every C entry point launches on the stream it is given (PyTorch's
current stream), allocates nothing, and returns ``cudaGetLastError()``
as an int; ``check_launch`` raises when it is not 0.  There is no
fallback: a failed build raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# C signature of every entry point: argument kinds in order.
# "p" = pointer (ctypes.c_void_p), "i" = int (ctypes.c_int).
SIGNATURES: Dict[str, Dict[str, str]] = {
    "scan_topk_indexed": {
        # q, data, valid, nrows, sel, qmask, order, ws, part_d, part_i,
        # gbuf, run_d, run_i, B, U, S, d, K, Uc, scratch_blocks, is_bf16,
        # l2, stream
        "scan_indexed": "ppppppppppppp" + "iiiiiiiii" + "p",
        # qmask, order, ws, B, U, Uc, stream
        "group_queries": "pppiiip",
        # d, K, is_bf16
        "scan_indexed_placement": "iii",
    },
    "scan_topk_indexed_q8": {
        # q_codes, q_scales, codes, scales, aux, qc, valid, nrows, sel,
        # qmask, order, ws, part_d, part_i, gbuf, run_d, run_i, B, U, S, d,
        # K, Uc, scratch_blocks, l2, stream
        "scan_indexed_q8": "ppppppppppppppppp" + "iiiiiiii" + "p",
        # d, K
        "scan_indexed_q8_placement": "ii",
    },
    "scan_topk": {
        # q, xs, valid, part_d, part_i, gbuf, out_d, out_i, Q, N, d, K,
        # splits, tiles_per_split, grid, vec, is_bf16, l2, stream
        "scan_dense_tiles": "pppppppp" + "iiiiiiiiii" + "p",
        # q, xs, valid, part_d, part_i, gbuf, ticket, out_d, out_i, Q, N,
        # d, K, blocks, rows_per_warp, vec, is_bf16, l2, stream
        "scan_dense_rows": "ppppppppp" + "iiiiiiiii" + "p",
        # stream
        "launch_empty": "p",
    },
    "kmeans_assign": {
        # xs, centroids, aux, out_a, out_d, part_a, part_d, N, C, d,
        # tiles_per_split, stream
        "kmeans_assign": "pppppppiiiip",
    },
    "flash_attention": {
        # q, k, v, out, B, Sq, Sk, H, KH, D, q/k/v strides of (B, S, head)
        # (9), causal, is_bf16, stream
        "flash_attention": "pppp" + "i" * 17 + "p",
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_EVENTS = [0]            # libraries loaded by this process


def build_events() -> int:
    """Monotonic count of kernel libraries this process has made ready
    (built if needed, then loaded): each is a one-time cost that a
    warmed path never pays again (the sanitizer's build-event counter)."""
    return _EVENTS[0]


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "CUDA kernels are built from source at first use")
    return found


def _sources(name: str):
    headers = sorted(CSRC.glob("*.cuh"))
    return [CSRC / f"{name}.cu"] + headers


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=None) -> Dict[str, float]:
    """Compile every kernel library that is not built yet, all nvcc
    processes started together.  Returns {name: seconds} for the
    libraries this call built (empty when all were current).  The ptxas
    report of each build is kept beside its library as ``.log``."""
    names = list(SIGNATURES) if names is None else list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    took, errors = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[n] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise KernelBuildError("\n".join(errors))
    return took


def build_log(name: str) -> Optional[str]:
    """The compiler's report (registers, shared memory, spills) of the
    current build of ``name``, if it was built here."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else None


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` with typed entry points, built first
    if needed (every missing library is built in the same call)."""
    if name in _LIBS:
        return _LIBS[name]
    path = _lib_path(name)
    if not path.exists():
        build_all()
    handle = ctypes.CDLL(str(path))
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int}
    for fn_name, sig in SIGNATURES[name].items():
        fn = getattr(handle, fn_name)
        fn.argtypes = [kinds[c] for c in sig]
        fn.restype = ctypes.c_int
    _LIBS[name] = handle
    _EVENTS[0] += 1
    return handle


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise KernelLaunchError(f"{what}: CUDA error {err} at launch")


class LaunchCounter:
    """Launches of one kernel wrapper.  The wrapper adds one where it
    launches its kernel and nowhere else, so a run can show that its
    main path went through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def add(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0


# ---------------------------------------------------------------------------
# The card's rates, and the work of a kernel call that runs on meta tensors
# ---------------------------------------------------------------------------

# H100 SXM5 80GB at 700 W, from NVIDIA's datasheet: device memory rate,
# f32 outside the tensor cores, dense bf16 and dense int8 on them
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
# the card's streaming multiprocessors: what the launch plans size their
# grids by when a call runs on meta tensors
H100_SMS = 132


def bound(nbytes: float, ops: float, ops_per_s: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


class WorkTally:
    """The work of the kernel calls made on ``meta`` tensors, by kernel:
    calls, operations and bytes from each kernel module's own formula, and
    ``ops_s``, the operations over the peak rate of their type (seconds).
    A wrapper called on meta tensors makes the card call's allocations,
    launches nothing and adds here instead (the dry-run's count)."""

    def __init__(self):
        self.by_kernel: Dict[str, Dict[str, float]] = {}

    def add(self, name: str, ops: float, nbytes: float,
            ops_per_s: float) -> None:
        w = self.by_kernel.setdefault(name, {"calls": 0, "ops": 0.0,
                                             "bytes": 0.0, "ops_s": 0.0})
        w["calls"] += 1
        w["ops"] += float(ops)
        w["bytes"] += float(nbytes)
        w["ops_s"] += float(ops) / ops_per_s

    def reset(self) -> None:
        self.by_kernel = {}


META_WORK = WorkTally()
_META_ROUTE = [0]


@contextlib.contextmanager
def card_route_on_meta():
    """Inside the context, the dispatchers send ``meta`` tensors where
    they send CUDA tensors, to the ``*_cuda`` wrappers (which then launch
    nothing and count their work); outside it a meta tensor is refused
    as before.  CPU tensors are unaffected either way."""
    _META_ROUTE[0] += 1
    try:
        yield
    finally:
        _META_ROUTE[0] -= 1


def card_route(t) -> bool:
    """Whether a dispatcher sends ``t`` to its kernel's wrapper: a CUDA
    tensor, or a meta tensor inside ``card_route_on_meta``."""
    return t.is_cuda or (t.is_meta and _META_ROUTE[0] > 0)
