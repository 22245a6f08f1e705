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
