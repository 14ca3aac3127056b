"""Build, load and launch the CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface and loaded with ``ctypes`` — no PyTorch headers,
so a build takes seconds. Builds run at first use, all sources in
parallel, into ``build/repro_torch/<hash>/`` at the repository root, keyed
by a hash of every source and of the flags: an edit to any ``.cu`` or
``.cuh`` file builds afresh. Strict IEEE float arithmetic is part of the
kernels' contract (bit-exact kNN), hence ``--fmad=false`` and never
``--use_fast_math``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
#: One shared library per ``csrc/<name>.cu``.
KERNELS = ("knn_multi_e", "knn_batch", "lookup_rho", "lookup",
           "pairwise_dist", "topk", "smap_gram", "knn_append",
           "pairwise_mxu", "knn_fused")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_entries: dict = {}  # launch function name → the loaded C function


def nvcc() -> str:
    """Path of the CUDA compiler (``$CUDA_HOME/bin/nvcc`` or on PATH)."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build on a machine with the "
            "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> pathlib.Path:
    return BUILD_ROOT / source_hash()


def build_all() -> dict[str, str]:
    """Compile every kernel that is not built yet; returns {name: ptxas log}.

    All ``nvcc`` processes start together and are waited for; a failed
    compile raises with the compiler's output. A file lock keeps two
    processes from building the same directory at once.
    """
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            procs = {}
            for name in KERNELS:
                if (out / f"lib{name}.so").exists():
                    continue
                tmp = out / f"lib{name}.so.tmp"
                procs[name] = (tmp, subprocess.Popen(
                    [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                     str(CSRC / f"{name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            failed = []
            for name, (tmp, proc) in procs.items():
                log, _ = proc.communicate()
                (out / f"{name}.log").write_text(log)
                if proc.returncode != 0:
                    failed.append(f"--- {name}.cu ---\n{log}")
                else:
                    os.replace(tmp, out / f"lib{name}.so")
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)
    return {name: (out / f"{name}.log").read_text() for name in KERNELS
            if (out / f"{name}.log").exists()}


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: Launch function name → (library, C argument types).
_SIGNATURES = {
    "knn_multi_e_launch": ("knn_multi_e",
                           [_P, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I,
                            _P, _P, _P]),
    "knn_multi_e_select_launch": ("knn_multi_e",
                                  [_P, _I, _I, _I, _I, _I, _P, _P, _I, _I,
                                   _P, _P, _P]),
    "knn_batch_launch": ("knn_batch",
                         [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P]),
    "knn_batch_thread_launch": ("knn_batch",
                                [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                                 _P]),
    "lookup_rho_all_launch": ("lookup_rho",
                              [_P, _I, _I, _I, _P, _LL, _LL, _P, _LL, _LL,
                               _I, _I, _I, _I, _I, _P, _P, _P]),
    "lookup_rho_own_launch": ("lookup_rho",
                              [_P, _LL, _I, _P, _LL, _LL, _P, _LL, _LL, _I,
                               _I, _I, _I, _I, _P, _P, _P]),
    "lookup_launch": ("lookup", [_P, _I, _I, _P, _P, _I, _I, _I, _P, _P]),
    "pairwise_dist_launch": ("pairwise_dist", [_P, _I, _I, _I, _I, _P, _P]),
    "topk_select_launch": ("topk", [_P, _I, _I, _I, _I, _I, _P, _P, _P]),
    "topk_select32_launch": ("topk", [_P, _I, _I, _I, _I, _P, _P, _P]),
    "topk_sizes_launch": ("topk",
                          [_P, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P]),
    "topk_sizes32_launch": ("topk",
                            [_P, _I, _I, _P, _I, _I, _P, _P, _P]),
    "smap_gram_launch": ("smap_gram",
                         [_P, _I, _I, _P, _LL, _I, _P, _I, _I, _I, _I, _I,
                          _P, _I, _I, _P, _P, _P]),
    "knn_append_launch": ("knn_append",
                          [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P,
                           _P, _P]),
    "knn_append_stream_launch": ("knn_append",
                                 [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                                  _P, _P, _P]),
    "pairwise_mxu_launch": ("pairwise_mxu", [_P, _I, _I, _I, _P, _P]),
    "knn_fused_launch": ("knn_fused",
                         [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P]),
    "knn_fused_select_launch": ("knn_fused",
                                [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                 _P, _P, _P]),
}


def entry(fn_name: str):
    """The C launch function ``fn_name`` (its library built on first use)."""
    with _lock:
        fn = _entries.get(fn_name)
        if fn is None:
            lib, argtypes = _SIGNATURES[fn_name]
            path = build_dir() / f"lib{lib}.so"
            if not path.exists():
                build_all()
            fn = getattr(ctypes.CDLL(str(path)), fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _entries[fn_name] = fn
    return fn


#: ``cudaErrorMemoryAllocation``: a kernel's own allocation failed.
CUDA_ERROR_MEMORY_ALLOCATION = 2


def check(err: int, name: str) -> None:
    """Raise if a launch function returned a nonzero ``cudaError_t``: an
    allocation failure as ``torch.cuda.OutOfMemoryError`` (what the
    caching allocator raises, and what the journaled runner's halve-B
    ladder catches), anything else as ``RuntimeError``."""
    if err == CUDA_ERROR_MEMORY_ALLOCATION:
        raise torch.cuda.OutOfMemoryError(
            f"CUDA out of memory. {name} kernel launch failed: "
            f"cudaError_t {err} (cudaErrorMemoryAllocation)")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def launch(device: torch.device, name: str, *args) -> None:
    """Call launch function ``name`` with ``args`` and the current stream
    of ``device`` last; raises if the launch failed. The device is made
    current only when it is not already."""
    fn = entry(name)
    if device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    check(err, name)


def as_contiguous(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as a contiguous ``dtype`` tensor: ``t`` itself when it is one
    already (no copy, no dispatch)."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    return t.to(dtype).contiguous()
