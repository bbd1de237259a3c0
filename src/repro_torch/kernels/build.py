"""Build the port's CUDA kernels and bind them with ctypes.

Each source in ``repro_torch/csrc/`` is compiled by ``nvcc`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/repro_torch/lib<name>-<hash>.so <name>.cu

Libraries land in ``build/repro_torch/`` at the repository root, named by
a hash of the source, the shared headers and the flags, so a changed
source rebuilds and an unchanged one is reused.  A library may hold
several entry points (``chunk_attention.cu`` holds chunk attention, chunk
attention with column masses and monolithic flash attention,
``paged_attention.cu`` paged decode and paged decode with row masses).
Nothing here runs at import time: a wrapper asks for its library on its
first launch, and ``build()`` compiles several sources at once, one
``nvcc`` process each.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("chunk_attention", "lookahead_score", "paged_attention",
           "decode_attention", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the extern "C" entry points (all return cudaError_t)
SIGNATURES = {
    "chunk_attention": [_P] * 7 + [_I] * 10 + [_P],
    "chunk_attention_masses": [_P] * 10 + [_I] * 11 + [_P],
    "flash_attention": [_P] * 5 + [_I] * 8 + [_P],
    "lookahead_score": [_P] * 7 + [_I] * 12 + [_P],
    "paged_decode_attention": [_P] * 8 + [_I] * 9 + [_P],
    "paged_decode_masses": [_P] * 9 + [_I] * 9 + [_P],
    "decode_attention": [_P] * 5 + [_I] * 8 + [_P],
    "ssd_scan": [_P] * 11 + [_I] * 11 + [_P],
}
# the entry point a source's library offers by default
_ENTRY = {"chunk_attention": "chunk_attention",
          "lookahead_score": "lookahead_score",
          "paged_attention": "paged_decode_attention",
          "decode_attention": "decode_attention",
          "ssd_scan": "ssd_scan"}

_libs: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    headers = [p.read_bytes() for p in sorted(CSRC.glob("*.cuh"))]
    for part in ((CSRC / f"{name}.cu").read_bytes(), *headers,
                 " ".join(NVCC_FLAGS).encode()):
        h.update(part)
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES, *, verbose: bool = False) -> dict:
    """Compile every source of ``names`` whose library is missing, all
    ``nvcc`` processes at once.  Returns {name: (seconds, nvcc stderr)}
    for the sources it compiled; raises with nvcc's output on failure.
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        stdout, stderr = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n"
                          f"{stdout}{stderr}")
            continue
        tmp.replace(out)  # atomic: a library is complete or absent
        report[name] = (secs, stderr)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def library(name: str, entry: str | None = None):
    """Entry point ``entry`` (default: the source's own) of the library
    built from source ``name``, built and loaded on first use."""
    entry = entry or _ENTRY[name]
    fn = _libs.get((name, entry))
    if fn is None:
        build((name,))
        fn = getattr(ctypes.CDLL(str(_target(name))), entry)
        fn.argtypes = SIGNATURES[entry]
        fn.restype = ctypes.c_int
        _libs[(name, entry)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise when a launch reported a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card ``device`` names, queried once
    per card (the split rules read it on every call)."""
    index = device.index
    return _sm_count(torch.cuda.current_device() if index is None else index)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()
