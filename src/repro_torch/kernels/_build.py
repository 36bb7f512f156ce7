"""Builds the CUDA kernels from ``csrc/*.cu`` at first use and loads them.

Each source is compiled by its own ``nvcc`` process (all started together),
the objects are linked into one shared library with a plain C interface,
and the library is loaded with ``ctypes``. Nothing is compiled when this
module is imported: a box without ``nvcc`` can import every module of the
package; only *launching* a kernel needs the toolchain.

The library lands in ``_build/`` beside this file, named after a hash of
the sources' contents and the compiler flags, so an edited source is
rebuilt and an unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# C entry -> argument types (pointers and the stream are c_void_p: without
# argtypes ctypes would cut them to 32 bits)
SIGNATURES = {
    "repro_bsr_spmv_batched": (_P,) * 5 + (_I,) * 6 + (_P,),
    "repro_bsr_spmv": (_P,) * 5 + (_I,) * 5 + (_P,),
    "repro_gamma_pairs": (_P, _P, _P, _P, _L, _I, _F, _I, _P),
    "repro_tsne_force": (_P,) * 5 + (_I,) * 4 + (_P,),
    "repro_block_attention": (_P,) * 8 + (_I,) * 12 + (_P,),
    "repro_key_tile_lists": (_P,) * 3 + (_I,) * 3 + (_P,),
    "repro_key_tile_order": (_P,) * 2 + (_I,) * 2 + (_P,),
    "repro_block_attention_dq": (_P,) * 11 + (_I,) * 12 + (_P,),
    "repro_block_attention_dkv": (_P,) * 13 + (_I,) * 12 + (_P,),
    "repro_decode_attend": (_P,) * 11 + (_I,) * 14 + (_P,),
    "repro_b6_logits_two_ways": (_P,) * 5,
    "repro_cluster_codes": (_P,) * 3 + (_I,) * 2 + (_L,) * 3 + (_I,) * 6
    + (_P,),
    "repro_cluster_layout": (_I,) * 4 + (_P,),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[Path] = None


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            exe = str(cand)
    if exe is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of repro_torch are built from "
            "source at first use and need the CUDA toolkit (looked on PATH "
            "and under $CUDA_HOME or /usr/local/cuda)")
    return exe


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*sources, *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _report_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def _compile(sources, out: Path, verbose: bool) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs = [BUILD_DIR / f"{out.stem}.{src.stem}.o" for src in sources]
    # -Xptxas -v: registers, shared memory and spills of every kernel,
    # kept beside the library (see ptxas_report)
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    for src, p, log in zip(sources, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        if verbose and log.strip():
            print(f"[nvcc {src.name}]\n{log.strip()}", flush=True)
    _report_path(out).write_text("".join(
        f"[nvcc {src.name}]\n{log}" for src, log in zip(sources, logs)))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)          # atomic: a reader never sees half a library
    for obj in objs:
        obj.unlink(missing_ok=True)


def load(verbose: bool = False) -> ctypes.CDLL:
    """The kernels' shared library, built on first call. Raises when there
    is no ``nvcc`` or a source does not compile — callers never fall back."""
    global _lib, _lib_path
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        if not sources:
            raise RuntimeError(f"no CUDA sources under {CSRC}")
        out = BUILD_DIR / f"librepro_torch_kernels_{_digest(sources)}.so"
        if not out.exists():
            _compile(sources, out, verbose)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib, _lib_path = lib, out
        return lib


def ptxas_report() -> str:
    """What ``-Xptxas -v`` printed when the loaded library was built (one
    ``[nvcc <source>]`` section per source); builds it first if needed."""
    load()
    report = _report_path(_lib_path)
    return report.read_text() if report.exists() else ""


def check(code: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


def current_stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream
