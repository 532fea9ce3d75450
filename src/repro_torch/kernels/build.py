"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with `nvcc` into its own shared library with a
plain C interface, `lib<name>.so`, loaded with `ctypes` (no PyTorch headers,
so a build takes seconds). The builds run in parallel, one `nvcc` per source,
at first use. Their output goes to `_build/<hash>/` beside this file, where
the hash covers every file in `csrc/` and the compiler flags, so an edited
source builds anew. `nvcc -Xptxas -v` reports each kernel's registers,
shared memory and spills; the report is kept as `lib<name>.log`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_ROOT = Path(__file__).parent / "_build"
CUDA_NVCC = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's nvcc where none is on PATH
# each kernel (a launch count and a C entry point) -> the source it is built
# from: `local_attention.cu` holds both banded kernels
KERNELS = {"lr_grad": "lr_grad", "lr_hvp": "lr_hvp", "minibatch_grad": "minibatch_grad",
           "infl_scores": "infl_scores", "replay_correction": "replay_correction",
           "flash_attention": "flash_attention", "paged_attention": "paged_attention",
           "local_attention": "local_attention", "block_sparse_attention": "local_attention",
           "chunked_prefill": "chunked_prefill"}
SOURCES = tuple(dict.fromkeys(KERNELS.values()))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict[str, ctypes._CFuncPtr] = {}


def source_hash() -> str:
    """Hash of every file in `csrc/` and of the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    """Directory of this source version's libraries."""
    return BUILD_ROOT / source_hash()


def nvcc() -> str:
    """Path of the CUDA compiler; raises where the toolkit is missing."""
    found = shutil.which("nvcc") or (str(CUDA_NVCC) if CUDA_NVCC.exists() else None)
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return found


def nvcc_command(name: str, out: Path) -> list[str]:
    """The compile line of `csrc/<name>.cu` into the shared library `out`."""
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names=SOURCES) -> dict[str, str]:
    """Build the libraries of `names` that are not built yet, all compilers
    running at once. Returns each library's `-Xptxas -v` report; raises with
    the compiler's output if any build fails."""
    out_dir = build_dir()
    missing = [name for name in names if not (out_dir / f"lib{name}.so").exists()]
    if missing:
        nvcc()  # raises before anything is written where there is no toolkit
        out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in missing:
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(nvcc_command(name, tmp), stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        (out_dir / f"lib{name}.log").write_text(log)
        os.replace(tmp, out_dir / f"lib{name}.so")  # atomic: readers never see half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: (out_dir / f"lib{name}.log").read_text() for name in names}


def entry(kernel: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point `symbol` of kernel `kernel`'s library (built at first
    use), with its argument types declared and an `int` (a cudaError_t)
    result."""
    lib = KERNELS[kernel]
    if symbol not in _ENTRIES:
        if lib not in _LIBS:
            build_all((lib,))
            _LIBS[lib] = ctypes.CDLL(str(build_dir() / f"lib{lib}.so"))
        fn = getattr(_LIBS[lib], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[symbol] = fn
    return _ENTRIES[symbol]


def error_string(kernel: str, err: int) -> str:
    """CUDA's message for the error code `err`, from kernel `kernel`'s library."""
    fn = _LIBS[KERNELS[kernel]].chef_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()
