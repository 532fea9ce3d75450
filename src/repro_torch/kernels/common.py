"""What the four kernel wrappers share: input checks, the launch with its
error check, and the launch counts.

On a CPU tensor a wrapper computes its kernel's plain PyTorch version. On a
CUDA tensor it launches the kernel or raises: there is no fallback from a
kernel to its plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_CLASSES = 16  # csrc/lr_rowcol.cuh: kMaxClasses
COL_THREADS = 256  # csrc/lr_rowcol.cuh: kColThreads, columns per column-pass block
BLOCKS_PER_SM = 4  # column-pass blocks the chunking aims at for each SM

# Launches of each kernel in this process: a wrapper adds one where it
# launches its kernel and nowhere else.
LAUNCHES = {name: 0 for name in build.SOURCES}

PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float


def reset_launches() -> None:
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def chunk_rows(n_rows: int, d: int, n_sms: int) -> tuple[int, int]:
    """(rows per chunk, chunks) of the column pass: chunks enough that its
    grid of (column tiles x chunks) holds about BLOCKS_PER_SM blocks for each
    of the card's `n_sms` SMs. The chunks' partial sums are added in a fixed
    order, so a result depends on the shapes and the SM count only."""
    tiles = -(-d // COL_THREADS)
    want = max(1, -(-BLOCKS_PER_SM * n_sms // tiles))
    rows = -(-n_rows // want)
    return rows, -(-n_rows // rows)


def n_sms(device: torch.device) -> int:
    """Streaming multiprocessors of the card `device`."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(kernel: str, n_classes: int, **tensors) -> torch.device:
    """Raise unless every tensor lies on one CUDA device, is contiguous, has
    the expected shape and dtype (float32, or int64 for `idx`), and the class
    count is one the kernel was built for. `tensors` maps a name to
    `(tensor, shape)`. Returns the device."""
    if not 1 <= n_classes <= MAX_CLASSES:
        raise ValueError(f"{kernel}: {n_classes} classes; the kernel takes 1 to {MAX_CLASSES}")
    device = None
    for name, (t, shape) in tensors.items():
        want = torch.int64 if name == "idx" else torch.float32
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} is on {t.device}, not on a CUDA device")
        if device is not None and t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, the others on {device}")
        device = t.device
        if t.dtype != want or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be a contiguous {want} tensor of shape "
                             f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
        if t.numel() == 0:
            raise ValueError(f"{kernel}: {name} is empty")
    return device


def launch(kernel: str, fn, device: torch.device, *args) -> None:
    """Call the C entry point `fn` on the current stream of `device`, raise
    if it reports an error, and count the launch."""
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err}: {build.error_string(kernel, err)}")
    LAUNCHES[kernel] += 1
