"""What the kernel wrappers share: input checks, the launch with its
error check, and the launch counts.

On a CPU tensor a wrapper computes its kernel's plain PyTorch version. On a
CUDA tensor it launches the kernel or raises: there is no fallback from a
kernel to its plain version.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import build

MAX_CLASSES = 16  # csrc/lr_common.cuh: kMaxClasses
# the many-row kernels (csrc/lr_gather.cuh): lr_grad, minibatch_grad,
# replay_correction, lr_hvp
GATHER_THREADS = 256  # kThreads: threads of a CTA, columns of a few-rows CTA
GATHER_CTAS_PER_SM = 2  # kCtasPerSm: many-rows CTAs an SM holds at once
FEW_MAX_FLOATS = 40960  # kFewMaxFloats: the few-rows kernel's shared memory at most, in floats
FEW_MAX_ROWS = 6  # kFewMaxRows: the few-rows kernel's slots at most (the measured crossover)
GATHER_SCRATCH_FLOATS = 1 << 24  # the many-rows partials [grid, C, D] at most (64 MB)

# Launches of each kernel in this process: a wrapper adds one where it
# launches its kernel and nowhere else, under a lock, so that counts from
# several threads are exact.
LAUNCHES = {name: 0 for name in build.KERNELS}
_COUNT_LOCK = threading.Lock()

PTR = ctypes.c_void_p
INT = ctypes.c_int
INT64 = ctypes.c_longlong
FLOAT = ctypes.c_float
FLOAT_TYPES = (torch.float32, torch.bfloat16)  # what the attention kernels read


def reset_launches() -> None:
    """Set every launch count to 0."""
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(kernel: str) -> None:
    """Add one to `kernel`'s launch count."""
    with _COUNT_LOCK:
        LAUNCHES[kernel] += 1


def check_row_ids(ids: torch.Tensor, n_rows: int, what: str) -> None:
    """Raise unless every id lies in [0, n_rows): the kernels read the rows
    they are given without a bounds check, so callers check a whole schedule
    once, before its loop (the check waits for the device)."""
    if ids.numel() and not (0 <= int(ids.min()) and int(ids.max()) < n_rows):
        raise ValueError(f"{what} indexes outside the {n_rows} rows")


def few_slots(n_classes: int) -> int:
    """Rows the few-rows kernel takes at `n_classes` (csrc/lr_gather.cuh:
    few_slots): a warp holds one lane per row and class, and past
    FEW_MAX_ROWS rows the many-rows grid is faster (at C 2 on the H100:
    chip_smoke.py's regime comparison)."""
    return min(FEW_MAX_ROWS, 32 // n_classes)


def row_pitch(n: int) -> int:
    """Floats a row of n floats takes in the gathered kernels' shared memory
    (csrc/lr_gather.cuh: row_pitch): rounded up to 16 bytes, and 16 bytes
    more for the copy's shift."""
    return (n + 3) // 4 * 4 + 4


def gather_plan(n_rows: int, d: int, n_classes: int, n_sms: int,
                few_ok: bool = True) -> tuple[bool, int]:
    """(few, grid) of a many-row kernel's one launch (csrc/lr_gather.cuh).
    Few rows (at most `few_slots`, their rows and w's at most FEW_MAX_FLOATS
    in shared memory, and `few_ok`: lr_hvp has no few-rows mode): the
    few-rows kernel, one CTA per block of GATHER_THREADS columns, each
    taking every row. Otherwise the many-rows kernel: a cooperative grid of
    at most GATHER_CTAS_PER_SM CTAs for each of the card's `n_sms` SMs and
    one per row, each summing the rows `gather_rows` gives it into its own
    [C, D] partial (at most GATHER_SCRATCH_FLOATS in all). The plan depends
    on the shapes and the SM count only, and so does every sum's order."""
    if (few_ok and n_rows <= few_slots(n_classes)
            and (n_rows + n_classes) * row_pitch(d) <= FEW_MAX_FLOATS):
        return True, -(-d // GATHER_THREADS)
    fit = max(1, GATHER_SCRATCH_FLOATS // (n_classes * d))
    return False, min(n_rows, GATHER_CTAS_PER_SM * n_sms, fit)


def gather_rows(cta: int, grid: int, n_rows: int) -> tuple[int, int]:
    """The contiguous rows [start, stop) many-rows CTA `cta` of `grid` takes."""
    return cta * n_rows // grid, (cta + 1) * n_rows // grid


@functools.cache
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def n_sms(device: torch.device) -> int:
    """Streaming multiprocessors of the card `device` (asked once a card)."""
    return _n_sms(device.index if device.index is not None else torch.cuda.current_device())


def check(kernel: str, n_classes: int, **tensors) -> torch.device:
    """Raise unless every tensor lies on one CUDA device, is contiguous, has
    the expected shape and dtype (int64 for the row ids `idx` and `ci`,
    float32 for the rest), and the class count is one the kernel was built
    for. `tensors` maps a name to `(tensor, shape)`. Returns the device."""
    if not 1 <= n_classes <= MAX_CLASSES:
        raise ValueError(f"{kernel}: {n_classes} classes; the kernel takes 1 to {MAX_CLASSES}")
    device = None
    for name, (t, shape) in tensors.items():
        dev = t.device  # read once: every attribute read costs host time
        if dev.type != "cuda":
            raise ValueError(f"{kernel}: {name} is on {dev}, not on a CUDA device")
        if device is None:
            device = dev
        elif dev != device:
            raise ValueError(f"{kernel}: {name} is on {dev}, the others on {device}")
        want = torch.int64 if name in ("idx", "ci") else torch.float32
        if t.dtype != want or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be a contiguous {want} tensor of shape "
                             f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
        if 0 in shape:
            raise ValueError(f"{kernel}: {name} is empty")
    return device


def check_attention(kernel: str, **tensors) -> torch.device:
    """The attention kernels' input check: raise unless every tensor lies on
    one CUDA device, is non-empty, has the expected shape and a last stride
    of 1 (and is contiguous where asked), the "float" ones share one of
    `FLOAT_TYPES` and the others have their own dtype. `tensors` maps a name
    to `(tensor, shape, kind, contiguous)` with kind "float", "int32" or a
    torch dtype. Returns the device. (It reads as few tensor attributes as
    it can: each read costs host time on every call.)"""
    first, index, ftype = None, None, None
    for name, (t, shape, kind, contiguous) in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{kernel}: {name} is on {t.device}, not on a CUDA device")
        if first is None:
            first, index = t, t.get_device()
        elif t.get_device() != index:
            raise ValueError(f"{kernel}: {name} is on {t.device}, the others on {first.device}")
        dtype = t.dtype
        if kind == "float":
            ok = dtype in FLOAT_TYPES and dtype == (ftype or dtype)
            ftype = ftype or dtype
        else:
            ok = dtype == (torch.int32 if kind == "int32" else kind)
        laid_out = t.is_contiguous() if contiguous else t.stride(-1) == 1
        if not ok or t.shape != shape or not laid_out:
            want = (f"float32 or bfloat16 (as the others, {ftype})" if kind == "float"
                    else str(kind))
            raise ValueError(f"{kernel}: {name} must be a {want} tensor of shape {tuple(shape)}"
                             f"{' (contiguous)' if contiguous else ' with a last stride of 1'}, "
                             f"got {dtype} {tuple(t.shape)} strides {t.stride()}")
        if 0 in shape:
            raise ValueError(f"{kernel}: {name} is empty")
    return first.device


def launch(kernel: str, fn, device: torch.device, *args) -> None:
    """Call the C entry point `fn` on the current stream of `device`, raise
    if it reports an error, and count the launch. The stream's handle comes
    from PyTorch's raw accessor (the one Triton launches with), which builds
    no Stream object."""
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err}: {build.error_string(kernel, err)}")
    count_launch(kernel)
