#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one H100: the CHEF
cleaning loop (blocking and pipelined, with a served model as annotator, as
jobs of the cleaning service, and over a stream of windows), the paged
serving path, the
sliding-window serving path, the ring serving path and the int8 page pools.

    python3 chip_smoke.py

1. Builds the twelve CUDA kernels from `src/repro_torch/kernels/csrc` (one
   nvcc per source, all ten sources at once) and prints nvcc's
   `-Xptxas -v` report; counts the HMMA TF32 instructions in the SASS of
   each kernel that runs the flash tile program (`cuobjdump -sass`) and
   fails where one has none.
2. For each CHEF kernel, at the main path's shapes (the mimic widths of the
   paper's Table 3; replay_correction at r = 1, 3 and 64 changed slots, a
   third of them padded; lr_hvp also at 3 and 16 classes and at 200 rows,
   fewer than its grid): makes inputs on the card from a fixed seed,
   launches the kernel, holds it against its plain PyTorch version
   (max|kernel - plain| <= 1e-4 * max|plain| + 1e-6), checks that it repeats
   bit for bit, and times both with CUDA events; for the three kernels of
   csrc/lr_gather.cuh also the host's cost of a call (200 calls back to
   back, no synchronise inside), their launch plan (regime, grid) and,
   as a yardstick, the time of one torch.sum over the same bytes laid out
   contiguously; and replay_correction at r = 1 to 10 slots in each regime
   the launch takes there (few_rows up to its slot limit, many_rows at
   every r), each held and timed as above: where the regime switch lies.
2b. lr_grad at the six validation sets' shapes of Table 3 (twitter, fact:
   D 769; fashion, chexpert, mimic, retina: D 2049) and at mimic's with 16
   classes: held and repeated as above, one launch a call, timed beside
   its plain version, its bound and one torch.sum over the same rows (also
   after a clean L2 flush), with its host cost a call; and on grids forced
   to CTAs of at least 4, 8 and 16 rows beside its own.
3. The same for the two attention kernels at OLMo-1B's full attention
   shapes (16 heads of 128): flash_attention at a 256-token prefill, a tail
   prefill (32 rows over 256 keys), GQA + window + softcap and bf16 (bf16
   outputs: 2^-7 * max|plain|); paged_attention at batch 4 over 32 table
   pages of 8 with a parked slot, and at G = 4 with a window. The flash
   cases also time one F.scaled_dot_product_attention call (float32, the
   same boolean mask) as the library yardstick. Each paged case (here and
   in 3b, 3c, float32 and int8) also reports its host cost a call, its
   launch plan, as a yardstick one torch.sum over its live K/V bytes laid
   out contiguously, the kernel and the yardstick after a clean L2 flush
   (read, not written), and the time of the merge that follows it
   (ops.paged_decode_finish).
3b. The same for the sliding-window kernels at StarCoder2-3B's attention
   shapes (24 query heads over 2 kv heads of 128, window 4096):
   local_attention at an 8192-token prefill and a tail, chunked_prefill's
   partials there with chunk 2048, block_sparse_attention at 2048 tokens
   with a seeded random mask, paged_attention at StarCoder2's decode shape;
   then, bit for bit, local == flash, chunked + merge == flash,
   block-sparse with an all-ones mask == flash and with the band's mask ==
   local.
3c. The same for the ring and int8 kernels: decode_attention at
   RecurrentGemma-9B's decode shape (16 query heads over 1 kv head of 256,
   a wrapped ring of 2048) and at OLMo-1B's ring shape (plain, softcap,
   bf16), beside one SDPA call, each with its host cost, its launch plan
   (chunk, split, grid) and one torch.sum of the ring's K and V bytes; the
   int8 paged partials at OLMo-1B's and
   StarCoder2-3B's decode shapes; local_attention at RecurrentGemma-9B's
   3000-token prefill (D 256), beside SDPA and bit for bit flash.
4. Serving: OLMo-1B at full width (float32, random weights from SEED) in
   ServeEngine(batch_size=4, max_len=256) at its defaults, prefix sharing
   on, serves 8 requests (prompt buckets 32-256, four sharing a 64-token
   prefix, 16 new tokens each) on backend `cuda` (launch counts set to 0
   just before, read just after) and on `reference`: same tokens (or a
   top-2 tie within 2e-3), logits within 1e-3 * (1 + |ref|), a joined
   request rerun solo gives the same tokens, and exactly 16 flash launches
   per prefill and 16 paged launches per decode round. Then the same 8
   requests with Model.kv_dtype = torch.int8 (int8 page pools, prefix
   sharing off) on `cuda` and `reference`: the same tokens, logits within one
   int8 step, 1/127 * (1 + |ref|), the pools' codes at most one step apart,
   0 prefix hits,
   16 int8-partials launches per decode round, the pools' bytes beside the
   float32 pools', and the share of tokens equal to the float32 run.
4b. The block-sparse entry point, Backend.block_sparse_attention, with four
   block masks at StarCoder2's head shapes on `cuda` (launch counts set to
   0 just before, read just after) and on `reference`.
4c. Serving StarCoder2-3B at full width and 15 of its 30 layers (float32,
   random weights from SEED, 6.4 GB) in ServeEngine(batch_size=2, page_size=8): two prompts past the
   4096 window (bucket 8192) and two of about 300 sharing a 128-token
   prefix, 32 new tokens each, on `cuda` unchunked, on `cuda` with
   prefill_chunk 2048 and on `reference`: the same tokens (or a top-2
   tie), logits within 1e-3 * (1 + |ref|), the same counters, and the
   launches, decode rounds and retired pages predicted before the runs;
   then the unchunked run under torch.profiler.
4d. Serving RecurrentGemma-9B at full width and 20 of its 38 layers
   (float32, random weights from SEED, made on the card once StarCoder2-3B's
   are freed) in
   ServeEngine(batch_size=2, max_len=4096) at cache "auto", which must
   resolve to the ring: a wave of prompts of 2,600 and 3,000 tokens (past
   the 2048 window: the ring roll runs and the ring wraps) and a prompt of
   400 that joins the first slot when it frees, on `cuda` and `reference`:
   the same tokens (or a top-2 tie), logits within 1e-3 * (1 + |ref|), the
   same prefill widths and finish order, and the local_attention and
   decode_attention launches predicted before the runs; then the `cuda`
   run under torch.profiler.
5. Then `sgd_train` and `deltagrad_replay` on the kernels repeat bit for
   bit, and the CHEF main path, `run_chef(method="infl",
   selector="increm")` on a mimic-shaped dataset made on the card, 2 rounds
   of 10 labels, Table 4's lr, l2 and epochs: first with constructor
   "retrain", then with the default, DeltaGrad-L. Each runs on backend
   `cuda` (launch counts set to 0 just before, read just after) and on
   backend `reference`. Both backends must select the same rows each round,
   or differ only at a priority tie, and end within 0.005 F1. The
   DeltaGrad-L run on `cuda` must launch minibatch_grad and
   replay_correction exactly as often as its schedule predicts.
6. Checkpoint: a DeltaGrad-L session on `cuda` runs 2 rounds, saving after
   each; a fresh session restored from round 1 runs round 2 again and must
   end bit for bit where the uninterrupted one did.
7. Trace: the first 600 steps of a DeltaGrad-L replay on `cuda`, timed on
   the host (three times with Python's garbage collector on, three times
   with it off, in turns), run under sync-debug mode, and profiled (device busy time,
   idle share, device kernels a step, blocking runtime calls, the costliest
   host ops and device kernels).
7b. Pipelined: the DeltaGrad-L run of 5 again through
   make_scheduler(pipelined=True) with a 0.5 s annotator latency: the same
   rows, labels and w bit for bit, a speculation every round, the card's
   peak memory; then retrain under strategies 'two' and 'three' with a 2 s
   latency, 3 rounds blocking and 3 pipelined, each round timed on the host
   clock around step(): bit for bit alike, every round a hit under 'two' and
   the pipelined mean round below the blocking one there.
7c. ModelAnnotator: OLMo-1B at full width (random weights from SEED) in
   ServeEngine(batch_size=4, max_len=1024, trace_logits=True) on `cuda`
   annotates 2 rounds of 10 rows of Table 3's fact dataset (prompts of 776
   tokens) through a blocking RoundScheduler on cleaning backends `cuda`
   (launch counts set to 0 just before, read just after: 16 flash launches a
   request, no paged) and `reference`: the same rows and labels; an engine on
   `reference` gives the same labels or parts at a top-2 tie.
7d. CleaningService: two workers, two jobs of 2 rounds on Table 3's twitter
   dataset, one cancelled after its first round and resumed from its
   checkpoint: every result equal to a direct scheduler run bit for bit, no
   job failed.
7e. Stream: the warm StreamingCleaningSession at mimic's widths (4 windows
   of 19,622 rows, capacity 78,488, Table 4's lr, l2 and epochs, batch 2000,
   a round of 10 labels after each window to a budget of 40) on `cuda`
   (launch counts set to 0 just before, read just after: every CHEF kernel
   must launch): each window's ingest seconds, r_max and launches (the first
   trains over the capacity, the others absorb by a DeltaGrad-L replay),
   each round's t_select, t_update and candidates, no padding row ever
   selected; then a cold rebuild (CleaningSession.initialize) on each
   window's grown rows, and replay_correction at the last absorb's widest
   step, held and timed as in 2. At twitter's widths (4 windows of 2,902 x
   768): the warm stream on `cuda` and `reference` selects the same rows
   each round (or parts at a priority tie) and ends within 0.005 F1; a cold
   stream with every window in before its first round equals a batch
   session on the same rows bit for bit (labels, weights, w, F1 each
   round, 2 rounds); weights trained over the capacity are equal bit for
   bit with two kinds of finite garbage in the weight-0 tail rows.
8. Prints the kernels line (launches from the DeltaGrad-L run on `cuda`,
   for flash and paged attention from the OLMo-1B run on `cuda`, for the
   int8 partials from its int8 run, for block-sparse attention from phase
   4b, for local attention from the unchunked and for chunked prefill from
   the chunked StarCoder2 run, for decode attention from the
   RecurrentGemma-9B run), the card's name and power limit, and last
   `{"ok": true, "device": {...}}`.

Any failure exits non-zero. Needs a CUDA device; imports nothing of JAX or of
the JAX package.

A second mode, on one card, measures the redesigned kernel (lr_grad)
against the parent commit:

    python3 chip_smoke.py --compare PARENT   # PARENT: a checkout of the parent commit

It runs both trees' lr_grad at the Table 3 validation shapes in fresh
processes in turns, with each call's device time and host enqueue time and
the host cost a call (the mean of 200 calls, and the least of 10 batches
of 20), and prints each tree's lr_grad digests.
"""
from __future__ import annotations

import gc
import json
import re
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# the flash tile program's float32 products: split TF32 on the tensor cores,
# three TF32 products (495 TFLOP/s dense) a float32 product
TF32X3_OPS_PER_S = 495e12 / 3
TOL_REL, TOL_ABS = 1e-4, 1e-6  # kernel vs plain: max|diff| <= TOL_REL * max|plain| + TOL_ABS
TIE_REL = 1e-3  # a row only one run selected must lie this close to a run's b-th priority
F1_TOL = 0.005  # final test F1, cuda run vs reference run
N, D, C, BS, N_VAL = 78_487, 2049, 2, 2000, 579  # mimic: Table 3 sizes, D = 2048 + 1
SEED = 0
CSRC = "src/repro_torch/kernels/csrc"
# cleaning rounds of the main path (cut from 3 to keep the script's time;
# the DeltaGrad-L rounds run twice, blocking and pipelined), labels a round
ROUNDS, B = 2, 10
CORR_R = (1, 3, 64)  # changed slots of a replay step in the kernel phase
LINE_R = 3  # the r reported in the kernels line: a mimic replay step changes 1-3 rows
TRACE_STEPS = 600  # replay steps the trace phase profiles (69 explicit: 10 of burn-in, every 10th)
HOST_CALLS = 200  # back-to-back calls of the host-cost figure
REGIME_R = range(1, 11)  # replay_correction slots at which the kernel phase times both regimes
TRACE_UNTRACED = 3  # untraced replays of the trace phase with the collector on, and as many off
GATHERED = ("minibatch_grad", "replay_correction")  # the gathered kernels of csrc/lr_gather.cuh
# lr_hvp in the kernel phase: name, rows, classes (mimic; 3 and 16 classes,
# whose columns of w, v and the partial do not fit a thread's registers at
# D 2049; fewer rows than the many-rows grid)
HVP_CASES = (("lr_hvp", N, C), ("lr_hvp/C=3", N, 3), ("lr_hvp/C=16", N, 16),
             ("lr_hvp/N=200", 200, C))
COMPARE_PROCS = 3  # fresh processes a side in the comparison mode, in turns
# lr_grad's phase: the validation sets of Table 3 (name, rows, D, C), and
# mimic's with 16 classes (past a thread's register blocks: rows_wide)
LR_GRAD_VAL = (("twitter", 37, 769, 2), ("fashion", 146, 2049, 2), ("chexpert", 234, 2049, 2),
               ("fact", 255, 769, 2), ("mimic", N_VAL, D, C), ("retina", 3512, D, 2),
               ("mimic/C=16", N_VAL, D, 16))
LR_GRAD_MIN_ROWS = (1, 4, 8, 16)  # the many-rows grids lr_grad's phase compares
REPLACES = {
    "lr_grad": "src/repro/kernels/lr_grad.py:36",
    "lr_hvp": "src/repro/kernels/lr_hvp.py:39",
    "minibatch_grad": "src/repro/kernels/minibatch_grad.py:51",
    "infl_scores": "src/repro/kernels/infl_scores.py:37",
    "replay_correction": "src/repro/kernels/replay_correction.py:47",
    "flash_attention": "src/repro/kernels/flash_attention.py:94",
    "paged_attention": "src/repro/kernels/paged_attention.py:157",
    "local_attention": "src/repro/kernels/local_attention.py:190",
    "block_sparse_attention": "src/repro/kernels/local_attention.py:212",
    "chunked_prefill": "src/repro/kernels/chunked_prefill.py:131",
    "decode_attention": "src/repro/kernels/decode_attention.py:67",
    "paged_attention_quant": "src/repro/kernels/paged_attention.py:247",
}
CHEF_KERNELS = ("lr_grad", "lr_hvp", "minibatch_grad", "infl_scores", "replay_correction")
# the libraries and kernels that run the flash tile program (csrc/attn_common.cuh)
TILE_LIBS = ("flash_attention", "local_attention", "chunked_prefill")
TILE_KERNELS = ("flash_kernel", "banded_kernel", "chunk_kernel")
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
BF16_TOL_REL = 2.0**-7  # bf16 outputs: each side rounds once, so they may sit one bf16 step apart
# the serving path: OLMo-1B at full width, random weights from SEED
SERVE_LENGTHS = (70, 20, 140, 100, 45, 200, 90, 180)  # prompt buckets 32 to 256
SERVE_SHARED = (0, 2, 3, 5)  # these requests share a 64-token prefix (2 per block class)
SERVE_PREFIX, SERVE_MAX_NEW, SERVE_BATCH, SERVE_MAX_LEN = 64, 16, 4, 256
SERVE_JOINED = 5  # a request admitted mid-stream (a prefix hit), rerun solo
LOGIT_TOL = 1e-3  # cuda vs reference logits: |a - b| <= LOGIT_TOL * (1 + |b|)
TIE_MARGIN = 2 * LOGIT_TOL  # tokens may part only where the top-2 logits lie this close
# int8 K/V pools: float noise between the backends' attention kernels moves a
# K/V value across a rounding boundary now and then, and that code then
# differs by one step of its page's scale (max|x| / 127, 0.8% of the row's
# largest value), which the later layers carry on: logits are held to one
# such step, LOGIT_TOL_INT8 * (1 + |b|), and the pools' codes to at most one
# step apart (repro's own int8 differential oracle,
# tests/test_serving.py::test_serve_engine_int8_paged_matches_ring_oracle,
# allows 1e-1)
LOGIT_TOL_INT8 = 1.0 / 127
# the sliding-window path: StarCoder2-3B at full width (window 4096), random
# weights from SEED; two long prompts past the window (bucket 8192) and two
# short ones sharing a page-aligned prefix, 32 new tokens each
SC_LENGTHS = (5000, 6000, 300, 310)
SC_SHARED = (2, 3)  # these share SC_PREFIX tokens: the second admitted is a prefix hit
SC_PREFIX, SC_MAX_NEW, SC_BATCH, SC_PAGE = 128, 32, 2, 8
SC_CHUNK = 2048  # the chunked run's prefill_chunk
SC_LAYERS = 15  # of StarCoder2-3B's 30: depth cut to keep the script's time (widths whole)
SC_SEQ = 8192  # the kernel phase's prefill width: the long prompts' bucket
BLOCK_SPARSE_CALLS = 4  # Backend.block_sparse_attention calls of the block-sparse phase
# the ring path: RecurrentGemma-9B at full width (window 2048), random weights
# from SEED; a wave of two prompts past the window, then a third request that
# joins the first one's slot when it finishes
RG_LENGTHS = (2600, 3000, 400)
RG_MAX_NEW = (16, 48, 24)
RG_BATCH, RG_MAX_LEN = 2, 4096
RG_WINDOW = 2048  # the ring of a local layer (configs/recurrentgemma_9b.py)
# of RecurrentGemma-9B's 38 layers (12 super-blocks of RG-LRU, RG-LRU, local
# and 2 RG-LRU at the tail): 6 super-blocks and the tail, depth cut to keep
# the script's time (widths whole)
RG_LAYERS = 20
RG_DECODE_POS = 3030  # the kernel phase's decode position: the ring wrapped
# the pipelined loop: DeltaGrad-L's annotator latency, then retrain's latency
# and rounds under strategies 'two' and 'three'
PIPE_DG_LATENCY, PIPE_LATENCY, PIPE_ROUNDS = 0.5, 2.0, 3
ANN_ROUNDS, ANN_MAX_LEN = 2, 1024  # the model annotator's rounds and its engine's max_len
SERVICE_ROUNDS = 2  # rounds of each job of the service phase
# the stream phase: 4 windows at mimic's Table 3 widths (capacity 78,488, one
# row more than mimic's 78,487) and at twitter's (capacity 11,608), a round
# of b = B labels after each window, to a budget of 40
STREAM_WINDOWS, STREAM_ROWS, STREAM_TW_ROWS, STREAM_BUDGET = 4, 19_622, 2_902, 40
STREAM_BATCH_BUDGET = 20  # the cold stream against the batch session: 2 rounds


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def call_times(torch, fn, reps: int = 20, clean: bool = False) -> tuple[list, list]:
    """Device time of each of `reps` calls of fn() in ms, by CUDA events,
    and the host's time to enqueue each (the two events and the call). Before
    each call L2 (50 MB) is flushed, as the loop finds its inputs there: by
    writing 128 MB, which leaves up to 50 MB of dirty lines in L2, each
    written back when the call's own reads or writes take its place; or,
    with `clean`, by reading them, which leaves clean lines. The stream is
    held by a sleep (about 1 ms) so that the host's launch time is not
    counted unless enqueueing outlasts the sleep."""
    flush = torch.empty(32 * 2**20, device="cuda")
    sink = torch.empty((), device="cuda")
    wipe = (lambda: torch.sum(flush, 0, out=sink)) if clean else flush.zero_
    for _ in range(3):
        fn()
    device, host = [], []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        wipe()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        host.append((time.perf_counter() - t0) * 1e3)
        b.synchronize()
        device.append(a.elapsed_time(b))
    return device, host


def time_ms(torch, fn, reps: int = 20, clean: bool = False) -> float:
    """Mean device time of fn() in ms (call_times)."""
    return sum(call_times(torch, fn, reps, clean)[0]) / reps


def host_us(torch, fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds a call of fn() costs: `calls` calls back to back
    with no synchronise inside, by the host clock, over `calls` (the device
    runs behind; it is drained before and after)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def host_us_min(torch, fn, batches: int = 10) -> float:
    """The least of `batches` host_us figures of HOST_CALLS / batches calls
    each: a host cost less shaken by the other work on the host's cores."""
    return min(host_us(torch, fn, HOST_CALLS // batches) for _ in range(batches))


def bound(bytes_moved: float, ops: float,
          ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """Least time in ms: bytes over the memory rate or operations over the
    peak rate of their type (float32 unless given), whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _template_args(targs: str) -> list[str]:
    """Readable template arguments from a mangled list such as
    `ILi128EfLb1E` or `I13__nv_bfloat16aE`: ints, f32, bf16, int8, mask=0/1
    (a substitution repeats the type before it)."""
    out, i = [], 1
    while i < len(targs):
        if targs.startswith("Li", i):
            j = targs.index("E", i)
            out.append(targs[i + 2:j])
            i = j + 1
        elif targs.startswith("Lb", i):
            out.append(f"mask={targs[i + 2]}")
            i += 4
        elif targs[i] in "fa":
            out.append("f32" if targs[i] == "f" else "int8")
            i += 1
        elif targs[i] == "S":  # a substitution: a type named before (the last one, here)
            out.append(out[-1] if out else "?")
            i = targs.index("_", i) + 1
        elif targs[i].isdigit():
            n = re.match(r"\d+", targs[i:]).group()
            name = targs[i + len(n):i + len(n) + int(n)]
            out.append("bf16" if "bfloat16" in name else name)
            i += len(n) + int(n)
        else:
            i += 1
    return out


def _kernel_name(mangled: str) -> str | None:
    """`flash_kernel<128,f32>` from `_ZN4chef12flash_kernelILi128EfEEv...`,
    `gather::many_rows<2,0>` from `_ZN4chef6gather9many_rowsILi2ELi0EEEv...`."""
    start = mangled.find("_ZN4chef")
    if start < 0:
        return None
    rest, names = mangled[start + len("_ZN4chef"):], []
    while rest[:1].isdigit():
        n = re.match(r"\d+", rest).group()
        names.append(rest[len(n):len(n) + int(n)])
        rest = rest[len(n) + int(n):]
    args = _template_args(rest.split("EEv")[0]) if rest.startswith("I") else []
    return "::".join(names) + (f"<{','.join(args)}>" if args else "")


def ptxas_report(log: str) -> list[str]:
    """One line per compiled function from nvcc's -Xptxas -v output:
    registers, shared memory and spills."""
    lines, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = f"spill stores {m.group(1)} B, spill loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$", line)
        if m and name:
            lines.append(f"{name}: {m.group(1)} registers, {m.group(2) or 0} B smem, {spills}")
            name = None
    return lines


def build_phase() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build_all()
    seconds = time.perf_counter() - t0
    for lib, log in logs.items():
        report = ptxas_report(log)
        if not report:
            fail(f"no -Xptxas -v report for {lib}")
        print(f"--- nvcc -Xptxas -v, lib{lib}.so:", *report, sep="\n  ", flush=True)
    emit({"phase": "build", "kernels": sorted(logs), "dir": str(build.build_dir()),
          "seconds": seconds})


def sass_phase() -> None:
    """Count the TF32 tensor-core instructions (HMMA ... TF32) in the SASS
    of each kernel that runs the flash tile program, from `cuobjdump -sass`
    on the built libraries; fails where a tile kernel has none."""
    from repro_torch.kernels import build

    tool = Path(build.nvcc()).parent / "cuobjdump"
    counts, other = {}, set()
    for lib in TILE_LIBS:
        sass = subprocess.run([str(tool), "-sass", str(build.build_dir() / f"lib{lib}.so")],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        name = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = _kernel_name(m.group(1))
                if name and any(name.startswith(k) for k in TILE_KERNELS):
                    counts[name] = 0
                continue
            if name in counts and "HMMA" in line:
                if re.search(r"HMMA\.\S*TF32", line):
                    counts[name] += 1
                else:
                    other.add(re.search(r"HMMA\S*", line).group())
    emit({"phase": "sass", "what": "HMMA TF32 instructions in each tile kernel's SASS",
          "hmma_tf32": counts, "other_hmma": sorted(other)})
    if not counts or not all(counts.values()):
        fail(f"a flash tile kernel has no HMMA TF32 instruction: {counts}")


def kernel_phase(torch, card_line: str) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.kernels import (LAUNCHES, common, infl_scores, lr_grad, lr_hvp,
                                     minibatch_grad, replay_correction)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    ones = lambda n: torch.ones(n, 1, device=dev)  # noqa: E731
    Xa = torch.cat([torch.randn(N, D - 1, generator=g, device=dev), ones(N)], dim=1)
    Xa_val = torch.cat([torch.randn(N_VAL, D - 1, generator=g, device=dev), ones(N_VAL)], dim=1)
    Y_val = torch.nn.functional.one_hot(
        torch.randint(0, C, (N_VAL,), generator=g, device=dev), C).float()
    w = 0.01 * torch.randn(C, D, generator=g, device=dev)
    v = 0.01 * torch.randn(C, D, generator=g, device=dev)
    Y = torch.softmax(torch.randn(N, C, generator=g, device=dev), dim=-1)
    gw = 0.8 + 0.2 * torch.rand(N, generator=g, device=dev)
    P = torch.softmax(Xa @ w.T, dim=-1)
    # distinct batches, so that timing the step does not find its rows in L2
    idxs = [torch.randperm(N, generator=g, device=dev)[:BS] for _ in range(8)]
    batch = [0]

    def next_idx():
        batch[0] += 1
        return idxs[batch[0] % len(idxs)]

    ones_val = torch.ones(N_VAL, device=dev)
    f = 4.0  # bytes per float32
    # a replay step's correction: r slots, the last third padded (ci = 0,
    # cm = 0); Y_new / gw_new are the labels and weights after cleaning
    Y_new = torch.nn.functional.one_hot(torch.randint(0, C, (N,), generator=g, device=dev),
                                        C).float()
    gw_new = torch.ones(N, device=dev)
    corr = {}
    for r in CORR_R:
        real = r - r // 3
        ci = torch.zeros(r, dtype=torch.int64, device=dev)
        ci[:real] = torch.randperm(N, generator=g, device=dev)[:real]
        cm = torch.zeros(r, device=dev)
        cm[:real] = 1.0
        corr[r] = (ci, cm, real)
    cases = {
        # name: (kernel, plain, shape, bytes it must move, operations)
        "lr_grad": (lambda: lr_grad.lr_grad(w, Xa_val, Y_val, ones_val, 0.0),
                    lambda: lr_grad.lr_grad_plain(w, Xa_val, Y_val, ones_val, 0.0),
                    [N_VAL, D, C], f * (N_VAL * D + N_VAL * C + N_VAL + 2 * C * D),
                    4.0 * N_VAL * C * D),
        "minibatch_grad": (lambda: minibatch_grad.minibatch_grad(w, Xa, Y, gw, next_idx(), 0.05),
                           lambda: minibatch_grad.minibatch_grad_plain(w, Xa, Y, gw, next_idx(),
                                                                       0.05),
                           [N, D, C, BS], f * (BS * D + BS * C + BS + 2 * C * D) + 8.0 * BS,
                           4.0 * BS * C * D),
        "infl_scores": (lambda: infl_scores.infl_scores(v, Xa, P, Y, 0.8),
                        lambda: infl_scores.infl_scores_plain(v, Xa, P, Y, 0.8),
                        [N, D, C], f * (N * D + 3 * N * C + C * D), 2.0 * N * C * D + 6.0 * N * C),
    }
    for name, n, c in HVP_CASES:
        wc = w if c == C else 0.01 * torch.randn(c, D, generator=g, device=dev)
        vc = v if c == C else 0.01 * torch.randn(c, D, generator=g, device=dev)
        args = (wc, vc, Xa[:n], gw[:n], 0.05)
        # bytes: the rows, their weights, w and v in, the result out
        cases[name] = (lambda args=args: lr_hvp.lr_hvp(*args),
                       lambda args=args: lr_hvp.lr_hvp_plain(*args),
                       [n, D, c], f * (n * D + n + 3 * c * D), 6.0 * n * c * D)
    for r, (ci, cm, real) in corr.items():
        args = (w, Xa, Y, Y_new, gw, gw_new, ci, cm, BS)
        cases[f"replay_correction/r={r}"] = (
            lambda args=args: replay_correction.replay_correction(*args),
            lambda args=args: replay_correction.replay_correction_plain(*args),
            # bytes: the real rows once, their labels and weights, every
            # slot's id and mask, w in, the result out; the padded slots add
            # nothing, so their rows are not counted
            [N, D, C, r, real], f * (real * D + 2 * real * C + 2 * real + 2 * C * D)
            + 12.0 * r, 4.0 * real * C * D)
    results = {}
    for name, (kern, plain, shape, nbytes, ops) in cases.items():
        batch[0] = 0  # kernel and plain version see the same batch
        out = kern()
        torch.cuda.synchronize()
        batch[0] = 0
        ref = plain()
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        limit = TOL_REL * float(ref.abs().max()) + TOL_ABS
        if not (bool(torch.isfinite(out).all()) and err <= limit):
            fail(f"{name}: max|kernel - plain| = {err} > {limit} at {shape}")
        batch[0] = 0
        again = kern()
        if not torch.equal(out, again):
            fail(f"{name}: two launches on the same inputs differ")
        ms = time_ms(torch, kern)
        plain_ms = time_ms(torch, plain)
        bound_ms, bound_by = bound(nbytes, ops)
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=None)
        extra = {}
        if name.startswith("lr_hvp"):
            # a yardstick: one torch.sum over the same rows (contiguous already)
            flat, sink = Xa[:shape[0]].view(-1), torch.empty((), device=dev)
            _, grid = common.gather_plan(*shape, common.n_sms(dev), few_ok=False)
            extra = {"host_us_per_call": host_us(torch, kern),
                     "plan": {"grid": grid, "rows_per_cta": shape[0] / grid},
                     "contiguous_read_ms": time_ms(torch, lambda: torch.sum(flat, 0, out=sink))}
        if name.split("/")[0] in GATHERED:
            few, grid = common.gather_plan(shape[3], D, C, common.n_sms(dev))  # bs or r rows
            # a yardstick: one torch.sum over the bytes of the rows read (bs, or
            # the real slots), contiguous, timed the same way
            flat, sink = torch.randn(shape[-1] * D, device=dev), torch.empty((), device=dev)
            extra = {"host_us_per_call": host_us(torch, kern),
                     "plan": {"regime": "few_rows" if few else "many_rows", "grid": grid},
                     "contiguous_read_ms": time_ms(torch, lambda: torch.sum(flat, 0, out=sink))}
        emit({"phase": "kernel", "name": name, "shape": shape, "max_abs_err": err,
              "tolerance": f"max|kernel-plain| <= {TOL_REL}*max|plain| + {TOL_ABS} = {limit}",
              "bitwise_repeat": True, "kernel_ms": ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, **extra,
              "card": card_line, "launches": dict(LAUNCHES)})
    results["replay_correction"] = results[f"replay_correction/r={LINE_R}"]
    # replay_correction in each regime its launch takes at r slots (the last
    # third padded): the plan forced, held and timed as above
    plan, nb = common.gather_plan, -(-D // common.GATHER_THREADS)
    try:
        for r in REGIME_R:
            real = r - r // 3
            ci = torch.zeros(r, dtype=torch.int64, device=dev)
            ci[:real] = torch.randperm(N, generator=g, device=dev)[:real]
            cm = torch.zeros(r, device=dev)
            cm[:real] = 1.0
            args = (w, Xa, Y, Y_new, gw, gw_new, ci, cm, BS)
            ref = replay_correction.replay_correction_plain(*args)
            limit = TOL_REL * float(ref.abs().max()) + TOL_ABS
            chosen = plan(r, D, C, common.n_sms(dev))
            forced = [(False, min(r, common.GATHER_CTAS_PER_SM * common.n_sms(dev)))]
            if r <= common.few_slots(C):
                forced.insert(0, (True, nb))
            for few, grid in forced:
                common.gather_plan = lambda *_, few=few, grid=grid: (few, grid)
                kern = lambda args=args: replay_correction.replay_correction(*args)  # noqa: E731
                out = kern()
                err = float((out - ref).abs().max())
                if not (bool(torch.isfinite(out).all()) and err <= limit
                        and torch.equal(out, kern())):
                    fail(f"replay_correction at r = {r} in the forced plan {(few, grid)}: "
                         f"max|kernel - plain| = {err} (limit {limit}) or no bitwise repeat")
                emit({"phase": "regime", "name": "replay_correction", "r": r, "real": real,
                      "regime": "few_rows" if few else "many_rows", "grid": grid,
                      "chosen": (few, grid) == chosen, "max_abs_err": err,
                      "kernel_ms": time_ms(torch, kern), "card": card_line})
    finally:
        common.gather_plan = plan
    return results


def lr_grad_phase(torch, card_line: str) -> None:
    """lr_grad at the validation shapes of the paper's Table 3 (LR_GRAD_VAL)
    and at mimic's with 16 classes, as the path calls it (one-hot labels,
    weights 1, l2 0): held against its plain version, repeated bit for bit,
    one launch a call; timed beside the plain version, one torch.sum over
    the same rows (contiguous, as a yardstick) and its bound, with the host's
    cost a call and the plan, and the kernel and the torch.sum after a clean
    L2 flush (read, not written). Then the many-rows grid forced to CTAs of
    at least m rows for each m of LR_GRAD_MIN_ROWS (m = 1: gather_plan's
    grid, at most two CTAs an SM and one a row, the grid lr_grad takes),
    each held and timed: fewer CTAs write fewer partials but chain more
    rows."""
    from repro_torch.kernels import LAUNCHES, common, lr_grad

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    sink = torch.empty((), device=dev)
    for name, n, d, c in LR_GRAD_VAL:
        Xa = torch.cat([torch.randn(n, d - 1, generator=g, device=dev),
                        torch.ones(n, 1, device=dev)], dim=1)
        Y = torch.nn.functional.one_hot(torch.randint(0, c, (n,), generator=g, device=dev),
                                        c).float()
        w = 0.01 * torch.randn(c, d, generator=g, device=dev)
        gw = torch.ones(n, device=dev)
        kern = lambda a=(w, Xa, Y, gw, 0.0): lr_grad.lr_grad(*a)  # noqa: E731
        ref = lr_grad.lr_grad_plain(w, Xa, Y, gw, 0.0)
        limit = TOL_REL * float(ref.abs().max()) + TOL_ABS
        before = LAUNCHES["lr_grad"]
        out = kern()
        launches = LAUNCHES["lr_grad"] - before
        err = float((out - ref).abs().max())
        if not (bool(torch.isfinite(out).all()) and err <= limit and torch.equal(out, kern())
                and launches == 1):
            fail(f"lr_grad {name}: max|kernel - plain| = {err} (limit {limit}), a bitwise "
                 f"repeat or {launches} launches a call, not 1")
        flat = Xa.view(-1)
        f = 4.0
        bound_ms, bound_by = bound(f * (n * d + n * c + n + 2 * c * d), 4.0 * n * c * d)
        few, grid = common.gather_plan(n, d, c, common.n_sms(dev))
        sum_flat = lambda: torch.sum(flat, 0, out=sink)  # noqa: E731
        emit({"phase": "lr_grad", "name": name, "shape": [n, d, c], "max_abs_err": err,
              "tolerance": limit, "bitwise_repeat": True, "launches_per_call": launches,
              "kernel_ms": time_ms(torch, kern), "plain_ms": time_ms(
                  torch, lambda a=(w, Xa, Y, gw, 0.0): lr_grad.lr_grad_plain(*a)),
              "contiguous_sum_ms": time_ms(torch, sum_flat),
              "kernel_ms_clean_l2": time_ms(torch, kern, clean=True),
              "contiguous_sum_ms_clean_l2": time_ms(torch, sum_flat, clean=True),
              "bound_ms": bound_ms, "bound_by": bound_by,
              "host_us_per_call": host_us(torch, kern), "host_us_per_call_min":
              host_us_min(torch, kern), "plan": {"few": few, "grid": grid},
              "card": card_line})
        plan = common.gather_plan
        try:
            for m in LR_GRAD_MIN_ROWS:
                forced = min(grid, max(1, n // m))
                common.gather_plan = lambda *_, k=forced: (False, k)
                out = kern()
                err = float((out - ref).abs().max())
                if not (err <= limit and torch.equal(out, kern())):
                    fail(f"lr_grad {name} on a grid of {forced}: max|kernel - plain| = {err} "
                         f"(limit {limit}) or no bitwise repeat")
                emit({"phase": "lr_grad_plan", "name": name, "min_rows": m, "grid": forced,
                      "partial_mb": forced * c * d * 4 / 1e6, "chosen": forced == grid,
                      "max_abs_err": err, "kernel_ms": time_ms(torch, kern),
                      "card": card_line})
        finally:
            common.gather_plan = plan


def determinism_phase(torch) -> None:
    """sgd_train on the kernels, twice from the same start, then
    deltagrad_replay of its trajectory, twice: each pair equal bit for
    bit."""
    from repro_torch.core import deltagrad, lr_head
    from repro_torch.core.backend import Backend

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    Xa = lr_head.augment(torch.randn(N, D - 1, generator=g, device=dev))
    Y = torch.softmax(torch.randn(N, C, generator=g, device=dev), dim=-1)
    gw = torch.full((N,), 0.8, device=dev)
    sched = lr_head.batch_schedule(SEED, N, BS, 2).to(dev)
    runs = [lr_head.sgd_train(torch.zeros(C, D, device=dev), Xa, Y, gw, sched, l2=0.05,
                              lr=0.0005, backend=Backend("cuda")) for _ in range(2)]
    (w1, (ws1, gs1)), (w2, (ws2, gs2)) = runs
    if not (torch.equal(w1, w2) and torch.equal(ws1, ws2) and torch.equal(gs1, gs2)):
        fail("sgd_train on the cuda backend does not repeat bit for bit")
    # clean 3 rows of every batch of the first epoch: each step corrects
    changed = sched[: sched.shape[0] // 2, :3].reshape(-1)
    Y_new = Y.clone()
    Y_new[changed] = torch.nn.functional.one_hot(changed % C, C).float()
    gw_new = gw.clone()
    gw_new[changed] = 1.0
    ci, cm = deltagrad.build_correction_schedule(sched.cpu().numpy(), changed.cpu().numpy())
    replays = [deltagrad.deltagrad_replay(ws1, gs1, sched, Xa, Y, Y_new, gw, gw_new, ci, cm,
                                          deltagrad.DGConfig(lr=0.0005, l2=0.05), BS,
                                          backend=Backend("cuda")) for _ in range(2)]
    (r1, (rws1, rgs1)), (r2, (rws2, rgs2)) = replays
    if not (torch.equal(r1, r2) and torch.equal(rws1, rws2) and torch.equal(rgs1, rgs2)):
        fail("deltagrad_replay on the cuda backend does not repeat bit for bit")
    emit({"phase": "determinism", "sgd_steps": int(sched.shape[0]), "replay_steps":
          int(sched.shape[0]), "replay_r_max": int(ci.shape[1]), "bitwise_equal": True})


def dataset_phase(torch):
    """The mimic-shaped dataset on the card and the main path's config."""
    from repro_torch.configs import ChefConfig, paper_dataset_specs
    from repro_torch.data import make_paper_dataset

    spec = paper_dataset_specs()["mimic"]
    t0 = time.perf_counter()
    ds = make_paper_dataset("mimic")
    torch.cuda.synchronize()
    emit({"phase": "dataset", "name": "mimic", "n_train": ds.n, "n_val": ds.X_val.shape[0],
          "n_test": ds.X_test.shape[0], "feature_dim": ds.X.shape[1],
          "seconds": time.perf_counter() - t0})
    cfg = ChefConfig(n_classes=spec.n_classes, feature_dim=spec.feature_dim, lr=spec.lr,
                     l2=spec.l2, n_epochs=spec.n_epochs, batch_size=BS, budget=ROUNDS * B,
                     round_size=B, strategy="three", backend="cuda")
    return ds, cfg


def predicted_launches(ds, cfg) -> dict:
    """minibatch_grad and replay_correction launches of a DeltaGrad-L run:
    the initial training takes T steps; each round's replay corrects all T
    steps and recomputes the batch gradient at the explicit ones (the first
    burn_in steps and every period-th after)."""
    T = max(ds.n // cfg.batch_size, 1) * cfg.n_epochs
    explicit = sum(1 for t in range(T) if t < cfg.dg_burn_in
                   or (t - cfg.dg_burn_in) % cfg.dg_period == 0)
    return {"minibatch_grad": T + ROUNDS * explicit, "replay_correction": ROUNDS * T}


def loop_phase(torch, card_line: str, ds, cfg, constructor: str) -> tuple:
    """run_chef(method="infl", selector="increm", constructor) on the mimic
    shape, backend cuda then reference. Returns the cuda run's launches and
    its result."""
    from repro_torch.cleaning import phases
    from repro_torch.core import run_chef
    from repro_torch.kernels import LAUNCHES, reset_launches

    # each round's selection, read off the selector as it returns it
    selections: list = []
    select = phases.InflSelector.select

    def recording_select(self, session, eligible, generator):
        sel = select(self, session, eligible, generator)
        selections.append(sel)
        return sel

    phases.InflSelector.select = recording_select
    runs = {}
    for name in ("cuda", "reference"):
        selections.clear()
        if name == "cuda":
            reset_launches()
        t0 = time.perf_counter()
        res = run_chef(ds, replace(cfg, backend=name), method="infl", selector="increm",
                       constructor=constructor)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        runs[name] = (res, list(selections), launches)
        for r in res.history:
            emit({"phase": "round", "constructor": constructor, "backend": name,
                  "round": r.round, "n_cleaned": r.n_cleaned_total,
                  "n_candidates": r.n_candidates, "f1_val": r.f1_val, "f1_test": r.f1_test,
                  "t_select_s": r.t_select, "t_update_s": r.t_update, "card": card_line})
        emit({"phase": "run_chef", "constructor": constructor, "backend": name,
              "rounds": len(res.history), "wall_s": wall, "f1_test_final": res.f1_test_final,
              "f1_val_final": res.f1_val_final,
              "launches": launches if name == "cuda" else None, "card": card_line})
    phases.InflSelector.select = select

    res_c, sel_c, launches = runs["cuda"]
    res_r, sel_r, _ = runs["reference"]
    for name, res in runs.items():
        if len(res[0].history) != ROUNDS or not bool(torch.isfinite(res[0].w).all()):
            fail(f"{constructor} {name} run: {len(res[0].history)} rounds, finite w: "
                 f"{bool(torch.isfinite(res[0].w).all())}")
        if res[0].w.shape != (C, D) or int(res[0].dataset.cleaned.sum()) != ROUNDS * B:
            fail(f"{constructor} {name} run: w {tuple(res[0].w.shape)}, "
                 f"{int(res[0].dataset.cleaned.sum())} cleaned")
    path = [k for k in CHEF_KERNELS if k != "replay_correction" or constructor == "deltagrad"]
    missing = [k for k in path if launches[k] == 0]
    if missing:
        fail(f"the {constructor} cuda run launched no {missing}")
    if constructor == "deltagrad":
        want = predicted_launches(ds, cfg)
        got = {k: launches[k] for k in want}
        emit({"phase": "launch_prediction", "constructor": constructor, "predicted": want,
              "launched": got})
        if got != want:
            fail(f"the deltagrad cuda run launched {got}, its schedule predicts {want}")
    compared = 0
    for k, (a, b) in enumerate(zip(sel_c, sel_r)):
        ia, ib = set(a.idx.tolist()), set(b.idx.tolist())
        if ia != ib:
            ties = all(any(_near_bth(s, j) for s in (a, b)) for j in ia ^ ib)
            emit({"phase": "compare", "constructor": constructor, "round": k,
                  "same_selection": False, "only_cuda": sorted(ia - ib),
                  "only_reference": sorted(ib - ia), "priority_tie": ties,
                  "tie_tolerance": TIE_REL})
            if not ties:
                fail(f"{constructor} round {k}: the runs select different rows and it is no "
                     "priority tie")
            break  # the runs' label states part here
        compared += 1
    df1 = abs(res_c.f1_test_final - res_r.f1_test_final)
    emit({"phase": "compare", "constructor": constructor, "rounds_same_selection": compared,
          "n_candidates_cuda": [r.n_candidates for r in res_c.history],
          "n_candidates_reference": [r.n_candidates for r in res_r.history],
          "f1_test_cuda": res_c.f1_test_final, "f1_test_reference": res_r.f1_test_final,
          "f1_diff": df1, "f1_tol": F1_TOL})
    if df1 > F1_TOL:
        fail(f"{constructor}: final test F1 differs by {df1} > {F1_TOL}")
    return launches, res_c


def checkpoint_phase(torch, ds, cfg) -> None:
    """A DeltaGrad-L session on the kernels runs 2 rounds, checkpointing
    after each; a fresh session restored from round 1 runs round 2 and must
    end bit for bit where the uninterrupted one did."""
    from repro_torch.cleaning import CleaningSession, make_scheduler

    with tempfile.TemporaryDirectory(prefix="chef_ckpt_") as ckpt_dir:
        full = make_scheduler(CleaningSession.initialize(ds, cfg), ckpt_dir=ckpt_dir)
        res_full = full.run(max_rounds=2)
        t0 = time.perf_counter()
        session = CleaningSession.restore(ckpt_dir, ds, cfg, step=1)
        t_restore = time.perf_counter() - t0
        res = make_scheduler(session).run(max_rounds=1)
        torch.cuda.synchronize()
        ckpt_bytes = sum(f.stat().st_size for f in Path(ckpt_dir).rglob("*") if f.is_file())
    same = {
        "rows": torch.equal(res.dataset.cleaned, res_full.dataset.cleaned),
        "labels": torch.equal(res.dataset.y_prob, res_full.dataset.y_prob),
        "w": torch.equal(res.w, res_full.w),
        "trajectory": all(map(torch.equal, session.traj, full.session.traj)),
        "f1": [r.f1_test for r in res.history] == [r.f1_test for r in res_full.history],
    }
    emit({"phase": "checkpoint", "rounds": len(res.history), "restored_round": 1,
          "restore_s": t_restore, "checkpoint_bytes": ckpt_bytes, "bitwise_equal": same})
    if len(res.history) != 2 or not all(same.values()):
        fail(f"the restored session does not repeat the uninterrupted one: {same}")


def _timed_run(torch, sched) -> tuple:
    """Run a scheduler to its end, one step at a time, with the host clock
    around each step (synchronized): (result, wall seconds of each round)."""
    walls = []
    while not sched.exhausted:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched.step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return sched.result(), walls


def _same_result(torch, a, b) -> dict:
    """Which parts of two ChefResults are equal bit for bit."""
    return {"rows": torch.equal(a.dataset.cleaned, b.dataset.cleaned),
            "labels": torch.equal(a.dataset.y_prob, b.dataset.y_prob),
            "w": torch.equal(a.w, b.w),
            "f1": [r.f1_val for r in a.history] == [r.f1_val for r in b.history]}


def pipelined_phase(torch, card_line: str, ds, cfg, blocking) -> None:
    """The pipelined loop on the kernels. DeltaGrad-L as loop_phase runs it
    on `cuda` (`blocking` is that run's result), pipelined with an annotator
    latency of PIPE_DG_LATENCY s: the same rows, labels and w bit for bit,
    a speculation every round, and the card's peak memory. Then retrain
    under strategies 'two' and 'three' with a latency of PIPE_LATENCY s,
    blocking and pipelined, PIPE_ROUNDS rounds each, each round's wall time
    on the host clock around step(): pipelined equals blocking bit for bit;
    under 'two' every round hits and the pipelined mean round is shorter
    than the blocking one ('three' may miss, and is reported)."""
    from repro_torch.cleaning import CleaningSession, make_scheduler

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sched = make_scheduler(CleaningSession.initialize(
        ds, replace(cfg, annotator_latency_s=PIPE_DG_LATENCY)), pipelined=True)
    res, walls = _timed_run(torch, sched)
    peak = torch.cuda.max_memory_allocated()
    same = _same_result(torch, res, blocking)
    emit({"phase": "pipelined", "constructor": "deltagrad", "latency_s": PIPE_DG_LATENCY,
          "rounds": len(res.history), "round_wall_s": walls,
          "t_update_s": [r.t_update for r in res.history],
          "t_select_s": [r.t_select for r in res.history], "spec_hits": sched.spec_hits,
          "spec_misses": sched.spec_misses, "bitwise_equal_blocking": same,
          "memory_before_bytes": base, "peak_memory_bytes": peak, "card": card_line})
    if not all(same.values()) or sched.spec_hits + sched.spec_misses != ROUNDS:
        fail(f"pipelined deltagrad: equal to the blocking run {same}, speculations "
             f"{sched.spec_hits} + {sched.spec_misses}, not {ROUNDS}")
    for strategy in ("two", "three"):
        c = replace(cfg, budget=PIPE_ROUNDS * B, strategy=strategy,
                    annotator_latency_s=PIPE_LATENCY)
        runs = {}
        for pipelined in (False, True):
            sched = make_scheduler(CleaningSession.initialize(ds, c), constructor="retrain",
                                   pipelined=pipelined)
            res, walls = _timed_run(torch, sched)
            runs[pipelined] = (res, walls, sched)
            emit({"phase": "pipelined", "constructor": "retrain", "strategy": strategy,
                  "pipelined": pipelined, "latency_s": PIPE_LATENCY,
                  "rounds": len(res.history), "round_wall_s": walls,
                  "mean_round_s": sum(walls) / len(walls),
                  "t_update_s": [r.t_update for r in res.history],
                  "t_select_s": [r.t_select for r in res.history],
                  "spec_hits": sched.spec_hits, "spec_misses": sched.spec_misses,
                  "card": card_line})
        (res_b, walls_b, _), (res_p, walls_p, sched_p) = runs[False], runs[True]
        same = _same_result(torch, res_p, res_b)
        faster = sum(walls_p) < sum(walls_b)
        emit({"phase": "pipelined_compare", "strategy": strategy, "bitwise_equal": same,
              "mean_round_s_blocking": sum(walls_b) / len(walls_b),
              "mean_round_s_pipelined": sum(walls_p) / len(walls_p),
              "pipelined_faster": faster})
        if len(res_p.history) != PIPE_ROUNDS or not all(same.values()):
            fail(f"pipelined retrain under {strategy}: {len(res_p.history)} rounds, equal to "
                 f"the blocking run {same}")
        if strategy == "two" and (sched_p.spec_hits != PIPE_ROUNDS or not faster):
            fail(f"pipelined retrain under 'two': {sched_p.spec_hits} hits of {PIPE_ROUNDS}, "
                 f"rounds {walls_p} against blocking {walls_b}")


def annotator_phase(torch, card_line: str) -> dict:
    """ModelAnnotator with OLMo-1B at full width (random weights from SEED):
    one ServeEngine(batch_size=4, max_len=1024, trace_logits=True) on `cuda`
    annotates ANN_ROUNDS rounds of B rows of Table 3's fact dataset (768
    features: prompts of 776 tokens) through a blocking RoundScheduler
    (INFL, Increm-INFL, retrain) with cleaning backend `cuda` (launch counts
    set to 0 just before, read just after) and then `reference`: the same
    rows and labels each round, and one flash_attention launch a layer and
    request, no paged_attention. Then an engine on `reference` under the
    `cuda` cleaning backend: the same labels, or a parting at a top-2 tie
    within TIE_MARGIN (after which the runs part). Returns the launches of
    the first run."""
    import numpy as np

    from repro_torch.cleaning import CleaningSession, RoundScheduler
    from repro_torch.cleaning.phases import make_constructor, make_selector
    from repro_torch.configs import ChefConfig, get_config, paper_dataset_specs
    from repro_torch.data import make_paper_dataset
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import Model
    from repro_torch.serving import ServeConfig, ServeEngine
    from repro_torch.stream import ModelAnnotator

    dev = torch.device("cuda")
    mcfg = get_config("olmo-1b")
    model = Model(mcfg, device=dev)
    params = model.init(SEED)
    spec = paper_dataset_specs()["fact"]
    ds = make_paper_dataset("fact")
    cfg = ChefConfig(n_classes=spec.n_classes, feature_dim=spec.feature_dim, lr=spec.lr,
                     l2=spec.l2, n_epochs=spec.n_epochs, batch_size=BS,
                     budget=ANN_ROUNDS * B, round_size=B, backend="cuda")

    def engine(backend):
        return ServeEngine(model, params, backend=backend, device=dev,
                           config=ServeConfig(batch_size=4, max_len=ANN_MAX_LEN,
                                              trace_logits=True))

    def clean(eng, backend):
        """(per round: {row: label}, per round: {row: first C logits}, wall s)."""
        annotator = ModelAnnotator(eng)
        labels, logits = [], []
        annotate = annotator.annotate

        def recording(session, selection, generator):
            run = eng.run
            served = []
            eng.run = lambda reqs: served.extend(run(reqs)) or served
            task = annotate(session, selection, generator)
            eng.run = run
            rows = selection.idx.tolist()
            labels.append(dict(zip(rows, task.result().tolist())))
            logits.append(dict(zip(rows, (r.logits[0][:spec.n_classes] for r in
                                          sorted(served, key=lambda r: r.uid)))))
            return task

        annotator.annotate = recording
        session = CleaningSession.initialize(ds, replace(cfg, backend=backend))
        sched = RoundScheduler(session, make_selector("infl", "increm"), annotator,
                               make_constructor("retrain"))
        t0 = time.perf_counter()
        res = sched.run()
        torch.cuda.synchronize()
        if len(res.history) != ANN_ROUNDS:
            fail(f"model annotator ({backend}): {len(res.history)} rounds")
        return labels, logits, time.perf_counter() - t0, dict(eng.stats)

    eng = engine("cuda")  # the kernels are loaded: the serving phases ran them
    reset_launches()
    labels_c, logits_c, wall_c, stats = clean(eng, "cuda")
    launches = dict(LAUNCHES)
    labels_r, _, wall_r, _ = clean(eng, "reference")
    requests = ANN_ROUNDS * B
    want = {"flash_attention": mcfg.n_layers * requests, "paged_attention": 0}
    got = {k: launches[k] for k in want}
    emit({"phase": "model_annotator", "arch": mcfg.name, "dataset": "fact",
          "prompt_tokens": 8 + spec.feature_dim, "rounds": ANN_ROUNDS, "requests": requests,
          "wall_s_cuda": wall_c, "wall_s_reference": wall_r, "engine_stats": stats,
          "launches": launches, "predicted": want, "same_labels": labels_c == labels_r,
          "card": card_line})
    if labels_c != labels_r:
        fail(f"model annotator: cleaning backends cuda and reference labelled "
             f"{labels_c} and {labels_r}")
    if got != want:
        fail(f"model annotator: launched {got}, one prefill a request predicts {want}")
    labels_e, logits_e, _, _ = clean(engine("reference"), "cuda")
    parted = None
    for k, (a, b) in enumerate(zip(labels_c, labels_e)):
        if a == b:
            continue
        for row in a.keys() & b.keys():
            if a[row] != b[row]:
                top2 = np.sort(logits_e[k][row])[-2:]
                if float(top2[1] - top2[0]) > TIE_MARGIN:
                    fail(f"model annotator: engines cuda and reference part at round {k} "
                         f"row {row}, no top-2 tie ({top2})")
        parted = k
        break
    compared = len(labels_c) if parted is None else parted  # rounds on the same rows
    emit({"phase": "model_annotator_engines", "same_labels": parted is None,
          "parted_at_round": parted, "tie_margin": TIE_MARGIN,
          "max_label_logit_diff": max((float(np.abs(logits_c[k][row] - logits_e[k][row]).max())
                                       for k in range(compared) for row in logits_c[k]),
                                      default=0.0), "card": card_line})
    return launches


def service_phase(torch, card_line: str) -> None:
    """CleaningService with two workers on the card over Table 3's twitter
    dataset, two jobs of SERVICE_ROUNDS rounds: Increm-INFL with DeltaGrad-L
    (checkpointed) and full INFL with retrain. The first is cancelled after
    its first committed round (its worker held at that round's end until
    the cancel is in), ends cancelled, and is submitted again with
    resume=True. Each result must equal a direct make_scheduler(...).run()
    bit for bit, and no job may end failed."""
    import threading

    from repro_torch.cleaning import CleaningService, make_scheduler, prepare_session
    from repro_torch.cleaning import scheduler as scheduler_mod
    from repro_torch.configs import ChefConfig, paper_dataset_specs
    from repro_torch.core.backend import Backend
    from repro_torch.data import make_paper_dataset

    spec = paper_dataset_specs()["twitter"]
    ds = make_paper_dataset("twitter")
    cfg = ChefConfig(n_classes=spec.n_classes, feature_dim=spec.feature_dim, lr=spec.lr,
                     l2=spec.l2, n_epochs=spec.n_epochs, batch_size=BS,
                     budget=SERVICE_ROUNDS * B, round_size=B, backend="cuda")
    jobs = {"dg": ("increm", "deltagrad"), "retrain": ("full", "retrain")}
    direct = {}
    for name, (selector, constructor) in jobs.items():
        session = prepare_session(ds, cfg, backend=Backend("cuda"), selector=selector,
                                  constructor=constructor)
        direct[name] = make_scheduler(session, selector=selector,
                                      constructor=constructor).run()
    step, held, release = scheduler_mod.RoundScheduler.step, threading.Event(), threading.Event()

    def holding_step(self):
        record = step(self)
        if self.ckpt is not None and self.session.round == 1 and not held.is_set():
            held.set()  # the checkpointed job's first round is committed...
            release.wait(600)  # ...and its worker waits here for the cancel
        return record

    scheduler_mod.RoundScheduler.step = holding_step
    t0 = time.perf_counter()
    svc = CleaningService(workers=2)
    try:
        with tempfile.TemporaryDirectory(prefix="chef_service_") as ckpt_dir:
            ids = {name: svc.submit(ds, cfg, selector=sel, constructor=con,
                                    ckpt_dir=ckpt_dir if name == "dg" else None)
                   for name, (sel, con) in jobs.items()}
            if not held.wait(600):
                fail("service: the checkpointed job committed no round")
            cancelled = svc.cancel(ids["dg"])
            release.set()
            svc.join()
            info = svc.poll(ids["dg"])
            ids["dg_resumed"] = svc.submit(ds, cfg, selector="increm", constructor="deltagrad",
                                           ckpt_dir=ckpt_dir, resume=True)
            results = {name: svc.result(ids[name], timeout=600)
                       for name in ("retrain", "dg_resumed")}
    finally:
        scheduler_mod.RoundScheduler.step = step
        svc.shutdown()
    wall = time.perf_counter() - t0
    states = {i.job_id: i.state for i in svc.jobs()}
    same = {"retrain": _same_result(torch, results["retrain"], direct["retrain"]),
            "dg_resumed": _same_result(torch, results["dg_resumed"], direct["dg"])}
    emit({"phase": "service", "dataset": "twitter", "workers": 2, "jobs": states,
          "cancelled": cancelled, "cancelled_after_rounds": info.rounds_done,
          "bitwise_equal_direct": same, "wall_s": wall, "card": card_line})
    if "failed" in states.values():
        fail(f"service: a job failed: {[i for i in svc.jobs() if i.state == 'failed']}")
    if not (cancelled and info.state == "cancelled" and info.rounds_done == 1):
        fail(f"service: the cancelled job ended {info}")
    if not all(all(v.values()) for v in same.values()):
        fail(f"service: results differ from the direct runs: {same}")


def _stream_source(torch, name: str, rows: int):
    """A SyntheticStream of STREAM_WINDOWS windows of `rows` rows at the
    widths of Table 3's `name` (features, validation and test rows, classes)
    and its ChefConfig (Table 4's lr, l2 and epochs; batch BS; b = B)."""
    from repro_torch.configs import ChefConfig, paper_dataset_specs
    from repro_torch.stream import SyntheticStream

    spec = paper_dataset_specs()[name]
    src = SyntheticStream(torch.Generator("cuda").manual_seed(SEED), window_size=rows,
                          n_windows=STREAM_WINDOWS, n_val=spec.n_val, n_test=spec.n_test,
                          feature_dim=spec.feature_dim, n_classes=spec.n_classes)
    cfg = ChefConfig(n_classes=spec.n_classes, feature_dim=spec.feature_dim, lr=spec.lr,
                     l2=spec.l2, n_epochs=spec.n_epochs, batch_size=BS, budget=STREAM_BUDGET,
                     round_size=B, strategy="three", backend="cuda")
    return src, cfg


def stream_phase(torch, card_line: str) -> None:
    """Streaming CHEF on the kernels. (1) The warm stream at mimic's widths
    (STREAM_WINDOWS windows of STREAM_ROWS rows), a round after each window,
    launch counts set to 0 just before and read just after: each window's
    absorb (seconds, r_max, launches) beside a cold rebuild on the same grown
    rows, each round's t_select, t_update and candidates, no padding row
    ever selected, every CHEF kernel launched; replay_correction timed at the
    absorb's widest step. (2) At twitter's widths: the warm stream on `cuda`
    and `reference` selects the same rows each round (or parts at a priority
    tie) and ends within F1_TOL; a cold stream with every window in before
    the first round equals a batch session on the same rows bit for bit;
    weights trained over the capacity do not move by a bit whatever finite
    garbage the weight-0 tail rows hold."""
    from repro_torch.cleaning import CleaningSession, make_scheduler
    from repro_torch.core import deltagrad
    from repro_torch.core.backend import Backend
    from repro_torch.core.pipeline import train_head
    from repro_torch.kernels import LAUNCHES, replay_correction, reset_launches
    from repro_torch.stream import StreamingCleaningSession, WindowStore
    from repro_torch.stream import session as stream_session

    def sync_time(fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def recording(s, log):
        """Record each selection of stream `s` with the fill level it saw and
        whether any padding row was eligible."""
        select = s._selector.select

        class Recording:
            def select(self, sess, eligible, generator):
                sel = select(sess, eligible, generator)
                log.append((sel, s.store.n, bool(eligible[s.store.n:].any())))
                return sel

        s._selector = Recording()

    # (1) the warm stream at mimic's widths
    src, cfg = _stream_source(torch, "mimic", STREAM_ROWS)
    torch.cuda.synchronize()
    absorbs, plans = [], []
    absorb, plan = stream_session.absorb_rows, deltagrad.build_correction_schedule

    def recording_plan(sched, changed):
        ci, cm = plan(sched, changed)
        plans.append(cm.sum(axis=1))
        return ci, cm

    def recording_absorb(*a, **kw):
        absorbs[:] = [a]  # the last absorb's inputs
        return absorb(*a, **kw)

    deltagrad.build_correction_schedule = recording_plan
    stream_session.absorb_rows = recording_absorb
    selections: list = []
    try:
        reset_launches()
        t_run = time.perf_counter()
        s = StreamingCleaningSession(src, cfg)
        recording(s, selections)
        while True:
            before = dict(LAUNCHES)
            m, ingest_s = sync_time(s.ingest)
            if not m:
                break
            launched = {k: LAUNCHES[k] - before[k] for k in CHEF_KERNELS}
            steps = plans[-1] if s.windows_ingested > 1 else None
            emit({"phase": "stream_window", "widths": "mimic", "window": s.windows_ingested,
                  "rows": s.store.n, "capacity": s.store.capacity,
                  "mode": "absorb" if steps is not None else "initialize", "ingest_s": ingest_s,
                  "steps": int(s.session.sched.shape[0]),
                  "r_max": int(steps.max()) if steps is not None else None,
                  "mean_real_slots": float(steps.mean()) if steps is not None else None,
                  "launches": launched, "card": card_line})
            for r in s.clean(1):
                emit({"phase": "stream_round", "widths": "mimic", "round": r.round,
                      "window": s.windows_ingested, "n_cleaned": r.n_cleaned_total,
                      "n_candidates": r.n_candidates, "f1_val": r.f1_val, "f1_test": r.f1_test,
                      "t_select_s": r.t_select, "t_update_s": r.t_update, "card": card_line})
        extra = s.clean(None)
        res = s.result()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        launches = dict(LAUNCHES)
    finally:
        deltagrad.build_correction_schedule = plan
        stream_session.absorb_rows = absorb
    emit({"phase": "stream", "widths": "mimic", "windows": s.windows_ingested,
          "rounds": len(res.history), "rounds_after_stream": len(extra), "wall_s": wall,
          "f1_test_final": res.f1_test_final, "launches": launches, "card": card_line})
    padding = [(int(sel.idx.max()), n, pad) for sel, n, pad in selections
               if int(sel.idx.max()) >= n or pad]
    if padding or len(res.history) != STREAM_BUDGET // B:
        fail(f"warm stream: {len(res.history)} rounds, padding rows eligible or selected "
             f"(top row, fill level, any padding eligible): {padding}")
    if not bool(torch.isfinite(res.w).all()) or res.w.shape != (C, D):
        fail(f"warm stream: w {tuple(res.w.shape)}, finite {bool(torch.isfinite(res.w).all())}")
    missing = [k for k in CHEF_KERNELS if launches[k] == 0]
    if missing:
        fail(f"the warm stream launched no {missing}")
    # the cold path's rebuild on each window's grown rows, for comparison
    for k in range(1, STREAM_WINDOWS + 1):
        cold, cold_s = sync_time(CleaningSession.initialize, src.batch_dataset(k), cfg)
        emit({"phase": "stream_cold_rebuild", "widths": "mimic", "window": k,
              "rows": k * STREAM_ROWS, "sgd_steps": int(cold.sched.shape[0]),
              "seconds": cold_s, "card": card_line})
        del cold
    # replay_correction at the widest step of the last absorb (r_max slots)
    traj, sched, Xa, Y_old, Y_new, w_old, w_new, idx = absorbs[-1][:8]
    ci, cm = plan(sched.cpu().numpy(), idx.cpu().numpy())
    t = int(cm.sum(axis=1).argmax())
    r, real = int(ci.shape[1]), int(cm[t].sum())
    args = (traj[0][t], Xa, Y_old, Y_new, w_old, w_new,
            torch.as_tensor(ci[t], dtype=torch.int64, device="cuda"),
            torch.as_tensor(cm[t], device="cuda"), BS)
    del absorbs[:], s
    kern = lambda: replay_correction.replay_correction(*args)  # noqa: E731
    plain = lambda: replay_correction.replay_correction_plain(*args)  # noqa: E731
    out, ref = kern(), plain()
    err = float((out - ref).abs().max())
    limit = TOL_REL * float(ref.abs().max()) + TOL_ABS
    if not (bool(torch.isfinite(out).all()) and err <= limit and torch.equal(out, kern())):
        fail(f"replay_correction at the absorb's r = {r}: max|kernel - plain| = {err} > "
             f"{limit} or no bitwise repeat")
    f = 4.0
    bound_ms, bound_by = bound(f * (real * D + 2 * real * C + 2 * real + 2 * C * D) + 12.0 * r,
                               4.0 * real * C * D)
    emit({"phase": "kernel", "name": f"replay_correction/absorb r={r}",
          "shape": [int(Xa.shape[0]), D, C, r, real],
          "max_abs_err": err, "kernel_ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
          "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "card": card_line})
    del args, traj, Xa, out, ref
    torch.cuda.empty_cache()

    # (2) twitter's widths: cuda against reference, cold against batch, the tail
    src, cfg = _stream_source(torch, "twitter", STREAM_TW_ROWS)
    runs = {}
    for name in ("cuda", "reference"):
        s = StreamingCleaningSession(src, replace(cfg, backend=name))
        log: list = []
        recording(s, log)
        res, wall = sync_time(s.run)
        runs[name] = (res, [sel for sel, _, _ in log])
        emit({"phase": "stream", "widths": "twitter", "backend": name, "rounds": len(res.history),
              "wall_s": wall, "t_update_s": [r.t_update for r in res.history],
              "n_candidates": [r.n_candidates for r in res.history],
              "f1_test_final": res.f1_test_final, "card": card_line})
    (res_c, sel_c), (res_r, sel_r) = runs["cuda"], runs["reference"]
    compared = 0
    for k, (a, b) in enumerate(zip(sel_c, sel_r)):
        ia, ib = set(a.idx.tolist()), set(b.idx.tolist())
        if ia != ib:
            ties = all(any(_near_bth(x, j) for x in (a, b)) for j in ia ^ ib)
            if not ties:
                fail(f"warm stream round {k}: cuda and reference select different rows and it "
                     "is no priority tie")
            break  # the runs' label states part here
        compared += 1
    df1 = abs(res_c.f1_test_final - res_r.f1_test_final)
    if len(sel_c) != STREAM_BUDGET // B or df1 > F1_TOL:
        fail(f"warm stream cuda vs reference: {len(sel_c)} rounds, F1 differs by {df1}")

    c = replace(cfg, budget=STREAM_BATCH_BUDGET)
    cold = StreamingCleaningSession(src, c, warm_start=False)
    while cold.ingest():
        pass
    cold.clean(None)
    res_cold = cold.result()
    res_batch = make_scheduler(CleaningSession.initialize(src.batch_dataset(), c)).run()
    same = {**_same_result(torch, res_cold, res_batch),
            "weights": torch.equal(res_cold.dataset.y_weight, res_batch.dataset.y_weight),
            "f1_test": [r.f1_test for r in res_cold.history]
            == [r.f1_test for r in res_batch.history]}

    store, _ = WindowStore.create(src).append(next(iter(src.windows())))
    tail = torch.arange(store.n, store.capacity, device="cuda")
    g = torch.Generator("cuda").manual_seed(SEED + 5)
    garbage = [(7.5, 0.3), (100.0 * torch.randn(len(tail), store.ds.X.shape[1], generator=g,
                                                device="cuda"),
                            torch.rand(len(tail), store.ds.n_classes, generator=g, device="cuda"))]
    ws = []
    for X_tail, Y_tail in garbage:
        X, Y = store.ds.X.clone(), store.ds.y_prob.clone()
        X[tail], Y[tail] = X_tail, Y_tail
        w, _, _ = train_head(replace(store.ds, X=X, y_prob=Y), cfg, cache=False,
                             backend=Backend("cuda"))
        ws.append(w)
    tail_same = torch.equal(ws[0], ws[1])
    emit({"phase": "stream_checks", "widths": "twitter", "rounds_same_selection": compared,
          "f1_test_cuda": res_c.f1_test_final, "f1_test_reference": res_r.f1_test_final,
          "f1_diff": df1, "f1_tol": F1_TOL, "cold_rounds": len(res_cold.history),
          "cold_equals_batch": same, "tail_rows": len(tail), "tail_invariant": tail_same})
    if len(res_cold.history) != STREAM_BATCH_BUDGET // B or not all(same.values()):
        fail(f"cold stream against the batch session: {len(res_cold.history)} rounds, {same}")
    if not tail_same:
        fail("weights trained over the capacity move with the weight-0 tail rows' contents")


def _device_profile(torch, fn, top: int = 12) -> dict:
    """fn() once under torch.profiler: its host wall, the union of the
    kernels' device intervals (busy time) and the device's idle share
    against the wall, the CUDA runtime calls that block the host, the host
    ops of most self time, and the device kernels of most total time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in device):
        busy += max(0.0, b - max(a, end))  # union of the device intervals, in us
        end = max(end, b)
    by_kernel: dict = {}
    for e in device:
        n, us = by_kernel.get(e.name, (0, 0.0))
        by_kernel[e.name] = (n + 1, us + e.time_range.end - e.time_range.start)
    host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    return {"wall_s": wall, "busy_us": busy, "kernels": len(device),
            "idle_share": 1.0 - busy / (wall * 1e6),
            "blocking": {e.key: e.count for e in host if "Synchronize" in e.key
                         or e.key in ("cudaMemcpy", "cudaStreamWaitEvent")},
            "top_host_ops": [(e.key, e.count, e.self_cpu_time_total) for e in
                             sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:top]],
            "top_device_kernels": sorted(([k[:90], n, us] for k, (n, us) in by_kernel.items()),
                                         key=lambda x: -x[2])[:top]}


def trace_phase(torch, card_line: str, ds, cfg) -> None:
    """Where a DeltaGrad-L replay step's time goes on the card: the first
    TRACE_STEPS steps of a mimic replay (10 rows cleaned), untraced (host
    clock) TRACE_UNTRACED times with the garbage collector on and as many
    with it off, in turns, then once under sync-debug mode (every synchronizing PyTorch
    call warns), then once under torch.profiler: the union of the kernels'
    device intervals against the host wall (the device's idle share), the
    CUDA runtime calls that block the host, and the host ops and device
    kernels that cost the most."""
    import warnings

    from repro_torch.core import deltagrad, lr_head
    from repro_torch.core.backend import Backend
    from repro_torch.core.pipeline import train_head

    bk = Backend("cuda")
    _, (ws, gs), sched = train_head(ds, cfg, cache=True, backend=bk)
    idx = sched[0, :B]
    Xa = lr_head.augment(ds.X)
    ds_new = ds.clean(idx, ds.y_true[idx])
    ci, cm = deltagrad.build_correction_schedule(sched.cpu().numpy(), idx.cpu().numpy())
    n = TRACE_STEPS
    dgc = deltagrad.DGConfig(cfg.dg_burn_in, cfg.dg_period, cfg.dg_history, cfg.lr, cfg.l2)

    def replay():
        return deltagrad.deltagrad_replay(ws[:n], gs[:n], sched[:n], Xa, ds.y_prob, ds_new.y_prob,
                                          ds.y_weight, ds_new.y_weight, ci[:n], cm[:n], dgc, BS,
                                          backend=bk)

    replay()
    torch.cuda.synchronize()
    untraced = {"gc_on": [], "gc_off": []}  # host us a step, the collector on / off in turns
    for _ in range(TRACE_UNTRACED):
        for key, times in untraced.items():
            gc.collect()
            if key == "gc_off":
                gc.disable()
            try:
                t0 = time.perf_counter()
                replay()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) / n * 1e6)
            finally:
                gc.enable()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            replay()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sync_warnings = sorted({str(w.message).splitlines()[0] for w in caught})
    prof = _device_profile(torch, replay)
    emit({"phase": "trace", "what": "deltagrad_replay, backend cuda, mimic widths",
          "steps": n, "host_us_per_step_untraced": untraced["gc_on"],
          "host_us_per_step_untraced_gc_off": untraced["gc_off"],
          "host_us_per_step_traced": prof["wall_s"] / n * 1e6,
          "device_busy_us_per_step": prof["busy_us"] / n, "device_kernels": prof["kernels"],
          "device_kernels_per_step": prof["kernels"] / n,
          "device_idle_share": prof["idle_share"],
          "sync_debug_warnings": sync_warnings, "blocking_runtime_calls": prof["blocking"],
          "top_host_ops_self_us_per_step": [
              [k, c / n, us / n] for k, c, us in prof["top_host_ops"]],
          "top_device_kernels_us_per_step": [
              [k, c / n, us / n] for k, c, us in prof["top_device_kernels"]],
          "card": card_line})


def _check_and_time(torch, name: str, kern, plain, library, shape, nbytes: float, ops: float,
                    ops_per_s: float, card_line: str, bf16: bool = False,
                    pairs=lambda out, ref: zip(out, ref), library_computes: str = "") -> dict:
    """Hold a kernel against its plain version (tuple outputs compared pair by
    pair, as `pairs` matches them up), check a bit-for-bit repeat, and time
    the kernel, the plain version and the library call (if any) with CUDA
    events. `library_computes` says what the library call computes where
    that is not the kernel's own output."""
    from repro_torch.kernels import LAUNCHES

    as_tuple = lambda x: x if isinstance(x, tuple) else (x,)  # noqa: E731
    out = as_tuple(kern())
    torch.cuda.synchronize()
    ref = as_tuple(plain())
    torch.cuda.synchronize()
    rel = BF16_TOL_REL if bf16 else TOL_REL
    err, limit = 0.0, 0.0
    for a, b in pairs(out, ref):
        e = float((a.float() - b.float()).abs().max())
        lim = rel * float(b.float().abs().max()) + TOL_ABS
        if not (bool(torch.isfinite(a).all()) and e <= lim):
            fail(f"{name}: max|kernel - plain| = {e} > {lim} at {shape}")
        err, limit = max(err, e), max(limit, lim)
    if not all(torch.equal(a, b) for a, b in zip(out, as_tuple(kern()))):
        fail(f"{name}: two launches on the same inputs differ")
    ms = time_ms(torch, kern)
    plain_ms = time_ms(torch, plain)
    library_ms = time_ms(torch, library) if library is not None else None
    bound_ms, bound_by = bound(nbytes, ops, ops_per_s)
    emit({"phase": "kernel", "name": name, "shape": shape, "max_abs_err": err,
          "tolerance": f"max|kernel-plain| <= {rel}*max|plain| + {TOL_ABS} (largest: {limit})",
          "bitwise_repeat": True, "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
          "bound_by": bound_by, "library_ms": library_ms,
          "library_computes": library_computes or "the kernel's output", "card": card_line,
          "launches": dict(LAUNCHES)})
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def attention_kernel_phase(torch, card_line: str) -> dict:
    """The two serving kernels against their plain versions at OLMo-1B's full
    attention shapes (16 heads of 128): flash at a prefill (S = 256), a tail
    prefill (32 rows at positions 64.. over 256 keys), GQA + window +
    softcap, and bf16; the paged partials at batch 4 with 32 table pages of
    8, one slot parked, and at G = 4 with a window. Returns the figures of
    the main path's shapes (prefill, batch-4 decode) for the kernels line."""
    from repro_torch.kernels import ops, paged_attention
    from repro_torch.models.attention import AttnSpec

    F = torch.nn.functional
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    results = {}
    flash_cases = {
        # name: B, Sq, Skv, Hq, Hkv, D, first q position, window, softcap, dtype
        "flash_attention": (1, 256, 256, 16, 16, 128, 0, 0, 0.0, torch.float32),
        "flash_attention/tail": (1, 32, 256, 16, 16, 128, 64, 0, 0.0, torch.float32),
        "flash_attention/gqa_window_softcap": (1, 256, 256, 16, 4, 128, 0, 64, 30.0,
                                               torch.float32),
        "flash_attention/bf16": (1, 256, 256, 16, 16, 128, 0, 0, 0.0, torch.bfloat16),
    }
    for name, (B, Sq, Skv, Hq, Hkv, D, off, window, softcap, dtype) in flash_cases.items():
        q = torch.randn(B, Sq, Hq, D, generator=g, device=dev).to(dtype)
        k = torch.randn(B, Skv, Hkv, D, generator=g, device=dev).to(dtype)
        v = torch.randn(B, Skv, Hkv, D, generator=g, device=dev).to(dtype)
        qpos = torch.arange(off, off + Sq, dtype=torch.int32, device=dev)
        kpos = torch.arange(Skv, dtype=torch.int32, device=dev)
        spec = AttnSpec(True, window, softcap)
        visible = qpos[:, None] >= kpos[None, :]
        if window:
            visible &= qpos[:, None] - kpos[None, :] < window
        # the library yardstick: one SDPA call, float32, the same boolean mask
        # (no softcap: SDPA has none, so that case has no library time)
        qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
        library = None if softcap else (
            lambda qf=qf, kf=kf, vf=vf, m=visible, gqa=Hq != Hkv:
            F.scaled_dot_product_attention(qf, kf, vf, attn_mask=m, enable_gqa=gqa))
        size = q.element_size()
        nbytes = size * (2 * B * Sq * Hq * D + 2 * B * Skv * Hkv * D) + 4.0 * (Sq + Skv)
        ops_n = 4.0 * D * float(visible.sum()) * B * Hq
        results[name] = _check_and_time(
            torch, name, lambda a=(q, k, v, qpos, kpos, spec): ops.flash_attention(*a),
            lambda a=(q, k, v, qpos, kpos, spec): ops.flash_attention_ref(*a), library,
            [B, Sq, Skv, Hq, Hkv, D, off, window, softcap, str(dtype)], nbytes, ops_n,
            BF16_OPS_PER_S if dtype == torch.bfloat16 else TF32X3_OPS_PER_S, card_line,
            bf16=dtype == torch.bfloat16)
    paged_cases = {
        # name: B, Hkv, G, D, P, table pages, pool pages, window
        "paged_attention": (4, 16, 1, 128, 8, 32, 129, 0),
        "paged_attention/gqa4_window": (4, 4, 4, 128, 8, 32, 129, 40),
    }
    for name, (B, Hkv, G, D, P, n_table, n_phys, window) in paged_cases.items():
        q = torch.randn(B, Hkv, G, D, generator=g, device=dev)
        k_pages = torch.randn(n_phys, P, Hkv, D, generator=g, device=dev)
        v_pages = torch.randn(n_phys, P, Hkv, D, generator=g, device=dev)
        table, pos = _olmo_decode_table(torch, g, dev, n_table, n_phys)
        n_live = float(_live_pages(torch, table, pos, P, window).sum())
        nbytes = (4.0 * (B * Hkv * G * D + 2 * n_live * P * Hkv * D + B * n_table + B)
                  + 4.0 * B * Hkv * n_table * G * (D + 2))
        ops_n = 4.0 * G * D * P * n_live * Hkv
        a = (q, k_pages, v_pages, table, pos)
        kern = lambda a=a, w=window: paged_attention.paged_attention_partials(  # noqa: E731
            *a, window=w)
        results[name] = _check_and_time(
            torch, name, kern,
            lambda a=a, w=window: paged_attention.paged_attention_partials_reference(*a, window=w),
            None, [B, Hkv, G, D, P, n_table, n_phys, window], nbytes, ops_n, FP32_OPS_PER_S,
            card_line, pairs=lambda out, ref, name=name: _partial_pairs(torch, name, out, ref))
        emit({"phase": "kernel_extra", "name": name, **_paged_extra(torch, kern, *a, window)})
    return results


def _olmo_decode_table(torch, g, dev, n_table: int, n_phys: int):
    """OLMo-1B's decode table at batch 4: slots at positions 217, 100 and 37
    with their whole n_table-page allocation (most of it past the
    position), the last slot parked (all trash, position 0)."""
    ids = (torch.randperm(n_phys - 1, generator=g, device=dev) + 1).int()
    table = torch.zeros(4, n_table, dtype=torch.int32, device=dev)
    pos = torch.zeros(4, dtype=torch.int32, device=dev)
    for b, p in enumerate((217, 100, 37)):
        table[b] = ids[b * n_table:(b + 1) * n_table]
        pos[b] = p
    return table, pos


def _starcoder_decode_table(torch, g, dev, n_table: int, n_phys: int, window: int):
    """StarCoder2-3B's decode table: two slots SC_MAX_NEW - 1 tokens into
    prompts of SC_LENGTHS[:2], the whole pages past the window retired."""
    ids = (torch.randperm(n_phys - 1, generator=g, device=dev) + 1).int()
    table = torch.zeros(2, n_table, dtype=torch.int32, device=dev)
    pos = torch.tensor([SC_LENGTHS[0] + SC_MAX_NEW - 1, SC_LENGTHS[1] + SC_MAX_NEW - 1],
                       dtype=torch.int32, device=dev)
    for b in range(2):
        need = -(-(SC_LENGTHS[b] + SC_MAX_NEW) // SC_PAGE)
        table[b, :need] = ids[b * n_table:b * n_table + need]
        table[b, :(int(pos[b]) - window) // SC_PAGE] = 0  # retired
    return table, pos


def _live_pages(torch, table, pos, P: int, window: int):
    """[B, n_table]: the table pages with a visible key."""
    first = torch.arange(table.shape[1], device=table.device) * P  # each page's first position
    live = (table != 0) & (first[None] <= pos[:, None])
    if window:
        live &= first[None] + P - 1 > pos[:, None] - window
    return live


def _paged_extra(torch, kern, q, k_pages, v_pages, table, pos, window: int) -> dict:
    """Beside a paged case: the host's cost of a call, the launch plan (query
    rows a warp, warps a CTA, keys a transpose reduction, shared memory), a
    yardstick (one torch.sum over the live pages' K and V bytes laid out
    contiguously, as float32, timed as the kernel is), the kernel and the
    yardstick after a clean flush (call_times), and the time of the merge,
    ops.paged_decode_finish, on the kernel's partials."""
    from repro_torch.kernels import ops, paged_attention

    B, Hkv, G, D = q.shape
    P = k_pages.shape[1]
    ids = table[_live_pages(torch, table, pos, P, window)].long()
    flat = torch.cat([k_pages[ids].reshape(-1), v_pages[ids].reshape(-1)]).view(torch.float32)
    sink = torch.empty((), device=q.device)
    read = lambda: torch.sum(flat, 0, out=sink)  # noqa: E731
    m, l, acc = kern()
    q4 = q.reshape(B, 1, Hkv * G, D)
    return {"host_us_per_call": host_us(torch, kern),
            "plan": paged_attention.paged_plan(G, D, P, k_pages.element_size()),
            "contiguous_read_ms": time_ms(torch, read),
            "contiguous_read_bytes": flat.numel() * flat.element_size(),
            "kernel_ms_clean_l2": time_ms(torch, kern, clean=True),
            "contiguous_read_ms_clean_l2": time_ms(torch, read, clean=True),
            "merge_ms": time_ms(torch, lambda: ops.paged_decode_finish(m, l, acc, q4))}


def _partial_pairs(torch, name, out, ref):
    """The paged partials' pairs to compare: m where the plain version has a
    live page (a neutral page's m is -1e30, which would swamp a relative
    tolerance; there the kernel must give exactly -1e30), l and acc whole."""
    (m, l, acc), (m_ref, l_ref, acc_ref) = out, ref
    live = m_ref > -1e29
    if not torch.equal(m[~live], m_ref[~live]):
        fail(f"{name}: a neutral page's m is not exactly -1e30")
    return [(m[live], m_ref[live]), (l, l_ref), (acc, acc_ref)]


def windowed_kernel_phase(torch, card_line: str) -> dict:
    """The banded, block-sparse and chunked-prefill kernels against their
    plain versions at StarCoder2-3B's attention shapes (24 query heads over 2
    kv heads of 128, window 4096, float32): a prefill at SC_SEQ tokens and a
    tail (256 rows at positions 5000.. over SC_SEQ keys), block-sparse at
    2048 tokens with a seeded random mask of about half the blocks, chunked
    with chunk SC_CHUNK; the paged decode kernel at StarCoder2's decode shape
    (G = 12, two slots past the window, their dead pages retired). Then the
    identities the kernels claim, each bit for bit: local == flash,
    block-sparse with an all-ones mask == flash and with the band's own mask
    == local, chunked + merge == flash. Returns the figures of the main
    path's shapes for the kernels line."""
    from repro_torch.kernels import chunked_prefill, local_attention, ops, paged_attention
    from repro_torch.models.attention import AttnSpec

    F = torch.nn.functional
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    Hq, Hkv, D, W = 24, 2, 128, 4096
    spec = AttnSpec(True, W, 0.0)
    results = {}

    def inputs(Sq, Skv, off):
        q = torch.randn(1, Sq, Hq, D, generator=g, device=dev)
        k = torch.randn(1, Skv, Hkv, D, generator=g, device=dev)
        v = torch.randn(1, Skv, Hkv, D, generator=g, device=dev)
        return (q, k, v, torch.arange(off, off + Sq, dtype=torch.int32, device=dev),
                torch.arange(Skv, dtype=torch.int32, device=dev))

    def band(qpos, kpos, window):
        m = qpos[:, None] >= kpos[None, :]
        return m & (qpos[:, None] - kpos[None, :] < window) if window else m

    def sdpa(a, mask):
        qf, kf, vf = (x.transpose(1, 2) for x in a[:3])
        return lambda: F.scaled_dot_product_attention(qf, kf, vf, attn_mask=mask, enable_gqa=True)

    def attn_bytes(a, out_floats):
        q, k, v, qpos, kpos = a
        return 4.0 * (q.numel() + k.numel() + v.numel() + out_floats + qpos.numel() + kpos.numel())

    prefill = inputs(SC_SEQ, SC_SEQ, 0)
    tail = inputs(256, SC_SEQ, 5000)
    for name, a in (("local_attention", prefill), ("local_attention/tail", tail)):
        vis = band(a[3], a[4], W)
        results[name] = _check_and_time(
            torch, name, lambda a=a: ops.local_attention(*a, spec),
            lambda a=a: ops.local_attention_ref(*a, spec), sdpa(a, vis),
            [1, a[0].shape[1], a[1].shape[1], Hq, Hkv, D, int(a[3][0]), W, "float32"],
            attn_bytes(a, a[0].numel()), 4.0 * D * Hq * float(vis.sum()), TF32X3_OPS_PER_S,
            card_line, library_computes="SDPA, float32, the boolean band mask")
    for name, a in (("chunked_prefill", prefill), ("chunked_prefill/tail", tail)):
        vis = band(a[3], a[4], W)
        Sq = a[0].shape[1]
        results[name] = _check_and_time(
            torch, name, lambda a=a: ops.chunked_prefill_partials(*a, spec, SC_CHUNK),
            lambda a=a: ops.chunked_prefill_partials_ref(*a, spec, SC_CHUNK), sdpa(a, vis),
            [1, Sq, a[1].shape[1], Hq, Hkv, D, int(a[3][0]), W, SC_CHUNK, "float32"],
            attn_bytes(a, Hq * Sq * (D + 2)), 4.0 * D * Hq * float(vis.sum()), TF32X3_OPS_PER_S,
            card_line, library_computes="SDPA of the whole op's output (partials and merge), "
                                        "float32, the boolean band mask: no one call gives the "
                                        "partials")
    sparse = inputs(2048, 2048, 0)
    nq, nk = ops.attn_block_mask_shape(2048, 2048)
    bq, bk = 2048 // nq, 2048 // nk
    mask = (torch.rand(nq, nk, generator=g, device=dev) < 0.5).int()
    cells = mask.bool().repeat_interleave(bq, 0).repeat_interleave(bk, 1)
    vis = band(sparse[3], sparse[4], W) & cells
    results["block_sparse_attention"] = _check_and_time(
        torch, "block_sparse_attention",
        lambda: ops.block_sparse_attention(*sparse, mask, spec),
        lambda: ops.block_sparse_attention_ref(*sparse, mask, spec), sdpa(sparse, vis),
        [1, sparse[0].shape[1], sparse[1].shape[1], Hq, Hkv, D, 0, W, [nq, nk],
         int(mask.sum()), "float32"],
        attn_bytes(sparse, sparse[0].numel()) + 4.0 * nq * nk,
        4.0 * D * Hq * float(vis.sum()), TF32X3_OPS_PER_S, card_line,
        library_computes="SDPA, float32, the block mask expanded to elements and the causal "
                         "mask (a row with no enabled key gives NaN there, 0 in the kernel)")

    # the decode kernel at StarCoder2's decode shape: two slots 31 tokens into
    # prompts of 5000 and 6000, whole pages past the window retired
    n_table, P = -(-(max(SC_LENGTHS) + SC_MAX_NEW) // SC_PAGE), SC_PAGE
    n_phys = 1 + 2 * n_table
    q = torch.randn(2, Hkv, Hq // Hkv, D, generator=g, device=dev)
    k_pages = torch.randn(n_phys, P, Hkv, D, generator=g, device=dev)
    v_pages = torch.randn(n_phys, P, Hkv, D, generator=g, device=dev)
    table, pos = _starcoder_decode_table(torch, g, dev, n_table, n_phys, W)
    n_live = float(_live_pages(torch, table, pos, P, W).sum())
    G = Hq // Hkv
    a = (q, k_pages, v_pages, table, pos)
    kern = lambda: paged_attention.paged_attention_partials(*a, window=W)  # noqa: E731
    results["paged_attention/starcoder2"] = _check_and_time(
        torch, "paged_attention/starcoder2", kern,
        lambda: paged_attention.paged_attention_partials_reference(*a, window=W), None,
        [2, Hkv, G, D, P, n_table, n_phys, W],
        4.0 * (q.numel() + 2 * n_live * P * Hkv * D + table.numel() + 2)
        + 4.0 * 2 * Hkv * n_table * G * (D + 2), 4.0 * G * D * P * n_live * Hkv,
        FP32_OPS_PER_S, card_line,
        pairs=lambda out, ref: _partial_pairs(torch, "paged_attention/starcoder2", out, ref))
    emit({"phase": "kernel_extra", "name": "paged_attention/starcoder2",
          **_paged_extra(torch, kern, *a, W)})

    # the identities, bit for bit
    q = prefill[0]
    flash = ops.flash_attention(*prefill, spec)
    spec512 = AttnSpec(True, 512, 0.0)
    band_mask = torch.from_numpy(local_attention.band_live(
        sparse[3].cpu().reshape(nq, bq), sparse[4].cpu().reshape(nk, bk), causal=True,
        window=512)).to(device=dev, dtype=torch.int32)
    local512 = ops.local_attention(*sparse, spec512)
    same = {
        "local == flash (8192, window 4096)": torch.equal(ops.local_attention(*prefill, spec),
                                                          flash),
        "chunked + merge == flash (8192, chunk 2048)": torch.equal(ops.chunked_prefill_finish(
            *ops.chunked_prefill_partials(*prefill, spec, SC_CHUNK), q), flash),
        "chunked + merge == flash (8192, chunk 1000 -> 1024)": torch.equal(
            ops.chunked_prefill_finish(*ops.chunked_prefill_partials(*prefill, spec, 1000), q),
            flash),
        "block-sparse all-ones == flash (2048)": torch.equal(
            ops.block_sparse_attention(*sparse, torch.ones_like(mask), spec),
            ops.flash_attention(*sparse, spec)),
        "block-sparse band mask == local (2048, window 512)": torch.equal(
            ops.block_sparse_attention(*sparse, band_mask, spec512), local512),
        "local == flash (2048, window 512)": torch.equal(
            local512, ops.flash_attention(*sparse, spec512)),
    }
    emit({"phase": "identities", "bitwise_equal": same,
          "chunk_eff": chunked_prefill.chunk_blocks(SC_CHUNK, chunked_prefill.KV_TILE)})
    if not all(same.values()):
        fail(f"a kernel identity does not hold bit for bit: {same}")
    return results


def _int8_pool(torch, g, n_phys, P, Hkv, D, dev):
    """Random int8 code pools and positive float32 (page, head) scales."""
    codes = [torch.randint(-127, 128, (n_phys, P, Hkv, D), generator=g, device=dev).to(
        torch.int8) for _ in range(2)]
    scales = [0.01 + 0.04 * torch.rand(n_phys, Hkv, generator=g, device=dev) for _ in range(2)]
    return codes + scales


def ring_int8_kernel_phase(torch, card_line: str) -> dict:
    """The two kernels of the ring and int8 paths against their plain
    versions: decode_attention at RecurrentGemma-9B's decode shape (B 2, 16
    query heads over 1 kv head of 256, a ring of 2048 wrapped at position
    RG_DECODE_POS, window 2048) and at OLMo-1B's ring shape (B 4, 16 heads of
    128, a ring of 256 wrapped), plain, with a softcap and in bf16, each
    also timed beside one SDPA call (float32, the slot mask broadcast); the
    int8 paged partials at OLMo-1B's decode shape and at StarCoder2-3B's (G
    12, two slots past the window, their dead pages retired). Then the
    banded kernel at RecurrentGemma-9B's prefill shape (S 3000, D 256: the
    DMAX 256 instance), timed beside SDPA, and bit for bit the flash kernel
    there. Returns the figures of the main paths' shapes for the kernels
    line."""
    from repro_torch.kernels import ops, paged_attention
    from repro_torch.models.attention import AttnSpec, ring_valid

    F = torch.nn.functional
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    results = {}
    decode_cases = {
        # name: B, Hkv, G, D, W, position, window, softcap, dtype
        "decode_attention": (RG_BATCH, 1, 16, 256, RG_WINDOW, RG_DECODE_POS, RG_WINDOW, 0.0,
                             torch.float32),
        "decode_attention/olmo_ring": (4, 16, 1, 128, 256, 300, 0, 0.0, torch.float32),
        "decode_attention/olmo_ring_softcap": (4, 16, 1, 128, 256, 300, 0, 30.0, torch.float32),
        "decode_attention/olmo_ring_bf16": (4, 16, 1, 128, 256, 300, 0, 0.0, torch.bfloat16),
    }
    for name, (B, Hkv, G, D, W, pos, window, softcap, dtype) in decode_cases.items():
        Hq = Hkv * G
        q = torch.randn(B, 1, Hq, D, generator=g, device=dev).to(dtype)
        k = torch.randn(B, W, Hkv, D, generator=g, device=dev).to(dtype)
        v = torch.randn(B, W, Hkv, D, generator=g, device=dev).to(dtype)
        spec = AttnSpec(True, window, softcap)
        valid = ring_valid(torch.tensor(pos, device=dev), W, spec)
        n_valid = float(valid.sum())
        qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
        library = None if softcap else (
            lambda qf=qf, kf=kf, vf=vf, m=valid[None, None, None, :], gqa=Hq != Hkv:
            F.scaled_dot_product_attention(qf, kf, vf, attn_mask=m, enable_gqa=gqa))
        size = q.element_size()
        # q in and out, the valid slots' K and V rows, the mask
        nbytes = size * (2 * B * Hq * D + 2 * B * n_valid * Hkv * D) + W
        kern = lambda a=(q, k, v, valid, spec): ops.decode_attention(*a)  # noqa: E731
        results[name] = _check_and_time(
            torch, name, kern, lambda a=(q, k, v, valid, spec): ops.decode_attention_ref(*a),
            library, [B, Hkv, G, D, W, pos, window, softcap, str(dtype)], nbytes,
            4.0 * B * Hq * D * n_valid, BF16_OPS_PER_S if dtype == torch.bfloat16
            else FP32_OPS_PER_S, card_line, bf16=dtype == torch.bfloat16,
            library_computes="SDPA, float32, the slot mask broadcast")
        emit({"phase": "kernel_extra", "name": name, **_decode_extra(torch, kern, q, k, v)})

    def quant_case(name, q, table, pos, n_phys, P, window):
        B, Hkv, G, D = q.shape
        kq, vq, ks, vs = _int8_pool(torch, g, n_phys, P, Hkv, D, dev)
        n_table = table.shape[1]
        n_live = float(_live_pages(torch, table, pos, P, window).sum())
        # q, the live pages' codes and scales, the table and positions in;
        # every table page's partial out
        nbytes = (4.0 * (q.numel() + B * n_table + B) + n_live * Hkv * (2 * P * D + 8)
                  + 4.0 * B * Hkv * n_table * G * (D + 2))
        a = (q, kq, vq, ks, vs, table, pos)
        kern = lambda: paged_attention.paged_attention_partials_quant(  # noqa: E731
            *a, window=window)
        res = _check_and_time(
            torch, name, kern,
            lambda: paged_attention.paged_attention_partials_quant_reference(*a, window=window),
            None, [B, Hkv, G, D, P, n_table, n_phys, window, "int8"], nbytes,
            4.0 * G * D * P * n_live * Hkv, FP32_OPS_PER_S, card_line,
            pairs=lambda out, ref: _partial_pairs(torch, name, out, ref))
        emit({"phase": "kernel_extra", "name": name,
              **_paged_extra(torch, kern, q, kq, vq, table, pos, window)})
        return res

    # OLMo-1B's decode: batch 4, 32 table pages of 8, slots at 217, 100 and 37
    # with their whole allocation, the last slot parked
    n_table, n_phys, P = 32, 129, 8
    q = torch.randn(4, 16, 1, 128, generator=g, device=dev)
    table, pos = _olmo_decode_table(torch, g, dev, n_table, n_phys)
    results["paged_attention_quant"] = quant_case("paged_attention_quant", q, table, pos,
                                                  n_phys, P, 0)
    # StarCoder2-3B's decode: two slots 31 tokens into prompts of 5000 and
    # 6000, whole pages past the window retired
    W = 4096
    n_table = -(-(max(SC_LENGTHS) + SC_MAX_NEW) // SC_PAGE)
    n_phys = 1 + 2 * n_table
    q = torch.randn(2, 2, 12, 128, generator=g, device=dev)
    table, pos = _starcoder_decode_table(torch, g, dev, n_table, n_phys, W)
    results["paged_attention_quant/starcoder2"] = quant_case(
        "paged_attention_quant/starcoder2", q, table, pos, n_phys, SC_PAGE, W)

    # the banded kernel at RecurrentGemma-9B's prefill (the wave's width): D 256
    S, Hq, Hkv, D, W = max(RG_LENGTHS[:RG_BATCH]), 16, 1, 256, RG_WINDOW
    q = torch.randn(RG_BATCH, S, Hq, D, generator=g, device=dev)
    k = torch.randn(RG_BATCH, S, Hkv, D, generator=g, device=dev)
    v = torch.randn(RG_BATCH, S, Hkv, D, generator=g, device=dev)
    qpos = torch.arange(S, dtype=torch.int32, device=dev)
    spec = AttnSpec(True, W, 0.0)
    vis = (qpos[:, None] >= qpos[None, :]) & (qpos[:, None] - qpos[None, :] < W)
    qf, kf, vf = (x.transpose(1, 2) for x in (q, k, v))
    a = (q, k, v, qpos, qpos)
    results["local_attention/recurrentgemma"] = _check_and_time(
        torch, "local_attention/recurrentgemma", lambda: ops.local_attention(*a, spec),
        lambda: ops.local_attention_ref(*a, spec),
        lambda: F.scaled_dot_product_attention(qf, kf, vf, attn_mask=vis, enable_gqa=True),
        [RG_BATCH, S, S, Hq, Hkv, D, 0, W, "float32"],
        4.0 * (2 * q.numel() + k.numel() + v.numel() + 2 * S),
        4.0 * D * Hq * RG_BATCH * float(vis.sum()), TF32X3_OPS_PER_S, card_line,
        library_computes="SDPA, float32, the boolean band mask")
    same = torch.equal(ops.local_attention(*a, spec), ops.flash_attention(*a, spec))
    emit({"phase": "identities", "bitwise_equal": {
        f"local == flash ({S}, D 256, window {W})": same}})
    if not same:
        fail("local attention at D 256 is not bit for bit flash attention")
    return results


def _decode_extra(torch, kern, q, k, v) -> dict:
    """Beside a decode case: the host's cost of a call, the launch plan (the
    chunk, the split and the grid), and a yardstick: one torch.sum over the
    ring's K and V bytes laid out contiguously, timed as the kernel is."""
    from repro_torch.kernels import common, decode_attention

    B, W, Hkv, D = k.shape
    plan = decode_attention.decode_plan(B, Hkv, q.shape[2] // Hkv, D, W,
                                        q.dtype == torch.bfloat16, q.device.index or 0)
    flat = torch.cat([k.reshape(-1), v.reshape(-1)])
    sink = torch.empty((), dtype=flat.dtype, device=q.device)
    return {"host_us_per_call": host_us(torch, kern), "plan": plan,
            "contiguous_read_ms": time_ms(torch, lambda: torch.sum(flat, 0, out=sink)),
            "contiguous_read_bytes": flat.numel() * flat.element_size()}


def _first_divergence(a, b):
    """Index of the first token where two streams differ, or None."""
    return next((i for i, (x, y) in enumerate(zip(a.out, b.out)) if x != y), None)


def serving_phase(torch, card_line: str) -> tuple[dict, dict]:
    """The paged serving path at OLMo-1B's full width, float32, random
    weights from SEED: ServeEngine(batch_size=4, max_len=256) at its
    defaults (prefix sharing on) serves 8 requests (prompt buckets 32 to
    256, four sharing a 64-token prefix, 16 new tokens each), on backend
    cuda (launch counts set to 0 just before, read just after) and on
    backend reference. Tokens must agree (or part at a top-2 tie within
    TIE_MARGIN), logits within LOGIT_TOL up to the first parting; a request
    that joined mid-stream, rerun solo on cuda, gives the same tokens; the
    launches must be 16 per prefill and 16 per decode round. Times each
    prefill (by bucket width) and decode round with a device sync around
    it. Then the same requests on int8 page pools (`_int8_serving`).
    Returns the launches of the float and of the int8 cuda run."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import Model
    from repro_torch.serving import Request, ServeConfig, ServeEngine

    dev = torch.device("cuda")
    cfg = get_config("olmo-1b")
    t0 = time.perf_counter()
    model = Model(cfg, device=dev)
    params = model.init(SEED)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    emit({"phase": "serve_model", "arch": cfg.name, "params": n_params,
          "param_bytes": 4 * n_params, "init_s": time.perf_counter() - t0,
          "layers": cfg.n_layers, "d_model": cfg.d_model, "heads": cfg.n_heads,
          "kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
          "padded_vocab": cfg.padded_vocab})
    r = np.random.default_rng(SEED)
    shared = r.integers(0, cfg.vocab_size, SERVE_PREFIX)
    prompts = []
    for i, n in enumerate(SERVE_LENGTHS):
        p = r.integers(0, cfg.vocab_size, n)
        if i in SERVE_SHARED:
            p[:SERVE_PREFIX] = shared
        prompts.append(p.astype(np.int32))

    timings: list = []

    def serve(backend, reqs, batch_size=SERVE_BATCH):
        eng = ServeEngine(model, params, backend=backend, device=dev,
                          config=ServeConfig(batch_size=batch_size, max_len=SERVE_MAX_LEN,
                                             trace_logits=True))
        t = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        return done, dict(eng.stats), time.perf_counter() - t

    undo = _time_model_calls(torch, model, timings)
    for backend in ("cuda", "reference"):  # warm-up: cuBLAS, the kernels' first load
        serve(backend, [Request(uid=-1, prompt=prompts[1], max_new=2)], batch_size=1)
    runs = {}
    for backend in ("cuda", "reference"):
        timings.clear()
        if backend == "cuda":
            reset_launches()
        done, stats, wall = serve(backend, [Request(uid=i, prompt=p, max_new=SERVE_MAX_NEW)
                                            for i, p in enumerate(prompts)])
        launches = dict(LAUNCHES)
        runs[backend] = (done, stats, launches)
        emit({"phase": "serve", "arch": cfg.name, "backend": backend,
              **_serve_figures(timings, stats, done, wall),
              "launches": launches if backend == "cuda" else None, "card": card_line})
    undo()

    (done_c, stats_c, launches), (done_r, stats_r, _) = runs["cuda"], runs["reference"]
    # the schedule depends on the prompts and budgets only
    if [q.uid for q in done_c] != [q.uid for q in done_r] or stats_c != stats_r:
        fail(f"serve: the backends scheduled differently: {stats_c} vs {stats_r}")
    worst, parted = _compare_streams(np, "serve", done_c, done_r, SERVE_MAX_NEW)
    want = {"flash_attention": cfg.n_layers * len(prompts),
            "paged_attention": cfg.n_layers * stats_c["decode_rounds"]}
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"serve: the cuda run launched {got}, its schedule predicts {want}")
    joined = next(q for q in done_c if q.uid == SERVE_JOINED)
    solo, _, _ = serve("cuda", [Request(uid=joined.uid, prompt=prompts[joined.uid],
                                        max_new=SERVE_MAX_NEW)], batch_size=1)
    i = _first_divergence(joined, solo[0])
    if i is not None:
        top2 = np.sort(solo[0].logits[i])[-2:]
        if float(top2[1] - top2[0]) > TIE_MARGIN:
            fail(f"serve: request {joined.uid} joined and solo part at token {i}")
    emit({"phase": "serve_compare", "same_tokens": not parted, "parted": parted,
          "max_logit_diff_rel": worst, "logit_tol": LOGIT_TOL, "tie_margin": TIE_MARGIN,
          "prefix_hits": stats_c["prefix_hits"], "launches": got, "predicted": want,
          "joined_uid": joined.uid, "joined_entry_width": joined.entry_width,
          "joined_vs_solo_same_tokens": i is None,
          "joined_vs_solo_max_logit_diff": float(max(
              np.abs(a - b).max() for a, b in zip(joined.logits, solo[0].logits)))})
    if stats_c["prefix_hits"] < 2:
        fail(f"serve: {stats_c['prefix_hits']} prefix hits, the requests were built for 2")
    serve_trace(torch, card_line, lambda: serve("cuda", [
        Request(uid=i, prompt=p, max_new=SERVE_MAX_NEW) for i, p in enumerate(prompts)]),
        stats_c["decode_rounds"])
    int8_launches = _int8_serving(torch, np, card_line, model, serve, prompts, timings,
                                  done_c)
    return launches, int8_launches


def _pool_bytes(cfg, num_pages: int, page_size: int, dtype) -> int:
    """Bytes of the model's page pools (codes and scales), on the meta
    device."""
    from repro_torch.models import attention as attn_lib

    pool = attn_lib.init_paged_kv_cache(cfg, num_pages, page_size, dtype, "meta",
                                        layers=cfg.n_layers)
    return sum(t.numel() * t.element_size() for t in pool)


def _int8_serving(torch, np, card_line: str, model, serve, prompts, timings, done_f32) -> dict:
    """The int8 page pools at OLMo-1B's full width: the serving phase's 8
    requests with Model.kv_dtype = torch.int8 (prefix sharing forced off) on
    backend cuda (launch counts set to 0 just before, read just after) and
    on reference: the same tokens (or a top-2 tie), logits within
    LOGIT_TOL_INT8, the pools' codes at most one step apart (the count that
    differ is printed), equal counters, 0 prefix hits, one flash launch a
    layer per request and one int8-partials launch a layer per decode
    round. Prints the pools'
    bytes beside the float32 pools' and the share of tokens equal to the
    float32 run's (a figure, not a check). Returns the cuda run's
    launches."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import Request

    cfg = model.cfg
    model.kv_dtype = torch.int8
    plain_decode, last = model.decode_step, {}

    def keep_cache(params, cache, batch, **kw):  # the pools as the run leaves them
        out = plain_decode(params, cache, batch, **kw)
        last["cache"] = out[1]
        return out

    model.decode_step = keep_cache
    try:
        undo = _time_model_calls(torch, model, timings)
        runs = {}
        for backend in ("cuda", "reference"):
            serve(backend, [Request(uid=-1, prompt=prompts[1], max_new=2)], batch_size=1)
            timings.clear()
            if backend == "cuda":
                reset_launches()
            done, stats, wall = serve(backend, [Request(uid=i, prompt=p, max_new=SERVE_MAX_NEW)
                                                for i, p in enumerate(prompts)])
            launches = dict(LAUNCHES)
            runs[backend] = (done, stats, launches, last.pop("cache"))
            emit({"phase": "serve", "arch": cfg.name, "kv_dtype": "int8", "backend": backend,
                  **_serve_figures(timings, stats, done, wall),
                  "launches": launches if backend == "cuda" else None, "card": card_line})
        undo()
    finally:
        model.kv_dtype, model.decode_step = None, plain_decode
    (done_c, stats_c, launches, cache_c), (done_r, stats_r, _, cache_r) = \
        runs["cuda"], runs["reference"]
    if [q.uid for q in done_c] != [q.uid for q in done_r] or stats_c != stats_r:
        fail(f"int8 serve: the backends scheduled differently: {stats_c} vs {stats_r}")
    # the pools of the two runs, trash page 0 left out (nobody's): codes at
    # most one step apart, scales within float rounding
    codes_differ, codes_total, scale_rel = 0, 0, 0.0
    for pool_c, pool_r in zip(cache_c["blocks"], cache_r["blocks"]):
        for a, b in zip(pool_c["kv"], pool_r["kv"]):
            a, b = a[:, 1:], b[:, 1:]
            if a.dtype == torch.int8:
                diff = (a.int() - b.int()).abs()
                if int(diff.max()) > 1:
                    fail(f"int8 serve: pool codes differ by {int(diff.max())} steps")
                codes_differ += int((diff > 0).sum())
                codes_total += diff.numel()
            else:
                scale_rel = max(scale_rel, float(((a - b).abs() / b.abs().clamp(min=1e-30)).max()))
    worst, parted = _compare_streams(np, "int8 serve", done_c, done_r, SERVE_MAX_NEW,
                                     LOGIT_TOL_INT8)
    want = {"flash_attention": cfg.n_layers * len(prompts), "paged_attention": 0,
            "paged_attention_quant": cfg.n_layers * stats_c["decode_rounds"]}
    got = {k: launches[k] for k in want}
    if got != want or stats_c["prefix_hits"] != 0:
        fail(f"int8 serve: the cuda run launched {got} with {stats_c['prefix_hits']} prefix "
             f"hits, its schedule predicts {want} and 0")
    by_uid = {q.uid: q.out for q in done_f32}
    same = sum(a == b for q in done_c for a, b in zip(q.out, by_uid[q.uid]))
    n_pages = 1 + SERVE_BATCH * -(-SERVE_MAX_LEN // 8)  # the engine's default pool
    emit({"phase": "serve_compare", "arch": cfg.name, "kv_dtype": "int8",
          "same_tokens": not parted, "parted": parted, "max_logit_diff_rel": worst,
          "logit_tol": LOGIT_TOL_INT8, "pool_codes_one_step_apart": codes_differ,
          "pool_codes": codes_total, "pool_scales_max_rel_diff": scale_rel,
          "prefix_hits": stats_c["prefix_hits"],
          "decode_rounds": stats_c["decode_rounds"], "launches": got, "predicted": want,
          "pool_bytes_int8": _pool_bytes(cfg, n_pages, 8, torch.int8),
          "pool_bytes_float32": _pool_bytes(cfg, n_pages, 8, torch.float32),
          "share_of_tokens_equal_to_float32_run": same / sum(len(q.out) for q in done_c)})
    return launches


def block_sparse_phase(torch, card_line: str) -> dict:
    """The block-sparse entry point, `Backend.block_sparse_attention`, as a
    caller with its own block mask calls it (no model does), at StarCoder2's
    head shapes (24 query heads over 2 kv heads of 128) over a 2048-token
    prompt, with BLOCK_SPARSE_CALLS masks at `attn_block_mask_shape`: the
    band of a 512 window, that band plus the first key block (attention
    sinks), every other column of the causal triangle, and a seeded random
    half. On backend cuda (launch counts set to 0 just before, read just
    after) and on reference: within the tolerance, one launch a call.
    Returns the cuda run's launches."""
    from repro_torch.core.backend import Backend
    from repro_torch.kernels import LAUNCHES, local_attention, ops, reset_launches
    from repro_torch.models.attention import AttnSpec

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    S, Hq, Hkv, D = 2048, 24, 2, 128
    q = torch.randn(1, S, Hq, D, generator=g, device=dev)
    k = torch.randn(1, S, Hkv, D, generator=g, device=dev)
    v = torch.randn(1, S, Hkv, D, generator=g, device=dev)
    pos = torch.arange(S, device=dev)
    nq, nk = ops.attn_block_mask_shape(S, S)
    blocks = pos.reshape(nq, -1)
    band = torch.from_numpy(local_attention.band_live(blocks.cpu(), blocks.cpu(), causal=True,
                                                      window=512)).to(dev)
    sinks = band.clone()
    sinks[:, 0] = True
    tri = torch.ones(nq, nk, dtype=torch.bool, device=dev).tril()
    strided = tri & (torch.arange(nk, device=dev)[None] % 2 == 0)
    strided |= torch.eye(nq, dtype=torch.bool, device=dev)
    random = (torch.rand(nq, nk, generator=g, device=dev) < 0.5) | torch.eye(
        nq, dtype=torch.bool, device=dev)
    masks = [m.int() for m in (band, sinks, strided, random)][:BLOCK_SPARSE_CALLS]
    spec = AttnSpec()
    reset_launches()
    t0 = time.perf_counter()
    outs = [Backend("cuda").block_sparse_attention(q, k, v, pos, pos, m, spec) for m in masks]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    worst = 0.0
    for out, m in zip(outs, masks):
        ref = Backend("reference").block_sparse_attention(q, k, v, pos, pos, m, spec)
        err = float((out - ref).abs().max())
        limit = TOL_REL * float(ref.abs().max()) + TOL_ABS
        if not (bool(torch.isfinite(out).all()) and err <= limit):
            fail(f"block-sparse path: max|cuda - reference| = {err} > {limit}")
        worst = max(worst, err)
    emit({"phase": "block_sparse_path", "calls": len(masks), "mask_shape": [nq, nk],
          "enabled_blocks": [int(m.sum()) for m in masks], "max_abs_err": worst,
          "wall_s": wall, "launches": launches, "card": card_line})
    if launches["block_sparse_attention"] != len(masks):
        fail(f"block-sparse path: {launches['block_sparse_attention']} launches, "
             f"{len(masks)} calls")
    return launches


def _time_model_calls(torch, model, timings: list):
    """Wrap model.prefill, prefill_tail and decode_step so that each call
    appends (kind, token width, seconds) to `timings`, timed on the host
    with a device sync before and after. Returns a function that undoes
    it."""
    plain = (model.prefill, model.prefill_tail, model.decode_step)

    def timed(kind, fn):
        def call(params, *args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(params, *args, **kw)
            torch.cuda.synchronize()
            batch = args[1] if kind == "decode" else args[0]  # decode_step(params, cache, batch)
            timings.append((kind, int(batch["tokens"].shape[1]), time.perf_counter() - t))
            return out
        return call

    model.prefill = timed("prefill", plain[0])
    model.prefill_tail = timed("tail", plain[1])
    model.decode_step = timed("decode", plain[2])

    def undo():
        model.prefill, model.prefill_tail, model.decode_step = plain
    return undo


def _serve_figures(timings: list, stats: dict, done: list, wall: float) -> dict:
    """Prefill ms by kind and width, decode ms a round, tokens per second."""
    prefill_ms: dict = {}
    for kind, width, sec in timings:
        if kind != "decode":
            prefill_ms.setdefault(f"{kind}/{width}", []).append(sec * 1e3)
    decode_s = [sec for kind, _, sec in timings if kind == "decode"]
    n_tok = sum(len(q.out) for q in done)
    return {"requests": len(done), "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
            "stats": stats, "prefill_ms_by_width": prefill_ms,
            "decode_ms_per_round_mean": 1e3 * sum(decode_s) / len(decode_s),
            "decode_ms_per_round_min": 1e3 * min(decode_s), "decode_rounds": len(decode_s),
            "decode_tokens_per_s": (n_tok - len(done)) / sum(decode_s),
            "finish_order": [q.uid for q in done]}


def _compare_streams(np, what: str, done, done_ref, max_new: int,
                     logit_tol: float = LOGIT_TOL) -> tuple[float, list]:
    """Tokens of two runs equal, or parting only at a top-2 tie within
    TIE_MARGIN; logits within `logit_tol` up to the first parting. Returns
    (the largest relative logit difference, the partings)."""
    worst, parted = 0.0, []
    by_uid = {q.uid: q for q in done_ref}
    for q in done:
        p = by_uid[q.uid]
        if len(q.out) != max_new or len(p.out) != max_new:
            fail(f"{what}: request {q.uid} gave {len(q.out)} / {len(p.out)} tokens")
        i = _first_divergence(q, p)
        upto = max_new if i is None else i + 1
        for a, b in zip(q.logits[:upto], p.logits[:upto]):
            if not np.isfinite(a).all():
                fail(f"{what}: request {q.uid}: non-finite logits")
            worst = max(worst, float(np.max(np.abs(a - b) / (1.0 + np.abs(b)))))
        if i is not None:
            top2 = np.sort(p.logits[i])[-2:]
            margin = float(top2[1] - top2[0])
            parted.append({"uid": q.uid, "token": i, "top2_margin": margin})
            if margin > TIE_MARGIN:
                fail(f"{what}: request {q.uid} parts at token {i} with a top-2 margin {margin}")
    if worst > logit_tol:
        fail(f"{what}: logits differ by {worst} > {logit_tol} (relative to 1+|b|)")
    return worst, parted


def starcoder_phase(torch, card_line: str) -> dict:
    """The sliding-window serving path at StarCoder2-3B's full width
    (d_model 3072, 24 query heads over 2 kv heads of 128, window 4096; the
    first SC_LAYERS of its 30 layers), float32, random weights from SEED:
    ServeEngine(batch_size=2, page_size=8) at repro's other defaults (prefix sharing and page
    retirement on, max_len from the requests) serves SC_LENGTHS (two prompts
    past the window, bucket 8192; two of about 300 sharing a 128-token
    prefix, one of them a prefix hit), SC_MAX_NEW greedy tokens each: on
    backend cuda unchunked (every prefill through local_attention), on cuda
    with prefill_chunk SC_CHUNK (the long prefills through chunked_prefill),
    and on reference. The launch counts, decode rounds and retired pages are
    predicted before the runs and checked after; tokens and logits are held
    as in the OLMo-1B phase, and the counters must be equal. Then the
    unchunked cuda run once more under torch.profiler. Returns the launches
    of the two cuda runs."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.chunked_prefill import KV_TILE, chunk_blocks
    from repro_torch.models import Model
    from repro_torch.serving import Request, ServeConfig, ServeEngine
    from repro_torch.serving.engine import bucket_len

    gc.collect()
    torch.cuda.empty_cache()  # the OLMo-1B phase's parameters are gone
    dev = torch.device("cuda")
    cfg = replace(get_config("starcoder2-3b"), n_layers=SC_LAYERS)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev)
    params = model.init(SEED)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    emit({"phase": "serve_model", "arch": cfg.name, "params": n_params,
          "param_bytes": 4 * n_params, "init_s": time.perf_counter() - t0,
          "layers": cfg.n_layers, "d_model": cfg.d_model, "heads": cfg.n_heads,
          "kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
          "window": cfg.sliding_window, "padded_vocab": cfg.padded_vocab})
    r = np.random.default_rng(SEED + 1)
    shared = r.integers(0, cfg.vocab_size, SC_PREFIX)
    prompts = []
    for i, n in enumerate(SC_LENGTHS):
        p = r.integers(0, cfg.vocab_size, n)
        if i in SC_SHARED:
            p[:SC_PREFIX] = shared
        prompts.append(p.astype(np.int32))
    max_len = max(SC_LENGTHS) + SC_MAX_NEW
    W, Ln = cfg.sliding_window, cfg.n_layers

    def serve(backend, chunk, reqs, batch_size=SC_BATCH):
        eng = ServeEngine(model, params, backend=backend, device=dev,
                          config=ServeConfig(batch_size=batch_size, max_len=max_len,
                                             page_size=SC_PAGE, trace_logits=True,
                                             prefill_chunk=chunk))
        t = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        return done, dict(eng.stats), time.perf_counter() - t

    def requests():
        return [Request(uid=i, prompt=p, max_new=SC_MAX_NEW) for i, p in enumerate(prompts)]

    # predicted before the runs: the slots take the requests in pairs, each
    # pair decoding SC_MAX_NEW - 1 rounds; both a solo prefill and a tail
    # prefill attend over the prompt's bucket; a slot retires the pages that
    # slid out of the window after every round but its last
    rounds = (len(prompts) // SC_BATCH) * (SC_MAX_NEW - 1)
    kv = [bucket_len(n) for n in SC_LENGTHS]
    retired = sum(max(0, (n + SC_MAX_NEW - 2 - W + 1) // SC_PAGE) for n in SC_LENGTHS)

    def predicted(chunk):
        chunked = [w for w in kv if chunk and w > chunk]
        return {"local_attention": Ln * (len(kv) - len(chunked)),
                "chunked_prefill": Ln * sum(-(-w // chunk_blocks(chunk, KV_TILE))
                                            for w in chunked),
                "flash_attention": 0, "paged_attention": Ln * rounds}

    emit({"phase": "starcoder_prediction", "decode_rounds": rounds, "pages_retired": retired,
          "prefix_hits": 1, "launches_unchunked": predicted(0),
          "launches_chunked": predicted(SC_CHUNK)})
    # warm-up: cuBLAS at the model's widths and the kernels' first load
    for backend, chunk in (("cuda", 0), ("cuda", SC_CHUNK), ("reference", 0)):
        serve(backend, chunk, [Request(uid=-1, prompt=prompts[0], max_new=1)], batch_size=1)
    timings: list = []
    undo = _time_model_calls(torch, model, timings)
    runs = {}
    for backend, chunk in (("cuda", 0), ("cuda", SC_CHUNK), ("reference", 0)):
        timings.clear()
        reset_launches()
        done, stats, wall = serve(backend, chunk, requests())
        launches = dict(LAUNCHES)
        runs[backend, chunk] = (done, stats, launches)
        emit({"phase": "serve", "arch": cfg.name, "backend": backend, "prefill_chunk": chunk,
              **_serve_figures(timings, stats, done, wall),
              "launches": launches if backend == "cuda" else None, "card": card_line})
    undo()

    done_r, stats_r, _ = runs["reference", 0]
    for (backend, chunk), (done, stats, launches) in runs.items():
        if [q.uid for q in done] != [q.uid for q in done_r] or stats != stats_r:
            fail(f"starcoder2 serve: {backend} chunk {chunk} scheduled differently: {stats} vs "
                 f"{stats_r}")
        if backend == "cuda":
            got = {k: launches[k] for k in ("local_attention", "chunked_prefill",
                                            "flash_attention", "paged_attention")}
            if got != predicted(chunk):
                fail(f"starcoder2 serve: cuda chunk {chunk} launched {got}, predicted "
                     f"{predicted(chunk)}")
    if (stats_r["decode_rounds"], stats_r["pages_retired"], stats_r["prefix_hits"]) != \
            (rounds, retired, 1):
        fail(f"starcoder2 serve: {stats_r}, predicted {rounds} rounds, {retired} pages retired, "
             "1 prefix hit")
    worst, parted = _compare_streams(np, "starcoder2 serve, cuda vs reference",
                                     runs["cuda", 0][0], done_r, SC_MAX_NEW)
    worst_c, parted_c = _compare_streams(np, "starcoder2 serve, cuda chunked vs reference",
                                         runs["cuda", SC_CHUNK][0], done_r, SC_MAX_NEW)
    bitwise = all(a.out == b.out and all(np.array_equal(x, y) for x, y in zip(a.logits, b.logits))
                  for a, b in zip(runs["cuda", 0][0], runs["cuda", SC_CHUNK][0]))
    emit({"phase": "serve_compare", "arch": cfg.name, "same_tokens": not parted,
          "parted": parted, "max_logit_diff_rel": worst,
          "chunked_same_tokens": not parted_c, "chunked_parted": parted_c,
          "chunked_max_logit_diff_rel": worst_c, "chunked_vs_unchunked_bitwise": bitwise,
          "logit_tol": LOGIT_TOL, "tie_margin": TIE_MARGIN, "pages_retired":
          stats_r["pages_retired"], "prefix_hits": stats_r["prefix_hits"],
          "decode_rounds": stats_r["decode_rounds"],
          "launches": {f"{b}/{c}": {k: v for k, v in lc.items() if v}
                       for (b, c), (_, _, lc) in runs.items() if b == "cuda"}})
    prof = _device_profile(torch, lambda: serve("cuda", 0, requests()), top=15)
    emit({"phase": "serve_trace", "what": "4 requests, StarCoder2-3B full width, backend cuda",
          "wall_s_traced": prof["wall_s"], "device_busy_s": prof["busy_us"] * 1e-6,
          "device_idle_share": prof["idle_share"], "device_kernels": prof["kernels"],
          "decode_rounds": rounds, "blocking_runtime_calls": prof["blocking"],
          "top_host_ops_self_us": prof["top_host_ops"],
          "top_device_kernels_us": prof["top_device_kernels"], "card": card_line})
    return {"unchunked": runs["cuda", 0][2], "chunked": runs["cuda", SC_CHUNK][2]}


def recurrent_phase(torch, card_line: str) -> dict:
    """The ring path at RecurrentGemma-9B's full width (RG-LRU blocks and
    local-attention blocks of 16 query heads over 1 kv head of 256, window
    2048; d_model 4096, LRU width 4096, vocab 256,000 tied; the first
    RG_LAYERS of its 38 layers: 14 RG-LRU and 6 local), float32, random
    weights from SEED (made on the card):
    ServeEngine(batch_size=RG_BATCH, max_len=RG_MAX_LEN) at cache "auto",
    which resolves to the ring, serves RG_LENGTHS: a wave of two prompts past
    the window (the ring roll runs; the ring of 2048 wraps) and a third that
    joins the first one's slot when it finishes (a left-padded prefill at the
    batch's position). On backend cuda (launch counts set to 0 just before,
    read just after) and on reference: the same tokens (or a top-2 tie),
    logits within LOGIT_TOL, the same prefill widths and finish order, and
    on cuda exactly the local_attention and decode_attention launches
    predicted before the runs; then the cuda run under torch.profiler.
    Returns the cuda run's launches."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import Model
    from repro_torch.serving import Request, ServeConfig, ServeEngine

    gc.collect()
    torch.cuda.empty_cache()  # the StarCoder2-3B phase's parameters are gone
    dev = torch.device("cuda")
    cfg = replace(get_config("recurrentgemma-9b"), n_layers=RG_LAYERS)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev)
    params = model.init(SEED)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    kinds = [cfg.block_pattern[i % len(cfg.block_pattern)] for i in range(cfg.n_layers)]
    n_local = kinds.count("local")
    emit({"phase": "serve_model", "arch": cfg.name, "params": n_params,
          "param_bytes": 4 * n_params, "init_s": time.perf_counter() - t0,
          "layers": cfg.n_layers, "rglru_layers": kinds.count("rglru"),
          "local_layers": n_local, "d_model": cfg.d_model, "heads": cfg.n_heads,
          "kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
          "window": cfg.sliding_window, "lru_width": cfg.rglru.lru_width,
          "padded_vocab": cfg.padded_vocab, "memory_allocated": torch.cuda.memory_allocated()})
    r = np.random.default_rng(SEED + 2)
    prompts = [r.integers(0, cfg.vocab_size, n).astype(np.int32) for n in RG_LENGTHS]

    def serve(backend, reqs):
        eng = ServeEngine(model, params, backend=backend, device=dev,
                          config=ServeConfig(batch_size=RG_BATCH, max_len=RG_MAX_LEN,
                                             trace_logits=True))
        if eng.cache_mode != "ring":
            fail(f"recurrentgemma serve: cache 'auto' resolved to {eng.cache_mode}, not ring")
        t = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        return done, eng.prefill_widths, time.perf_counter() - t

    def requests():
        return [Request(uid=i, prompt=p, max_new=n)
                for i, (p, n) in enumerate(zip(prompts, RG_MAX_NEW))]

    # predicted before the runs: the wave prefills at its longest prompt; the
    # first request drains after max_new - 1 rounds, the third joins its
    # slot at the position reached and needs max_new - 1 rounds more, the
    # second drains last; one local_attention launch a local layer per
    # prefill, one decode_attention launch a local layer per round
    wave = max(RG_LENGTHS[:RG_BATCH])
    first_done = RG_MAX_NEW[0] - 1
    rounds = max(RG_MAX_NEW[1] - 1, first_done + RG_MAX_NEW[2] - 1)
    widths = {wave, wave + first_done}
    predicted = {"local_attention": 2 * n_local, "decode_attention": n_local * rounds,
                 "flash_attention": 0, "paged_attention": 0, "paged_attention_quant": 0}
    emit({"phase": "recurrentgemma_prediction", "decode_rounds": rounds,
          "prefill_widths": sorted(widths), "finish_order": [0, 2, 1], "launches": predicted})
    for backend in ("cuda", "reference"):  # warm-up: cuBLAS at these widths, the kernels' load
        serve(backend, [Request(uid=-1, prompt=prompts[2][:64], max_new=2)])
    timings: list = []
    undo = _time_model_calls(torch, model, timings)
    runs = {}
    for backend in ("cuda", "reference"):
        timings.clear()
        reset_launches()
        done, prefill_widths, wall = serve(backend, requests())
        launches = dict(LAUNCHES)
        n_rounds = sum(kind == "decode" for kind, _, _ in timings)
        runs[backend] = (done, prefill_widths, launches, n_rounds)
        emit({"phase": "serve", "arch": cfg.name, "backend": backend, "cache": "ring",
              **_serve_figures(timings, {"decode_rounds": n_rounds}, done, wall),
              "prefill_widths": sorted(prefill_widths),
              "launches": launches if backend == "cuda" else None, "card": card_line})
    undo()
    (done_c, widths_c, launches, rounds_c), (done_r, widths_r, _, rounds_r) = \
        runs["cuda"], runs["reference"]
    order = [q.uid for q in done_c]
    if order != [q.uid for q in done_r] or order != [0, 2, 1] or widths_c != widths_r \
            or widths_c != widths or rounds_c != rounds_r or rounds_c != rounds:
        fail(f"recurrentgemma serve: finish order {order} / {[q.uid for q in done_r]}, prefill "
             f"widths {widths_c} / {widths_r}, rounds {rounds_c} / {rounds_r}; predicted "
             f"[0, 2, 1], {widths}, {rounds}")
    got = {k: launches[k] for k in predicted}
    if got != predicted:
        fail(f"recurrentgemma serve: the cuda run launched {got}, predicted {predicted}")
    by_uid = {q.uid: q for q in done_r}
    worst, parted = 0.0, []
    for q in done_c:  # each request's own budget
        w, p = _compare_streams(np, "recurrentgemma serve", [q], [by_uid[q.uid]],
                                RG_MAX_NEW[q.uid])
        worst, parted = max(worst, w), parted + p
    emit({"phase": "serve_compare", "arch": cfg.name, "cache": "ring", "same_tokens": not parted,
          "parted": parted, "max_logit_diff_rel": worst, "logit_tol": LOGIT_TOL,
          "tie_margin": TIE_MARGIN, "decode_rounds": rounds_c,
          "prefill_widths": sorted(widths_c), "launches": got, "predicted": predicted,
          "joined_uid": 2, "joined_entry_width": by_uid[2].entry_width})
    prof = _device_profile(torch, lambda: serve("cuda", requests()), top=15)
    emit({"phase": "serve_trace", "what": "3 requests, RecurrentGemma-9B full width, ring, "
          "backend cuda", "wall_s_traced": prof["wall_s"],
          "device_busy_s": prof["busy_us"] * 1e-6, "device_idle_share": prof["idle_share"],
          "device_kernels": prof["kernels"], "decode_rounds": rounds,
          "blocking_runtime_calls": prof["blocking"],
          "top_host_ops_self_us": prof["top_host_ops"],
          "top_device_kernels_us": prof["top_device_kernels"], "card": card_line})
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def serve_trace(torch, card_line: str, serve_once, rounds: int) -> None:
    """Where the serving run's time goes on the card: the same 8-request run
    on `cuda` once under sync-debug mode (every synchronizing PyTorch call
    warns) and once under torch.profiler (device busy time and idle share,
    blocking runtime calls, the costliest host ops and device kernels)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            serve_once()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sync_warnings = sorted({str(w.message).splitlines()[0] for w in caught})
    prof = _device_profile(torch, serve_once, top=15)
    emit({"phase": "serve_trace", "what": "8 requests, OLMo-1B full width, backend cuda",
          "wall_s_traced": prof["wall_s"], "device_busy_s": prof["busy_us"] * 1e-6,
          "device_idle_share": prof["idle_share"], "device_kernels": prof["kernels"],
          "decode_rounds": rounds, "sync_debug_warnings": len(caught),
          "sync_debug_kinds": sync_warnings, "blocking_runtime_calls": prof["blocking"],
          "top_host_ops_self_us": prof["top_host_ops"],
          "top_device_kernels_us": prof["top_device_kernels"], "card": card_line})


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _near_bth(sel, j: int) -> bool:
    """Whether row j's priority in this run lies within TIE_REL of the run's
    b-th (largest selected) priority."""
    pb = float(sel.priority[sel.idx[-1]])
    pj = float(sel.priority[j])
    return abs(pj - pb) <= TIE_REL * abs(pb)


def _redesign_inputs(torch):
    """The cases the comparison mode times: lr_grad at each shape of
    LR_GRAD_VAL, as the path calls it (one-hot labels, weights 1, l2 0;
    inputs from SEED). Each name maps to (kernel, plain version)."""
    from repro_torch.kernels import lr_grad

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    cases = {}
    for name, n, d, c in LR_GRAD_VAL:
        Xa = torch.cat([torch.randn(n, d - 1, generator=g, device=dev),
                        torch.ones(n, 1, device=dev)], dim=1)
        Y = torch.nn.functional.one_hot(torch.randint(0, c, (n,), generator=g, device=dev),
                                        c).float()
        a = (0.01 * torch.randn(c, d, generator=g, device=dev), Xa, Y,
             torch.ones(n, device=dev), 0.0)
        cases[f"lr_grad/{name}"] = (lambda a=a: lr_grad.lr_grad(*a),
                                    lambda a=a: lr_grad.lr_grad_plain(*a))
    return cases


def redesign_phase(torch, card_line: str, tree: str) -> None:
    """One process of the comparison mode, on the repro_torch it imported
    (this tree's or, with --src, another's): each case of _redesign_inputs
    held against its plain version (the kernels' tolerance) and repeated
    bit for bit, then the device time and host enqueue time of each of 20
    calls (call_times: a slow device time beside a slow enqueue is the
    host's), the host cost (host_us, host_us_min) and lr_grad's launches a
    call; and lr_grad's digests at tests/test_torch_gpu.py's
    LR_GRAD_SHAPES."""
    import importlib.util

    from repro_torch.kernels import LAUNCHES, build

    build.build_all(("lr_grad",))  # before any timing
    for name, (kern, plain) in _redesign_inputs(torch).items():
        before = LAUNCHES["lr_grad"]
        out = kern()
        launches = LAUNCHES["lr_grad"] - before
        ref = plain()
        err = float((out - ref).abs().max())
        limit = TOL_REL * float(ref.abs().max()) + TOL_ABS
        if not (bool(torch.isfinite(out).all()) and err <= limit and torch.equal(out, kern())):
            fail(f"{tree} {name}: max|kernel - plain| = {err} past {limit} or no bitwise "
                 "repeat")
        device, host = call_times(torch, kern)
        emit({"phase": "redesign", "tree": tree, "name": name, "max_abs_err": err,
              "kernel_ms": sum(device) / len(device),
              "kernel_ms_median": sorted(device)[len(device) // 2],
              "kernel_ms_max": max(device), "call_ms": device, "enqueue_ms": host,
              "host_us_per_call": host_us(torch, kern),
              "host_us_per_call_min": host_us_min(torch, kern), "counted_launches": launches,
              "card": card_line})
    spec = importlib.util.spec_from_file_location("gpu_tests", ROOT / "tests/test_torch_gpu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    emit({"phase": "lr_grad_digests", "tree": tree,
          "digests": mod._lr_grad_digests(torch.device("cuda"))})


def compare_mode(parent: str) -> None:
    """The redesigned kernel against the tree at `parent` (a checkout of the
    parent commit) on this card: COMPARE_PROCS fresh processes a side in
    turns (parent, change, change, parent, ...), each running
    redesign_phase; then each case's times side by side, and each tree's
    lr_grad digests (one set a tree: each repeats bit for bit)."""
    import statistics

    runs: dict = {}
    order = [t for i in range(COMPARE_PROCS) for t in
             (("parent", "change") if i % 2 == 0 else ("change", "parent"))]
    for tree in order:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--redesign", tree]
        if tree == "parent":
            cmd += ["--src", str(Path(parent).resolve() / "src")]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            fail(f"the {tree} process failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                rec = json.loads(line)
                if rec.get("phase") in ("redesign", "lr_grad_digests"):
                    print(line, flush=True)
                    runs.setdefault(tree, []).append(rec)
    summary = {}
    for tree, recs in runs.items():
        for rec in recs:
            if rec["phase"] == "redesign":
                entry = summary.setdefault(rec["name"], {}).setdefault(
                    tree, {"ms": [], "ms_median_of_calls": [], "ms_max_of_calls": [],
                           "host_us": [], "host_us_min": []})
                entry["ms"].append(rec["kernel_ms"])
                entry["ms_median_of_calls"].append(rec["kernel_ms_median"])
                entry["ms_max_of_calls"].append(rec["kernel_ms_max"])
                entry["host_us"].append(rec["host_us_per_call"])
                entry["host_us_min"].append(rec["host_us_per_call_min"])
    for name, trees in summary.items():
        for entry in trees.values():
            for key in ("ms", "ms_median_of_calls", "ms_max_of_calls", "host_us", "host_us_min"):
                entry[f"{key}_median"] = statistics.median(entry[key])
    digests = {tree: [r["digests"] for r in recs if r["phase"] == "lr_grad_digests"]
               for tree, recs in runs.items()}
    repeat = all(d == ds[0] for ds in digests.values() for d in ds)
    emit({"phase": "compare_summary", "order": order, "cases": summary,
          "lr_grad_digests": {tree: ds[0] for tree, ds in digests.items()},
          "lr_grad_repeats": repeat})
    if not repeat:
        fail(f"lr_grad's results differ between processes of one tree: {digests}")


def main() -> None:
    args = sys.argv[1:]
    if args[:1] == ["--compare"]:  # --compare PARENT_CHECKOUT
        compare_mode(args[1])
        print(card(), flush=True)
        return
    if "--src" in args:  # import repro_torch from another checkout's src
        sys.path.insert(0, args[args.index("--src") + 1])
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the card")
    import repro_torch  # noqa: F401  (sets full-float32 matmuls)

    if args[:1] == ["--redesign"]:  # --redesign TREE [--src DIR]: one comparison process
        redesign_phase(torch, card(), args[1])
        return

    card_line = card()
    emit({"phase": "start", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "card": card_line})
    seconds: dict = {}  # each phase's wall time on the host clock

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        return out

    timed("build", build_phase)
    timed("sass", sass_phase)
    kern = timed("kernel", kernel_phase, torch, card_line)
    timed("lr_grad", lr_grad_phase, torch, card_line)
    kern.update(timed("attention_kernel", attention_kernel_phase, torch, card_line))
    kern.update(timed("windowed_kernel", windowed_kernel_phase, torch, card_line))
    kern.update(timed("ring_int8_kernel", ring_int8_kernel_phase, torch, card_line))
    serve_launches, int8_launches = timed("serving", serving_phase, torch, card_line)
    sparse_launches = timed("block_sparse", block_sparse_phase, torch, card_line)
    sc_launches = timed("starcoder", starcoder_phase, torch, card_line)
    rg_launches = timed("recurrent", recurrent_phase, torch, card_line)
    timed("determinism", determinism_phase, torch)
    ds, cfg = timed("dataset", dataset_phase, torch)
    timed("loop_retrain", loop_phase, torch, card_line, ds, cfg, "retrain")
    launches, dg_blocking = timed("loop_deltagrad", loop_phase, torch, card_line, ds, cfg,
                                  "deltagrad")
    timed("checkpoint", checkpoint_phase, torch, ds, cfg)
    timed("trace", trace_phase, torch, card_line, ds, cfg)
    timed("pipelined", pipelined_phase, torch, card_line, ds, cfg, dg_blocking)
    del ds, dg_blocking
    timed("annotator", annotator_phase, torch, card_line)
    timed("service", service_phase, torch, card_line)
    timed("stream", stream_phase, torch, card_line)
    emit({"phase": "timing", "seconds": seconds, "total_s": sum(seconds.values())})
    # each kernel's launches from the run of the path it serves
    launches.update({"flash_attention": serve_launches["flash_attention"],
                     "paged_attention": serve_launches["paged_attention"],
                     "block_sparse_attention": sparse_launches["block_sparse_attention"],
                     "local_attention": sc_launches["unchunked"]["local_attention"],
                     "chunked_prefill": sc_launches["chunked"]["chunked_prefill"],
                     "decode_attention": rg_launches["decode_attention"],
                     "paged_attention_quant": int8_launches["paged_attention_quant"]})
    from repro_torch.kernels.build import KERNELS

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": f"{CSRC}/{KERNELS[name]}.cu",
         "replaces": REPLACES[name], "launches": launches[name], **kern[name]}
        for name in REPLACES]})
    print(card(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
