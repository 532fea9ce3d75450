#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one H100: the CHEF
cleaning loop, the paged serving path and the sliding-window serving path.

    python3 chip_smoke.py

1. Builds the ten CUDA kernels from `src/repro_torch/kernels/csrc` (one
   nvcc per source, all nine sources at once) and prints nvcc's
   `-Xptxas -v` report.
2. For each CHEF kernel, at the main path's shapes (the mimic widths of the
   paper's Table 3; replay_correction at r = 1, 3 and 64 changed slots, a
   third of them padded): makes inputs on the card from a fixed seed,
   launches the kernel, holds it against its plain PyTorch version
   (max|kernel - plain| <= 1e-4 * max|plain| + 1e-6), checks that it repeats
   bit for bit, and times both with CUDA events.
3. The same for the two attention kernels at OLMo-1B's full attention
   shapes (16 heads of 128): flash_attention at a 256-token prefill, a tail
   prefill (32 rows over 256 keys), GQA + window + softcap and bf16 (bf16
   outputs: 2^-7 * max|plain|); paged_attention at batch 4 over 32 table
   pages of 8 with a parked slot, and at G = 4 with a window. The flash
   cases also time one F.scaled_dot_product_attention call (float32, the
   same boolean mask) as the library yardstick.
3b. The same for the sliding-window kernels at StarCoder2-3B's attention
   shapes (24 query heads over 2 kv heads of 128, window 4096):
   local_attention at an 8192-token prefill and a tail, chunked_prefill's
   partials there with chunk 2048, block_sparse_attention at 2048 tokens
   with a seeded random mask, paged_attention at StarCoder2's decode shape;
   then, bit for bit, local == flash, chunked + merge == flash,
   block-sparse with an all-ones mask == flash and with the band's mask ==
   local.
4. Serving: OLMo-1B at full width (float32, random weights from SEED) in
   ServeEngine(batch_size=4, max_len=256) at its defaults, prefix sharing
   on, serves 8 requests (prompt buckets 32-256, four sharing a 64-token
   prefix, 16 new tokens each) on backend `cuda` (launch counts set to 0
   just before, read just after) and on `reference`: same tokens (or a
   top-2 tie within 2e-3), logits within 1e-3 * (1 + |ref|), a joined
   request rerun solo gives the same tokens, and exactly 16 flash launches
   per prefill and 16 paged launches per decode round.
4b. The block-sparse entry point, Backend.block_sparse_attention, with four
   block masks at StarCoder2's head shapes on `cuda` (launch counts set to
   0 just before, read just after) and on `reference`.
4c. Serving StarCoder2-3B at full width (float32, random weights from SEED,
   12.7 GB) in ServeEngine(batch_size=2, page_size=8): two prompts past the
   4096 window (bucket 8192) and two of about 300 sharing a 128-token
   prefix, 32 new tokens each, on `cuda` unchunked, on `cuda` with
   prefill_chunk 2048 and on `reference`: the same tokens (or a top-2
   tie), logits within 1e-3 * (1 + |ref|), the same counters, and the
   launches, decode rounds and retired pages predicted before the runs;
   then the unchunked run under torch.profiler.
5. Then `sgd_train` and `deltagrad_replay` on the kernels repeat bit for
   bit, and the CHEF main path, `run_chef(method="infl",
   selector="increm")` on a mimic-shaped dataset made on the card, 3 rounds
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
   the host, run under sync-debug mode, and profiled (device busy time,
   idle share, blocking runtime calls, the costliest host ops).
8. Prints the kernels line (launches from the DeltaGrad-L run on `cuda`,
   for flash and paged attention from the OLMo-1B run on `cuda`, for
   block-sparse attention from phase 4b, for local attention from the
   unchunked and for chunked prefill from the chunked StarCoder2 run), the
   card's name and power limit, and last `{"ok": true, "device": {...}}`.

Any failure exits non-zero. Needs a CUDA device; imports nothing of JAX or of
the JAX package.
"""
from __future__ import annotations

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
TOL_REL, TOL_ABS = 1e-4, 1e-6  # kernel vs plain: max|diff| <= TOL_REL * max|plain| + TOL_ABS
TIE_REL = 1e-3  # a row only one run selected must lie this close to a run's b-th priority
F1_TOL = 0.005  # final test F1, cuda run vs reference run
N, D, C, BS, N_VAL = 78_487, 2049, 2, 2000, 579  # mimic: Table 3 sizes, D = 2048 + 1
SEED = 0
CSRC = "src/repro_torch/kernels/csrc"
ROUNDS, B = 3, 10  # cleaning rounds of the main path, labels a round
CORR_R = (1, 3, 64)  # changed slots of a replay step in the kernel phase
LINE_R = 3  # the r reported in the kernels line: a mimic replay step changes 1-3 rows
TRACE_STEPS = 600  # replay steps the trace phase profiles (59 of them explicit)
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
}
CHEF_KERNELS = ("lr_grad", "lr_hvp", "minibatch_grad", "infl_scores", "replay_correction")
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
BF16_TOL_REL = 2.0**-7  # bf16 outputs: each side rounds once, so they may sit one bf16 step apart
# the serving path: OLMo-1B at full width, random weights from SEED
SERVE_LENGTHS = (70, 20, 140, 100, 45, 200, 90, 180)  # prompt buckets 32 to 256
SERVE_SHARED = (0, 2, 3, 5)  # these requests share a 64-token prefix (2 per block class)
SERVE_PREFIX, SERVE_MAX_NEW, SERVE_BATCH, SERVE_MAX_LEN = 64, 16, 4, 256
SERVE_JOINED = 5  # a request admitted mid-stream (a prefix hit), rerun solo
LOGIT_TOL = 1e-3  # cuda vs reference logits: |a - b| <= LOGIT_TOL * (1 + |b|)
TIE_MARGIN = 2 * LOGIT_TOL  # tokens may part only where the top-2 logits lie this close
# the sliding-window path: StarCoder2-3B at full width (window 4096), random
# weights from SEED; two long prompts past the window (bucket 8192) and two
# short ones sharing a page-aligned prefix, 32 new tokens each
SC_LENGTHS = (5000, 6000, 300, 310)
SC_SHARED = (2, 3)  # these share SC_PREFIX tokens: the second admitted is a prefix hit
SC_PREFIX, SC_MAX_NEW, SC_BATCH, SC_PAGE = 128, 32, 2, 8
SC_CHUNK = 2048  # the chunked run's prefill_chunk
SC_SEQ = 8192  # the kernel phase's prefill width: the long prompts' bucket
BLOCK_SPARSE_CALLS = 4  # Backend.block_sparse_attention calls of the block-sparse phase


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


def time_ms(torch, fn, reps: int = 20) -> float:
    """Mean device time of fn() in ms, by CUDA events. Before each call L2
    (50 MB) is flushed, as the loop finds its inputs there, and the stream
    is held by a sleep so that the host's launch time is not counted."""
    flush = torch.empty(32 * 2**20, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def bound(bytes_moved: float, ops: float,
          ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """Least time in ms: bytes over the memory rate or operations over the
    peak rate of their type (float32 unless given), whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_report(log: str) -> list[str]:
    """One line per compiled function from nvcc's -Xptxas -v output:
    registers, shared memory and spills."""
    lines, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN4chef(\d+)(\w+)'", line)
        if m:
            n = int(m.group(1))
            base, rest = m.group(2)[:n], m.group(2)[n:]
            targs = rest.split("EEv")[0] if rest.startswith("I") else ""
            args = re.findall(r"Li(\d+)E", targs)
            if "bfloat16" in targs or re.search(r"[EI]f(?:L|$)", targs):
                args.append("bf16" if "bfloat16" in targs else "f32")
            args += [f"mask={b}" for b in re.findall(r"Lb([01])E", targs)]
            name = base + (f"<{','.join(args)}>" if args else "")
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


def kernel_phase(torch, card_line: str) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.kernels import (LAUNCHES, infl_scores, lr_grad, lr_hvp, minibatch_grad,
                                     replay_correction)

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
        "lr_hvp": (lambda: lr_hvp.lr_hvp(w, v, Xa, gw, 0.05),
                   lambda: lr_hvp.lr_hvp_plain(w, v, Xa, gw, 0.05),
                   [N, D, C], f * (N * D + N + 3 * C * D), 6.0 * N * C * D),
        "minibatch_grad": (lambda: minibatch_grad.minibatch_grad(w, Xa, Y, gw, next_idx(), 0.05),
                           lambda: minibatch_grad.minibatch_grad_plain(w, Xa, Y, gw, next_idx(),
                                                                       0.05),
                           [N, D, C, BS], f * (BS * D + BS * C + BS + 2 * C * D) + 8.0 * BS,
                           4.0 * BS * C * D),
        "infl_scores": (lambda: infl_scores.infl_scores(v, Xa, P, Y, 0.8),
                        lambda: infl_scores.infl_scores_plain(v, Xa, P, Y, 0.8),
                        [N, D, C], f * (N * D + 3 * N * C + C * D), 2.0 * N * C * D + 6.0 * N * C),
    }
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
        emit({"phase": "kernel", "name": name, "shape": shape, "max_abs_err": err,
              "tolerance": f"max|kernel-plain| <= {TOL_REL}*max|plain| + {TOL_ABS} = {limit}",
              "bitwise_repeat": True, "kernel_ms": ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "card": card_line,
              "launches": dict(LAUNCHES)})
    results["replay_correction"] = results[f"replay_correction/r={LINE_R}"]
    return results


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


def loop_phase(torch, card_line: str, ds, cfg, constructor: str) -> dict:
    """run_chef(method="infl", selector="increm", constructor) on the mimic
    shape, backend cuda then reference. Returns the cuda run's launches."""
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
    return launches


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
    TRACE_STEPS steps of a mimic replay (10 rows cleaned), once untraced
    (host clock) and once under sync-debug mode (every synchronizing PyTorch
    call warns), then once under torch.profiler: the union of the kernels'
    device intervals against the host wall (the device's idle share), the
    CUDA runtime calls that block the host, and the host ops that cost the
    most."""
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
    t0 = time.perf_counter()
    replay()
    torch.cuda.synchronize()
    wall_untraced = time.perf_counter() - t0
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
          "steps": n, "host_us_per_step_untraced": wall_untraced / n * 1e6,
          "host_us_per_step_traced": prof["wall_s"] / n * 1e6,
          "device_busy_us_per_step": prof["busy_us"] / n, "device_kernels": prof["kernels"],
          "device_idle_share": prof["idle_share"],
          "sync_debug_warnings": sync_warnings, "blocking_runtime_calls": prof["blocking"],
          "top_host_ops_self_us_per_step": [
              [k, c / n, us / n] for k, c, us in prof["top_host_ops"]],
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
            BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S, card_line,
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
        ids = (torch.randperm(n_phys - 1, generator=g, device=dev) + 1).int()
        table = torch.zeros(B, n_table, dtype=torch.int32, device=dev)
        pos = torch.zeros(B, dtype=torch.int32, device=dev)
        # three live slots at positions 217, 100 and 37 with their whole
        # 32-page allocation; the last slot parked (all trash, position 0)
        for b, p in enumerate((217, 100, 37)):
            table[b] = ids[b * n_table:(b + 1) * n_table]
            pos[b] = p
        kpos0 = torch.arange(n_table, device=dev) * P  # first position of each page
        live = (table != 0) & (kpos0[None] <= pos[:, None])
        if window:
            live &= kpos0[None] + P - 1 > pos[:, None] - window
        n_live = float(live.sum())
        nbytes = (4.0 * (B * Hkv * G * D + 2 * n_live * P * Hkv * D + B * n_table + B)
                  + 4.0 * B * Hkv * n_table * G * (D + 2))
        ops_n = 4.0 * G * D * P * n_live * Hkv
        kw = dict(window=window)
        a = (q, k_pages, v_pages, table, pos)
        results[name] = _check_and_time(
            torch, name, lambda a=a: paged_attention.paged_attention_partials(*a, **kw),
            lambda a=a: paged_attention.paged_attention_partials_reference(*a, **kw), None,
            [B, Hkv, G, D, P, n_table, n_phys, window], nbytes, ops_n, FP32_OPS_PER_S,
            card_line, pairs=lambda out, ref, name=name: _partial_pairs(torch, name, out, ref))
    return results


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
            attn_bytes(a, a[0].numel()), 4.0 * D * Hq * float(vis.sum()), FP32_OPS_PER_S,
            card_line, library_computes="SDPA, float32, the boolean band mask")
    for name, a in (("chunked_prefill", prefill), ("chunked_prefill/tail", tail)):
        vis = band(a[3], a[4], W)
        Sq = a[0].shape[1]
        results[name] = _check_and_time(
            torch, name, lambda a=a: ops.chunked_prefill_partials(*a, spec, SC_CHUNK),
            lambda a=a: ops.chunked_prefill_partials_ref(*a, spec, SC_CHUNK), sdpa(a, vis),
            [1, Sq, a[1].shape[1], Hq, Hkv, D, int(a[3][0]), W, SC_CHUNK, "float32"],
            attn_bytes(a, Hq * Sq * (D + 2)), 4.0 * D * Hq * float(vis.sum()), FP32_OPS_PER_S,
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
        4.0 * D * Hq * float(vis.sum()), FP32_OPS_PER_S, card_line,
        library_computes="SDPA, float32, the block mask expanded to elements and the causal "
                         "mask (a row with no enabled key gives NaN there, 0 in the kernel)")

    # the decode kernel at StarCoder2's decode shape: two slots 31 tokens into
    # prompts of 5000 and 6000, whole pages past the window retired
    n_table, P = -(-(max(SC_LENGTHS) + SC_MAX_NEW) // SC_PAGE), SC_PAGE
    n_phys = 1 + 2 * n_table
    q = torch.randn(2, Hkv, Hq // Hkv, D, generator=g, device=dev)
    k_pages = torch.randn(n_phys, P, Hkv, D, generator=g, device=dev)
    v_pages = torch.randn(n_phys, P, Hkv, D, generator=g, device=dev)
    ids = (torch.randperm(n_phys - 1, generator=g, device=dev) + 1).int()
    table = torch.zeros(2, n_table, dtype=torch.int32, device=dev)
    pos = torch.tensor([SC_LENGTHS[0] + SC_MAX_NEW - 1, SC_LENGTHS[1] + SC_MAX_NEW - 1],
                       dtype=torch.int32, device=dev)
    for b in range(2):
        need = -(-(SC_LENGTHS[b] + SC_MAX_NEW) // P)
        table[b, :need] = ids[b * n_table:b * n_table + need]
        table[b, :(int(pos[b]) - W) // P] = 0  # retired
    kpos0 = torch.arange(n_table, device=dev) * P
    live = (table != 0) & (kpos0[None] <= pos[:, None]) & (kpos0[None] + P - 1 > pos[:, None] - W)
    n_live = float(live.sum())
    G = Hq // Hkv
    a = (q, k_pages, v_pages, table, pos)
    results["paged_attention/starcoder2"] = _check_and_time(
        torch, "paged_attention/starcoder2",
        lambda: paged_attention.paged_attention_partials(*a, window=W),
        lambda: paged_attention.paged_attention_partials_reference(*a, window=W), None,
        [2, Hkv, G, D, P, n_table, n_phys, W],
        4.0 * (q.numel() + 2 * n_live * P * Hkv * D + table.numel() + 2)
        + 4.0 * 2 * Hkv * n_table * G * (D + 2), 4.0 * G * D * P * n_live * Hkv,
        FP32_OPS_PER_S, card_line,
        pairs=lambda out, ref: _partial_pairs(torch, "paged_attention/starcoder2", out, ref))

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
    it. Returns the cuda run's launches and figures."""
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
            "decode_tokens_per_s": stats["slot_rounds"] / sum(decode_s),
            "finish_order": [q.uid for q in done]}


def _compare_streams(np, what: str, done, done_ref, max_new: int) -> tuple[float, list]:
    """Tokens of two runs equal, or parting only at a top-2 tie within
    TIE_MARGIN; logits within LOGIT_TOL up to the first parting. Returns
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
    if worst > LOGIT_TOL:
        fail(f"{what}: logits differ by {worst} > {LOGIT_TOL} (relative to 1+|b|)")
    return worst, parted


def starcoder_phase(torch, card_line: str) -> dict:
    """The sliding-window serving path at StarCoder2-3B's full width (30
    layers, d_model 3072, 24 query heads over 2 kv heads of 128, window
    4096), float32, random weights from SEED: ServeEngine(batch_size=2,
    page_size=8) at repro's other defaults (prefix sharing and page
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
    import gc

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
    cfg = get_config("starcoder2-3b")
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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the card")
    import repro_torch  # noqa: F401  (sets full-float32 matmuls)

    card_line = card()
    emit({"phase": "start", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "card": card_line})
    build_phase()
    kern = kernel_phase(torch, card_line)
    kern.update(attention_kernel_phase(torch, card_line))
    kern.update(windowed_kernel_phase(torch, card_line))
    serve_launches = serving_phase(torch, card_line)
    sparse_launches = block_sparse_phase(torch, card_line)
    sc_launches = starcoder_phase(torch, card_line)
    determinism_phase(torch)
    ds, cfg = dataset_phase(torch)
    loop_phase(torch, card_line, ds, cfg, "retrain")
    launches = loop_phase(torch, card_line, ds, cfg, "deltagrad")
    checkpoint_phase(torch, ds, cfg)
    trace_phase(torch, card_line, ds, cfg)
    # each kernel's launches from the run of the path it serves
    launches.update({"flash_attention": serve_launches["flash_attention"],
                     "paged_attention": serve_launches["paged_attention"],
                     "block_sparse_attention": sparse_launches["block_sparse_attention"],
                     "local_attention": sc_launches["unchunked"]["local_attention"],
                     "chunked_prefill": sc_launches["chunked"]["chunked_prefill"]})
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
