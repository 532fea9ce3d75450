#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of CHEF (`src/repro_torch`) on one H100.

    python3 chip_smoke.py

1. Builds the five CUDA kernels from `src/repro_torch/kernels/csrc` (one nvcc
   per source, all at once) and prints nvcc's `-Xptxas -v` report.
2. For each kernel, at the main path's shapes (the mimic widths of the
   paper's Table 3; replay_correction at r = 1, 3 and 64 changed slots, a
   third of them padded): makes inputs on the card from a fixed seed,
   launches the kernel, holds it against its plain PyTorch version
   (max|kernel - plain| <= 1e-4 * max|plain| + 1e-6), checks that it repeats
   bit for bit, and times both with CUDA events. Then checks that
   `sgd_train` and `deltagrad_replay` on the kernels repeat bit for bit.
3. Drives the main path, `run_chef(method="infl", selector="increm")` on a
   mimic-shaped dataset made on the card, 3 rounds of 10 labels, Table 4's
   lr, l2 and epochs: first with constructor "retrain", then with the
   default, DeltaGrad-L. Each runs on backend `cuda` (launch counts set to 0
   just before, read just after) and on backend `reference`. Both backends
   must select the same rows each round, or differ only at a priority tie,
   and end within 0.005 F1. The DeltaGrad-L run on `cuda` must launch
   minibatch_grad and replay_correction exactly as often as its schedule
   predicts.
4. Checkpoint: a DeltaGrad-L session on `cuda` runs 2 rounds, saving after
   each; a fresh session restored from round 1 runs round 2 again and must
   end bit for bit where the uninterrupted one did (same rows, same w, same
   trajectory).
5. Trace: the first 600 steps of a DeltaGrad-L replay on `cuda`, timed on
   the host, run under sync-debug mode, and profiled (device busy time,
   idle share, blocking runtime calls, the costliest host ops).
6. Prints the kernels line (launches from the DeltaGrad-L run on `cuda`),
   the card's name and power limit, and last `{"ok": true, "device": {...}}`.

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
}


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


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """Least time in ms: bytes over the memory rate or operations over the
    float32 rate, whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
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
            args = re.findall(r"Li(\d+)E", rest.split("EEv")[0]) if rest.startswith("I") else []
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
    path = [k for k in REPLACES if k != "replay_correction" or constructor == "deltagrad"]
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


def trace_phase(torch, card_line: str, ds, cfg) -> None:
    """Where a DeltaGrad-L replay step's time goes on the card: the first
    TRACE_STEPS steps of a mimic replay (10 rows cleaned), once untraced
    (host clock) and once under sync-debug mode (every synchronizing PyTorch
    call warns), then once under torch.profiler: the union of the kernels'
    device intervals against the host wall (the device's idle share), the
    CUDA runtime calls that block the host, and the host ops that cost the
    most."""
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        replay()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # union of the device intervals, in us
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    blocking = {e.key: e.count for e in host
                if "Synchronize" in e.key or e.key in ("cudaMemcpy", "cudaStreamWaitEvent")}
    top = sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    emit({"phase": "trace", "what": "deltagrad_replay, backend cuda, mimic widths",
          "steps": n, "host_us_per_step_untraced": wall_untraced / n * 1e6,
          "host_us_per_step_traced": wall / n * 1e6,
          "device_busy_us_per_step": busy / n, "device_kernels": len(spans),
          "device_idle_share": 1.0 - busy / (wall * 1e6),
          "sync_debug_warnings": sync_warnings, "blocking_runtime_calls": blocking,
          "top_host_ops_self_us_per_step": [
              [e.key, e.count / n, e.self_cpu_time_total / n] for e in top],
          "card": card_line})


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
    determinism_phase(torch)
    ds, cfg = dataset_phase(torch)
    loop_phase(torch, card_line, ds, cfg, "retrain")
    launches = loop_phase(torch, card_line, ds, cfg, "deltagrad")
    checkpoint_phase(torch, ds, cfg)
    trace_phase(torch, card_line, ds, cfg)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": f"{CSRC}/{name}.cu",
         "replaces": REPLACES[name], "launches": launches[name], **kern[name]}
        for name in REPLACES]})
    print(card(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
