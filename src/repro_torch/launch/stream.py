"""Streaming cleaning command: online CHEF over a synthetic weak-label stream,
cleaning between window arrivals, on the card unless `--device cpu` is given.

  PYTHONPATH=src python -m repro_torch.launch.stream --windows 4 --window_size 100 \
      --backend cuda --rounds_per_window 1
  PYTHONPATH=src python -m repro_torch.launch.stream --device cpu

The flags and defaults are `repro.launch.stream`'s, plus `--device`.
`--backend` selects the compute implementation end to end: `reference`
(plain PyTorch) or `cuda` (the hand-written kernels; on the CPU their plain
versions); with `--model_annotator` the engine serves on it too. Its
default is `repro`'s `reference`, so the card runs the kernels only when
given `--backend cuda` (`StreamingCleaningSession` itself defaults to
`ChefConfig.backend`, `cuda`). `--cold`
switches from warm-start absorption (a DeltaGrad-L replay a window, the
streaming design) to the from-scratch retrain oracle. `--ckpt_dir`
checkpoints after every ingest and round, so a killed run resumes bit for
bit with `--resume`. `--model_annotator` replaces the simulated human vote
by a `ServeEngine` annotation round (`reduced(--arch)` with random weights
from the seed, logits traced; see repro_torch/stream/annotator.py).
"""
from __future__ import annotations

import argparse
import logging
import time

import torch

from repro_torch.configs.chef_lr import ChefConfig
from repro_torch.device import resolve_device
from repro_torch.stream import StreamingCleaningSession, SyntheticStream

log = logging.getLogger("repro_torch.stream")


def parser() -> argparse.ArgumentParser:
    """`repro.launch.stream`'s flags and defaults, plus `--device`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=4)
    ap.add_argument("--window_size", type=int, default=100)
    ap.add_argument("--feature_dim", type=int, default=24)
    ap.add_argument("--backend", default="reference",
                    help="reference | cuda (the hand-written kernels run only with cuda)")
    ap.add_argument("--budget", type=int, default=40)
    ap.add_argument("--round_size", type=int, default=10)
    ap.add_argument("--rounds_per_window", type=int, default=1)
    ap.add_argument("--selector", default="increm", help="full | increm | increm_tight")
    ap.add_argument("--cold", action="store_true",
                    help="warm_start=False: the from-scratch retrain oracle")
    ap.add_argument("--pipelined", action="store_true")
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="restore from --ckpt_dir's latest checkpoint")
    ap.add_argument("--model_annotator", action="store_true",
                    help="annotate through a ServeEngine instead of the simulated human vote")
    ap.add_argument("--arch", default="olmo-1b",
                    help="model config for --model_annotator (reduced)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (raises without one)")
    return ap


def main(argv=None) -> dict:
    """CLI entry; returns the summary dict."""
    ap = parser()
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    source = SyntheticStream(torch.Generator(device).manual_seed(args.seed),
                             window_size=args.window_size, n_windows=args.windows,
                             feature_dim=args.feature_dim, device=device)
    cfg = ChefConfig(budget=args.budget, round_size=args.round_size, n_epochs=8,
                     batch_size=min(400, source.total_rows), lr=0.05, l2=0.05,
                     backend=args.backend, seed=args.seed)

    annotator = None
    if args.model_annotator:
        from repro_torch.configs import get_config, reduced
        from repro_torch.core.backend import get_backend
        from repro_torch.models import Model
        from repro_torch.serving import ServeConfig, ServeEngine
        from repro_torch.stream import ModelAnnotator

        model = Model(reduced(get_config(args.arch)), device=device)
        params = model.init(args.seed + 1)
        engine = ServeEngine(model, params, backend=get_backend(args.backend), device=device,
                             config=ServeConfig(batch_size=4, max_len=args.feature_dim + 16,
                                                trace_logits=True))
        annotator = ModelAnnotator(engine)

    kw = dict(backend=args.backend, warm_start=not args.cold, selector=args.selector,
              constructor="deltagrad", pipelined=args.pipelined, annotator=annotator,
              device=device)
    if args.resume:
        if args.ckpt_dir is None:
            ap.error("--resume requires --ckpt_dir")
        session = StreamingCleaningSession.restore(args.ckpt_dir, source, cfg, **kw)
    else:
        session = StreamingCleaningSession(source, cfg, ckpt_dir=args.ckpt_dir, **kw)

    t0 = time.time()
    result = session.run(rounds_per_window=args.rounds_per_window)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    log.info("streamed %d windows (%d rows), %d rounds in %.2fs (f1_val=%.4f f1_test=%.4f, "
             "warm_start=%s, backend=%s)", session.windows_ingested, session.store.n,
             len(result.history), dt, result.f1_val_final, result.f1_test_final, not args.cold,
             args.backend)
    return {"windows": session.windows_ingested, "rows": session.store.n,
            "rounds": len(result.history), "wall_s": dt, "f1_val": result.f1_val_final,
            "f1_test": result.f1_test_final, "warm_start": not args.cold,
            "backend": args.backend}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    print(main())
