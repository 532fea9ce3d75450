"""Batched serving command: initialises a model from a seed and serves a wave
of greedy-decode requests through `ServeEngine`, on the card unless
`--device cpu` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --backend cuda

The flags and defaults are `repro.launch.serve`'s, plus `--device`. As
there, the model is `reduced(get_config(arch))` with random weights from
`--seed`, and the command returns (and logs) the same summary dict.
`--backend` is `reference` (plain PyTorch) or `cuda` (the hand-written
attention kernels). `--cache auto` serves an attention-only arch from the
paged cache and an arch with recurrent blocks (`--arch recurrentgemma-9b`)
from the ring cache; `--cache ring` takes the ring for any arch. A
sliding-window arch (`--arch starcoder2-3b`, or `--attn window:<W>`)
prefills through the banded kernel and, paged, retires pages that slid out
of its window; `--prefill_chunk N` > 0 prefills a KV span longer than N in
chunks. `--kv_dtype int8` serves from int8 page pools (or an int8 ring);
as in `repro`, `--kv_dtype bf16` leaves the paged pools in the param dtype
and rounds the prefill's K/V through bf16. `--spec_k K` > 1 turns on
speculative decode with K rows a verify step (paged cache; not with int8
pools). A MoE arch (`--arch qwen3-moe-30b-a3b`, `--arch mixtral-8x22b`) runs
its reduced form's 4 experts, top 2.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \
      --attn window:16 --prefill_chunk 16 --prompt_len 40 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b \
      --prompt_len 40 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --kv_dtype int8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \
      --spec_k 4 --device cpu
"""
from __future__ import annotations

import argparse
import logging
import time
from dataclasses import replace as dc_replace

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.backend import get_backend
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.serving.engine import Request, ServeConfig, ServeEngine

log = logging.getLogger("repro_torch.serve")


def parser() -> argparse.ArgumentParser:
    """`repro.launch.serve`'s flags and defaults, plus `--device`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt_len", type=int, default=32)
    ap.add_argument("--max_new", type=int, default=16)
    ap.add_argument("--backend", default="reference", help="reference | cuda")
    ap.add_argument("--cache", default="auto", help="auto | paged | ring")
    ap.add_argument("--page_size", type=int, default=8,
                    help="tokens per physical page (paged cache)")
    ap.add_argument("--share_prefix", action=argparse.BooleanOptionalAction, default=True,
                    help="alias block-aligned shared prompt prefixes (paged)")
    ap.add_argument("--prefix_len", type=int, default=0,
                    help="common prompt prefix length across requests "
                         "(0 = fully independent prompts)")
    ap.add_argument("--spec_k", type=int, default=0,
                    help="speculative decode rows per step (<=1 = off)")
    ap.add_argument("--prefill_chunk", type=int, default=0,
                    help="chunked-prefill KV span in tokens (0 = full-width flash prefill)")
    ap.add_argument("--prefix_cap", type=int, default=0,
                    help="max warm prefix-index entries, LRU-evicted past the cap "
                         "(0 = unbounded)")
    ap.add_argument("--attn", default="",
                    help="attention-pattern override: 'window:<W>' or 'full'; empty keeps "
                         "the arch pattern")
    ap.add_argument("--kv_dtype", default="", choices=["", "int8", "bf16"],
                    help="KV cache dtype override: int8, bf16, or empty = the model's "
                         "param dtype")
    ap.add_argument("--retire_pages", action=argparse.BooleanOptionalAction, default=True,
                    help="free block-table pages that slid fully out of the attention "
                         "window (windowed archs only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (raises without one)")
    return ap


def main(argv=None) -> dict:
    """CLI entry; returns the summary dict."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = reduced(get_config(args.arch))
    if args.attn:
        if args.attn == "full":
            cfg = dc_replace(cfg, attn_kind="full", sliding_window=0)
        elif args.attn.startswith("window:"):
            cfg = dc_replace(cfg, attn_kind="sliding",
                             sliding_window=int(args.attn.split(":", 1)[1]))
        else:
            raise SystemExit(f"unknown --attn {args.attn!r} (want 'window:<W>' or 'full')")
    model = Model(cfg, device=device)
    model.kv_dtype = {"int8": torch.int8, "bf16": torch.bfloat16, "": None}[args.kv_dtype]
    params = model.init(args.seed)
    engine = ServeEngine(
        model, params, backend=get_backend(args.backend), device=device,
        config=ServeConfig(batch_size=args.batch, max_len=args.prompt_len + args.max_new,
                           cache=args.cache, page_size=args.page_size,
                           share_prefix=args.share_prefix, spec_k=args.spec_k,
                           prefill_chunk=args.prefill_chunk, prefix_cap=args.prefix_cap,
                           retire_pages=args.retire_pages))
    rng = np.random.default_rng(args.seed)
    pl = min(args.prefix_len, args.prompt_len)
    shared = rng.integers(0, cfg.vocab_size, pl)
    reqs = [Request(uid=i, prompt=np.concatenate([
        shared, rng.integers(0, cfg.vocab_size, args.prompt_len - pl)]).astype(np.int64),
        max_new=args.max_new) for i in range(args.requests)]
    t0 = time.time()
    done = engine.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    n_tok = sum(len(r.out) for r in done)
    stats = engine.stats
    hit_rate = stats.get("prefix_hit_tokens", 0) / max(stats.get("prompt_tokens", 0), 1)
    log.info("served %d requests, %d tokens in %.2fs (%.1f tok/s, backend=%s, cache=%s, "
             "prefix_hit_rate=%.2f, prefill_chunk=%d, window=%d)", len(done), n_tok, dt,
             n_tok / dt, args.backend, engine.cache_mode, hit_rate, args.prefill_chunk,
             cfg.sliding_window)
    return {"requests": len(done), "tokens": n_tok, "wall_s": dt, "backend": args.backend,
            "cache": engine.cache_mode, "prefix_hit_rate": hit_rate, "stats": dict(stats),
            "prefill_chunk": args.prefill_chunk, "window": cfg.sliding_window}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    print(main())
