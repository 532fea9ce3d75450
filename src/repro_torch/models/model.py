"""Public model API of the serving path (the port of `repro/models/model.py`
for attention-only decoders):

    model = Model(get_config("olmo-1b"))          # on the card
    params = model.init(0)
    logits, cache = model.prefill(params, {"tokens": tokens})
    logits, cache = model.decode_step(params, paged_cache, {"tokens": nxt})

Parameters live on `model.device` in `param_dtype`; every serving call
routes its attention through the `Backend` it is given (`reference` |
`cuda`; `reference` when none is).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import get_backend
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


class Model:
    def __init__(self, cfg: ModelConfig, param_dtype=torch.float32, device=None):
        self.cfg = cfg
        self.param_dtype = param_dtype
        self.device = resolve_device(device)
        # torch.int8 would select int8 page pools (not ported yet)
        self.kv_dtype = None

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0) -> dict:
        """Random parameters from `seed` (one torch.Generator on the model's
        device, `repro`'s draw order and fan-in scaling)."""
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        return T.init_params(self.cfg, L.Creator(g, self.param_dtype, self.device))

    def init_cache(self, batch: int, seq_len: int, dtype=None, full: bool = False) -> dict:
        return T.init_cache(self.cfg, batch, seq_len, dtype or self.param_dtype, self.device,
                            full=full)

    def init_paged_cache(self, batch: int, num_pages: int, page_size: int, table_pages: int,
                         dtype=None) -> dict:
        """Paged serving cache in the param dtype, so committed prefill K/V
        round-trip exactly."""
        if self.kv_dtype == torch.int8:
            dtype = torch.int8
        return T.init_paged_cache(self.cfg, batch, num_pages, page_size, table_pages,
                                  dtype or self.param_dtype, self.device)

    # --------------------------------------------------------------- helpers
    def _embed_in(self, params, batch: dict) -> torch.Tensor:
        return L.embed_tokens(self.cfg, params["embed"], batch["tokens"].long(),
                              dtype=self.param_dtype)

    def _head(self, params, h) -> torch.Tensor:
        hid = L.apply_norm(self.cfg, params["final_norm"], h)
        return L.lm_logits(self.cfg, params["embed"], hid)

    @staticmethod
    def _take(hidden, last_pos) -> torch.Tensor:
        """hidden[b, last_pos[b]] -> [B, 1, d]."""
        idx = last_pos.long().to(hidden.device)[:, None, None].expand(-1, 1, hidden.shape[-1])
        return torch.gather(hidden, 1, idx)

    # ----------------------------------------------------------------- serve
    def prefill(self, params, batch: dict, *, cache_len: Optional[int] = None, backend=None,
                last_pos=None, full_cache: bool = False, prefill_chunk: int = 0):
        """Full-prompt forward -> (logits [B, 1, V] at position -1, or at
        `last_pos` [B] for right-padded prompts, and the dense KV cache of
        capacity `cache_len` (default the prompt width))."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        cache = self.init_cache(B, cache_len or S, full=full_cache)
        pos = torch.arange(S, device=self.device)
        out = T.run_stack(self.cfg, params, self._embed_in(params, batch), mode="prefill",
                          cache=cache, pos=pos, backend=get_backend(backend),
                          prefill_chunk=prefill_chunk)
        h_last = out.hidden[:, -1:] if last_pos is None else self._take(out.hidden, last_pos)
        return self._head(params, h_last), out.cache

    def prefill_tail(self, params, batch: dict, paged_cache: dict, *, page_row, share_pages: int,
                     kv_len: int, last_pos, backend=None, prefill_chunk: int = 0):
        """Tail-only prefill of a prefix-sharing admission: the unshared tail
        tokens [1, W_t] (right-padded), at absolute positions from
        share_pages * P, attend over the shared-prefix K/V in the pages of
        `page_row` at the solo run's kv width `kv_len`. Returns (logits at the
        last real tail row `last_pos` [1], the dense tail cache)."""
        tokens = batch["tokens"]
        B, W_t = tokens.shape
        assert B == 1, "tail prefill is per slot (batch 1)"
        dense = self.init_cache(B, W_t, full=True)

        def graft(dn, pl):
            return {"kv": dn["kv"], "pool": pl["kv"]}

        cache = {"blocks": tuple(graft(d, p) for d, p in zip(dense["blocks"],
                                                             paged_cache["blocks"])),
                 "tail": tuple(graft(d, p) for d, p in zip(dense["tail"], paged_cache["tail"])),
                 "pos": torch.zeros((), dtype=torch.int32, device=self.device),
                 "pages": page_row.to(device=self.device, dtype=torch.int32)[None]}
        first_pool = (paged_cache["blocks"] or paged_cache["tail"])[0]["kv"]
        pos = share_pages * first_pool.page_size + torch.arange(W_t, device=self.device)
        out = T.run_stack(self.cfg, params, self._embed_in(params, batch), mode="tail",
                          cache=cache, pos=pos, backend=get_backend(backend),
                          share_pages=share_pages, kv_len=kv_len, prefill_chunk=prefill_chunk)
        return self._head(params, self._take(out.hidden, last_pos)), out.cache

    def decode_step(self, params, cache: dict, batch: dict, *, backend=None):
        """One decode step over the paged cache: tokens [B, 1], each slot at
        its own position cache["pos"] [B]; writes the new K/V into the pages
        in place -> (logits [B, 1, V], the cache with pos + 1)."""
        if cache["pos"].ndim != 1:
            raise NotImplementedError("decode over the ring cache (one shared position) is "
                                      "not ported to repro_torch yet; see ROADMAP.md queue 1")
        out = T.run_stack(self.cfg, params, self._embed_in(params, batch), mode="decode",
                          cache=cache, pos=cache["pos"], backend=get_backend(backend))
        return self._head(params, out.hidden), out.cache
