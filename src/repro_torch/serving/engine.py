"""Continuous-batching greedy serving over a paged KV cache or a ring cache
(the port of `repro/serving/engine.py`).

Two cache disciplines, selected by `ServeConfig.cache`:

* ``paged`` (the default for attention-only decoder archs): each admitted
  request gets pages from a shared physical pool for
  ceil((prompt + budget) / page_size) tokens, is prefilled alone at a
  power-of-two bucket of its prompt length (right-padded: the causal mask
  is the pad mask), and decodes at its own absolute positions; a block
  table maps each slot's logical pages to physical ones, page 0 being the
  trash page of parked slots and pad rows. A full-attention arch prefills
  through `Backend.flash_attention`, and every decode step goes through
  `Backend.paged_decode_attention`.
* ``ring`` (the default for archs with recurrent blocks, such as
  RecurrentGemma-9B's RG-LRU layers; `repro`'s differential oracle on an
  attention-only arch): one ring cache for the whole batch with ONE shared
  position. A wave of up to batch_size requests is prefilled together,
  left-padded to its longest prompt, into a ring of `max_len` positions
  (the window's for local blocks, written at slot t % W); a request that
  joins a freed slot mid-stream is prefilled left-padded to the batch's
  current position, at the full batch width, and its slot of every cache
  leaf (K/V and the RG-LRU states alike) is spliced into the running cache.
  Every decode step goes through `Backend.decode_attention` with the
  ring's slot mask.

Prefix sharing (`ServeConfig.share_prefix`, on by default, paged only):
admission keys every full page a committed prompt covers in a prefix index
(exact token bytes). A later prompt that extends an indexed page-aligned
prefix aliases those pages in its block table and prefills only its
unshared tail (`Model.prefill_tail`, at the solo run's kv width). Pages are
refcounted on the host (mirrored on the card as `cache["refcount"]`):
index entries and table rows each hold a reference, a page frees at zero,
and a write aimed at a shared page first copies it (copy-on-write). Index
entries are evicted newest chain first under pool pressure, least recently
used first past `prefix_cap`. The pool and the index persist across
`run()` waves, so a later wave's repeated prefix aliases pages an earlier
wave prefilled.

Sliding-window archs prefill through `Backend.local_attention` (the banded
kernel), and with `ServeConfig.prefill_chunk > 0` a prefill whose KV span
exceeds the chunk goes through `Backend.chunked_prefill`. For a windowed arch
the paged engine also retires pages (`ServeConfig.retire_pages`, on by
default): after each decode round every block-table entry whose whole page
has slid out of the window is pointed at the trash page and unpinned,
freed once no table row or index entry holds it. Such a page's keys all
fail the decode kernel's `kpos > pos - window` test, so its partial was
already the neutral one the trash page gives: retiring changes no output.

With `Model.kv_dtype = torch.int8` the paged pools hold int8 codes and one
float32 scale per (page, kv head) (`attention.QuantPagedKVCache`): a prefill
commit quantizes per page, a decode write folds its token into a running-max
page scale, the engine zeroes the scale rows of every page it allocates
(retired and freed pages included, when they are handed out again), and
decode runs `Backend.quant_paged_decode_attention`. As in `repro`, prefix
sharing is forced off there (a tail prefill would attend over dequantized
prefix K/V where the solo run saw full precision) and `spec_k > 1` is
refused. On the ring the same setting gives an int8 ring with per-token
scales.

Speculative decode (`ServeConfig.spec_k > 1`, paged only) verifies a slot's
current token and spec_k - 1 prompt-lookup drafts in one paged decode call,
the rows as the batch, and keeps the longest draft prefix that matches the
verified argmaxes; rollback is the slot's position alone.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np
import torch

from repro_torch.core.backend import get_backend
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import transformer as T


def _leaves(tree):
    """The tensors of a cache tree (dicts, tuples and NamedTuples), in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _splice_slot(dst: dict, src: dict, slot: int) -> dict:
    """Copy batch slot `slot` of every leaf of cache `src` into `dst`, in
    place (a ring-mode join): stacked super-block leaves carry the batch on
    axis 1, tail leaves on axis 0; the shared position is equal on both
    sides (the join prefill is left-padded to it)."""
    for group, axis in (("blocks", 1), ("tail", 0)):
        for d, s in zip(_leaves(dst[group]), _leaves(src[group])):
            d.select(axis, slot).copy_(s.select(axis, slot))
    return dst


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Greedy next-token ids [B, 1] int32 from last-position logits; a tie
    goes to the lowest index, as `jnp.argmax` breaks it (torch.argmax
    returns the first maximal index)."""
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]


def bucket_len(n: int, lo: int = 8) -> int:
    """Round `n` up to a power-of-two bucket (>= lo)."""
    w = max(int(lo), 1)
    while w < n:
        w *= 2
    return w


@dataclass
class ServeConfig:
    """ServeEngine configuration: every field and default is `repro`'s.
    `num_pages=0` sizes the pool to every slot's worst case plus the trash
    page."""

    batch_size: int = 4
    max_len: int = 256          # per-request prompt + decode budget bound
    cache: str = "auto"         # "auto" | "paged" | "ring"
    page_size: int = 8          # tokens per physical page (paged only)
    num_pages: int = 0          # physical pool size; 0 = auto-size
    bucket_min: int = 8         # smallest power-of-two prefill bucket
    trace_logits: bool = False  # record per-request logits on Request.logits
    share_prefix: bool = True   # alias shared prefixes; pool persists runs
    spec_k: int = 0             # speculative rows per decode step (<=1 = off)
    prefill_chunk: int = 0      # chunked-prefill KV span; 0 = full flash
    prefix_cap: int = 0         # max warm prefix-index entries; 0 = unbounded
    retire_pages: bool = True   # free fully-out-of-window pages per round


@dataclass
class Request:
    """One generation request: prompt token ids and a decode budget. The
    engine fills `out` (generated ids), `entry_width` (the prompt bucket it
    was prefilled at) and, with `ServeConfig.trace_logits`, `logits` (one
    [V] float32 numpy row per generated token)."""

    uid: int
    prompt: np.ndarray  # [S] int32
    max_new: int
    out: list = field(default_factory=list)
    done: bool = False
    entry_width: int = -1
    logits: list = field(default_factory=list)


class ServeEngine:
    """Continuous-batching greedy decode over `batch_size` slots with a paged
    or a ring KV cache (see the module docstring), on `device` (the card
    unless the caller asks for the CPU; the model's parameters must live
    there). `backend` (`reference` | `cuda`, default `reference`) selects the
    attention of prefill and decode."""

    def __init__(self, model, params, batch_size: Optional[int] = None,
                 max_len: Optional[int] = None, backend=None,
                 config: Optional[ServeConfig] = None, device=None):
        cfg = config or ServeConfig()
        if batch_size is not None:
            cfg = replace(cfg, batch_size=batch_size)
        if max_len is not None:
            cfg = replace(cfg, max_len=max_len)
        self.config = cfg
        self.model = model
        self.params = params
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the engine runs on "
                             f"{self.device}: make the Model on the engine's device")
        self.B = cfg.batch_size
        self.max_len = cfg.max_len
        self.backend = get_backend(backend)
        paged_ok = T.paged_supported(model.cfg)
        if cfg.cache == "auto":
            self.cache_mode = "paged" if paged_ok else "ring"
        elif cfg.cache == "paged" and not paged_ok:
            raise ValueError(f"cache='paged' unsupported for {model.cfg.name} "
                             "(recurrent blocks / enc-dec) — use 'ring' or 'auto'")
        elif cfg.cache not in ("paged", "ring"):
            raise ValueError(f"unknown cache mode {cfg.cache!r}")
        else:
            self.cache_mode = cfg.cache
        self._quant = self.cache_mode == "paged" and model.kv_dtype == torch.int8
        if self._quant:
            if cfg.spec_k > 1:
                raise ValueError("spec_k > 1 is unsupported with int8 KV pools "
                                 "(draft rollback cannot undo a grown page scale)")
            # a tail prefill would attend over dequantized prefix K/V where the
            # solo run saw full precision: sharing is forced off, as in repro
            cfg = replace(cfg, share_prefix=False)
            self.config = cfg
        # page retirement is exact only where every layer masks beyond the
        # window (`repro`'s rule; attn_kind is arch-wide)
        w = model.cfg.sliding_window
        windowed = w > 0 and all(k == "local" or model.cfg.attn_kind == "sliding"
                                 for k in model.cfg.block_pattern)
        self._retire_window = w if (cfg.retire_pages and windowed) else 0
        self.prefill_widths: set = set()  # distinct prefill widths run
        self.stats: dict = {}
        if self.cache_mode == "paged":
            if cfg.page_size < 1:
                raise ValueError(f"page_size must be >= 1, got {cfg.page_size}")
            self.table_pages = -(-cfg.max_len // cfg.page_size)
            self.num_pages = cfg.num_pages or (1 + self.B * self.table_pages)
            self.page_refs = np.zeros(self.num_pages, np.int32)
            self._prefix_index: OrderedDict = OrderedDict()
            self._prefix_evictions = 0  # lifetime count, mirrored into stats
            self._slot_rows: list = [None] * self.B
            self._pool = None  # (cache, free list) kept across run() waves
        if cfg.spec_k > 1 and self.cache_mode != "paged":
            raise ValueError("spec_k needs the paged cache discipline")

    def run(self, requests: list) -> list:
        """Serve `requests` to completion; returns them in finish order."""
        pending, done = [], []
        for r in requests:
            if r.max_new <= 0:  # never enters a slot
                r.done = True
                done.append(r)
            else:
                pending.append(r)
        if self.cache_mode == "paged":
            if self.config.spec_k > 1:
                return self._run_paged_spec(pending, done)
            return self._run_paged(pending, done)
        return self._run_ring(pending, done)

    # ------------------------------------------------------------- plumbing
    def _bucket(self, n: int) -> int:
        return bucket_len(n, self.config.bucket_min)

    def _rows(self, row: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(row, dtype=torch.int32, device=self.device)

    @staticmethod
    def _pools(cache: dict):
        """Every layer group's page pool."""
        for group in ("blocks", "tail"):
            for c in cache[group]:
                yield c["kv"]

    def _commit(self, cache: dict, dense: dict, write) -> dict:
        """write(pool, dense_kv) for every layer group, in place."""
        for group in ("blocks", "tail"):
            for pool, dn in zip(cache[group], dense[group]):
                write(pool["kv"], dn["kv"])
        return cache

    def _sync_refcount(self, cache):
        """Refresh the card's refcount mirror from the host's array."""
        cache["refcount"].copy_(torch.from_numpy(self.page_refs))
        return cache

    def _reset_page_scales(self, cache, pages: list):
        """Zero the scale rows of freshly allocated `pages` in every int8 pool
        (a float pool has no scales): a recycled page's old running-max scale
        must not enter its new tenant's quantization."""
        if not self._quant or not pages:
            return cache
        ids = torch.as_tensor(pages, dtype=torch.int64, device=self.device)
        for pool in self._pools(cache):
            attn_lib.paged_reset_scales(pool, ids)
        return cache

    # --------------------------------------------- sliding-window retirement
    def _retire_window_pages(self, cache, free: list, slot_pages: list, active: list):
        """Release every block-table page whose whole span has slid out of the
        window. Page j (tokens [j P, (j+1) P)) is dead for the next decode at
        position p + 1 once (j+1) P - 1 <= p - window: every key of it fails
        the decode kernel's `kpos > pos - window` test, so pointing its table
        entry at the trash page changes no output. Refcount-aware: an aliased
        prefix page is only unpinned, and returns to the free list at
        refcount zero. Returns (cache, whether any page was retired)."""
        w = self._retire_window
        if not w:
            return cache, False
        P = self.config.page_size
        freed = False
        for i, r in enumerate(active):
            if r is None:
                continue
            p = len(r.prompt) + len(r.out) - 1  # last written position
            n_dead = (p - w + 1) // P
            if n_dead <= 0:
                continue
            row = self._slot_rows[i]
            for j in range(n_dead):
                pg = int(row[j])
                if pg == 0:
                    continue
                row[j] = 0
                cache["pages"][i, j] = 0
                slot_pages[i].remove(pg)
                self.page_refs[pg] -= 1
                if self.page_refs[pg] == 0:
                    free.append(pg)
                self.stats["pages_retired"] += 1
                freed = True
        if freed:
            cache = self._sync_refcount(cache)
        return cache, freed

    # ----------------------------------------------- prefix index + refcounts
    def _class_bit(self, bucket: int) -> bool:
        """Flash kv block class of a prompt bucket (`repro`'s rule): prefix
        sharing never crosses the 128 boundary."""
        return bucket > 128

    def _prefix_match(self, prompt, bucket: int):
        """Longest indexed page-aligned prefix of `prompt` in the same block
        class -> (n_share, aliased page ids), capped at (L-1)//P pages so a
        tail token always remains; each hit is touched to the recent end."""
        if not self.config.share_prefix:
            return 0, []
        P = self.config.page_size
        pb = np.asarray(prompt, np.int32)
        cls = self._class_bit(bucket)
        ids = []
        for j in range((len(pb) - 1) // P):
            key = (cls, pb[:(j + 1) * P].tobytes())
            page = self._prefix_index.get(key)
            if page is None:
                break
            self._prefix_index.move_to_end(key)
            ids.append(page)
        return len(ids), ids

    def _register_prefix(self, prompt, bucket: int, row: np.ndarray,
                         free: Optional[list] = None):
        """Index every full page of the admitted prompt; each new entry pins
        its page. Past `prefix_cap`, retire least recently used prefixes."""
        if not self.config.share_prefix:
            return
        P = self.config.page_size
        pb = np.asarray(prompt, np.int32)
        cls = self._class_bit(bucket)
        for j in range(len(pb) // P):
            key = (cls, pb[:(j + 1) * P].tobytes())
            if key not in self._prefix_index:
                pg = int(row[j])
                self._prefix_index[key] = pg
                self.page_refs[pg] += 1
        cap = self.config.prefix_cap
        if cap and free is not None:
            while len(self._prefix_index) > cap:
                if not self._evict_chain(free, last=False):
                    break

    def _evict_chain(self, free: list, *, last: bool) -> bool:
        """Drop one prefix entry and every deeper entry extending it,
        un-pinning their pages (freed at refcount 0). `last=True` starts at
        the most recently touched end, `last=False` at the least."""
        if not self._prefix_index:
            return False
        (cls, pb), pg = self._prefix_index.popitem(last=last)
        dropped = [pg]
        for key in [k for k in self._prefix_index if k[0] == cls and k[1].startswith(pb)]:
            dropped.append(self._prefix_index.pop(key))
        for pg in dropped:
            self.page_refs[pg] -= 1
            if self.page_refs[pg] == 0:
                free.append(pg)
        self._prefix_evictions += len(dropped)
        if self.stats:
            self.stats["prefix_evictions"] = self._prefix_evictions
        return True

    def _evict_one(self, free: list) -> bool:
        """Pool-pressure eviction: the most recently touched prefix chain."""
        return self._evict_chain(free, last=True)

    def _copy_page(self, cache, src: int, dst: int):
        """Copy physical page src onto dst in every layer's pool."""
        for pool in self._pools(cache):
            attn_lib.paged_copy_page(pool, src, dst)
        return cache

    def _cow_page(self, cache, free: list, slot_pages: list, slot: int, pidx: int):
        """Copy-on-write entry `pidx` of `slot`'s table row onto a fresh page
        and redirect the row; sharers keep the original."""
        row = self._slot_rows[slot]
        old = int(row[pidx])
        while not free:
            if not self._evict_one(free):
                raise RuntimeError("copy-on-write found no free page and nothing evictable")
        new = free.pop()
        cache = self._copy_page(cache, old, new)
        self.page_refs[old] -= 1
        self.page_refs[new] = 1
        row[pidx] = new
        slot_pages[slot][slot_pages[slot].index(old)] = new
        cache["pages"][slot, pidx] = new
        self.stats["cow_copies"] += 1
        return self._sync_refcount(cache)

    def _cow_guard(self, cache, free: list, slot_pages: list, slot: int, wpos: int,
                   count: int = 1):
        """Make the pages behind write positions [wpos, wpos + count) of `slot`
        exclusively owned before a decode writes them."""
        P = self.config.page_size
        row = self._slot_rows[slot]
        for pidx in range(wpos // P, (wpos + count - 1) // P + 1):
            pg = int(row[pidx])
            if pg != 0 and self.page_refs[pg] > 1:
                cache = self._cow_page(cache, free, slot_pages, slot, pidx)
        return cache

    # ------------------------------------------------------------- the loop
    def _paged_init(self, pending: list, done: list):
        """Validate the requests, build (or reuse) the pool and admit into
        every slot -> (cache, nxt, free, slot_pages, active, remaining)."""
        P = self.config.page_size
        for r in pending:
            if len(r.prompt) + r.max_new > self.max_len:
                raise ValueError(f"request {r.uid}: prompt {len(r.prompt)} + budget "
                                 f"{r.max_new} exceeds max_len {self.max_len}")
            if len(r.prompt) == 0:
                raise ValueError(f"request {r.uid}: empty prompt")
        if self.config.share_prefix and self._pool is not None:
            cache, free = self._pool  # the warm pool: index pins still hold their pages
            cache = self._sync_refcount(cache)
        else:
            cache = self.model.init_paged_cache(self.B, self.num_pages, P, self.table_pages)
            free = list(range(1, self.num_pages))  # page 0 = the trash page
            self.page_refs = np.zeros(self.num_pages, np.int32)
            self._prefix_index = OrderedDict()
        slot_pages: list = [[] for _ in range(self.B)]
        active: list = [None] * self.B
        remaining = [0] * self.B
        self._slot_rows = [None] * self.B
        self.stats = {"prompt_tokens": 0, "prefill_tokens": 0, "prefix_hit_tokens": 0,
                      "prefix_hits": 0, "spec_proposed": 0, "spec_accepted": 0,
                      "cow_copies": 0, "pages_retired": 0, "decode_rounds": 0,
                      "slot_rounds": 0, "prefix_evictions": self._prefix_evictions}
        nxt = torch.zeros(self.B, 1, dtype=torch.int32, device=self.device)
        cache, nxt = self._admit_idle_slots(pending, done, cache, nxt, active, remaining, free,
                                            slot_pages)
        return cache, nxt, free, slot_pages, active, remaining

    def _admit_idle_slots(self, pending, done, cache, nxt, active, remaining, free, slot_pages):
        """Offer admission to every idle slot."""
        for i in range(self.B):
            if active[i] is None:
                cache, nxt = self._try_admit(pending, done, cache, nxt, active, remaining, free,
                                             slot_pages, i)
        return cache, nxt

    def _run_paged(self, pending: list, done: list) -> list:
        cache, nxt, free, slot_pages, active, remaining = self._paged_init(pending, done)
        while any(r is not None for r in active):
            for i, r in enumerate(active):
                if r is not None:  # copy any still-shared write-target page
                    cache = self._cow_guard(cache, free, slot_pages, i,
                                            len(r.prompt) + len(r.out) - 1)
            self.stats["decode_rounds"] += 1
            self.stats["slot_rounds"] += sum(r is not None for r in active)
            logits, cache = self.model.decode_step(self.params, cache, {"tokens": nxt},
                                                   backend=self.backend)
            nxt = greedy(logits)
            nxt_np = nxt.cpu().numpy()
            log_np = logits.float().cpu().numpy() if self.config.trace_logits else None
            freed = False
            for i, r in enumerate(active):
                if r is None:
                    continue
                r.out.append(int(nxt_np[i, 0]))
                if log_np is not None:
                    r.logits.append(log_np[i, 0].copy())
                remaining[i] -= 1
                if remaining[i] == 0:
                    r.done = True
                    done.append(r)
                    active[i] = None
                    cache = self._release_slot(cache, free, slot_pages, i)
                    freed = True
            cache, retired = self._retire_window_pages(cache, free, slot_pages, active)
            if freed or retired:
                cache, nxt = self._admit_idle_slots(pending, done, cache, nxt, active,
                                                    remaining, free, slot_pages)
        return self._end_paged_run(pending, done, cache, free)

    def _end_paged_run(self, pending: list, done: list, cache, free: list) -> list:
        """Fail loud on requests no slot could ever hold (a hand-shrunk pool),
        keep the pool for later waves when prefixes are shared, and return
        the requests in finish order."""
        if pending:
            raise RuntimeError(f"{len(pending)} requests unadmittable with "
                               f"{len(free)}/{self.num_pages - 1} pages free")
        if self.config.share_prefix:
            self._pool = (cache, free)  # keep the pinned prefix pages for later waves
        return done

    # ------------------------------------------------------ speculative path
    def _draft(self, r, n: int) -> np.ndarray:
        """Prompt-lookup draft: the continuation of the most recent earlier
        occurrence of the request's last token in its own context (prompt +
        generated so far), zero-padded to exactly `n` proposals."""
        out = np.zeros((n,), np.int32)
        if n == 0:
            return out
        ctx = np.concatenate([np.asarray(r.prompt, np.int32), np.asarray(r.out, np.int32)])
        hits = np.nonzero(ctx[:-1] == ctx[-1])[0]
        if hits.size:
            cont = ctx[int(hits[-1]) + 1:int(hits[-1]) + 1 + n]
            out[:cont.size] = cont
        return out

    def _run_paged_spec(self, pending: list, done: list) -> list:
        """Speculative decode, spec_k rows a step, one slot at a time: the
        slot's current token and k-1 drafted ones are verified in one paged
        decode call with the rows as the batch. Every row carries the slot's
        table row at its own position, and `paged_update_decode` writes every
        row's K/V before `paged_decode_attend` reads the pools, so the rows'
        causal masks make the call an exact multi-token decode. Acceptance
        keeps the longest draft prefix matching the verified argmaxes (row 0
        is the plain step: at least one token a step); rollback is the
        slot's position, behind which the rejected rows' writes stay masked
        until overwritten. Rows past the slot's remaining budget are parked
        on the trash row (pages 0, position 0, token 0)."""
        k = self.config.spec_k
        cache, nxt, free, slot_pages, active, remaining = self._paged_init(pending, done)
        while any(r is not None for r in active):
            for i in range(self.B):
                r = active[i]
                if r is None:
                    continue
                k_eff = min(k, remaining[i])
                p = len(r.prompt) + len(r.out) - 1  # the next write position
                draft = self._draft(r, k - 1)
                d = np.zeros((k, 1), np.int32)
                d[0, 0] = r.out[-1]  # the last emitted token is the next input
                d[1:k_eff, 0] = draft[:k_eff - 1]
                pos_k = np.zeros(k, np.int32)
                pos_k[:k_eff] = p + np.arange(k_eff)
                pages_k = np.zeros((k, self.table_pages), np.int32)
                pages_k[:k_eff] = self._slot_rows[i]
                cache = self._cow_guard(cache, free, slot_pages, i, p, k_eff)
                self.stats["decode_rounds"] += 1
                self.stats["slot_rounds"] += 1
                # the rows' cache shares the engine's pool tensors, which the
                # call writes in place; its returned pos is discarded. Parked
                # rows all write cell (trash page 0, offset 0): duplicate
                # indices of one index_put, whose winner is unspecified, on a
                # page nothing reads (repro writes it too)
                sub = {"blocks": cache["blocks"], "tail": cache["tail"],
                       "pos": self._rows(pos_k), "pages": self._rows(pages_k),
                       "refcount": cache["refcount"]}
                logits, _ = self.model.decode_step(self.params, sub, {"tokens": self._rows(d)},
                                                   backend=self.backend)
                g = greedy(logits)[:, 0].cpu().numpy()
                a = 0  # accepted proposals: the longest exact-match draft prefix
                while a + 1 < k_eff and d[a + 1, 0] == g[a]:
                    a += 1
                self.stats["spec_proposed"] += k_eff - 1
                self.stats["spec_accepted"] += a
                r.out.extend(int(g[t]) for t in range(a + 1))
                if self.config.trace_logits:
                    log_np = logits.float().cpu().numpy()
                    for t in range(a + 1):
                        r.logits.append(log_np[t, 0].copy())
                remaining[i] -= a + 1
                cache["pos"][i] = p + a + 1  # the rollback: rows past a stay masked
                cache, retired = self._retire_window_pages(cache, free, slot_pages, active)
                if remaining[i] == 0:
                    r.done = True
                    done.append(r)
                    active[i] = None
                    cache = self._release_slot(cache, free, slot_pages, i)
                    retired = True
                if retired:
                    cache, nxt = self._admit_idle_slots(pending, done, cache, nxt, active,
                                                        remaining, free, slot_pages)
        return self._end_paged_run(pending, done, cache, free)

    def _release_slot(self, cache, free: list, slot_pages: list, slot: int):
        """Drop a finished slot's page references and park the slot (all-trash
        row, position 0)."""
        for pg in slot_pages[slot]:
            self.page_refs[pg] -= 1
            if self.page_refs[pg] == 0:
                free.append(pg)
        slot_pages[slot] = []
        self._slot_rows[slot] = None
        cache["pages"][slot] = 0
        cache["pos"][slot] = 0
        return self._sync_refcount(cache)

    def _try_admit(self, pending: list, done: list, cache, nxt, active, remaining, free: list,
                   slot_pages: list, slot: int):
        """Admit into `slot` the first pending request whose fresh page need
        (pages minus prefix aliases) fits the free list, evicting index
        chains when nothing fits. A solo admission prefills the prompt at its
        bucket and commits its K/V into the pages; a prefix hit aliases the
        matched pages and prefills only the tail at the solo kv width. The
        prompt's full pages are then indexed and the first generated token
        recorded. Returns (cache, nxt)."""
        P = self.config.page_size
        while True:
            if not pending:
                return cache, nxt
            cand = None
            while cand is None:
                for r in pending:
                    need = -(-(len(r.prompt) + r.max_new) // P)
                    n_share, aliased = self._prefix_match(r.prompt, self._bucket(len(r.prompt)))
                    if need - n_share <= len(free):
                        cand = (r, need, n_share, aliased)
                        break
                else:
                    if not self._evict_one(free):
                        return cache, nxt
            j, need, n_share, aliased = cand
            pending.remove(j)
            L = len(j.prompt)
            pages = aliased + [free.pop() for _ in range(need - n_share)]
            for pg in pages:
                self.page_refs[pg] += 1
            slot_pages[slot] = pages
            row = np.zeros(self.table_pages, np.int32)
            row[:need] = pages
            self._slot_rows[slot] = row
            row_t = self._rows(row)
            # int8 pools: zero the fresh pages' scale rows before any write
            cache = self._reset_page_scales(cache, pages[n_share:])
            width = self._bucket(L)
            j.entry_width = width
            self.stats["prompt_tokens"] += L
            if n_share:
                Ls = n_share * P
                tail_w = self._bucket(L - Ls)
                self.prefill_widths.add(tail_w)
                self.stats["prefill_tokens"] += tail_w
                self.stats["prefix_hit_tokens"] += Ls
                self.stats["prefix_hits"] += 1
                toks = np.zeros((1, tail_w), np.int32)
                toks[0, :L - Ls] = j.prompt[Ls:]  # right-pad the tail
                logits, dense = self.model.prefill_tail(
                    self.params, {"tokens": self._rows(toks)}, cache, page_row=row_t,
                    share_pages=n_share, kv_len=width, last_pos=torch.tensor([L - Ls - 1]),
                    backend=self.backend, prefill_chunk=self.config.prefill_chunk)
                self._commit(cache, dense, lambda pool, dn: attn_lib.paged_commit_tail(
                    pool, dn, row_t, Ls, L, tail_w))
            else:
                self.prefill_widths.add(width)
                self.stats["prefill_tokens"] += width
                toks = np.zeros((1, width), np.int32)
                toks[0, :L] = j.prompt  # right-pad: the pads lie past the causal mask
                logits, dense = self.model.prefill(
                    self.params, {"tokens": self._rows(toks)}, cache_len=width,
                    backend=self.backend, last_pos=torch.tensor([L - 1]), full_cache=True,
                    prefill_chunk=self.config.prefill_chunk)
                commit = attn_lib.quant_paged_commit if self._quant else attn_lib.paged_commit
                self._commit(cache, dense, lambda pool, dn: commit(pool, dn, row_t, L, width))
            self._register_prefix(j.prompt, width, row, free)
            cache["pages"][slot] = row_t
            cache["pos"][slot] = L
            cache = self._sync_refcount(cache)
            first = greedy(logits)
            j.out.append(int(first[0, 0]))
            if self.config.trace_logits:
                j.logits.append(logits[0, 0].float().cpu().numpy().copy())
            if j.max_new == 1:  # drained on its own prefill; the slot frees again
                j.done = True
                done.append(j)
                cache = self._release_slot(cache, free, slot_pages, slot)
                continue
            nxt[slot] = first[0]
            active[slot] = j
            remaining[slot] = j.max_new - 1
            return cache, nxt

    # ------------------------------------------------------------- ring path
    def _prefill_ring(self, toks: np.ndarray):
        """A left-padded [B, S] prefill into a fresh ring of `max_len`
        positions -> (logits at position -1 [B, 1, V], the cache)."""
        return self.model.prefill(self.params, {"tokens": self._rows(toks)},
                                  cache_len=self.max_len, backend=self.backend)

    def _try_join(self, pending: list, done: list, cache, nxt, active, remaining, slot: int):
        """Fill freed `slot` from `pending` mid-stream: the first request whose
        prompt fits the positions run so far and whose budget fits max_len is
        prefilled left-padded to the current position (the whole batch, the
        other rows pad), its slot of every cache leaf spliced in, and its
        first token (the join prefill's greedy pick) recorded. Returns
        (cache, nxt), unchanged when nothing fits."""
        while True:
            cur = int(cache["pos"])
            j = next((r for r in pending
                      if len(r.prompt) <= cur and cur + r.max_new <= self.max_len), None)
            if j is None:
                return cache, nxt
            pending.remove(j)
            toks = np.zeros((self.B, cur), np.int32)
            toks[slot, cur - len(j.prompt):] = j.prompt
            j.entry_width = cur
            self.prefill_widths.add(cur)
            j_logits, j_cache = self._prefill_ring(toks)
            cache = _splice_slot(cache, j_cache, slot)
            first = greedy(j_logits)
            j.out.append(int(first[slot, 0]))
            if self.config.trace_logits:
                j.logits.append(j_logits[slot, -1].float().cpu().numpy().copy())
            if j.max_new == 1:  # drained on its own prefill; the slot frees again
                j.done = True
                done.append(j)
                continue
            nxt[slot] = first[slot]
            active[slot] = j
            remaining[slot] = j.max_new - 1
            return cache, nxt

    def _run_ring(self, pending: list, done: list) -> list:
        """Waves of up to batch_size requests, each prefilled together
        left-padded to its longest prompt; freed slots take joins until the
        wave drains."""
        while pending:
            wave, pending = pending[:self.B], pending[self.B:]
            S = max(len(r.prompt) for r in wave)
            toks = np.zeros((self.B, S), np.int32)
            for i, r in enumerate(wave):
                toks[i, S - len(r.prompt):] = r.prompt  # left-pad
                r.entry_width = S
            self.prefill_widths.add(S)
            logits, cache = self._prefill_ring(toks)
            nxt = greedy(logits)
            if self.config.trace_logits:
                log_np = logits.float().cpu().numpy()
                for i, r in enumerate(wave):
                    r.logits.append(log_np[i, -1].copy())
            active: list = list(wave) + [None] * (self.B - len(wave))
            remaining = [r.max_new if r else 0 for r in active]
            while True:
                nxt_np = nxt.cpu().numpy()
                for i, r in enumerate(active):
                    if r is None or remaining[i] == 0:
                        continue
                    r.out.append(int(nxt_np[i, 0]))
                    remaining[i] -= 1
                    if remaining[i] == 0:
                        r.done = True
                        done.append(r)
                        active[i] = None
                        cache, nxt = self._try_join(pending, done, cache, nxt, active,
                                                    remaining, i)
                if not any(remaining):
                    break
                logits, cache = self.model.decode_step(self.params, cache, {"tokens": nxt},
                                                       backend=self.backend)
                nxt = greedy(logits)
                if self.config.trace_logits:
                    log_np = logits.float().cpu().numpy()
                    for i, r in enumerate(active):
                        if r is not None and remaining[i] > 0:
                            r.logits.append(log_np[i, 0].copy())
        return done
