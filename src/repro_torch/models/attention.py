"""GQA attention of the serving path (the port of the parts of
`repro/models/attention.py` that the paged engine runs): the projections,
the backend route, the dense prefill cache and the paged KV cache.

Layout: q [B, S, Hq, D]; k, v [B, S, Hkv, D]. Page pools are
[N_pages, P, Hkv, D] (or [n_layers, N_pages, P, Hkv, D] stacked over
layers); physical page 0 is the reserved trash page. Where `repro` returns
a new pool (JAX arrays are immutable and its engine donates the old one),
the port writes the pages in place and returns the same pool.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AttnSpec(NamedTuple):
    """Attention pattern: causality, sliding window, logit softcap."""

    causal: bool = True
    window: int = 0  # 0 => unbounded (full attention)
    logit_softcap: float = 0.0


def attention(q, k, v, qpos, kpos, spec: AttnSpec, backend, prefill_chunk: int = 0):
    """Multi-token attention through the serving backend, `repro`'s route,
    most specific first: a chunked prefill (`Backend.chunked_prefill`) when
    `prefill_chunk` > 0 and the KV span exceeds it; a windowed multi-token
    query through the banded kernel (`Backend.local_attention`); else
    `Backend.flash_attention`. All three give flash attention's result."""
    Sq, Skv = q.shape[1], k.shape[1]
    if prefill_chunk and Sq > 1 and Skv > prefill_chunk:
        return backend.chunked_prefill(q, k, v, qpos, kpos, spec, prefill_chunk)
    if spec.window and Sq > 1:
        return backend.local_attention(q, k, v, qpos, kpos, spec)
    return backend.flash_attention(q, k, v, qpos, kpos, spec)


# ----------------------------------------------------------------------------
# Attention block parameters
# ----------------------------------------------------------------------------


def init_attn(create, cfg, layers: int) -> dict:
    """Stacked q/k/v/o projections (+ optional biases) for `layers` layers."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": create((layers, d, nq, hd), fan_in=d),
        "wk": create((layers, d, nkv, hd), fan_in=d),
        "wv": create((layers, d, nkv, hd), fan_in=d),
        "wo": create((layers, nq, hd, d), fan_in=nq * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = create((layers, nq, hd), mode="zeros")
        p["bk"] = create((layers, nkv, hd), mode="zeros")
        p["bv"] = create((layers, nkv, hd), mode="zeros")
    return p


def _proj(x, w):
    """x [B,S,d] . w [d,H,D] -> [B,S,H,D]."""
    d, H, D = w.shape
    return (x @ w.reshape(d, H * D)).reshape(*x.shape[:-1], H, D)


def qkv_proj(cfg, p: dict, x: torch.Tensor):
    """x [B,S,d] -> (q [B,S,Hq,D], k / v [B,S,Hkv,D]) with optional biases."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def out_proj(p: dict, o: torch.Tensor) -> torch.Tensor:
    """Output projection: o [B,S,Hq,D] -> [B,S,d]."""
    H, D, d = p["wo"].shape
    return o.reshape(*o.shape[:-2], H * D) @ p["wo"].reshape(H * D, d)


# ----------------------------------------------------------------------------
# Dense KV cache (a prefill's, token t at slot t)
# ----------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Dense KV cache of a prefill: k, v [B, W, Hkv, D] (RoPE applied to k)."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k.shape[-3]


def init_kv_cache(cfg, batch: int, capacity: int, dtype, device, layers: int = 0) -> KVCache:
    """Zeroed [B, capacity, Hkv, D] cache, with a leading [layers] dim when
    `layers` > 0."""
    shape = ((layers,) if layers else ()) + (batch, capacity, cfg.n_kv_heads,
                                             cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


# ----------------------------------------------------------------------------
# Paged KV cache
# ----------------------------------------------------------------------------


class PagedKVCache(NamedTuple):
    """A pool of fixed-size physical pages shared by every batch slot,
    indexed through the engine's block table. Page 0 is the trash page:
    unallocated table entries point at it, junk writes of parked slots and
    right-pad positions land there, and no attention reads it. With prefix
    sharing a page may sit in several table rows; the engine's refcounts
    and copy-on-write keep writes off shared pages."""

    k: torch.Tensor  # [N_pages, page_size, Hkv, D] (RoPE applied to k)
    v: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k.shape[-3]

    @property
    def num_pages(self) -> int:
        return self.k.shape[-4]


def init_paged_kv_cache(cfg, num_pages: int, page_size: int, dtype, device,
                        layers: int = 0) -> PagedKVCache:
    """Zeroed page pool [num_pages, page_size, Hkv, D], with a leading
    [layers] dim when `layers` > 0. An int8 pool (`repro`'s
    QuantPagedKVCache) is not ported yet."""
    if dtype == torch.int8:
        raise NotImplementedError("int8 page pools (kv_dtype int8) are not ported to "
                                  "repro_torch yet; see ROADMAP.md queue 2")
    shape = ((layers,) if layers else ()) + (num_pages, page_size, cfg.n_kv_heads,
                                             cfg.resolved_head_dim)
    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device))


def paged_update_decode(cache: PagedKVCache, k_new, v_new, pos: torch.Tensor,
                        pages: torch.Tensor) -> PagedKVCache:
    """Write one token a slot, in place: k_new / v_new [B,1,Hkv,D]; pos [B];
    pages [B, n_pages]. Slot b's token lands in page pages[b, pos_b // P] at
    offset pos_b % P; the logical page index is clipped, so a parked slot
    (all-trash row) writes into the trash page."""
    P = cache.page_size
    pidx = torch.clamp(pos.long() // P, 0, pages.shape[1] - 1)
    page_of = torch.gather(pages.long(), 1, pidx[:, None])[:, 0]
    off = pos.long() % P
    cache.k[page_of, off] = k_new[:, 0].to(cache.k.dtype)
    cache.v[page_of, off] = v_new[:, 0].to(cache.v.dtype)
    return cache


def _scatter_rows(pool: PagedKVCache, dense: KVCache, page_row, apos, length):
    """Write dense row t (absolute position apos[t]) into the slot's pages,
    in place; rows at or past `length` go to the trash page. Leaves may
    carry a leading layers dim (pool [L, N, P, Hkv, D], dense [L, 1, W, Hkv,
    D])."""
    P = pool.k.shape[-3]
    n_table = page_row.shape[0]
    pidx = torch.clamp(apos // P, 0, n_table - 1)
    page_of = torch.where(apos < length, page_row.long()[pidx], 0)
    off = apos % P
    for dst, src in ((pool.k, dense.k), (pool.v, dense.v)):
        if dst.ndim == 5:
            dst[:, page_of, off] = src[:, 0].to(dst.dtype)
        else:
            dst[page_of, off] = src[0].to(dst.dtype)
    return pool


def paged_commit(pool: PagedKVCache, dense: KVCache, page_row: torch.Tensor, length: int,
                 seq_len: int) -> PagedKVCache:
    """Scatter a batch-1 prefill cache of width `seq_len` (token t at slot t)
    into the slot's pages; its `length` real tokens go to their pages, the
    right-pad rows to the trash page."""
    W = dense.k.shape[-3]
    assert W == seq_len, f"paged_commit needs a full-capacity prefill cache; {W} != {seq_len}"
    apos = torch.arange(W, device=pool.k.device)
    return _scatter_rows(pool, dense, page_row, apos, length)


def paged_commit_tail(pool: PagedKVCache, dense: KVCache, page_row: torch.Tensor, start: int,
                      length: int, tail_len: int) -> PagedKVCache:
    """Scatter a tail-only prefill cache (tail token t at absolute position
    start + t) into the slot's pages past the shared prefix; pad rows
    (start + t >= length) go to the trash page."""
    W = dense.k.shape[-3]
    assert W == tail_len, f"paged_commit_tail needs a full-capacity tail cache; {W} != {tail_len}"
    apos = start + torch.arange(W, device=pool.k.device)
    return _scatter_rows(pool, dense, page_row, apos, length)


def paged_gather_prefix(pool: PagedKVCache, page_row: torch.Tensor, n_share: int):
    """The first `n_share` pages of a block-table row, densified:
    -> (k, v) [1, n_share * P, Hkv, D]."""
    ids = page_row[:n_share].long()
    P, Hkv, D = pool.k.shape[1:]
    return (pool.k[ids].reshape(1, n_share * P, Hkv, D),
            pool.v[ids].reshape(1, n_share * P, Hkv, D))


def paged_prefix_concat(pool: PagedKVCache, page_row: torch.Tensor, n_share: int, k_tail,
                        v_tail, kv_len: int):
    """The attention K/V of a tail prefill at the solo run's width:
    [shared-prefix rows from the pages | tail rows | zero pad] -> (k, v)
    [1, kv_len, Hkv, D]. Tail rows past kv_len are pad rows and dropped."""
    Ls = n_share * pool.page_size
    kp, vp = paged_gather_prefix(pool, page_row, n_share)
    B, Wt, Hkv, D = k_tail.shape
    m = min(Wt, kv_len - Ls)
    pad = kv_len - Ls - m
    out = []
    for pre, tail in ((kp, k_tail), (vp, v_tail)):
        parts = [pre.to(tail.dtype), tail[:, :m]]
        if pad:
            parts.append(tail.new_zeros(B, pad, Hkv, D))
        out.append(torch.cat(parts, dim=1))
    return out[0], out[1]


def paged_copy_page(pool: PagedKVCache, src: int, dst: int) -> PagedKVCache:
    """Copy physical page `src` onto `dst` in place (the device half of
    copy-on-write); a leading layers dim is copied along."""
    if pool.k.ndim == 5:
        pool.k[:, dst] = pool.k[:, src]
        pool.v[:, dst] = pool.v[:, src]
    else:
        pool.k[dst] = pool.k[src]
        pool.v[dst] = pool.v[src]
    return pool


def paged_decode_attend(cfg, cache: PagedKVCache, q, pos: torch.Tensor, pages: torch.Tensor,
                        spec: AttnSpec, backend):
    """One-token attention over the paged cache (already written at `pos`):
    q [B,1,Hq,D]; pos [B]; pages [B, n_pages] -> [B,1,Hq,D], through
    `Backend.paged_decode_attention`."""
    return backend.paged_decode_attention(q, cache.k, cache.v, pages, pos, spec)
