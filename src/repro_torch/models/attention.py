"""GQA attention of the serving path (the port of the serving parts of
`repro/models/attention.py`): the projections, the backend route, the ring
KV cache (dense, token t at slot t % W) and its int8 form with per-token
scales, and the paged KV cache and its int8 form with per-(page, head)
scales.

Layout: q [B, S, Hq, D]; k, v [B, S, Hkv, D]. Ring caches are
[B, W, Hkv, D]; page pools are [N_pages, P, Hkv, D]; either may carry a
leading [n_layers] dim when stacked over layers. Physical page 0 is the
reserved trash page. Where `repro` returns a new cache (JAX arrays are
immutable and its engine donates the old one), the port writes the cache in
place and returns the same cache.
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
# Dense / ring KV cache (token t at slot t % W)
# ----------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Dense ring KV cache: k, v [B, W, Hkv, D] (RoPE applied to k). A
    prefill's full-capacity cache holds token t at slot t; a ring of
    capacity W (the window, for a sliding arch) at slot t % W."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k.shape[-3]


class QuantKVCache(NamedTuple):
    """int8 ring KV cache with one float32 scale per (slot, kv head)."""

    k: torch.Tensor  # [B, W, Hkv, D] int8
    v: torch.Tensor
    k_scale: torch.Tensor  # [B, W, Hkv] float32
    v_scale: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k.shape[-3]


def _round_int8(x: torch.Tensor) -> torch.Tensor:
    """Round half to even (as jnp.round) and clip to [-127, 127] as int8."""
    return torch.clamp(torch.round(x), -127, 127).to(torch.int8)


def quantize_kv(x: torch.Tensor):
    """[..., D] -> (int8 codes, float32 scale max|x| / 127 over D)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    return _round_int8(xf / torch.clamp(scale, min=1e-9)[..., None]), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of `quantize_kv`: int8 codes and per-slot scales -> dtype."""
    return (q.float() * scale[..., None]).to(dtype)


def init_kv_cache(cfg, batch: int, capacity: int, dtype, device, layers: int = 0):
    """Zeroed [B, capacity, Hkv, D] cache, with a leading [layers] dim when
    `layers` > 0; dtype int8 gives the QuantKVCache (per-slot scales)."""
    shape = ((layers,) if layers else ()) + (batch, capacity, cfg.n_kv_heads,
                                             cfg.resolved_head_dim)
    if dtype == torch.int8:
        return QuantKVCache(*(torch.zeros(shape, dtype=torch.int8, device=device)
                              for _ in range(2)),
                            *(torch.zeros(shape[:-1], dtype=torch.float32, device=device)
                              for _ in range(2)))
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def cache_write_prefill(cache, k: torch.Tensor, v: torch.Tensor):
    """Write a prefill's K/V [B, S, Hkv, D] into a ring cache of capacity W,
    in place: with S < W into slots [0, S); else the last W rows, rolled by
    (S - W) % W so that token t sits at slot t % W. An int8 ring quantizes
    per token."""
    W, S = cache.capacity, k.shape[1]
    if S >= W:
        k, v = k[:, -W:], v[:, -W:]
        if S > W:
            shift = (S - W) % W
            k, v = torch.roll(k, shift, dims=1), torch.roll(v, shift, dims=1)
    n = min(S, W)
    if isinstance(cache, QuantKVCache):
        for codes, scales, x in ((cache.k, cache.k_scale, k), (cache.v, cache.v_scale, v)):
            xq, xs = quantize_kv(x)
            codes[:, :n] = xq
            scales[:, :n] = xs
    else:
        cache.k[:, :n] = k.to(cache.k.dtype)
        cache.v[:, :n] = v.to(cache.v.dtype)
    return cache


def cache_update_decode(cache, k_new, v_new, pos: torch.Tensor):
    """Write one token a sequence at ring slot pos % W, in place (an index
    write of that slot, no host sync): k_new / v_new [B, 1, Hkv, D]; pos a
    0-dim tensor. An int8 ring quantizes the token per (slot, head)."""
    slot = (pos.long() % cache.capacity).reshape(1)
    if isinstance(cache, QuantKVCache):
        for codes, scales, x in ((cache.k, cache.k_scale, k_new),
                                 (cache.v, cache.v_scale, v_new)):
            xq, xs = quantize_kv(x)
            codes.index_copy_(1, slot, xq)
            scales.index_copy_(1, slot, xs)
        return cache
    cache.k.index_copy_(1, slot, k_new.to(cache.k.dtype))
    cache.v.index_copy_(1, slot, v_new.to(cache.v.dtype))
    return cache


def ring_valid(pos: torch.Tensor, capacity: int, spec: AttnSpec) -> torch.Tensor:
    """[W] bool: which ring slots hold attendable tokens at decode position
    `pos`: written (kpos <= pos), not overwritten, and inside the window
    when there is one. Computed once a decode step, on the device."""
    slots = torch.arange(capacity, device=pos.device)
    kpos = pos - torch.remainder(pos - slots, capacity)  # the latest write to each slot
    lo = torch.clamp(pos + 1 - spec.window, min=0) if spec.window else 0
    return (kpos >= lo) & (kpos >= 0) & (kpos <= pos)


def decode_attend(cfg, cache, q, pos: torch.Tensor, spec: AttnSpec, backend):
    """One-token attention over the ring cache (already written at `pos`):
    q [B, 1, Hq, D]; pos a 0-dim tensor -> [B, 1, Hq, D], through
    `Backend.decode_attention`. An int8 ring is dequantized to q's dtype
    first."""
    valid = ring_valid(pos, cache.capacity, spec)
    if isinstance(cache, QuantKVCache):
        ck = dequantize_kv(cache.k, cache.k_scale, q.dtype)
        cv = dequantize_kv(cache.v, cache.v_scale, q.dtype)
    else:
        ck, cv = cache.k, cache.v
    return backend.decode_attention(q, ck, cv, valid, spec)


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


class QuantPagedKVCache(NamedTuple):
    """int8 page pool: the codes of `PagedKVCache` plus one symmetric float32
    scale per (page, kv head). A commit writes whole pages (scale = max|x| /
    127 over the page's committed tokens); a decode write folds the token
    into a running-max page scale, requantizing the page's codes when the
    scale grows (unchanged codes otherwise); the engine zeroes the scale
    rows of every page it allocates, so a recycled page's old scale never
    enters the running max."""

    k: torch.Tensor  # [N_pages, P, Hkv, D] int8
    v: torch.Tensor
    k_scale: torch.Tensor  # [N_pages, Hkv] float32
    v_scale: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k.shape[-3]

    @property
    def num_pages(self) -> int:
        return self.k.shape[-4]


def init_paged_kv_cache(cfg, num_pages: int, page_size: int, dtype, device, layers: int = 0):
    """Zeroed page pool [num_pages, page_size, Hkv, D], with a leading
    [layers] dim when `layers` > 0; dtype int8 gives the QuantPagedKVCache
    (per-(page, head) scales)."""
    lead = (layers,) if layers else ()
    shape = lead + (num_pages, page_size, cfg.n_kv_heads, cfg.resolved_head_dim)
    if dtype == torch.int8:
        return QuantPagedKVCache(*(torch.zeros(shape, dtype=torch.int8, device=device)
                                   for _ in range(2)),
                                 *(torch.zeros(lead + (num_pages, cfg.n_kv_heads),
                                               dtype=torch.float32, device=device)
                                   for _ in range(2)))
    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device))


def paged_update_decode(cache, k_new, v_new, pos: torch.Tensor, pages: torch.Tensor):
    """Write one token a slot, in place: k_new / v_new [B,1,Hkv,D]; pos [B];
    pages [B, n_pages]. Slot b's token lands in page pages[b, pos_b // P] at
    offset pos_b % P; the logical page index is clipped, so a parked slot
    (all-trash row) writes into the trash page. An int8 pool takes the write
    under its running-max page scale (`_quant_page_write`)."""
    P = cache.page_size
    pidx = torch.clamp(pos.long() // P, 0, pages.shape[1] - 1)
    page_of = torch.gather(pages.long(), 1, pidx[:, None])[:, 0]
    off = pos.long() % P
    if isinstance(cache, QuantPagedKVCache):
        _quant_page_write(cache.k, cache.k_scale, k_new, page_of, off)
        _quant_page_write(cache.v, cache.v_scale, v_new, page_of, off)
        return cache
    cache.k[page_of, off] = k_new[:, 0].to(cache.k.dtype)
    cache.v[page_of, off] = v_new[:, 0].to(cache.v.dtype)
    return cache


def _quant_page_write(pool_q, pool_s, x_new, page_of, off) -> None:
    """One-token int8 page write under the running-max page scale, in place.
    The token's per-head max|x| / 127 is folded into the page's scale; a
    grown scale requantizes the page's codes (ratio < 1), an unchanged one
    leaves them exact (round(code * 1.0) == code). The token is quantized
    from full precision against the final scale. Parked slots write codes
    and scale into the trash page, which no attention reads."""
    x = x_new[:, 0].float()  # [B, Hkv, D]
    s_tok = x.abs().amax(dim=-1) / 127.0  # [B, Hkv]
    s_old = pool_s[page_of]
    s_new = torch.maximum(s_old, s_tok)
    ratio = s_old / torch.clamp(s_new, min=1e-9)
    row_q = _round_int8(pool_q[page_of].float() * ratio[:, None, :, None])  # [B, P, Hkv, D]
    tok_q = _round_int8(x / torch.clamp(s_new, min=1e-9)[..., None])
    pool_q[page_of] = row_q
    pool_q[page_of, off] = tok_q
    pool_s[page_of] = s_new


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


def quant_paged_commit(pool: QuantPagedKVCache, dense: QuantKVCache, page_row: torch.Tensor,
                       length: int, seq_len: int) -> QuantPagedKVCache:
    """`paged_commit` for the int8 pool, in place: scatter a batch-1 prefill
    cache quantized per token (capacity `seq_len`, token t at slot t) into
    the slot's pages under per-page scales. A page's scale is the max of its
    committed tokens' scales (max|x| / 127 over the page, per head), and each
    token's codes are requantized from its own scale to the page's. Pad
    positions (t >= length) stay out of the page max and go to the trash
    page, as does the scale of a page that holds only pad. Leaves may carry
    a leading layers dim."""
    W = dense.k.shape[-3]
    assert W == seq_len, f"quant_paged_commit needs a full-capacity prefill cache; {W} != {seq_len}"
    P = pool.k.shape[-3]
    assert W % P == 0, (W, P)
    n_table, n_rows = page_row.shape[0], W // P
    dev = pool.k.device
    row = page_row.to(device=dev).long()
    t = torch.arange(W, device=dev)
    ok = t < length
    page_of = torch.where(ok, row[torch.clamp(t // P, 0, n_table - 1)], 0)
    off = t % P
    ridx = torch.arange(n_rows, device=dev)
    row_dst = torch.where(ridx * P < length, row[torch.clamp(ridx, 0, n_table - 1)], 0)
    stacked = pool.k.ndim == 5
    for pool_q, pool_s, dq, ds in ((pool.k, pool.k_scale, dense.k, dense.k_scale),
                                   (pool.v, pool.v_scale, dense.v, dense.v_scale)):
        s_row = ds.select(-3, 0)  # [(n,) W, Hkv]: the batch-1 row
        s_tok = torch.where(ok[:, None], s_row, 0.0)
        s_page = s_tok.reshape(*s_tok.shape[:-2], n_rows, P, -1).amax(dim=-2)
        s_tgt = torch.repeat_interleave(s_page, P, dim=-2)  # [(n,) W, Hkv]
        ratio = s_row / torch.clamp(s_tgt, min=1e-9)
        codes = _round_int8(dq.select(-4, 0).float() * ratio[..., None])
        if stacked:
            pool_q[:, page_of, off] = codes
            pool_s[:, row_dst] = s_page
        else:
            pool_q[page_of, off] = codes
            pool_s[row_dst] = s_page
    return pool


def paged_reset_scales(pool: QuantPagedKVCache, page_ids: torch.Tensor) -> QuantPagedKVCache:
    """Zero the scale rows of `page_ids` in place (the engine does it for
    every page it allocates, before the prefill commit); trash-page ids are
    harmless."""
    ids = page_ids.to(device=pool.k.device).long()
    if pool.k.ndim == 5:
        pool.k_scale[:, ids] = 0.0
        pool.v_scale[:, ids] = 0.0
    else:
        pool.k_scale[ids] = 0.0
        pool.v_scale[ids] = 0.0
    return pool


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


def paged_copy_page(pool, src: int, dst: int):
    """Copy physical page `src` onto `dst` in place (the device half of
    copy-on-write), an int8 pool's scale rows with its codes; a leading
    layers dim is copied along."""
    for t in pool:
        if pool.k.ndim == 5:
            t[:, dst] = t[:, src]
        else:
            t[dst] = t[src]
    return pool


def paged_decode_attend(cfg, cache, q, pos: torch.Tensor, pages: torch.Tensor, spec: AttnSpec,
                        backend):
    """One-token attention over the paged cache (already written at `pos`):
    q [B,1,Hq,D]; pos [B]; pages [B, n_pages] -> [B,1,Hq,D], through
    `Backend.paged_decode_attention`, or `quant_paged_decode_attention` for
    an int8 pool (dequantized in the kernel)."""
    if isinstance(cache, QuantPagedKVCache):
        return backend.quant_paged_decode_attention(q, cache.k, cache.v, cache.k_scale,
                                                    cache.v_scale, pages, pos, spec)
    return backend.paged_decode_attention(q, cache.k, cache.v, pages, pos, spec)
