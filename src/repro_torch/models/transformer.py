"""The decoder stack of the serving path (the port of the serving parts of
`repro/models/transformer.py`): decoders built of `attn`, `local` and
`attn_moe` attention blocks and `rglru` recurrent blocks, with rotary
positions. An `attn_moe` block's feed-forward half is the mixture of experts
(`models/moe.py`), whose aux loss serving does not read.

Parameters are stacked per layer as in `repro` (`params["blocks"][j]` holds
pattern slot j of every super-block; `params["tail"]` the remainder layers
that do not fill a whole pattern), so they carry across one to one;
`run_stack` is a plain loop over the layers, where `repro` scans. Modes:

* ``prefill`` — full sequence, writes every layer's cache: the K/V of an
  attention layer (ring-rolled when the prompt is longer than the ring),
  the recurrent state of an RG-LRU layer.
* ``tail``    — a prefix-sharing tail prefill: the unshared tail tokens
  attend over [shared-prefix K/V from the pages | tail K/V | zero pad] at
  the solo run's width; returns the tail's dense cache.
* ``decode``  — one token a sequence: over the paged cache each slot at its
  own position ([B] positions, written into the pages in place), or over the
  ring cache at one shared position (a 0-dim tensor, written at slot
  pos % W); an RG-LRU layer steps its state.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models.attention import AttnSpec, KVCache

_NOT_PORTED = ("is not ported to repro_torch yet (the port runs decoders of attn, local, "
               "attn_moe and rglru blocks with rotary positions; ssd, enc-dec, M-RoPE and "
               "sinusoidal positions are still to port); see ROADMAP.md queue 1")


def _check_supported(cfg) -> None:
    """Raise for an architecture the port's stack cannot run."""
    kinds_ok = all(k in ("attn", "local", "attn_moe", "rglru") for k in cfg.block_pattern)
    if not kinds_ok or cfg.is_encoder_decoder or cfg.rope_kind != "rope":
        raise NotImplementedError(f"arch {cfg.name!r} (pattern {cfg.block_pattern}, rope "
                                  f"{cfg.rope_kind!r}, enc-dec {cfg.is_encoder_decoder}) "
                                  f"{_NOT_PORTED}")
    if "rglru" in cfg.block_pattern and cfg.rglru is None:
        raise ValueError(f"arch {cfg.name!r} has rglru blocks but no RGLRUConfig")
    if "attn_moe" in cfg.block_pattern and cfg.moe is None:
        raise ValueError(f"arch {cfg.name!r} has attn_moe blocks but no MoEConfig")


# ----------------------------------------------------------------------------
# Parameter init
# ----------------------------------------------------------------------------


def _init_block(create, cfg, kind: str, layers: int) -> dict:
    p = {"norm1": L.init_norm(create, cfg, layers)}
    if kind == "rglru":
        p["rglru"] = rglru_lib.init_rglru(create, cfg, layers)
    else:
        p["attn"] = attn_lib.init_attn(create, cfg, layers)
    p["norm2"] = L.init_norm(create, cfg, layers)
    if kind == "attn_moe":
        p["moe"] = moe_lib.init_moe(create, cfg, layers)
    else:
        p["mlp"] = L.init_mlp(create, cfg, layers)
    return p


def _unstack0(tree):
    if isinstance(tree, dict):
        return {k: _unstack0(v) for k, v in tree.items()}
    return tree[0]


def init_params(cfg, create) -> dict:
    """`repro`'s parameter tree and draw order: embed, the stacked blocks of
    each pattern slot, the remainder layers, the final norm."""
    _check_supported(cfg)
    pattern = cfg.block_pattern
    n_super, rem = divmod(cfg.n_layers, len(pattern))
    params: dict = {"embed": L.init_embed(create, cfg)}
    params["blocks"] = tuple(_init_block(create, cfg, kind, n_super) for kind in pattern) \
        if n_super else ()
    params["tail"] = tuple(_unstack0(_init_block(create, cfg, kind, 1))
                           for kind in pattern[:rem])
    params["final_norm"] = _unstack0(L.init_norm(create, cfg, 1))
    return params


# ----------------------------------------------------------------------------
# Caches
# ----------------------------------------------------------------------------


def paged_supported(cfg) -> bool:
    """`repro`'s rule: every block an attention kind, decoder-only, rotary."""
    return (all(k in ("attn", "local", "attn_moe") for k in cfg.block_pattern)
            and not cfg.is_encoder_decoder and cfg.rope_kind != "none")


def cache_capacity(cfg, kind: str, seq_len: int, full: bool = False) -> int:
    """KV capacity of one block: the sliding window bounds it (a ring of
    min(window, seq_len) slots) unless `full`, which keeps every position
    (the paged engine's prefill, whose commit scatters them into pages)."""
    window = cfg.sliding_window
    if full:
        return seq_len
    if kind == "local" or (kind in ("attn", "attn_moe") and cfg.attn_kind == "sliding"):
        return min(window, seq_len) if window else seq_len
    return seq_len


def init_block_cache(cfg, kind: str, batch: int, seq_len: int, dtype, device, kv_dtype=None,
                     full: bool = False, layers: int = 0) -> dict:
    """One block's cache (stacked over `layers` when > 0): {"kv"} for an
    attention block (int8 when `kv_dtype` is), {"rg"} for an RG-LRU one."""
    if kind == "rglru":
        return {"rg": rglru_lib.init_rglru_state(cfg, batch, dtype, device, layers)}
    return {"kv": attn_lib.init_kv_cache(cfg, batch, cache_capacity(cfg, kind, seq_len, full),
                                         kv_dtype or dtype, device, layers)}


def init_cache(cfg, batch: int, seq_len: int, dtype, device, kv_dtype=None,
               full: bool = False) -> dict:
    """The model's ring cache: per pattern slot a block cache stacked over
    its super-blocks, per remainder layer one, and the shared position `pos`
    (a 0-dim tensor). `full` lifts the window bound (the paged prefill)."""
    _check_supported(cfg)
    pattern = cfg.block_pattern
    n_super, rem = divmod(cfg.n_layers, len(pattern))
    kw = dict(kv_dtype=kv_dtype, full=full)
    return {"blocks": tuple(init_block_cache(cfg, kind, batch, seq_len, dtype, device,
                                             layers=n_super, **kw) for kind in pattern)
            if n_super else (),
            "tail": tuple(init_block_cache(cfg, kind, batch, seq_len, dtype, device, **kw)
                          for kind in pattern[:rem]),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def init_paged_cache(cfg, batch: int, num_pages: int, page_size: int, table_pages: int, dtype,
                     device) -> dict:
    """Paged cache: one page pool per pattern slot (stacked over its
    super-blocks) and per remainder layer, int8 with scales when `dtype` is
    int8, plus the engine-owned per-slot state: `pos` [batch], the block
    table `pages` [batch, table_pages] (an all-zero row parks a slot on the
    trash page) and `refcount` [num_pages], the device mirror of the
    engine's page refcounts."""
    if not paged_supported(cfg):
        raise ValueError(f"paged KV cache needs an attention-only decoder arch; {cfg.name} has "
                         f"pattern {cfg.block_pattern}")
    pattern = cfg.block_pattern
    n_super, rem = divmod(cfg.n_layers, len(pattern))

    def pool(layers):
        return {"kv": attn_lib.init_paged_kv_cache(cfg, num_pages, page_size, dtype, device,
                                                   layers)}

    return {"blocks": tuple(pool(n_super) for _ in pattern) if n_super else (),
            "tail": tuple(pool(0) for _ in pattern[:rem]),
            "pos": torch.zeros(batch, dtype=torch.int32, device=device),
            "pages": torch.zeros(batch, table_pages, dtype=torch.int32, device=device),
            "refcount": torch.zeros(num_pages, dtype=torch.int32, device=device)}


# ----------------------------------------------------------------------------
# Block application
# ----------------------------------------------------------------------------


def _attn_spec(cfg, kind: str) -> AttnSpec:
    window = cfg.sliding_window if kind == "local" or cfg.attn_kind == "sliding" else 0
    return AttnSpec(causal=True, window=window, logit_softcap=cfg.attn_logit_softcap)


def _rotate(cfg, x, pos):
    return L.apply_rope(x, pos, cfg.rope_theta)  # the only rope_kind the port runs


def _attend(cfg, kind: str, p: dict, x: torch.Tensor, *, mode: str, cache: dict,
            pos: torch.Tensor, backend, pages, share_pages: int, kv_len: int,
            prefill_chunk: int):
    """The attention half of an `attn` / `local` / `attn_moe` block -> (o
    [B,S,Hq,D], the block's new cache). Caches are written in place."""
    spec = _attn_spec(cfg, kind)
    q, k, v = attn_lib.qkv_proj(cfg, p["attn"], x)
    if mode == "tail":
        q, k = _rotate(cfg, q, pos), _rotate(cfg, k, pos)
        kf, vf = attn_lib.paged_prefix_concat(cache["pool"], pages[0], share_pages, k, v, kv_len)
        kpos = torch.arange(kv_len, device=x.device)
        o = attn_lib.attention(q, kf, vf, pos, kpos, spec, backend, prefill_chunk)
        dense = cache["kv"]
        return o, {"kv": KVCache(k.to(dense.k.dtype), v.to(dense.v.dtype))}
    if mode == "decode" and pos.ndim == 1:  # paged: each slot at its own position
        pvec = pos[:, None]  # [B, 1]
        q, k = _rotate(cfg, q, pvec), _rotate(cfg, k, pvec)
        kv = attn_lib.paged_update_decode(cache["kv"], k, v, pos, pages)
        return attn_lib.paged_decode_attend(cfg, kv, q, pos, pages, spec, backend), cache
    if mode == "decode":  # ring: one shared position, a 0-dim tensor
        q, k = _rotate(cfg, q, pos[None]), _rotate(cfg, k, pos[None])
        kv = attn_lib.cache_update_decode(cache["kv"], k, v, pos)
        return attn_lib.decode_attend(cfg, kv, q, pos, spec, backend), cache
    if mode != "prefill":
        raise ValueError(f"unknown mode {mode!r}")
    q, k = _rotate(cfg, q, pos), _rotate(cfg, k, pos)
    o = attn_lib.attention(q, k, v, pos, pos, spec, backend, prefill_chunk)
    attn_lib.cache_write_prefill(cache["kv"], k, v)
    return o, cache


def apply_block(cfg, kind: str, p: dict, h: torch.Tensor, *, mode: str, cache: dict,
                pos: torch.Tensor, backend, pages: Optional[torch.Tensor] = None,
                share_pages: int = 0, kv_len: int = 0, prefill_chunk: int = 0):
    """One block of kind `attn`, `local`, `attn_moe` or `rglru` in mode
    prefill, tail or decode -> (h, the block's new cache). `pos` is [S]
    absolute positions (prefill, tail), the per-slot [B] positions (paged
    decode) or the ring's 0-dim position (ring decode). An RG-LRU prefill starts from zero state,
    as `repro`'s does; its state is written into the cache in place."""
    x = L.apply_norm(cfg, p["norm1"], h)
    if kind == "rglru":
        if mode == "decode":
            y, st = rglru_lib.apply_rglru_step(cfg, p["rglru"], x, cache["rg"])
        elif mode == "prefill":
            y, st = rglru_lib.apply_rglru_seq(cfg, p["rglru"], x, None)
        else:
            raise ValueError(f"rglru blocks run no {mode!r} mode")
        for dst, src in zip(cache["rg"], st):
            dst.copy_(src)
        new_cache = cache
    else:
        y, new_cache = _attend(cfg, kind, p, x, mode=mode, cache=cache, pos=pos,
                               backend=backend, pages=pages, share_pages=share_pages,
                               kv_len=kv_len, prefill_chunk=prefill_chunk)
        y = attn_lib.out_proj(p["attn"], y)
    h = h + y
    x = L.apply_norm(cfg, p["norm2"], h)
    if kind == "attn_moe":  # over the widths repro runs it over: they set the capacity
        y, _aux = moe_lib.apply_moe(cfg, p["moe"], x)
    else:
        y = L.apply_mlp(cfg, p["mlp"], x)
    return h + y, new_cache


class StackOut(NamedTuple):
    hidden: torch.Tensor
    cache: Any


def _layer(tree, i: int):
    """Layer i of a stacked tree (views: writes reach the stacked tensors)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(x[i] for x in tree))
    return tree[i]


def _stack(caches: list):
    """The layers' tail caches, stacked back over layers."""
    first = caches[0]
    if isinstance(first, dict):
        return {k: _stack([c[k] for c in caches]) for k in first}
    return type(first)(*(torch.stack(xs) for xs in zip(*caches)))


def run_stack(cfg, params: dict, h: torch.Tensor, *, mode: str, cache: dict, pos: torch.Tensor,
              backend, share_pages: int = 0, kv_len: int = 0, prefill_chunk: int = 0) -> StackOut:
    """Every layer in order. Prefill and decode write their caches in place;
    a tail prefill returns its dense tail cache stacked like `repro`'s. The
    new cache's `pos` is the old one advanced by the tokens run."""
    _check_supported(cfg)
    pattern = cfg.block_pattern
    n_super, rem = divmod(cfg.n_layers, len(pattern))
    pages = cache.get("pages")
    kw = dict(mode=mode, pos=pos, backend=backend, pages=pages, share_pages=share_pages,
              kv_len=kv_len, prefill_chunk=prefill_chunk)
    out: list = [[] for _ in params["blocks"]]
    for i in range(n_super):
        for j, kind in enumerate(pattern):
            h, c = apply_block(cfg, kind, _layer(params["blocks"][j], i), h,
                               cache=_layer(cache["blocks"][j], i), **kw)
            out[j].append(c)
    block_caches = [_stack(c) if mode == "tail" else cache["blocks"][j]
                    for j, c in enumerate(out)]
    tail_caches = []
    for j, kind in enumerate(pattern[:rem]):
        h, c = apply_block(cfg, kind, params["tail"][j], h, cache=cache["tail"][j], **kw)
        tail_caches.append(c)
    new_pos = cache["pos"] + (1 if mode == "decode" else h.shape[1])
    new_cache = {"blocks": tuple(block_caches), "tail": tuple(tail_caches), "pos": new_pos}
    if pages is not None:
        new_cache["pages"] = pages
    if "refcount" in cache:
        new_cache["refcount"] = cache["refcount"]
    return StackOut(h, new_cache)
