"""The decoder stack of the serving path (the port of the parts of
`repro/models/transformer.py` the paged engine runs), for attention-only
decoders built of `attn` blocks.

Parameters are stacked per layer as in `repro` (`params["blocks"][j]` holds
pattern slot j of every super-block), so they carry across one to one;
`run_stack` is a plain loop over the layers, where `repro` scans. Modes:

* ``prefill`` — full sequence, returns the dense cache of every layer.
* ``tail``    — a prefix-sharing tail prefill: the unshared tail tokens
  attend over [shared-prefix K/V from the pages | tail K/V | zero pad] at
  the solo run's width; returns the tail's dense cache.
* ``decode``  — one token a slot, each at its own position, written into
  the paged cache in place and attended through the block table.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models.attention import AttnSpec, KVCache

_NOT_PORTED = ("is not ported to repro_torch yet (the port runs attention-only decoders "
               "with rotary positions); see ROADMAP.md queue 1")


def _check_supported(cfg) -> None:
    """Raise for an architecture the port's stack cannot run."""
    if not paged_supported(cfg) or any(k != "attn" for k in cfg.block_pattern) \
            or cfg.rope_kind != "rope":
        raise NotImplementedError(f"arch {cfg.name!r} (pattern {cfg.block_pattern}, rope "
                                  f"{cfg.rope_kind!r}) {_NOT_PORTED}")


# ----------------------------------------------------------------------------
# Parameter init
# ----------------------------------------------------------------------------


def _init_block(create, cfg, layers: int) -> dict:
    return {"norm1": L.init_norm(create, cfg, layers),
            "attn": attn_lib.init_attn(create, cfg, layers),
            "norm2": L.init_norm(create, cfg, layers),
            "mlp": L.init_mlp(create, cfg, layers)}


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
    params["blocks"] = tuple(_init_block(create, cfg, n_super) for _ in pattern) if n_super \
        else ()
    params["tail"] = tuple(_unstack0(_init_block(create, cfg, 1)) for _ in pattern[:rem])
    params["final_norm"] = _unstack0(L.init_norm(create, cfg, 1))
    return params


# ----------------------------------------------------------------------------
# Caches
# ----------------------------------------------------------------------------


def paged_supported(cfg) -> bool:
    """`repro`'s rule: every block an attention kind, decoder-only, rotary."""
    return (all(k in ("attn", "local", "attn_moe") for k in cfg.block_pattern)
            and not cfg.is_encoder_decoder and cfg.rope_kind != "none")


def init_cache(cfg, batch: int, seq_len: int, dtype, device, full: bool = False) -> dict:
    """Dense prefill cache: per pattern slot a KVCache [n_super, B, seq_len,
    Hkv, D], per remainder layer one [B, seq_len, Hkv, D], and `pos`. Only
    the full capacity exists in the port: a window-bounded ring cache (what
    `repro` allocates for sliding-window archs without `full`) is not
    ported."""
    if not full and (cfg.sliding_window or "local" in cfg.block_pattern):
        raise NotImplementedError("the ring KV cache is not ported to repro_torch yet; see "
                                  "ROADMAP.md queue 1")
    pattern = cfg.block_pattern
    n_super, rem = divmod(cfg.n_layers, len(pattern))

    def dense(layers):
        return {"kv": attn_lib.init_kv_cache(cfg, batch, seq_len, dtype, device, layers)}

    return {"blocks": tuple(dense(n_super) for _ in pattern) if n_super else (),
            "tail": tuple(dense(0) for _ in pattern[:rem]),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def init_paged_cache(cfg, batch: int, num_pages: int, page_size: int, table_pages: int, dtype,
                     device) -> dict:
    """Paged cache: one page pool per pattern slot (stacked over its
    super-blocks) and per remainder layer, plus the engine-owned per-slot
    state: `pos` [batch], the block table `pages` [batch, table_pages] (an
    all-zero row parks a slot on the trash page) and `refcount`
    [num_pages], the device mirror of the engine's page refcounts."""
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


def _attn_spec(cfg) -> AttnSpec:
    window = cfg.sliding_window if cfg.attn_kind == "sliding" else 0
    return AttnSpec(causal=True, window=window, logit_softcap=cfg.attn_logit_softcap)


def _rotate(cfg, x, pos):
    return L.apply_rope(x, pos, cfg.rope_theta)  # the only rope_kind the port runs


def apply_block(cfg, p: dict, h: torch.Tensor, *, mode: str, cache: dict,
                pos: torch.Tensor, backend, pages: Optional[torch.Tensor] = None,
                share_pages: int = 0, kv_len: int = 0, prefill_chunk: int = 0):
    """One `attn` block in mode prefill, tail or (paged) decode -> (h, the
    block's new cache). `pos` is [S] absolute positions (prefill, tail) or
    the per-slot [B] positions (decode)."""
    spec = _attn_spec(cfg)
    x = L.apply_norm(cfg, p["norm1"], h)
    q, k, v = attn_lib.qkv_proj(cfg, p["attn"], x)
    if mode == "tail":
        q, k = _rotate(cfg, q, pos), _rotate(cfg, k, pos)
        kf, vf = attn_lib.paged_prefix_concat(cache["pool"], pages[0], share_pages, k, v, kv_len)
        kpos = torch.arange(kv_len, device=h.device)
        o = attn_lib.attention(q, kf, vf, pos, kpos, spec, backend, prefill_chunk)
        dense = cache["kv"]
        new_cache = {"kv": KVCache(k.to(dense.k.dtype), v.to(dense.v.dtype))}
    elif mode == "decode":
        pvec = pos[:, None]  # [B, 1]: each slot at its own position
        q, k = _rotate(cfg, q, pvec), _rotate(cfg, k, pvec)
        kv = attn_lib.paged_update_decode(cache["kv"], k, v, pos, pages)
        o = attn_lib.paged_decode_attend(cfg, kv, q, pos, pages, spec, backend)
        new_cache = cache
    elif mode == "prefill":
        q, k = _rotate(cfg, q, pos), _rotate(cfg, k, pos)
        o = attn_lib.attention(q, k, v, pos, pos, spec, backend, prefill_chunk)
        dense = cache["kv"]
        S = k.shape[1]
        if S > dense.capacity:
            raise NotImplementedError("a prefill wider than its cache (the ring roll) is not "
                                      "ported to repro_torch yet; see ROADMAP.md queue 1")
        dense.k[:, :S] = k.to(dense.k.dtype)
        dense.v[:, :S] = v.to(dense.v.dtype)
        new_cache = cache
    else:
        raise ValueError(f"unknown mode {mode!r}")
    h = h + attn_lib.out_proj(p["attn"], o)
    x = L.apply_norm(cfg, p["norm2"], h)
    return h + L.apply_mlp(cfg, p["mlp"], x), new_cache


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
    a tail prefill returns its dense tail cache stacked like `repro`'s."""
    _check_supported(cfg)
    pattern = cfg.block_pattern
    n_super, rem = divmod(cfg.n_layers, len(pattern))
    pages = cache.get("pages")
    kw = dict(mode=mode, pos=pos, backend=backend, pages=pages, share_pages=share_pages,
              kv_len=kv_len, prefill_chunk=prefill_chunk)
    out: list = [[] for _ in params["blocks"]]
    for i in range(n_super):
        for j in range(len(pattern)):
            h, c = apply_block(cfg, _layer(params["blocks"][j], i), h,
                               cache=_layer(cache["blocks"][j], i), **kw)
            out[j].append(c)
    block_caches = [_stack(c) if mode == "tail" else cache["blocks"][j]
                    for j, c in enumerate(out)]
    tail_caches = []
    for j in range(rem):
        h, c = apply_block(cfg, params["tail"][j], h, cache=cache["tail"][j], **kw)
        tail_caches.append(c)
    new_pos = cache["pos"] + (1 if mode == "decode" else h.shape[1])
    new_cache = {"blocks": tuple(block_caches), "tail": tuple(tail_caches), "pos": new_pos}
    if pages is not None:
        new_cache["pages"] = pages
    if "refcount" in cache:
        new_cache["refcount"] = cache["refcount"]
    return StackOut(h, new_cache)
