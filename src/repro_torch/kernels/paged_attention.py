"""Single-token GQA decode attention over a paged KV cache, as per-page
partial softmaxes merged by `combine_pages`.

The pools are [N_pages, P, Hkv, D], indexed through a block table
[B, n_pages] of physical page ids; page j of slot b holds the absolute
positions [j P, (j+1) P), valid iff kpos <= pos_b (and, with a window,
kpos > pos_b - window). Physical page 0 is the trash page: a table entry of
0 gives the neutral partial (m, l, acc) = (-1e30, 0, 0) unread.

Replaces the TPU kernel
`repro/kernels/paged_attention.py::paged_attention_partials_pallas`. The
CUDA kernel (`csrc/paged_attention.cu`) gives each (slot, kv head, page)
cell one warp, several warps a CTA and no block barrier: a trash page, or
a page with no valid key, writes the neutral partial without reading the
pool; a live page's K and V rows go to the warp's shared memory in 16-byte
copies all issued at once, and the scores, softmax and p.v run in
registers, a few query rows at a time. It writes the same three partial
tensors, in one allocation; the merge, `combine_pages`, is plain PyTorch
shared by both forms, as in the JAX package it is jnp outside the kernel.
Bound on the H100: device-memory bytes, one read of every live page's K
and V rows and the partials written; at decode sizes latency weighs as
much (the source's note says what the design does about it).

Its int8 mode (`paged_attention_partials_quant`, the C entry
`chef_paged_attention_quant`) replaces
`paged_attention_partials_quant_pallas`: the pools hold int8 codes with one
float32 scale per (page, kv head), and each code is widened in registers as
code * scale (`repro`'s `_dequant_page`, the same bits), so the pool
crosses memory at a quarter of the float32 bytes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, common

NEG_INF = -1e30

_ARGTYPES = ([common.PTR] * 8 + [common.INT] * 7 + [common.FLOAT] * 3
             + [common.INT, common.PTR])
_QUANT_ARGTYPES = ([common.PTR] * 10 + [common.INT] * 7 + [common.FLOAT] * 3
                   + [common.INT, common.PTR])
_PLAN_ARGTYPES = [common.INT] * 4 + [common.PTR]


@functools.cache
def paged_plan(G: int, D: int, P: int, kv_bytes: int) -> dict:
    """The kernels' launch at these shapes, as `csrc/paged_attention.cu`
    plans it (kv_bytes: 4 float32, 2 bfloat16, 1 int8 pools): query `rows`
    a warp takes at once, `warps` (page cells) a CTA, `keys` whose scores
    one transpose reduction sums, `smem` bytes a CTA. For reports only: the
    kernel plans its own launch. Raises where it takes no such shapes."""
    fn = build.entry("paged_attention", "chef_paged_plan", _PLAN_ARGTYPES)
    plan = (ctypes.c_int * 4)()
    err = fn(G, D, P, kv_bytes, plan)
    if err != 0:
        raise ValueError(f"paged_attention: no launch for G {G}, D {D}, P {P}, "
                         f"{kv_bytes}-byte pools: {build.error_string('paged_attention', err)}")
    return dict(zip(("rows", "warps", "keys", "smem"), plan))


def _page_partial(q, k, v, valid, *, scale: float, softcap: float):
    """Self-normalised partial softmax of pages: q [..., G, D]; k, v
    [..., P, D]; valid [..., P] -> (m [..., G], l [..., G], acc [..., G, D]).
    A wholly invalid page gives (NEG_INF, 0, 0): p is masked by `where`."""
    s = (q @ k.transpose(-1, -2)) * scale  # [..., G, P]
    if softcap:
        s = softcap * torch.tanh(s * (1.0 / softcap))
    mask = valid[..., None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    return m, p.sum(dim=-1), p @ v


def paged_attention_partials_reference(q, k_pages, v_pages, page_table, pos, *, window: int = 0,
                                       softcap: float = 0.0, scale: float = None):
    """Plain PyTorch version: `_page_partial` over every (slot, kv head, page)
    cell at once, the pages gathered through the table. q [B, Hkv, G, D] ->
    (m [B, Hkv, n_pages, G], l [B, Hkv, n_pages, G], acc [B, Hkv, n_pages, G,
    D]) in float32."""
    table = page_table.long()
    return _partials(q, k_pages.float()[table], v_pages.float()[table], page_table, pos,
                     window=window, softcap=softcap, scale=scale)


def dequant_page(codes, scale):
    """int8 codes [..., P, Hkv, D] and their pages' scales [..., Hkv] ->
    float32 codes * scale (`repro`'s `_dequant_page`: exact widening, one
    multiply)."""
    return codes.float() * scale[..., None, :, None]


def paged_attention_partials_quant_reference(q, k_pages, v_pages, k_scale, v_scale, page_table,
                                             pos, *, window: int = 0, softcap: float = 0.0,
                                             scale: float = None):
    """Plain PyTorch version of the int8 mode: the int8 pages gathered through
    the table, dequantized with their (page, head) scales, then the float
    partials."""
    table = page_table.long()
    return _partials(q, dequant_page(k_pages[table], k_scale[table]),
                     dequant_page(v_pages[table], v_scale[table]), page_table, pos,
                     window=window, softcap=softcap, scale=scale)


def _partials(q, kg, vg, page_table, pos, *, window: int, softcap: float, scale: float):
    """The partials from the gathered float32 pages kg, vg [B, n_pages, P,
    Hkv, D]."""
    B, Hkv, G, D = q.shape
    P = kg.shape[2]
    n_pages = page_table.shape[1]
    kg = kg.permute(0, 3, 1, 2, 4)  # [B, Hkv, n_pages, P, D]
    vg = vg.permute(0, 3, 1, 2, 4)
    kpos = (torch.arange(n_pages, device=q.device)[:, None] * P
            + torch.arange(P, device=q.device)[None, :])  # [n_pages, P]
    pos_b = pos.long()[:, None, None]
    valid = kpos[None] <= pos_b
    if window:
        valid &= kpos[None] > pos_b - window
    m, l, acc = _page_partial(q.float()[:, :, None], kg, vg, valid[:, None],
                              scale=float(scale or D**-0.5), softcap=float(softcap))
    trash = (page_table == 0)[:, None, :, None]  # [B, 1, n_pages, 1]
    return (torch.where(trash, NEG_INF, m), torch.where(trash, 0.0, l),
            torch.where(trash[..., None], 0.0, acc))


def combine_pages(m, l, acc) -> torch.Tensor:
    """Merge per-page partial softmaxes: m, l [..., n_pages, G]; acc
    [..., n_pages, G, D] -> [..., G, D]. Neutral partials (NEG_INF, 0, 0)
    weigh exactly zero unless every page is neutral, which gives 0."""
    M = m.amax(dim=-2)  # [..., G]
    w = torch.exp(m - M[..., None, :])  # [..., n_pages, G]
    l_tot = (l * w).sum(dim=-2)
    acc_tot = (acc * w[..., None]).sum(dim=-3)
    return acc_tot / torch.clamp(l_tot, min=1e-30)[..., None]


def _outputs(B: int, Hkv: int, n_pages: int, G: int, D: int, device):
    """The kernels' outputs in one allocation: acc [B, Hkv, n_pages, G, D],
    then m and l [B, Hkv, n_pages, G], contiguous views (as_strided: the
    fewest host ops); and the address of each."""
    rows = B * Hkv * n_pages * G
    buf = torch.empty(rows * (D + 2), device=device)
    shape, strides = (B, Hkv, n_pages, G), (Hkv * n_pages * G, n_pages * G, G, 1)
    ptr = buf.data_ptr()
    m = buf.as_strided(shape, strides, rows * D)
    l = buf.as_strided(shape, strides, rows * (D + 1))
    acc = buf.as_strided(shape + (D,), tuple(x * D for x in strides) + (1,))
    return (m, l, acc), (ptr + 4 * rows * D, ptr + 4 * rows * (D + 1), ptr)


def paged_attention_partials(q, k_pages, v_pages, page_table, pos, *, window: int = 0,
                             softcap: float = 0.0, scale: float = None):
    """Per-page partials (m, l, acc), float32: the kernel on a CUDA tensor, the
    plain version on a CPU tensor. q [B, Hkv, G, D] and the pools contiguous,
    of one float type; table [B, n_pages] and pos [B] int32. Every table
    entry must lie in [0, N_pages): the kernel reads the pages it is given
    without a bounds check (the serving engine owns the table)."""
    if q.is_cpu:
        return paged_attention_partials_reference(q, k_pages, v_pages, page_table, pos,
                                                  window=window, softcap=softcap, scale=scale)
    B, Hkv, G, D = q.shape
    n_phys, P = k_pages.shape[:2]
    n_pages = page_table.shape[1]
    pool = (n_phys, P, Hkv, D)
    device = common.check_attention(
        "paged_attention", q=(q, (B, Hkv, G, D), "float", True),
        k_pages=(k_pages, pool, "float", True), v_pages=(v_pages, pool, "float", True),
        page_table=(page_table, (B, n_pages), "int32", True), pos=(pos, (B,), "int32", True))
    out, ptrs = _outputs(B, Hkv, n_pages, G, D, device)
    fn = build.entry("paged_attention", "chef_paged_attention", _ARGTYPES)
    common.launch("paged_attention", fn, device, q.data_ptr(), k_pages.data_ptr(),
                  v_pages.data_ptr(), page_table.data_ptr(), pos.data_ptr(), *ptrs, B, Hkv, G,
                  D, P, n_pages, int(window), float(softcap), 1.0 / softcap if softcap else 0.0,
                  float(scale or D**-0.5), int(q.dtype == torch.bfloat16))
    return out


def paged_attention_partials_quant(q, k_pages, v_pages, k_scale, v_scale, page_table, pos, *,
                                   window: int = 0, softcap: float = 0.0, scale: float = None):
    """Per-page partials (m, l, acc) over int8 pools, float32: the kernel on a
    CUDA tensor, the plain version on a CPU tensor. q [B, Hkv, G, D]
    contiguous float32 or bfloat16; pools [N_pages, P, Hkv, D] contiguous
    int8; scales [N_pages, Hkv] contiguous float32; table and pos as
    `paged_attention_partials`."""
    if q.is_cpu:
        return paged_attention_partials_quant_reference(
            q, k_pages, v_pages, k_scale, v_scale, page_table, pos, window=window,
            softcap=softcap, scale=scale)
    B, Hkv, G, D = q.shape
    n_phys, P = k_pages.shape[:2]
    n_pages = page_table.shape[1]
    pool = (n_phys, P, Hkv, D)
    device = common.check_attention(
        "paged_attention_quant", q=(q, (B, Hkv, G, D), "float", True),
        k_pages=(k_pages, pool, torch.int8, True), v_pages=(v_pages, pool, torch.int8, True),
        k_scale=(k_scale, (n_phys, Hkv), torch.float32, True),
        v_scale=(v_scale, (n_phys, Hkv), torch.float32, True),
        page_table=(page_table, (B, n_pages), "int32", True), pos=(pos, (B,), "int32", True))
    out, ptrs = _outputs(B, Hkv, n_pages, G, D, device)
    fn = build.entry("paged_attention_quant", "chef_paged_attention_quant", _QUANT_ARGTYPES)
    common.launch("paged_attention_quant", fn, device, q.data_ptr(), k_pages.data_ptr(),
                  v_pages.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                  page_table.data_ptr(), pos.data_ptr(), *ptrs, B, Hkv, G, D, P, n_pages,
                  int(window), float(softcap), 1.0 / softcap if softcap else 0.0,
                  float(scale or D**-0.5), int(q.dtype == torch.bfloat16))
    return out
