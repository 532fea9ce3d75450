"""Single-token GQA decode attention over a paged KV cache, as per-page
partial softmaxes merged by `combine_pages`.

The pools are [N_pages, P, Hkv, D], indexed through a block table
[B, n_pages] of physical page ids; page j of slot b holds the absolute
positions [j P, (j+1) P), valid iff kpos <= pos_b (and, with a window,
kpos > pos_b - window). Physical page 0 is the trash page: a table entry of
0 gives the neutral partial (m, l, acc) = (-1e30, 0, 0) unread.

Replaces the TPU kernel
`repro/kernels/paged_attention.py::paged_attention_partials_pallas`. The
CUDA kernel (`csrc/paged_attention.cu`) gives each (page, kv head, slot)
cell its own CTA and writes the same three partial tensors; the merge,
`combine_pages`, is plain PyTorch shared by both forms, as in the JAX
package it is jnp outside the kernel. Bound on the H100: device-memory
bytes, one read of every valid page's K and V rows.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, common

NEG_INF = -1e30

_ARGTYPES = ([common.PTR] * 8 + [common.INT] * 7 + [common.FLOAT] * 3
             + [common.INT, common.PTR])


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
    B, Hkv, G, D = q.shape
    P = k_pages.shape[1]
    n_pages = page_table.shape[1]
    table = page_table.long()
    kg = k_pages.float()[table].permute(0, 3, 1, 2, 4)  # [B, Hkv, n_pages, P, D]
    vg = v_pages.float()[table].permute(0, 3, 1, 2, 4)
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


def paged_attention_partials(q, k_pages, v_pages, page_table, pos, *, window: int = 0,
                             softcap: float = 0.0, scale: float = None):
    """Per-page partials (m, l, acc), float32: the kernel on a CUDA tensor, the
    plain version on a CPU tensor. q [B, Hkv, G, D] and the pools contiguous,
    of one float type; table [B, n_pages] and pos [B] int32. Every table
    entry must lie in [0, N_pages): the kernel reads the pages it is given
    without a bounds check (the serving engine owns the table)."""
    if q.device.type == "cpu":
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
    m = torch.empty(B, Hkv, n_pages, G, device=device)
    l = torch.empty_like(m)
    acc = torch.empty(B, Hkv, n_pages, G, D, device=device)
    fn = build.entry("paged_attention", "chef_paged_attention", _ARGTYPES)
    common.launch("paged_attention", fn, device, q.data_ptr(), k_pages.data_ptr(),
                  v_pages.data_ptr(), page_table.data_ptr(), pos.data_ptr(), m.data_ptr(),
                  l.data_ptr(), acc.data_ptr(), B, Hkv, G, D, P, n_pages, int(window),
                  float(softcap), 1.0 / softcap if softcap else 0.0, float(scale or D**-0.5),
                  int(q.dtype == torch.bfloat16))
    return m, l, acc
