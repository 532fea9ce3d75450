"""The capacity-preallocated growing dataset store (the port of
`repro/stream/window.py`).

A streaming run over a capacity of N_cap rows keeps every per-row tensor at
its full capacity shape from the start (features, labels, weights,
provenance, and the [T, C, d+1] trajectory whose batch schedule is drawn
once over N_cap) and grows by writing arriving rows into the padded tail.
Two invariants make that exact:

  1. Padding rows are exact neutral elements: their weight is 0.0 and every
     batch-gradient kernel multiplies the residual by the weight
     ((P - Y) * 0 == 0.0), so a padding row adds nothing to any gradient
     whatever its X / y_prob rows hold.
  2. The batch schedule is drawn over the CAPACITY, so arriving rows already
     hold batch slots: a window append is a pure label / weight change on
     its rows, the event `core.deltagrad.absorb_rows` replays.

Every tensor lives on the device the store was created on. An update
builds new tensors (`index_copy`, `slice_scatter`) and never writes into
one that a cleaning session or an earlier store holds: in warm mode
`write_labels` hands the store the session's own label tensors, and the
absorb's replay needs them as they were before the append. `repro`'s
mesh sharding of the rows (`_commit_rows`), and with it the store's
`backend`, waits for the port of `dist`.

Selection never sees padding: `valid` feeds `CleaningSession.eligible_mask`.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from repro_torch.data.synth import ChefDataset
from repro_torch.device import resolve_device
from repro_torch.stream.ingest import StreamSource, Window


@dataclass(frozen=True)
class WindowStore:
    """Immutable handle on the capacity store: `ds` holds capacity-shaped
    tensors (rows >= `n` are neutral padding); `append` returns a new store.
    Label state (y_prob / y_weight / cleaned) is authoritative only until a
    cleaning session takes over; `write_labels` syncs it back before the
    next append."""

    ds: ChefDataset  # capacity-shaped; rows >= n are exact-neutral padding
    n: int  # valid rows
    capacity: int
    gamma: float

    @classmethod
    def create(cls, source: StreamSource, *, capacity: Optional[int] = None,
               device=None) -> "WindowStore":
        """Preallocate the store for `source` on `device` (the card unless
        `device="cpu"`; capacity defaults to the source's total row budget).
        Padding rows carry weight 0.0, the exact neutral element, and
        all-zero features and labels."""
        dev = resolve_device(device)
        cap = int(capacity if capacity is not None else source.total_rows)
        d = int(source.X_val.shape[1])
        C, A = int(source.n_classes), int(source.n_annotators)
        ds = ChefDataset(
            name="stream",
            X=torch.zeros(cap, d, device=dev),
            y_prob=torch.zeros(cap, C, device=dev),
            y_weight=torch.zeros(cap, device=dev),
            cleaned=torch.zeros(cap, dtype=torch.bool, device=dev),
            y_true=torch.zeros(cap, dtype=torch.int64, device=dev),
            human_labels=torch.zeros(cap, A, dtype=torch.int64, device=dev),
            X_val=source.X_val.to(dev), y_val=source.y_val.to(dev),
            X_test=source.X_test.to(dev), y_test=source.y_test.to(dev),
            n_classes=C,
        )
        return cls(ds=ds, n=0, capacity=cap, gamma=float(source.gamma))

    @property
    def device(self) -> torch.device:
        """The device every tensor of the store lives on."""
        return self.ds.X.device

    @property
    def valid(self) -> torch.Tensor:
        """[capacity] bool — True for rows that have arrived. Feeds
        `CleaningSession.eligible_mask` so selection never proposes a
        padding row."""
        return torch.arange(self.capacity, device=self.device) < self.n

    def append(self, window: Window) -> "tuple[WindowStore, torch.Tensor]":
        """Write an arriving window into rows [n, n+m) of new tensors:
        features, weak labels, weight gamma. Returns (new store, the [m] row
        ids), the changed set `absorb_rows` and `extend_provenance` take."""
        m = window.m
        if self.n + m > self.capacity:
            raise ValueError(f"window of {m} rows exceeds capacity {self.capacity} "
                             f"(have {self.n})")
        dev = self.device
        idx = torch.arange(self.n, self.n + m, device=dev)
        ds = self.ds
        ds = replace(
            ds,
            X=ds.X.index_copy(0, idx, window.X.to(dev, ds.X.dtype)),
            y_prob=ds.y_prob.index_copy(0, idx, window.y_prob.to(dev, ds.y_prob.dtype)),
            y_weight=ds.y_weight.index_fill(0, idx, self.gamma),
            y_true=ds.y_true.index_copy(0, idx, window.y_true.to(dev, ds.y_true.dtype)),
            human_labels=ds.human_labels.index_copy(
                0, idx, window.human_labels.to(dev, ds.human_labels.dtype)),
        )
        return replace(self, ds=ds, n=self.n + m), idx

    def write_labels(self, session_ds: ChefDataset) -> "WindowStore":
        """Sync label state (y_prob / y_weight / cleaned) back from a
        cleaning session's dataset: capacity-shaped (warm session, whose
        tensors the store then shares) or dense over the first n rows (cold
        session, written into new tensors)."""
        rows = int(session_ds.y_weight.shape[0])
        if rows == self.capacity:
            ds = replace(self.ds, y_prob=session_ds.y_prob, y_weight=session_ds.y_weight,
                         cleaned=session_ds.cleaned)
        elif rows == self.n:
            ds = replace(self.ds,
                         y_prob=self.ds.y_prob.slice_scatter(session_ds.y_prob, 0, 0, rows),
                         y_weight=self.ds.y_weight.slice_scatter(session_ds.y_weight, 0, 0, rows),
                         cleaned=self.ds.cleaned.slice_scatter(session_ds.cleaned, 0, 0, rows))
        else:
            raise ValueError(f"label state has {rows} rows; expected n={self.n} "
                             f"or capacity={self.capacity}")
        return replace(self, ds=ds)

    def dense(self) -> ChefDataset:
        """The [0, n) rows as a plain dense dataset: what the cold
        (warm_start=False) path re-initializes on, and bit for bit the batch
        dataset when the stream's windows concatenate to it."""
        s = slice(0, self.n)
        ds = self.ds
        return replace(ds, X=ds.X[s], y_prob=ds.y_prob[s], y_weight=ds.y_weight[s],
                       cleaned=ds.cleaned[s], y_true=ds.y_true[s],
                       human_labels=ds.human_labels[s])

    @classmethod
    def from_arrays(cls, X, y_true, human_labels, *, n: int, gamma: float, X_val, y_val, X_test,
                    y_test, n_classes: int, device=None) -> "WindowStore":
        """Rebuild a store on `device` (the card unless `device="cpu"`) from
        checkpointed capacity arrays (the streaming session's restore).
        Label state starts neutral: the restored cleaning session owns it
        and `write_labels` syncs it before the next append."""
        dev = resolve_device(device)

        def f32(a):
            return torch.as_tensor(a, device=dev).to(torch.float32)

        def i64(a):
            return torch.as_tensor(a, device=dev).to(torch.int64)

        X = f32(X)
        cap, C = int(X.shape[0]), int(n_classes)
        ds = ChefDataset(
            name="stream", X=X,
            y_prob=torch.zeros(cap, C, device=dev),
            y_weight=torch.zeros(cap, device=dev),
            cleaned=torch.zeros(cap, dtype=torch.bool, device=dev),
            y_true=i64(y_true), human_labels=i64(human_labels),
            X_val=f32(X_val), y_val=f32(y_val), X_test=f32(X_test), y_test=i64(y_test),
            n_classes=C,
        )
        return cls(ds=ds, n=int(n), capacity=cap, gamma=float(gamma))
