"""Streaming ingest (the port of `repro/stream/ingest.py`): the `StreamSource`
protocol and a lazy windowed batching pipeline.

Online CHEF consumes data as a sequence of `Window`s, small batches of
weakly-labelled rows that arrive between cleaning rounds:

  * `windowed(chunks, size)` is a LAZY re-chunker: it consumes an iterable
    of row chunks of any size and yields windows of exactly `size` rows,
    pulling from the upstream iterator only when the next window needs
    rows. Nothing is held beyond one window's buffer.

  * `SyntheticStream` is a weak-label stream over `data.synth`: ONE
    `make_dataset` draw cut into windows, so the first k windows are, bit
    for bit, rows [0, k * window_size) of the batch dataset
    (`batch_dataset(k)`), which makes the stream-against-batch contract
    exact. The draw goes through this module's `make_dataset`, so a test can
    hand the stream the JAX package's dataset.
"""
from __future__ import annotations

from typing import Iterable, Iterator, NamedTuple, Optional, Protocol, runtime_checkable

import torch

from repro_torch.data.synth import ChefDataset, make_dataset


class Window(NamedTuple):
    """One arriving chunk of weakly-labelled rows (leading dim = rows)."""

    X: torch.Tensor  # [m, d] frozen-backbone features
    y_prob: torch.Tensor  # [m, C] weak (probabilistic) labels
    y_true: torch.Tensor  # [m] hidden ground truth (simulation only)
    human_labels: torch.Tensor  # [m, A] simulated annotator labels

    @property
    def m(self) -> int:
        """Number of rows in the window."""
        return int(self.X.shape[0])


def _concat(parts: list) -> Window:
    if len(parts) == 1:
        return parts[0]
    return Window(*(torch.cat(fields) for fields in zip(*parts)))


def windowed(chunks: Iterable[Window], size: int, *, drop_last: bool = False) -> Iterator[Window]:
    """Lazily re-chunk an iterable of `Window` chunks into windows of exactly
    `size` rows: rows are buffered across chunk boundaries and the upstream
    iterator is advanced only when the buffer cannot fill the next window.
    The final short window is yielded unless `drop_last`."""
    if size < 1:
        raise ValueError(f"window size must be >= 1, got {size}")
    buf: list = []
    have = 0
    for chunk in chunks:
        buf.append(chunk)
        have += chunk.m
        while have >= size:
            merged = _concat(buf)
            out = Window(*(f[:size] for f in merged))
            rest = Window(*(f[size:] for f in merged))
            yield out
            have -= size
            buf = [rest] if have else []
    if have and not drop_last:
        yield _concat(buf)


@runtime_checkable
class StreamSource(Protocol):
    """What the streaming session needs from a data stream: an iterator of
    `Window`s plus the fixed evaluation context (validation and test splits,
    class count, the weak-label weight gamma, and the total row budget that
    sizes the capacity store)."""

    n_classes: int
    gamma: float
    total_rows: int
    n_annotators: int
    X_val: torch.Tensor
    y_val: torch.Tensor
    X_test: torch.Tensor
    y_test: torch.Tensor

    def windows(self) -> Iterator[Window]:
        """Yield arriving windows in order (lazily)."""
        ...


class SyntheticStream:
    """Synthetic weak-label stream on `device` (the card unless
    `device="cpu"`): one `make_dataset` draw from `generator` served in
    `window_size`-row windows, so streaming and batch runs see the same rows
    bit for bit. `windows()` yields lazily through `windowed`;
    `batch_dataset(k)` is the from-scratch oracle over the first k windows
    (default: all)."""

    def __init__(self, generator: Optional[torch.Generator] = None, *, window_size: int = 100,
                 n_windows: int = 4, n_val: int = 64, n_test: int = 64, feature_dim: int = 24,
                 gamma: float = 0.8, device=None, **make_kw):
        self.window_size = int(window_size)
        self.n_windows = int(n_windows)
        self.total_rows = self.window_size * self.n_windows
        self._ds = make_dataset(generator, n_train=self.total_rows, n_val=n_val, n_test=n_test,
                                feature_dim=feature_dim, gamma=gamma, device=device, **make_kw)
        self.n_classes = self._ds.n_classes
        self.gamma = float(gamma)
        self.n_annotators = int(self._ds.human_labels.shape[1])
        self.X_val, self.y_val = self._ds.X_val, self._ds.y_val
        self.X_test, self.y_test = self._ds.X_test, self._ds.y_test

    def _rows(self) -> Iterator[Window]:
        ds = self._ds
        for k in range(self.n_windows):
            s = slice(k * self.window_size, (k + 1) * self.window_size)
            yield Window(ds.X[s], ds.y_prob[s], ds.y_true[s], ds.human_labels[s])

    def windows(self) -> Iterator[Window]:
        """Lazy iterator of exact `window_size` windows."""
        return windowed(self._rows(), self.window_size)

    def batch_dataset(self, k: Optional[int] = None) -> ChefDataset:
        """The from-scratch oracle: the first k windows (default all) as one
        batch `ChefDataset`, bit for bit the rows the stream delivers."""
        k = self.n_windows if k is None else k
        n = k * self.window_size
        ds = self._ds
        return ChefDataset(
            name=ds.name, X=ds.X[:n], y_prob=ds.y_prob[:n], y_weight=ds.y_weight[:n],
            cleaned=ds.cleaned[:n], y_true=ds.y_true[:n], human_labels=ds.human_labels[:n],
            X_val=ds.X_val, y_val=ds.y_val, X_test=ds.X_test, y_test=ds.y_test,
            n_classes=ds.n_classes)


def generator_source(stream: SyntheticStream, chunk_rows: int) -> Iterator[Window]:
    """Serve a SyntheticStream's rows again as `chunk_rows`-row chunks: an
    upstream granularity that does not match the window, to exercise
    `windowed`'s re-chunking across chunk boundaries."""
    ds = stream._ds
    n = stream.total_rows
    for lo in range(0, n, chunk_rows):
        s = slice(lo, min(lo + chunk_rows, n))
        yield Window(ds.X[s], ds.y_prob[s], ds.y_true[s], ds.human_labels[s])
