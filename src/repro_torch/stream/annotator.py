"""`ModelAnnotator` — a `ServeEngine` as the model-in-the-loop annotator
(the port of `repro/stream/annotator.py`).

CHEF's annotation phase is pluggable (`cleaning.phases.Annotator`); this one
replaces the simulated human vote with a served model. Each selected row
becomes a token prompt: a fixed task prefix (the same tokens every round,
so the paged engine's prefix index aliases its pages across rounds and
`run()` waves), then one bin token per feature. It is served for ONE new
token with `trace_logits` on, and the cleaned label is the argmax over the
first `n_classes` logits.

The engine runs on its own device and backend; only the selected rows'
features go to the host, to be tokenized. With one new token a request
drains on its prefill, so the engine's attention runs the prefill kernel
(`flash_attention` on backend `cuda`) and no decode step.

`predict()` returns None: a model's vote costs a serve round trip either
way, so there is nothing cheaper to speculate on, and a pipelined
scheduler with this annotator never speculates.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.cleaning.phases import AnnotationTask, RoundSelection
from repro_torch.serving.engine import Request, ServeEngine


@dataclass
class ModelAnnotator:
    """Annotate by a one-token greedy decode through a `ServeEngine`.

    The engine must record logits (`ServeConfig.trace_logits=True`): the
    label is read from the first token's logit row, not from the sampled
    token id (the vocabulary is far larger than n_classes). `n_bins`, `lo`
    and `hi` define each feature's quantization grid; `prefix_len` sizes the
    shared task prefix."""

    engine: ServeEngine
    n_bins: int = 16
    prefix_len: int = 8
    lo: float = -3.0
    hi: float = 3.0
    latency_s: float = 0.0
    _uid: int = field(default=0, repr=False)

    def __post_init__(self):
        if not self.engine.config.trace_logits:
            raise ValueError(
                "ModelAnnotator reads labels from decode logits — construct "
                "the ServeEngine with ServeConfig(trace_logits=True)")
        vocab = int(self.engine.model.cfg.vocab_size)
        if vocab < self.n_bins + 1:
            raise ValueError(f"vocab {vocab} too small for {self.n_bins} feature bins")
        # the fixed task prefix: the same every round, so its pages are aliased
        self._prefix = ((np.arange(self.prefix_len) * 37 + 11) % vocab).astype(np.int32)

    def _tokenize(self, X: np.ndarray) -> list:
        """[m, d] features -> m prompts: the task prefix, then one bin token
        a feature (bin b -> token 1 + b; token 0 is reserved)."""
        span = self.hi - self.lo
        bins = np.clip(np.round((X - self.lo) / span * (self.n_bins - 1)),
                       0, self.n_bins - 1).astype(np.int32)
        return [np.concatenate([self._prefix, 1 + row]) for row in bins]

    def annotate(self, session, selection: RoundSelection, generator) -> AnnotationTask:
        """Serve one one-token request a selected row and take the argmax
        over the first `n_classes` logits. Deterministic (greedy; the
        generator is unused)."""
        X = session.ds.X[selection.idx].cpu().numpy().astype(np.float32)
        reqs = [Request(uid=self._uid + i, prompt=p, max_new=1)
                for i, p in enumerate(self._tokenize(X))]
        self._uid += len(reqs)
        done = {r.uid: r for r in self.engine.run(list(reqs))}
        C = int(session.ds.n_classes)
        labels = [int(np.argmax(done[r.uid].logits[0][:C])) for r in reqs]
        return AnnotationTask(torch.tensor(labels, dtype=torch.int64,
                                           device=selection.idx.device), self.latency_s)

    def predict(self, session, selection: RoundSelection) -> Optional[torch.Tensor]:
        """No guess before the annotation: the model's vote costs the same
        serve round trip as the annotation itself."""
        return None
