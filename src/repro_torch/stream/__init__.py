"""repro_torch.stream — the model-in-the-loop annotator of online CHEF (the
port of `repro.stream`'s `ModelAnnotator`).

`ModelAnnotator` plugs a `ServeEngine` into the cleaning loop's annotation
phase. The rest of `repro.stream` (ingest, the window store and the
streaming session) waits for the port of ROADMAP.md's queue item 4.
"""
from repro_torch.stream.annotator import ModelAnnotator

__all__ = ["ModelAnnotator"]
