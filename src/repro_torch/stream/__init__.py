"""repro_torch.stream — online CHEF: label cleaning over arriving data (the
port of `repro.stream`).

Ingest (`StreamSource` / `windowed` / `SyntheticStream`) feeds a
capacity-preallocated `WindowStore`; `StreamingCleaningSession` cleans
between window arrivals, absorbing each window by DeltaGrad-L replay (warm
start) or re-initializing from scratch (the retrain oracle, bit for bit the
batch session); `ModelAnnotator` plugs a `ServeEngine` into the annotation
phase. The command line is `repro_torch.launch.stream`.
"""
from repro_torch.stream.annotator import ModelAnnotator
from repro_torch.stream.ingest import (StreamSource, SyntheticStream, Window, generator_source,
                                      windowed)
from repro_torch.stream.session import StreamingCleaningSession
from repro_torch.stream.window import WindowStore

__all__ = [
    "ModelAnnotator", "StreamSource", "StreamingCleaningSession", "SyntheticStream", "Window",
    "WindowStore", "generator_source", "windowed",
]
