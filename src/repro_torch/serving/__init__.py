"""Paged continuous-batching serving (the port of `repro.serving`)."""
from repro_torch.serving.engine import Request, ServeConfig, ServeEngine, bucket_len, greedy

__all__ = ["Request", "ServeConfig", "ServeEngine", "bucket_len", "greedy"]
