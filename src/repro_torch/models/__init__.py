"""The serving model: layers, attention with its paged KV cache, the
decoder stack and the `Model` facade (attention-only decoders)."""
from repro_torch.models.model import Model

__all__ = ["Model"]
