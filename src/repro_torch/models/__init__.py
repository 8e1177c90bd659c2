"""Model of the port: the dense AB-Sparse decoder."""
from repro_torch.models.transformer import Transformer, resolve_device

__all__ = ["Transformer", "resolve_device"]
