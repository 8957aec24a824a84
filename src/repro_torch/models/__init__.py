"""Dense decoder models of the PyTorch port."""
from repro_torch.models.model import Model, resolve_device

__all__ = ["Model", "resolve_device"]
