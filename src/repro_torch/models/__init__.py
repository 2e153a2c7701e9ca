"""Model code of the port (dense attention + MLP stages)."""
from repro_torch.models.transformer import Model

__all__ = ["Model"]
