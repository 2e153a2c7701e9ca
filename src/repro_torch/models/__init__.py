"""Model code of the port (attention + MLP and attention + MoE stages)."""
from repro_torch.models.transformer import Model

__all__ = ["Model"]
