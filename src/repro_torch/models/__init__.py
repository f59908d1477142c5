from repro_torch.models.transformer import Model

__all__ = ["Model"]
