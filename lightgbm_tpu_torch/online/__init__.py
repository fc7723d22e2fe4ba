"""Model registry behind the HTTP endpoint (online training comes with
the training slice)."""
from .registry import ModelRegistry, RegistryEntry

__all__ = ["ModelRegistry", "RegistryEntry"]
