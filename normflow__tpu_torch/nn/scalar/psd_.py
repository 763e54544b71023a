"""The reference's ``nn/scalar/psd_.py`` names."""

from ...models.spectral import PSDBlock as PSDBlock_  # noqa: F401
