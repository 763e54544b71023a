"""The reference's ``nn/scalar/meanfield_.py`` names."""

from ...models.spectral import MeanFieldFlow as MeanFieldNet_  # noqa: F401
