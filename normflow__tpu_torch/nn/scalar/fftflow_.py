"""The reference's ``nn/scalar/fftflow_.py`` names."""

from ...models.spectral import IPSD, FreeScalar, IPSDNoZeroMode  # noqa: F401
from ...models.spectral import FFTFlow as FFTNet_  # noqa: F401
