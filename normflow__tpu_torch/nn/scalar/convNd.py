"""The reference's ``nn/scalar/convNd.py`` names."""

from ...models.nets import CircularConv as Conv4d  # noqa: F401
from ...models.nets import CircularConv as ConvNd  # noqa: F401
