"""The reference's ``nn/scalar/modules.py`` names."""

from ...models.elementwise import SplineNet  # noqa: F401
from ...models.nets import ACTIVATIONS, PlusBias  # noqa: F401
from ...models.nets import ConvNet as ConvAct  # noqa: F401
from ...models.nets import LinearNet as LinearAct  # noqa: F401
