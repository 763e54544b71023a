"""The reference's ``nn/scalar/modules_.py`` names."""

from ...models.elementwise import ArcTanh as ArcTanh_  # noqa: F401
from ...models.elementwise import Clone as Clone_  # noqa: F401
from ...models.elementwise import DistConvertor as DistConvertor_  # noqa
from ...models.elementwise import Expit as Expit_  # noqa: F401
from ...models.elementwise import Identity as Identity_  # noqa: F401
from ...models.elementwise import Logit as Logit_  # noqa: F401
from ...models.elementwise import Pade11 as Pade11_  # noqa: F401
from ...models.elementwise import Pade22 as Pade22_  # noqa: F401
from ...models.elementwise import Pade32 as Pade32_  # noqa: F401
from ...models.elementwise import \
    PhaseDistConvertor as PhaseDistConvertor_  # noqa: F401
from ...models.elementwise import Scale as ScaleNet_  # noqa: F401
from ...models.elementwise import SgnBias as SgnBiasNet_  # noqa: F401
from ...models.elementwise import SplineFlow as SplineNet_  # noqa: F401
from ...models.elementwise import Tanh as Tanh_  # noqa: F401
from ...models.elementwise import \
    UnityDistConvertor as UnityDistConvertor_  # noqa: F401
