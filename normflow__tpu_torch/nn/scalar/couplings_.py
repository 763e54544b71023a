"""The reference's ``nn/scalar/couplings_.py`` names."""

from ...models.couplings import AffineCoupling as AffineCoupling_  # noqa
from ...models.couplings import Coupling as Coupling_  # noqa: F401
from ...models.couplings import \
    MultiRQSplineCoupling as MultiRQSplineCoupling_  # noqa: F401
from ...models.couplings import RQSplineCoupling as RQSplineCoupling_  # noqa
from ...models.couplings import ShiftCoupling as ShiftCoupling_  # noqa: F401
