"""The reference's ``nn/scalar/cntr_couplings_.py`` names."""

from ...models.couplings import \
    CntrAffineCoupling as CntrAffineCoupling_  # noqa: F401
from ...models.couplings import CntrCoupling as CntrCoupling_  # noqa: F401
from ...models.couplings import \
    CntrMultiRQSplineCoupling as CntrMultiRQSplineCoupling_  # noqa: F401
from ...models.couplings import \
    CntrRQSplineCoupling as CntrRQSplineCoupling_  # noqa: F401
from ...models.couplings import \
    CntrShiftCoupling as CntrShiftCoupling_  # noqa: F401
from ...models.couplings import \
    DirectCntrCoupling as DirectCntrCoupling_  # noqa: F401
