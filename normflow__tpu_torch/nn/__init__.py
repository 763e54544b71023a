"""Flow networks under the reference's names (``normflow__tpu/nn``).

The reference's trailing-underscore names are aliases of the port's
classes, so that scripts written against it port mechanically.
"""

from ..models.core import (Flow, FlowList, Frozen, InvisibilityMaskWrapper,
                           MultiChannelFlow, MultiOutChannelFlow, freeze,
                           unfreeze)
from ..models.couplings import (AffineCoupling, CntrAffineCoupling,
                                CntrCoupling, CntrMultiRQSplineCoupling,
                                CntrRQSplineCoupling, CntrShiftCoupling,
                                Coupling, DirectCntrCoupling,
                                MultiRQSplineCoupling, RQSplineCoupling,
                                ShiftCoupling)
from ..models.elementwise import (ArcTanh, Clone, DistConvertor, Expit,
                                  Identity, Logit, Pade11, Pade22, Pade32,
                                  PhaseDistConvertor, Scale, SgnBias,
                                  SplineFlow, SplineNet, Tanh,
                                  UnityDistConvertor)
from ..models.gauge import (U1AngleAction, U1PlaquetteCoupling,
                            build_u1_gauge_flow)
from ..models.nets import (ACTIVATIONS, CircularConv, ConvNet, Dense,
                           LinearNet)
from ..models.spectral import (IPSD, FFTFlow, FreeScalar, IPSDNoZeroMode,
                               MeanFieldFlow, PSDBlock)
from . import scalar

# the reference's names
Module_ = Flow
ModuleList_ = FlowList
MultiChannelModule_ = MultiChannelFlow
MultiOutChannelModule_ = MultiOutChannelFlow
InvisibilityMaskWrapperModule_ = InvisibilityMaskWrapper
Identity_ = Identity
Clone_ = Clone
ScaleNet_ = Scale
Tanh_ = Tanh
ArcTanh_ = ArcTanh
Expit_ = Expit
Logit_ = Logit
Pade11_ = Pade11
Pade22_ = Pade22
Pade32_ = Pade32
SgnBiasNet_ = SgnBias
SplineNet_ = SplineFlow
UnityDistConvertor_ = UnityDistConvertor
PhaseDistConvertor_ = PhaseDistConvertor
DistConvertor_ = DistConvertor
ConvAct = ConvNet
LinearAct = LinearNet
Coupling_ = Coupling
ShiftCoupling_ = ShiftCoupling
AffineCoupling_ = AffineCoupling
RQSplineCoupling_ = RQSplineCoupling
MultiRQSplineCoupling_ = MultiRQSplineCoupling
DirectCntrCoupling_ = DirectCntrCoupling
CntrCoupling_ = CntrCoupling
CntrShiftCoupling_ = CntrShiftCoupling
CntrAffineCoupling_ = CntrAffineCoupling
CntrRQSplineCoupling_ = CntrRQSplineCoupling
CntrMultiRQSplineCoupling_ = CntrMultiRQSplineCoupling
FFTNet_ = FFTFlow
MeanFieldNet_ = MeanFieldFlow
PSDBlock_ = PSDBlock
ConvNd = CircularConv
Conv4d = CircularConv
