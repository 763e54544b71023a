"""Flows, nets, masks, priors and actions, the U(1) gauge and staggered
fermion sectors: the names ``normflow__tpu/models`` exports."""

from . import (actions, core, couplings, elementwise, fermions, gauge, masks,
               nets, priors, spectral)
from .actions import (GaugeAction, MatrixAction, SchwingerAction,
                      ScalarPhi4Action, U1GaugeAction)
from .core import (Flow, FlowList, Frozen, InvisibilityMaskWrapper,
                   MultiChannelFlow, MultiOutChannelFlow, freeze,
                   sum_density, trainable_mask, unfreeze)
from .couplings import (AffineCoupling, CntrAffineCoupling, CntrCoupling,
                        CntrMultiRQSplineCoupling, CntrRQSplineCoupling,
                        CntrShiftCoupling, Coupling, DirectCntrCoupling,
                        MultiRQSplineCoupling, RQSplineCoupling,
                        ShiftCoupling)
from .elementwise import (ArcTanh, Clone, DistConvertor, Expit, Identity,
                          Logit, Pade11, Pade22, Pade32, PhaseDistConvertor,
                          Scale, SgnBias, SplineFlow, SplineNet, Tanh,
                          UnityDistConvertor)
from .fermions import (StaggeredFermionLogDet, build_schwinger_action,
                       staggered_dirac_matrix)
from .gauge import (U1AngleAction, U1PlaquetteCoupling, build_u1_gauge_flow,
                    u1_plaq_angle)
from .masks import (AlongAxesEvenOddMask, AlongAxisEvenOddPartitioner,
                    ChunkCatPartitioner, DoubleMask, DummyMask, EvenOddMask,
                    GaugeLinksDoubleMask, ListPartitioner, Mask, MatrixMask,
                    PackedEvenOddMask, ZebraPlanarMask)
from .nets import ACTIVATIONS, CircularConv, ConvNet, Dense, LinearNet
from .priors import NormalPrior, PriorList, UniformPrior
from .spectral import (IPSD, FFTFlow, FreeScalar, IPSDNoZeroMode,
                       MeanFieldFlow, PSDBlock)
