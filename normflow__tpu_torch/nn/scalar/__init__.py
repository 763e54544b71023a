"""The reference's ``nn.scalar`` modules, each re-exporting the port's
classes under the reference's names (``normflow__tpu/nn/scalar``)."""

from .cntr_couplings_ import (CntrAffineCoupling_, CntrCoupling_,
                              CntrMultiRQSplineCoupling_,
                              CntrRQSplineCoupling_, CntrShiftCoupling_,
                              DirectCntrCoupling_)
from .convNd import Conv4d, ConvNd
from .couplings_ import (AffineCoupling_, Coupling_, MultiRQSplineCoupling_,
                         RQSplineCoupling_, ShiftCoupling_)
from .fftflow_ import FFTNet_
from .meanfield_ import MeanFieldNet_
from .modules import ACTIVATIONS, ConvAct, LinearAct, PlusBias, SplineNet
from .modules_ import (ArcTanh_, Clone_, DistConvertor_, Expit_, Identity_,
                       Logit_, Pade11_, Pade22_, Pade32_, PhaseDistConvertor_,
                       ScaleNet_, SgnBiasNet_, SplineNet_, Tanh_,
                       UnityDistConvertor_)
from .psd_ import PSDBlock_
