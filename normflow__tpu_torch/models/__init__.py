"""Flows, nets, masks, priors and actions; the U(1) gauge and staggered
fermion sectors are exported here as in ``normflow__tpu/models``."""

from . import actions, fermions, gauge
from .actions import (GaugeAction, MatrixAction, SchwingerAction,
                      ScalarPhi4Action, U1GaugeAction)
from .fermions import (StaggeredFermionLogDet, build_schwinger_action,
                       staggered_dirac_matrix)
from .gauge import (U1AngleAction, U1PlaquetteCoupling, build_u1_gauge_flow,
                    u1_plaq_angle)
