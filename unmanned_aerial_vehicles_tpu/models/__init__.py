from .params import RigidBodyParams, X500_PARAMS, GZ_QUADROTOR_PARAMS, COMPARISON_PARAMS
from .double_integrator import (
    double_integrator_derivative,
    double_integrator_step,
)
from .rigid_body import (
    rigid_body_derivative,
    rigid_body_rk4_step,
    rigid_body_rk4_substeps,
    rigid_body_euler_step,
)
from .px4_surrogate import (
    PID_CAMPAIGN_RATE_LOOP,
    RateLoopParams,
    px4_rate_tracking_step,
)

__all__ = [
    "RigidBodyParams",
    "X500_PARAMS",
    "GZ_QUADROTOR_PARAMS",
    "COMPARISON_PARAMS",
    "double_integrator_derivative",
    "double_integrator_step",
    "rigid_body_derivative",
    "rigid_body_rk4_step",
    "rigid_body_rk4_substeps",
    "rigid_body_euler_step",
    "PID_CAMPAIGN_RATE_LOOP",
    "RateLoopParams",
    "px4_rate_tracking_step",
]
