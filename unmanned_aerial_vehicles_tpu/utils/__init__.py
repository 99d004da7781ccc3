from .examples import fast_examples, scaled
from .rotations import (
    euler_to_quaternion,
    euler_to_rotation_matrix,
    euler_rate_transform,
    quaternion_to_euler,
    wrap_angle,
)

__all__ = [
    "fast_examples",
    "scaled",
    "euler_to_quaternion",
    "euler_to_rotation_matrix",
    "euler_rate_transform",
    "quaternion_to_euler",
    "wrap_angle",
]
