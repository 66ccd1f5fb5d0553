"""Rotation, allocentric, camera and symmetry geometry on torch tensors."""

from .allocentric import allo_to_ego_mat, ego_to_allo_mat
from .camera import (
    backproject_depth,
    crop_K,
    project,
    recover_pose_centroid_z,
    transform_pts,
)
from .rotations import (
    angular_distance,
    axangle_to_mat,
    axangle_to_quat,
    euler_to_mat,
    exp_map,
    log_map,
    mat_to_ortho6d,
    mat_to_quat,
    normalize,
    ortho6d_to_mat,
    quat_mul,
    quat_to_mat,
)
from .symmetry import closest_rot, symmetry_rotations, symmetry_transforms

__all__ = [
    "allo_to_ego_mat", "ego_to_allo_mat", "backproject_depth", "crop_K",
    "project", "recover_pose_centroid_z", "transform_pts",
    "angular_distance", "axangle_to_mat", "axangle_to_quat",
    "euler_to_mat", "exp_map", "log_map", "mat_to_ortho6d", "mat_to_quat",
    "normalize", "ortho6d_to_mat", "quat_mul", "quat_to_mat",
    "closest_rot", "symmetry_rotations", "symmetry_transforms",
]
