"""Rotation, allocentric and camera geometry on torch tensors."""

from .allocentric import allo_to_ego_mat
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
    exp_map,
    normalize,
    ortho6d_to_mat,
    quat_to_mat,
)

__all__ = [
    "allo_to_ego_mat", "backproject_depth", "crop_K",
    "project", "recover_pose_centroid_z", "transform_pts",
    "angular_distance", "axangle_to_mat", "exp_map",
    "normalize", "ortho6d_to_mat", "quat_to_mat",
]
