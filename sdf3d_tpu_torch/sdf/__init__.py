"""SDF scene graphs: the primitives, CSG combinators and the neural SDF
ported so far."""

from sdf3d_tpu_torch.sdf.node import SDFNode, as_f32, mat_vec, vdot, vlength, vnormalize
from sdf3d_tpu_torch.sdf.primitives import Plane, Sphere, ground_plane, plane, sphere
from sdf3d_tpu_torch.sdf.csg import Union, union
from sdf3d_tpu_torch.sdf.neural import NeuralSDF, distill, distill_loss, neural_sdf
from sdf3d_tpu_torch.sdf.io import load_setup, save_setup, scene_from_json, scene_to_json

__all__ = [
    "SDFNode",
    "as_f32",
    "mat_vec",
    "vdot",
    "vlength",
    "vnormalize",
    "Plane",
    "Sphere",
    "ground_plane",
    "plane",
    "sphere",
    "Union",
    "union",
    "NeuralSDF",
    "distill",
    "distill_loss",
    "neural_sdf",
    "load_setup",
    "save_setup",
    "scene_from_json",
    "scene_to_json",
]
