"""Scene-graph builders: world objects, surfaces, CSG, compilation."""

from pyrayt_tpu_torch.scene.objects import (
    CountedObject,
    Intersectable,
    ObjectGroup,
    TracerSurface,
    WorldObject,
    bounding_box_spans,
    fresh_ids,
)
from pyrayt_tpu_torch.scene.surfaces import Cuboid, Cylinder, Paraboloid, Sphere, XYPlane
from pyrayt_tpu_torch.scene import csg
from pyrayt_tpu_torch.scene.csg import CSGSurface, difference, intersect, union
from pyrayt_tpu_torch.scene.compile import CompiledScene, SceneSpec, compile_scene
