"""Pure tensor geometry and math of the PyTorch port."""

from pyrayt_tpu_torch.core.operations import (
    binomial_root,
    element_wise_dot,
    reflect,
    refract,
    safe_normalize,
    safe_sqrt,
    smallest_positive_root,
)
from pyrayt_tpu_torch.core.csg import Operation, array_csg, csg_combine_with_ids
from pyrayt_tpu_torch.core.homogeneous import (
    HomogeneousCoordinate,
    Point,
    Ray,
    Vector,
    bundle_of_rays,
    bundle_rays,
)
from pyrayt_tpu_torch.core import primitives
