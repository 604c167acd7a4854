"""CSG builder surfaces (counterpart of ``pyrayt_tpu.scene.csg``).

``union``/``intersect``/``difference`` build a binary tree of
Intersectables.  The tree is static; the engines consume it through
``compile_scene``, while the eager ``intersect`` method serves the API and
the tests.
"""

from __future__ import annotations

import numpy as np

from pyrayt_tpu_torch.core.csg import Operation, csg_combine_with_ids
from pyrayt_tpu_torch.scene.objects import Intersectable

__all__ = ["Operation", "CSGSurface", "union", "intersect", "difference"]


def _array_csg_spans_np(array1, array2, operation: Operation):
    """NumPy CSG merge of the builder's (2, 3) AABB spans."""
    merged = np.concatenate((array1, array2), axis=0)
    order = np.argsort(merged, axis=0, kind="stable")
    merged_sorted = np.take_along_axis(merged, order, axis=0)
    if operation in (Operation.UNION, Operation.INTERSECT):
        count = np.cumsum(np.where(order & 1, -1, 1), axis=0)
    else:
        from_second = order >= array1.shape[0]
        count = np.cumsum(np.where((order & 1).astype(bool) ^ from_second, -1, 1), axis=0) + 1
    if operation == Operation.UNION:
        occupied = count != 0
        boundary = occupied ^ np.roll(occupied, 1, axis=0)
    else:
        is_two = count == 2
        boundary = is_two | np.roll(is_two, 1, axis=0)
    return np.sort(np.where(boundary, merged_sorted, np.inf), axis=0)


class CSGSurface(Intersectable):
    def __init__(
        self,
        l_child: Intersectable,
        r_child: Intersectable,
        operation: Operation,
        *args,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self._operation = operation

        self._l_child = l_child
        self._l_child.attach_to(self)
        self._r_child = r_child
        self._r_child.attach_to(self)

        # difference inverts the cut surface's normals
        if self._operation == Operation.DIFFERENCE:
            self._r_child.invert_normals()

    @property
    def _aobb_spans(self):
        """The children's boxes merged, on each read (a child moved on its
        own changes it)."""
        if self._operation == Operation.DIFFERENCE:
            return self._l_child.bounding_box
        new_spans = _array_csg_spans_np(
            np.asarray(self._l_child.bounding_box.T),
            np.asarray(self._r_child.bounding_box.T),
            self._operation,
        )
        return new_spans[:2].T

    @property
    def operation(self) -> Operation:
        return self._operation

    @property
    def l_child(self) -> Intersectable:
        return self._l_child

    @property
    def r_child(self) -> Intersectable:
        return self._r_child

    def intersect(self, rays):
        """Eager CSG intersection returning ``(hits, surface_ids)``."""
        if rays.ndim == 2:
            rays = rays[..., None]
        l_hits, l_ids = self._l_child.intersect(rays)
        r_hits, r_ids = self._r_child.intersect(rays)
        return csg_combine_with_ids(l_hits, l_ids, r_hits, r_ids, self._operation)

    def invert_normals(self):
        self._l_child.invert_normals()
        self._r_child.invert_normals()

    def reset_normals(self):
        self._l_child.reset_normals()
        self._r_child.reset_normals()

    @property
    def surface_ids(self) -> tuple:
        return self._l_child.surface_ids + self._r_child.surface_ids

    def _append_world_transform(self, new_transform):
        # a traced factor is shared by the subtree, not re-made per child
        super()._append_world_transform(new_transform)
        self._l_child.transform(new_transform)
        self._r_child.transform(new_transform)


def union(s0: Intersectable, s1: Intersectable) -> CSGSurface:
    return CSGSurface(s0, s1, Operation.UNION)


def intersect(s0: Intersectable, s1: Intersectable) -> CSGSurface:
    return CSGSurface(s0, s1, Operation.INTERSECT)


def difference(s0: Intersectable, s1: Intersectable) -> CSGSurface:
    return CSGSurface(s0, s1, Operation.DIFFERENCE)
