"""Host-side image container: a NumPy array + ImageAttributes geometry.

Replaces the reference's irtkGenericImage<T> (IRTKSimple2/image++) for the
host/orchestration layer.  Array data is stored in [z, y, x] order (x is the
fastest axis, matching IRTK memory order);
coordinate vectors in the API are (x, y, z) like the reference.

On-device state uses plain jnp arrays; this class is for pipeline setup,
cropping, IO and tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .geometry import ImageAttributes


@dataclasses.dataclass
class Image:
    data: np.ndarray  # [z, y, x] (or [t, z, y, x] for 4D)
    attr: ImageAttributes

    def __post_init__(self):
        expected = self.attr.shape_zyx
        if self.data.ndim == 3 and tuple(self.data.shape) != expected:
            raise ValueError(
                f"data shape {self.data.shape} != attributes {expected}")

    # -- basic accessors ----------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return self.data.shape

    def copy(self) -> "Image":
        return Image(self.data.copy(), self.attr.copy())

    @classmethod
    def zeros(cls, attr: ImageAttributes, dtype=np.float32) -> "Image":
        return cls(np.zeros(attr.shape_zyx, dtype=dtype), attr.copy())

    @classmethod
    def full(cls, attr: ImageAttributes, value, dtype=np.float32) -> "Image":
        return cls(np.full(attr.shape_zyx, value, dtype=dtype), attr.copy())

    # -- geometry helpers ---------------------------------------------------
    def i2w(self) -> np.ndarray:
        return self.attr.i2w()

    def w2i(self) -> np.ndarray:
        return self.attr.w2i()

    def image_to_world(self, idx):
        return self.attr.image_to_world(idx)

    def world_to_image(self, pts):
        return self.attr.world_to_image(pts)

    # -- region / crop ------------------------------------------------------
    def get_region(self, x1: int, y1: int, z1: int,
                   x2: int, y2: int, z2: int) -> "Image":
        """Sub-image [x1:x2, y1:y2, z1:z2) with corrected origin
        (matches irtkGenericImage::GetRegion)."""
        if not (0 <= x1 < x2 <= self.attr.x and 0 <= y1 < y2 <= self.attr.y
                and 0 <= z1 < z2 <= self.attr.z):
            raise ValueError("region out of range")
        new_attr = self.attr.region(x1, y1, z1, x2, y2, z2)
        return Image(np.ascontiguousarray(self.data[z1:z2, y1:y2, x1:x2]),
                     new_attr)

    def crop_to_mask(self, mask: "Image", padding: float = 0.0,
                     boundary: int = 0) -> "Image":
        """Crop to the bounding box of mask > 0 (+boundary voxels), like
        irtkReconstruction::CropImage (irtkReconstructionGPU.cc:5205).

        The mask must live on the same grid as this image.
        """
        nz = np.nonzero(mask.data > 0)
        if len(nz[0]) == 0:
            raise ValueError("empty mask")
        z1, z2 = int(nz[0].min()), int(nz[0].max()) + 1
        y1, y2 = int(nz[1].min()), int(nz[1].max()) + 1
        x1, x2 = int(nz[2].min()), int(nz[2].max()) + 1
        # reference crops with a 1-voxel boundary margin where possible
        z1 = max(z1 - boundary, 0); y1 = max(y1 - boundary, 0)
        x1 = max(x1 - boundary, 0)
        z2 = min(z2 + boundary, self.attr.z); y2 = min(y2 + boundary, self.attr.y)
        x2 = min(x2 + boundary, self.attr.x)
        return self.get_region(x1, y1, z1, x2, y2, z2)

    # -- intensity helpers --------------------------------------------------
    def min_max(self, exclude_padding: Optional[float] = None):
        d = self.data
        if exclude_padding is not None:
            d = d[d > exclude_padding]
        if d.size == 0:
            return 0.0, 0.0
        return float(d.min()), float(d.max())


def split_4d(data: np.ndarray, attr: ImageAttributes):
    """Split a 4D [t,z,y,x] array into a list of 3D Images
    (reference: reconstruction.cc:279-303 splits 4D stacks into 3D)."""
    imgs = []
    for t in range(data.shape[0]):
        a = attr.copy()
        a.t = 1
        imgs.append(Image(np.ascontiguousarray(data[t]), a))
    return imgs
