"""NIfTI I/O mapped onto the IRTK geometry convention.

Replaces the reference's vendored niftilib stack (IRTKSimple2/nifti) using
the self-contained reader in nifti1.py.  The attribute mapping replicates
irtkFileNIFTIToImage.cc:230-330:

- qform is preferred over sform (qform_code > 0 wins, handled in nifti1.load);
- spacing = column norms of the affine, axes = normalized columns (sign
  preserved, i.e. the IRTK world frame IS the NIfTI world frame, no flip);
- origin = affine @ ((dim-1)/2): the world position of the grid centre.
"""
from __future__ import annotations

import numpy as np

from ..core.geometry import ImageAttributes
from ..core.image import Image
from . import nifti1


def affine_to_attr(affine: np.ndarray, shape_xyz) -> ImageAttributes:
    a = ImageAttributes()
    a.x, a.y, a.z = int(shape_xyz[0]), int(shape_xyz[1]), int(shape_xyz[2])
    lin = affine[:3, :3]
    spacing = np.linalg.norm(lin, axis=0)
    spacing[spacing == 0] = 1.0
    a.dx, a.dy, a.dz = (float(spacing[0]), float(spacing[1]),
                        float(spacing[2]))
    axes = lin / spacing[None, :]
    a.xaxis = tuple(axes[:, 0])
    a.yaxis = tuple(axes[:, 1])
    a.zaxis = tuple(axes[:, 2])
    centre = (np.asarray([a.x, a.y, a.z], dtype=np.float64) - 1.0) / 2.0
    origin = lin @ centre + affine[:3, 3]
    a.xorigin, a.yorigin, a.zorigin = (float(origin[0]), float(origin[1]),
                                       float(origin[2]))
    return a


def attr_to_affine(attr: ImageAttributes) -> np.ndarray:
    """Inverse of affine_to_attr: 4x4 NIfTI affine from attributes."""
    affine = np.eye(4)
    lin = attr.axes * attr.spacing[None, :]
    affine[:3, :3] = lin
    centre = (np.asarray([attr.x, attr.y, attr.z], dtype=np.float64) - 1.0) / 2.0
    affine[:3, 3] = attr.origin - lin @ centre
    return affine


def read_nifti(path: str) -> Image:
    """Read a 3D (or 4D) NIfTI file into an Image ([z,y,x] or [t,z,y,x])."""
    data, affine, hdr = nifti1.load(path)
    data = np.asarray(data).astype(np.float32)
    if data.ndim == 3:
        arr = np.ascontiguousarray(data.transpose(2, 1, 0))
    else:
        arr = np.ascontiguousarray(data.transpose(3, 2, 1, 0))
    attr = affine_to_attr(np.asarray(affine, dtype=np.float64),
                          data.shape[:3])
    if data.ndim == 4:
        attr.t = data.shape[3]
        attr.dt = float(abs(hdr.pixdim[4])) or 1.0
    return Image(arr, attr)


def read_stacks(paths, nthreads: int = 0):
    """Threaded multi-stack loader (native data-loader tier).

    Reads + inflates all files in parallel via native/csrc/niftiz.cc
    (fr_nz_read_many), then parses each in Python; falls back to
    sequential read_nifti when the native tier is unavailable.  This is
    the analog of the reference's stack-loading loop
    (reconstruction.cc:272-318 over niftilib).
    """
    from .. import native
    bufs = native.read_bytes_many(paths, nthreads)
    if bufs is None:
        return [read_nifti(p) for p in paths]
    out = []
    for p, raw in zip(paths, bufs):
        if raw is None:
            out.append(read_nifti(p))  # per-file fallback
            continue
        data, affine, hdr = nifti1.load_bytes(raw)
        data = np.asarray(data).astype(np.float32)
        if data.ndim == 3:
            arr = np.ascontiguousarray(data.transpose(2, 1, 0))
        else:
            arr = np.ascontiguousarray(data.transpose(3, 2, 1, 0))
        attr = affine_to_attr(np.asarray(affine, dtype=np.float64),
                              data.shape[:3])
        if data.ndim == 4:
            attr.t = data.shape[3]
            attr.dt = float(abs(hdr.pixdim[4])) or 1.0
        out.append(Image(arr, attr))
    return out


def write_nifti(img: Image, path: str, dtype=np.float32) -> None:
    affine = attr_to_affine(img.attr)
    if img.data.ndim == 3:
        data = np.asarray(img.data, dtype=dtype).transpose(2, 1, 0)
    elif img.data.ndim == 4:
        data = np.asarray(img.data, dtype=dtype).transpose(3, 2, 1, 0)
    else:
        raise ValueError(f"unsupported ndim {img.data.ndim}")
    nifti1.save(path, data, affine)
