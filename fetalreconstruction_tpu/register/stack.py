"""Stack-to-template 3D-3D registration (StackRegistrations).

Reimplements irtkReconstructionGPU.cc:849-1001 (ParallelStackRegistrations
+ the StackRegistrations wrapper): the template stack (or an external
reference volume) is the registration target with the mask zeroed outside;
every other stack registers to it with the GuessParameterThickSlices preset
(CC) or ...ThickSlicesNMI for an external target.  Run twice by the
pipeline — before and after mask cropping (reconstruction.cc:661, 711).

TRANSFORM CONVENTION: the pipeline STORES transforms mapping
stack world -> template world (the wrapper calls
InvertStackTransformations before AND after the registrations, .cc:946 and
1000, because IRTK's registration output maps target(template) world ->
source(stack) world).  This stored direction is what CreateSlices /
MatchStackIntensities / TransformMask and the PSF forward matrices consume.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.geometry import invert_rigid
from ..core.image import Image
from .volume import VolRegConfig, register_volumes_batched


def stack_registrations(stacks: List[Image], template_index: int,
                        mask: Optional[Image] = None,
                        external_template: Optional[Image] = None,
                        use_nmi: bool = False,
                        init_transforms: Optional[np.ndarray] = None,
                        cfg: Optional[VolRegConfig] = None) -> np.ndarray:
    """Returns (n_stacks, 4, 4) stack transforms in the STORED convention
    (stack world -> template world).

    mask (if given) must live on the template grid; target voxels outside
    it are zeroed (making 0 the corner-guessed padding).
    init_transforms, if given, are also in the stored convention.

    All non-template stacks register as ONE lock-step batched problem
    (register_volumes_batched) — the analog of the reference's
    TBB-parallel ParallelStackRegistrations
    (irtkReconstructionGPU.cc:849-938).
    """
    n = len(stacks)
    out = np.tile(np.eye(4), (n, 1, 1))
    if init_transforms is not None:
        out = np.array(init_transforms, copy=True)

    if external_template is not None:
        target = external_template
        use_nmi = True
    else:
        target = stacks[template_index]
    if mask is not None:
        data = np.where(mask.data > 0, target.data, 0.0).astype(np.float32)
        target = Image(data, target.attr.copy())

    if cfg is None:
        cfg = VolRegConfig(metric="nmi" if use_nmi else "cc")

    idx = [i for i in range(n)
           if external_template is not None or i != template_index]
    if not idx:
        return out
    # registration works in IRTK direction (template -> stack):
    # invert stored inits, run the batch, store the inverses back
    mats, _ = register_volumes_batched(
        cfg, [target] * len(idx), [stacks[i] for i in idx],
        init_matrices=np.stack([invert_rigid(out[i]) for i in idx]))
    for j, i in enumerate(idx):
        out[i] = invert_rigid(mats[j])
    return out
