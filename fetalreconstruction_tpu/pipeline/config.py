"""Reconstruction configuration (mirrors the reference CLI defaults).

Defaults replicate reconstruction.cc:92-157 (SVR) and
patchBasedReconMain.cpp:110-135 (PVR).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass
class SVRConfig:
    # inputs
    output: str = "3TReconstruction.nii.gz"
    input_stacks: List[str] = dataclasses.field(default_factory=list)
    mask: Optional[str] = None
    transformation_files: List[str] = dataclasses.field(default_factory=list)
    thickness: List[float] = dataclasses.field(default_factory=list)
    packages: List[int] = dataclasses.field(default_factory=list)

    # reconstruction parameters (reference defaults)
    iterations: int = 9
    sigma: float = 20.0                 # bias field sigma (mm)
    resolution: float = 0.75
    multires_levels: int = 3            # --multires
    average_value: float = 700.0        # --average
    delta: float = 150.0
    lambda_: float = 0.02
    last_iter_lambda: float = 0.01
    smooth_mask: float = 4.0
    global_bias_correction: bool = False
    low_intensity_cutoff: float = 0.01
    intensity_matching: bool = True
    rec_iterations_first: int = 4
    rec_iterations_last: int = 13
    disable_bias_correction: bool = True   # reference default (cc:121)
    template_number: int = 0
    use_nmi: bool = False
    force_excluded: List[int] = dataclasses.field(default_factory=list)
    quality_factor: float = 1.0
    debug: bool = False
    no_log: bool = False          # --no_log: keep output on the console
    log_prefix: str = ""
    num_stacks_tuner: int = 0     # use only the first N stacks (cc:406-418)
    checkpoint_dir: str = ""      # per-outer-iteration .npz checkpoints
    resume: bool = False          # resume from latest checkpoint
    save_slice_transformations: bool = False
    use_auto_template: bool = False
    tfolder: str = ""             # per-slice .dof resume folder
    reference_volume: str = ""    # seed volume; registration runs at iter 0
    t1_package_size: int = 0      # --T1PackageSize: split stacks into
                                  # packages registered to the reference
                                  # volume (T1->T2 path, cc:494-556)
    sfolder: str = ""             # --sfolder: replace slices from folder

    # experimental patch/superpixel slice modes of the SVR tool
    # (reconstruction.cc:200-209, CreateSlicesAndTransformations*Based)
    patch_based: bool = False     # --patchBased
    patch_size: int = 64          # --patchSize
    patch_stride: int = 32        # --patchStride
    superpixel_based: bool = False  # --superpixelBased
    num_superpixels: float = 0.0  # --superpixel [noLabels]; 0 = auto
    manual_mask: str = ""         # --manualMask: per-slice segmentation
                                  # pushed through the PSF at the end

    bspline: bool = False         # also produce the alternative B-spline
                                  # reconstruction (irtkBSplineReconstruction)

    # engine knobs (no reference analog)
    engine: str = "fast"          # "fast" (conv+trilinear) | "exact"
    max_psf_support: int = 12
    # slice-to-volume registration pyramid: default = the reference's
    # CPU GuessParameterSliceToVolume preset (3 levels, 20 iterations;
    # see register/slice2vol.SliceRegConfig)
    reg_levels: int = 3
    reg_iterations: int = 20
    # s2v optimizer ("coord" stepped+compacted host driver, "coord-scan"
    # the identical algorithm as one fixed-length scanned program — what
    # mesh paths run inside shard_map, "gd" reference gradient scheme)
    reg_optimizer: str = "coord"
