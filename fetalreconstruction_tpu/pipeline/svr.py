"""Full SVR pipeline orchestrator.

Reimplements the reference SVR application flow (reconstruction.cc:70-1301
/ SURVEY.md §3.1) on top of the jitted svr_core graph:

  mask prep -> template crop -> CreateTemplate -> SetMask ->
  StackRegistrations -> per-stack mask crop -> StackRegistrations ->
  MatchStackIntensitiesWithMasking -> CreateSlicesAndTransformations ->
  MaskSlices -> outer loop {registration schedule, smoothing schedule,
  GaussianReconstruction, SimulateSlices, InitializeRobustStatistics,
  EStep, inner SR loop} -> RestoreSliceIntensities -> ScaleVolume.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..core.geometry import ImageAttributes, invert_rigid
from ..core.image import Image
from ..io.nifti import read_nifti, write_nifti
from ..ops import psf as psf_ops
from ..ops.gaussian import gaussian_blur
from ..ops.sampling import resample_to_grid
from ..register import slice2vol as s2v
from ..register.package import package_to_volume
from ..register.prepare import prepare_registration_slices
from ..register.stack import stack_registrations
from ..sr.superresolution import mask_volume, smoothing_parameters
from ..utils.perfstats import PerfStats
from . import svr_core
from .config import SVRConfig
from .state import SliceBatch, create_slices


# ---------------------------------------------------------------------------
# host-side preparation steps (reference L5/L6)
# ---------------------------------------------------------------------------

def create_mask_from_overlap(stacks: List[Image]) -> Image:
    """Mask = voxels of stack[0]'s grid inside EVERY stack's FOV
    (CreateMaskFromOverlap, irtkReconstructionGPU.cc:696)."""
    base = stacks[0]
    zs, ys, xs = base.attr.shape_zyx
    z, y, x = np.meshgrid(np.arange(zs), np.arange(ys), np.arange(xs),
                          indexing="ij")
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float64)
    w = base.attr.image_to_world(pts)
    inside = np.ones(len(w), bool)
    for st in stacks:
        p = st.attr.world_to_image(w)
        inside &= ((p[:, 0] >= 0) & (p[:, 0] < st.attr.x)
                   & (p[:, 1] >= 0) & (p[:, 1] < st.attr.y)
                   & (p[:, 2] >= 0) & (p[:, 2] < st.attr.z))
    return Image(inside.reshape(zs, ys, xs).astype(np.float32),
                 base.attr.copy())


def transform_mask(image: Image, mask: Image,
                   transform: np.ndarray) -> Image:
    """NN-resample the mask onto `image`'s grid through `transform`
    (stack world -> mask/template world), filling 0 outside
    (TransformMask, .cc:805)."""
    m = mask.attr.w2i() @ transform @ image.attr.i2w()
    out = resample_to_grid(jnp.asarray(mask.data),
                           jnp.asarray(mask.attr.w2i() @ transform,
                                       jnp.float32),
                           image.attr.shape_zyx,
                           jnp.asarray(image.attr.i2w(), jnp.float32),
                           interp="nn", padding=0.0)
    return Image(np.asarray(out), image.attr.copy())


def crop_image(image: Image, mask: Image) -> Image:
    """Crop to the inclusive bounding box of mask > 0 (CropImage,
    .cc:5205)."""
    nz = np.nonzero(mask.data > 0)
    if len(nz[0]) == 0:
        raise ValueError("empty mask - cannot crop")
    z1, z2 = int(nz[0].min()), int(nz[0].max())
    y1, y2 = int(nz[1].min()), int(nz[1].max())
    x1, x2 = int(nz[2].min()), int(nz[2].max())
    return image.get_region(x1, y1, z1, x2 + 1, y2 + 1, z2 + 1)


def create_template(stack: Image, resolution: float) -> ImageAttributes:
    """Reconstruction grid = template stack enlarged by 2 slices in z and
    NN-resampled to isotropic `resolution` (CreateTemplate, .cc:648)."""
    a = stack.attr.copy()
    a.z += 2
    if resolution <= 0:
        resolution = min(a.dx, a.dy, a.dz)
    return a.with_spacing(resolution, resolution, resolution)


def set_mask(mask: Optional[Image], recon_attr: ImageAttributes,
             sigma: float, threshold: float = 0.5) -> Image:
    """Smooth+binarize the mask and NN-resample to the recon grid
    (SetMask, .cc:750)."""
    if mask is None:
        return Image(np.ones(recon_attr.shape_zyx, np.float32),
                     recon_attr.copy())
    data = jnp.asarray(mask.data)
    if sigma > 0:
        data = gaussian_blur(data, sigma, mask.attr.spacing)
        data = (data > threshold).astype(jnp.float32)
    out = resample_to_grid(data, jnp.asarray(mask.attr.w2i(), jnp.float32),
                           recon_attr.shape_zyx,
                           jnp.asarray(recon_attr.i2w(), jnp.float32),
                           interp="nn", padding=0.0)
    return Image(np.asarray(out), recon_attr.copy())


def match_stack_intensities(stacks: List[Image],
                            stack_transforms: np.ndarray, mask: Image,
                            average_value: float,
                            together: bool = False):
    """Per-stack intensity factors (MatchStackIntensitiesWithMasking,
    .cc:1375): factor = averageValue / mean(stack values at voxels whose
    transformed position rounds into mask == 1).  Rescales in place
    (only values > 0) and returns the factors."""
    averages = []
    for st, t in zip(stacks, stack_transforms):
        zs, ys, xs = st.attr.shape_zyx
        z, y, x = np.meshgrid(np.arange(zs), np.arange(ys), np.arange(xs),
                              indexing="ij")
        pts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float64)
        w = st.attr.image_to_world(pts)
        w = w @ np.asarray(t)[:3, :3].T + np.asarray(t)[:3, 3]
        p = np.round(mask.attr.world_to_image(w)).astype(int)
        inb = ((p[:, 0] >= 0) & (p[:, 0] < mask.attr.x)
               & (p[:, 1] >= 0) & (p[:, 1] < mask.attr.y)
               & (p[:, 2] >= 0) & (p[:, 2] < mask.attr.z))
        pc = np.clip(p, 0, [mask.attr.x - 1, mask.attr.y - 1,
                            mask.attr.z - 1])
        mval = mask.data[pc[:, 2], pc[:, 1], pc[:, 0]]
        use = inb & (mval == 1)
        vals = st.data.reshape(-1)[use]
        if len(vals) == 0:
            raise ValueError("stack has no overlap with ROI")
        averages.append(float(vals.mean()))
    factors = []
    if together:
        ga = float(np.mean(averages))
        factors = [average_value / ga] * len(stacks)
    else:
        factors = [average_value / a for a in averages]
    for st, f in zip(stacks, factors):
        st.data[st.data > 0] *= f
    return np.asarray(factors, np.float32)


def mask_slices(batch: SliceBatch, transforms: np.ndarray,
                mask: Image) -> None:
    """Outside-mask or near-zero slice pixels -> -1 (MaskSlices,
    .cc:1940).  Mutates batch.data."""
    n, h, w = batch.data.shape
    for i in range(n):
        a = batch.attrs[i]
        ys, xs = np.meshgrid(np.arange(a.y), np.arange(a.x), indexing="ij")
        pts = np.stack([xs, ys, np.zeros_like(xs)], -1).reshape(-1, 3)
        wpt = a.image_to_world(pts.astype(np.float64))
        t = transforms[i]
        wpt = wpt @ t[:3, :3].T + t[:3, 3]
        p = np.round(mask.attr.world_to_image(wpt)).astype(int)
        inb = ((p[:, 0] >= 0) & (p[:, 0] < mask.attr.x)
               & (p[:, 1] >= 0) & (p[:, 1] < mask.attr.y)
               & (p[:, 2] >= 0) & (p[:, 2] < mask.attr.z))
        pc = np.clip(p, 0, [mask.attr.x - 1, mask.attr.y - 1,
                            mask.attr.z - 1])
        mval = mask.data[pc[:, 2], pc[:, 1], pc[:, 0]]
        keep = inb & (mval != 0)
        sl = batch.data[i, :a.y, :a.x].reshape(-1)
        sl[sl < 0.01] = -1.0
        sl[~keep] = -1.0
        batch.data[i, :a.y, :a.x] = sl.reshape(a.y, a.x)


def replace_slices(folder: str, batch) -> "SliceBatch":
    """--sfolder (replaceSlices, irtkReconstructionGPU.cc:4767): replace
    slice data with pre-transformed slices read from a folder (sorted
    order); slice geometry/transform bookkeeping is preserved."""
    import os
    files = sorted(os.path.join(folder, f) for f in os.listdir(folder)
                   if f.endswith((".nii", ".nii.gz")))
    for i, f in enumerate(files[:batch.n_slices]):
        img = read_nifti(f)
        d = img.data[0] if img.data.ndim == 3 else img.data
        h = min(d.shape[0], batch.data.shape[1])
        w = min(d.shape[1], batch.data.shape[2])
        batch.data[i, :, :] = -1.0
        batch.data[i, :h, :w] = d[:h, :w]
    return batch


# ---------------------------------------------------------------------------
# the full pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SVRResult:
    reconstructed: Image
    transforms: np.ndarray          # (N,4,4) final slice transforms
    slice_weights: np.ndarray       # (N,)
    stack_factors: np.ndarray
    stats: PerfStats
    excluded_slices: List[int]
    slice_inside: Optional[np.ndarray] = None  # (N,) bool
    manual_mask_volume: Optional[Image] = None  # --manualMask output
    bspline_reconstructed: Optional[Image] = None  # --bspline output

    def inclusion_report(self) -> str:
        """Included/excluded/outside slice lists (Evaluate,
        irtkReconstructionGPU.cc:4540)."""
        sw = self.slice_weights
        inside = (self.slice_inside if self.slice_inside is not None
                  else np.ones_like(sw, bool))
        inc = np.nonzero((sw >= 0.5) & inside)[0]
        exc = np.nonzero((sw < 0.5) & inside)[0]
        out = np.nonzero(~inside)[0]
        return ("Included slices: %s\nTotal: %d\n"
                "Excluded slices: %s\nTotal: %d\n"
                "Outside slices: %s\nTotal: %d"
                % (" ".join(map(str, inc)), len(inc),
                   " ".join(map(str, exc)), len(exc),
                   " ".join(map(str, out)), len(out)))


def run_svr(cfg: SVRConfig, stacks: Optional[List[Image]] = None,
            mask: Optional[Image] = None,
            slice_factory=None,
            reference_volume: Optional[Image] = None,
            mesh=None, mesh_mode: str = "slices",
            iteration_hook=None) -> SVRResult:
    """slice_factory (optional): callable(cropped_stacks, thickness,
    recon_mask_img, stack_transforms) -> SliceBatch, used by the PVR
    pipeline to substitute patches for whole slices.

    reference_volume (optional, or cfg.reference_volume path): seeds the
    initial reconstruction, and registration then runs already at
    iteration 0 (reconstruction.cc:254-258, 826).

    mesh (optional jax.sharding.Mesh): with mesh_mode="slices" (a
    "slices" axis) every device stage — registration, geometry, gaussian
    reconstruction and the fused EM/SR iteration — runs through the
    explicit shard_map program in parallel/sharded.py (slices sharded,
    volume replicated, psum collectives; the SPMD form of the
    reference's multi-GPU reduce-to-root + broadcast,
    reconstruction_cuda2.cu:2225-2239).  The slice count is padded to a
    mesh multiple with invalid slices.  The host-side package-to-volume
    hierarchy (CPU TBB in the reference) stays replicated.

    mesh_mode="volume" (a "vol_z" axis mesh): the LARGE-AREA mode
    (SURVEY §5) — the recon grid, per-stack conv tables and scatter
    accumulators shard into z-slabs (parallel/volume_sharded.py) with
    slices replicated; the recon z-extent is padded to a mesh multiple.
    Requires the fast engine; NormaliseBias runs slab-wise with
    multi-hop blur halos (volume_sharded.vs_normalise_bias)."""
    stats = PerfStats()
    # FETALRECON_SYNC_STATS=1: block on each stage's outputs before
    # sampling, so the PerfStats table attributes DEVICE time to the
    # stage that spent it (JAX dispatch is async; without this, device
    # time lands on whichever later stage first converts to numpy).
    # Off by default — the syncs serialize dispatch and slow real runs.
    import os as _os
    if _os.environ.get("FETALRECON_SYNC_STATS") == "1":
        def _sync(*arrs):
            for a in arrs:
                jax.block_until_ready(a)
    else:
        def _sync(*arrs):
            pass

    # ----- load inputs ----------------------------------------------------
    if stacks is None:
        from ..io.nifti import read_stacks
        stacks = read_stacks(cfg.input_stacks)  # threaded native loader
        stacks = [Image(s.data.astype(np.float32), s.attr) for s in stacks]
    else:
        stacks = [Image(np.array(s.data, np.float32, copy=True),
                        s.attr.copy()) for s in stacks]
    # split 4D stacks into 3D volumes, duplicating per-stack thickness /
    # package entries (reconstruction.cc:279-303)
    from ..core.image import split_4d
    cfg_thickness, cfg_packages = list(cfg.thickness), list(cfg.packages)
    if any(s.data.ndim == 4 for s in stacks):
        split, thick, pkgs = [], [], []
        for i, s in enumerate(stacks):
            parts = split_4d(s.data, s.attr) if s.data.ndim == 4 else [s]
            split.extend(parts)
            if cfg_thickness:
                thick.extend([cfg_thickness[i]] * len(parts))
            if cfg_packages:
                pkgs.extend([cfg_packages[i]] * len(parts))
        stacks, cfg_thickness, cfg_packages = split, thick, pkgs
    # --num_stacks_tuner: use only the first N stacks
    # (reconstruction.cc:406-418)
    if cfg.num_stacks_tuner > 0:
        stacks = stacks[:cfg.num_stacks_tuner]
        cfg_thickness = cfg_thickness[:cfg.num_stacks_tuner]
        cfg_packages = cfg_packages[:cfg.num_stacks_tuner]
    if mask is None and cfg.mask is not None:
        mask = read_nifti(cfg.mask)
    n_stacks = len(stacks)
    thickness = cfg_thickness if cfg_thickness else \
        [2.0 * s.attr.dz for s in stacks]
    tmpl = cfg.template_number
    if cfg.use_auto_template:
        from ..utils.motion import select_template
        tmpl = select_template(stacks)
    stack_transforms = np.tile(np.eye(4), (n_stacks, 1, 1))
    if cfg.transformation_files:
        # reference: .dof files store template->stack; the pipeline's
        # stored convention is the inverse (reconstruction.cc:399)
        from ..io.dof import read_dof
        for i, f in enumerate(cfg.transformation_files[:n_stacks]):
            if f and f != "id":
                stack_transforms[i] = invert_rigid(read_dof(f))

    # --T1PackageSize: split every stack into packages and register those
    # to the external (T2) reference volume (reconstruction.cc:494-556)
    external_target = None
    if cfg.t1_package_size > 0:
        from ..register.package import split_image
        if reference_volume is None and cfg.reference_volume:
            reference_volume = read_nifti(cfg.reference_volume)
        if reference_volume is None:
            raise ValueError("--T1PackageSize requires a reference volume")
        external_target = reference_volume
        pkg_stacks = []
        for st in stacks:
            pkg_stacks.extend(split_image(st, cfg.t1_package_size))
        stacks = pkg_stacks
        n_stacks = len(stacks)
        thickness = [2.0 * s.attr.dz for s in stacks]
        stack_transforms = np.tile(np.eye(4), (n_stacks, 1, 1))
    stats.sample("load")

    # --manualMask: per-slice segmentation of the FIRST stack, pushed
    # through the PSF at the end (reconstruction.cc:261-264, 1240-1249)
    manual_img = None
    if cfg.manual_mask:
        manual_img = read_nifti(cfg.manual_mask)

    # ----- mask prep + template grid --------------------------------------
    if mask is None:
        mask = create_mask_from_overlap(stacks)
        mask = Image((mask.data > 0).astype(np.float32), mask.attr)
    m_tmpl = transform_mask(stacks[tmpl], mask,
                            stack_transforms[tmpl])
    stacks[tmpl] = crop_image(stacks[tmpl], m_tmpl)
    if manual_img is not None and tmpl == 0:
        manual_img = crop_image(manual_img, m_tmpl)
    recon_attr = create_template(stacks[tmpl], cfg.resolution)
    out_attr, vol_pad_z = recon_attr, 0
    if mesh is not None and mesh_mode in ("volume", "grid"):
        # z-slab sharding needs the grid z to divide the vol_z mesh
        # axis; the pad slabs are cropped back off every output image so
        # the result matches the single-device run voxel-for-voxel
        from ..parallel.volume_sharded import pad_attr_z
        out_attr = recon_attr.copy()
        n_vz = (dict(zip(mesh.axis_names, mesh.devices.shape))["vol_z"]
                if mesh_mode == "grid" else mesh.devices.size)
        recon_attr, vol_pad_z = pad_attr_z(recon_attr, n_vz)

    def _crop_pad_z(data):
        """Drop the mesh-padding z-slabs (added at the high end)."""
        return data[:data.shape[0] - vol_pad_z] if vol_pad_z else data
    recon_mask_img = set_mask(mask, recon_attr, cfg.smooth_mask)
    stats.sample("template+mask")

    # ----- stack registrations x2, crop, intensity matching ---------------
    # the target is the template stack with voxels outside the mask zeroed
    # (irtkReconstructionGPU.cc:956-988); the mask lives on the recon grid,
    # so resample it onto the template stack grid first
    def _template_mask():
        if mask is None:
            return None
        if external_target is not None:
            # external target already lives in template world
            return transform_mask(external_target, recon_mask_img,
                                  np.eye(4))
        return transform_mask(stacks[tmpl], recon_mask_img,
                              stack_transforms[tmpl])
    stack_transforms = stack_registrations(
        stacks, tmpl, mask=_template_mask(),
        external_template=external_target,
        use_nmi=cfg.use_nmi or external_target is not None)
    for i in range(n_stacks):
        if i == tmpl:
            continue
        mi = transform_mask(stacks[i], recon_mask_img, stack_transforms[i])
        stacks[i] = crop_image(stacks[i], mi)
        if manual_img is not None and i == 0:
            manual_img = crop_image(manual_img, mi)
    stack_transforms = stack_registrations(
        stacks, tmpl, mask=_template_mask(),
        init_transforms=stack_transforms,
        external_template=external_target,
        use_nmi=cfg.use_nmi or external_target is not None)
    stats.sample("stack registration")
    if cfg.debug:
        for i, st in enumerate(stacks):
            write_nifti(st, f"{cfg.log_prefix}stack{i}.nii.gz")

    stack_factors = match_stack_intensities(
        stacks, stack_transforms, recon_mask_img, cfg.average_value,
        together=not cfg.intensity_matching)
    stats.sample("intensity matching")

    # ----- slices / patches ----------------------------------------------
    # experimental patch / superpixel slice modes of the SVR tool
    # (reconstruction.cc:733-747)
    if slice_factory is None and cfg.patch_based:
        from ..patches.extract import extract_patches

        def slice_factory(st, th, m, tr):
            return extract_patches(st, th, cfg.patch_size,
                                   cfg.patch_stride, mask=m,
                                   stack_transforms=tr)
    elif slice_factory is None and cfg.superpixel_based:
        from ..patches.slic import extract_superpixel_patches

        def slice_factory(st, th, m, tr):
            # the SVR tool runs SLIC with compactness 1 and an explicit
            # label count (reconstruction.cc:311-316)
            return extract_superpixel_patches(
                st, th, compactness=1.0,
                num_superpixels=int(cfg.num_superpixels) or None)
    if slice_factory is not None:
        batch = slice_factory(stacks, thickness, recon_mask_img,
                              stack_transforms)
    else:
        batch = create_slices(stacks, thickness)
    if cfg.sfolder:
        batch = replace_slices(cfg.sfolder, batch)
    n = batch.n_slices
    transforms = np.stack([stack_transforms[batch.stack_index[i]]
                           for i in range(n)]).astype(np.float64)
    if slice_factory is None:
        mask_slices(batch, transforms, recon_mask_img)
    stats.sample("create slices")

    # ----- device setup ---------------------------------------------------
    support = psf_ops.reference_support(batch.dims, recon_attr.dx,
                                        cfg.quality_factor,
                                        cfg.max_psf_support)
    offsets = psf_ops.make_offsets(support)
    fast = None
    if cfg.engine == "fast":
        from ..ops.psf_fast import FastPSF
        fast = FastPSF.from_batch(batch, recon_attr.w2i(), support)
    ctx = svr_core.SVRContext(
        vol_shape=recon_attr.shape_zyx,
        vol_spacing=(recon_attr.dx, recon_attr.dy, recon_attr.dz),
        offsets=offsets,
        slice_spacing_xy=(stacks[0].attr.dx, stacks[0].attr.dy),
        sigma_bias=cfg.sigma,
        global_bias_correction=cfg.global_bias_correction,
        disable_bias=cfg.disable_bias_correction,
        delta=cfg.delta,
        low_intensity_cutoff=cfg.low_intensity_cutoff,
        fast=fast)

    if mesh is not None and mesh_mode in ("slices", "grid"):
        from jax.sharding import NamedSharding, PartitionSpec as P
        from ..parallel.sharded import pad_slices_for_mesh
        n_dev = (dict(zip(mesh.axis_names,
                          mesh.devices.shape))["slices"]
                 if mesh_mode == "grid" else mesh.devices.size)
        n_pad = pad_slices_for_mesh(batch.n_slices, n_dev)
        if n_pad > batch.n_slices:
            extra = n_pad - batch.n_slices
            batch.data = np.concatenate(
                [batch.data,
                 np.full((extra,) + batch.data.shape[1:], -1.0,
                         np.float32)])
            batch.i2w = np.concatenate(
                [batch.i2w, np.tile(batch.i2w[-1:], (extra, 1, 1))])
            batch.dims = np.concatenate(
                [batch.dims, np.tile(batch.dims[-1:], (extra, 1))])
            batch.stack_index = np.concatenate(
                [batch.stack_index,
                 np.full((extra,), batch.stack_index[-1], np.int32)])
            # geometry bookkeeping for the pad slices (all-invalid data):
            # reuse the last real slice's attributes so registration
            # preparation stays well-defined
            batch.attrs = batch.attrs + [batch.attrs[-1].copy()
                                         for _ in range(extra)]
            transforms = np.concatenate(
                [transforms, np.tile(transforms[-1:], (extra, 1, 1))])
            n = n_pad
        from ..parallel.sharded import place_global
        place = lambda a: place_global(mesh, P("slices"), a)
    else:
        place = lambda a: a

    slices_j = place(jnp.asarray(batch.data))
    valid = place(jnp.asarray(batch.data != -1.0))
    slice_i2w_j = place(jnp.asarray(batch.i2w, jnp.float32))
    dims_j = place(jnp.asarray(batch.dims))
    stack_id_j = place(jnp.asarray(batch.stack_index, jnp.int32))
    recon_w2i_j = jnp.asarray(recon_attr.w2i(), jnp.float32)
    mask_j = jnp.asarray(recon_mask_img.data)
    if mesh is not None and mesh_mode in ("volume", "grid"):
        from jax.sharding import PartitionSpec as P
        from ..parallel.sharded import place_global
        mask_j = place_global(mesh, P("vol_z"), mask_j)
    mask_flat = mask_j.reshape(-1)
    pos = batch.data[batch.data > 0]
    max_i = float(pos.max()) if pos.size else 1.0
    min_i = float(pos.min()) if pos.size else 0.0
    force_excluded = np.zeros((n,), bool)
    for idx in cfg.force_excluded:
        if 0 <= idx < n:
            force_excluded[idx] = True

    if cfg.tfolder:
        from ..io.dof import read_transformations
        transforms = read_transformations(cfg.tfolder, n)

    reg_targets = None
    # --useNMI switches the s2v similarity too (the reference's
    # GuessParameterSliceToVolume(useNMI) path)
    reg_cfg = s2v.SliceRegConfig(levels=cfg.reg_levels,
                                 iterations=cfg.reg_iterations,
                                 metric="nmi" if cfg.use_nmi else "ncc",
                                 optimizer=cfg.reg_optimizer)
    do_bias = (cfg.intensity_matching
               and not cfg.disable_bias_correction and cfg.sigma > 0)
    do_nbias = do_bias and not cfg.global_bias_correction

    # PSF-matched registration tables (SliceRegConfig.psf_matched):
    # per-stack convolved recon, rebuilt per registration round
    if reg_cfg.psf_matched and ctx.fast is not None:
        _psf_tab = jax.jit(lambda r: s2v.build_psf_tables(ctx.fast, r))
    else:
        def _psf_tab(rec):
            return None

    # stage dispatch: with a mesh every device stage runs the explicit
    # shard_map program (parallel/sharded.py for slice-DP,
    # parallel/volume_sharded.py for z-slab volume sharding) — the same
    # programs the multi-device dryrun and the CPU-mesh equality tests
    # validate; without one, the plain jitted svr_core graph
    if mesh is not None and mesh_mode == "grid":
        from ..parallel import mesh2d as g2
        if ctx.fast is None:
            raise ValueError("mesh_mode='grid' requires engine='fast'")
        _g2_geom = g2.g2_build_geometry_fn(ctx, mesh)
        _g2_gauss = g2.g2_gaussian_reconstruction_fn(ctx, mesh)
        _g2_sim = g2.g2_simulate_fn(ctx, mesh)
        _g2_irs = g2.g2_initialize_robust_statistics_fn(ctx, mesh)
        _g2_estep = g2.g2_estep_fn(ctx, mesh)
        _g2_inner = g2.g2_inner_iteration_fn(
            ctx, mesh, do_bias=do_bias, do_scale=cfg.intensity_matching,
            do_normalise_bias=do_nbias)
        _g2_reg = g2.g2_register_slices_fn(reg_cfg, mesh, recon_attr.dx,
                                           ctx=ctx)

        def _geom_fn(rw2i, t, i2w, dims, v, mf, sid):
            g = _g2_geom(rw2i, t, i2w, v, mask_j, sid)
            return g, g.sume

        def _gauss_fn(s, v, geom, sume, b, sc, mf):
            return _g2_gauss(s, v, geom, b, sc, mask_j)

        def _sim_fn(geom, sume, rec, mf):
            return _g2_sim(geom, rec, mask_j)

        def _irs_fn(s, v, ss, em_, mx, mn, ex):
            return _g2_irs(s, v, ss, em_, jnp.float32(mx),
                           jnp.float32(mn), ex)

        def _estep_fn(s, v, sume, ss, em_, ex):
            return _g2_estep(s, v, sume, ss, em_, ex)

        def _inner_fn(geom, sume, s, v, em_, ss, rec, vw, m, mf, ex, a,
                      lm, mn, mx, it_):
            return _g2_inner(geom, s, v, em_, ss, rec, vw, mask_j, ex, a,
                             lm, mn, mx, it_)

        def _reg_fn(rec, rw2i, t, mo, ofs, tg):
            return _g2_reg(rec, rw2i, t, mo, ofs, tg, stack_id_j)
    elif mesh is not None and mesh_mode == "volume":
        from ..parallel import volume_sharded as vsd
        if ctx.fast is None:
            raise ValueError("mesh_mode='volume' requires engine='fast'")
        _vs_geom = vsd.vs_build_geometry_fn(ctx, mesh)
        _vs_gauss = vsd.vs_gaussian_reconstruction_fn(ctx, mesh)
        _vs_sim = vsd.vs_simulate_fn(ctx, mesh)
        _vs_inner = vsd.vs_inner_iteration_fn(
            ctx, mesh, do_bias=do_bias, do_scale=cfg.intensity_matching,
            do_normalise_bias=do_nbias)

        def _geom_fn(rw2i, t, i2w, dims, v, mf, sid):
            g = _vs_geom(rw2i, t, i2w, v, mask_j, sid)
            return g, g.sume

        def _gauss_fn(s, v, geom, sume, b, sc, mf):
            return _vs_gauss(s, v, geom, b, sc, mask_j)

        def _sim_fn(geom, sume, rec, mf):
            return _vs_sim(geom, rec, mask_j)

        def _irs_fn(s, v, ss, em_, mx, mn, ex):
            return svr_core.initialize_robust_statistics(ctx, s, v, ss,
                                                         em_, mx, mn, ex)

        def _estep_fn(s, v, sume, ss, em_, ex):
            return svr_core.estep(ctx, s, v, sume, ss, em_, ex)

        def _inner_fn(geom, sume, s, v, em_, ss, rec, vw, m, mf, ex, a,
                      lm, mn, mx, it_):
            return _vs_inner(geom, s, v, em_, ss, rec, vw, mask_j, ex, a,
                             lm, mn, mx, it_)

        def _reg_fn(rec, rw2i, t, mo, ofs, tg):
            # registration reads the (sharded) volume replicated
            tab = _psf_tab(rec)
            return s2v.register_slices_to_volume(
                reg_cfg, rec, rw2i, t, mo, ofs, tg, recon_attr.dx,
                psf_table=tab, vol_shape=tuple(ctx.vol_shape)
                if tab is not None else None,
                sid=stack_id_j if tab is not None else None)
    elif mesh is not None:
        from ..parallel import sharded
        _geom_fn = sharded.sharded_build_geometry(ctx, mesh)
        _gauss_fn = sharded.sharded_gaussian_reconstruction(ctx, mesh)
        _sim_fn = sharded.sharded_simulate(ctx, mesh)
        _irs_fn = sharded.sharded_initialize_robust_statistics(ctx, mesh)
        _estep_fn = sharded.sharded_estep(ctx, mesh)
        _inner_fn = sharded.sharded_inner_iteration(
            ctx, mesh, do_bias=do_bias, do_scale=cfg.intensity_matching,
            do_normalise_bias=do_nbias)
        _reg0 = sharded.sharded_register_slices(reg_cfg, mesh,
                                                recon_attr.dx, ctx=ctx)

        def _reg_fn(rec, rw2i, t, mo, ofs, tg):
            return _reg0(rec, rw2i, t, mo, ofs, tg, stack_id_j)
    else:
        def _geom_fn(rw2i, t, i2w, dims, v, mf, sid):
            return svr_core.build_geometry(ctx, rw2i, t, i2w, dims, v, mf,
                                           stack_id=sid)

        def _gauss_fn(s, v, geom, sume, b, sc, mf):
            return svr_core.gaussian_reconstruction(ctx, geom, sume, s, v,
                                                    b, sc, mf)

        def _sim_fn(geom, sume, rec, mf):
            return svr_core.simulate(ctx, geom, sume, rec, mf)

        def _irs_fn(s, v, ss, em_, mx, mn, ex):
            return svr_core.initialize_robust_statistics(ctx, s, v, ss,
                                                         em_, mx, mn, ex)

        def _estep_fn(s, v, sume, ss, em_, ex):
            return svr_core.estep(ctx, s, v, sume, ss, em_, ex)

        def _inner_fn(geom, sume, s, v, em_, ss, rec, vw, m, mf, ex, a,
                      lm, mn, mx, it_):
            return svr_core.inner_iteration(
                ctx, geom, sume, s, v, em_, ss, rec, vw, m, mf, ex, a, lm,
                mn, mx, it_, do_bias=do_bias,
                do_scale=cfg.intensity_matching,
                do_normalise_bias=do_nbias)

        def _reg_fn(rec, rw2i, t, mo, ofs, tg):
            tab = _psf_tab(rec)
            return s2v.register_slices_to_volume(
                reg_cfg, rec, rw2i, t, mo, ofs, tg, recon_attr.dx,
                psf_table=tab, vol_shape=tuple(ctx.vol_shape)
                if tab is not None else None,
                sid=stack_id_j if tab is not None else None)

    recon = jnp.zeros(recon_attr.shape_zyx, jnp.float32)
    if reference_volume is None and cfg.reference_volume:
        reference_volume = read_nifti(cfg.reference_volume)
    have_reference = reference_volume is not None
    if have_reference:
        recon = resample_to_grid(
            jnp.asarray(reference_volume.data),
            jnp.asarray(reference_volume.attr.w2i(), jnp.float32),
            recon_attr.shape_zyx,
            jnp.asarray(recon_attr.i2w(), jnp.float32), interp="linear",
            padding=0.0)
    em = svr_core.init_em_state(n, valid)
    small_slices = np.zeros((n,), bool)
    stats.sample("device setup")

    # ----- checkpoint / resume ---------------------------------------------
    # outer-iteration granularity: (iteration, volume, per-slice transforms)
    # is the complete resume state — EM state is reinitialized at the top of
    # every outer iteration anyway (InitializeEMValues, reconstruction.cc:935)
    start_it = 0
    if cfg.checkpoint_dir:
        import os
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        if cfg.resume:
            from .checkpoint import load_checkpoint
            cps = sorted(f for f in os.listdir(cfg.checkpoint_dir)
                         if f.startswith("checkpoint_iter")
                         and f.endswith(".npz"))
            if cps:
                state = load_checkpoint(
                    os.path.join(cfg.checkpoint_dir, cps[-1]))
                # redo the checkpointed iteration's successor; if the run
                # was already complete, redo the last iteration (keeps the
                # final-restoration state well-defined)
                start_it = min(state["iteration"] + 1,
                               max(cfg.iterations - 1, 0))
                recon = jnp.asarray(state["recon"].data)
                transforms = np.asarray(state["transforms"], np.float64)
                have_reference = True

    # ----- outer loop -----------------------------------------------------
    iterations = cfg.iterations
    levels = cfg.multires_levels
    cur_lambda = cfg.lambda_
    eval_log = None
    if not cfg.no_log:
        eval_log = open(cfg.log_prefix + "log-evaluation.txt", "a")
    for it in range(start_it, iterations):
        # registration (at iteration 0 only with a reference volume,
        # reconstruction.cc:826)
        if it > 0 or have_reference:
            have_pkgs = (len(cfg_packages) == n_stacks
                         and it <= iterations * (levels - 1) // levels
                         and it < iterations - 1)
            if have_pkgs:
                recon_img = Image(np.asarray(recon), recon_attr.copy())
                if it == 1:
                    transforms = package_to_volume(
                        stacks, cfg_packages, recon_img, transforms,
                        use_nmi=cfg.use_nmi)
                elif it == 2:
                    transforms = package_to_volume(
                        stacks, cfg_packages, recon_img, transforms,
                        evenodd=True, use_nmi=cfg.use_nmi)
                elif it == 3:
                    transforms = package_to_volume(
                        stacks, cfg_packages, recon_img, transforms,
                        evenodd=True, half=True, use_nmi=cfg.use_nmi)
                else:
                    transforms = package_to_volume(
                        stacks, cfg_packages, recon_img, transforms,
                        evenodd=True, half=True, half_iter=it - 2,
                        use_nmi=cfg.use_nmi)
                    have_pkgs = False  # fall through to slice-to-volume
                _sync()
                stats.sample("package registration")
            if not have_pkgs:
                if reg_targets is None:
                    reg_targets, reg_mo, reg_ofs = \
                        prepare_registration_slices(batch, recon_attr.dx)
                    reg_targets = place(jnp.asarray(reg_targets))
                    reg_mo = place(jnp.asarray(reg_mo))
                    reg_ofs = place(jnp.asarray(reg_ofs))
                new_t, _ = _reg_fn(recon, recon_w2i_j,
                                   place(jnp.asarray(transforms,
                                                     jnp.float32)),
                                   reg_mo, reg_ofs, reg_targets)
                transforms = np.asarray(new_t, np.float64)
                _sync()
                stats.sample("registration")

        # smoothing schedule (reconstruction.cc:893-911); lambda persists
        # between level boundaries (SetSmoothingParameters only fires at
        # iter == iterations*(levels-i-1)/levels)
        if it == iterations - 1:
            cur_lambda = cfg.last_iter_lambda
        else:
            l = cfg.lambda_
            for i in range(levels):
                if it == iterations * (levels - i - 1) // levels:
                    cur_lambda = l
                l *= 2
        alpha, lam = smoothing_parameters(cfg.delta, cur_lambda)

        rec_iterations = (cfg.rec_iterations_first
                          if it < iterations - 1
                          else cfg.rec_iterations_last)

        # geometry + initial volume
        geom, sume = _geom_fn(recon_w2i_j,
                              place(jnp.asarray(transforms, jnp.float32)),
                              slice_i2w_j, dims_j, valid, mask_flat,
                              stack_id_j)
        em = svr_core.init_em_state(n, valid)
        recon, vol_weights, voxel_count = _gauss_fn(
            slices_j, valid, geom, sume, em.bias, em.scale, mask_flat)
        _sync(recon, vol_weights)
        stats.sample("gaussian reconstruction")

        # exclude slices with small ROI overlap (GaussianReconstructionGPU)
        vc = np.asarray(voxel_count)
        median = np.sort(vc)[int(round(len(vc) * 0.5))]
        small_slices = vc < 0.1 * median
        excluded = jnp.asarray(force_excluded | small_slices)

        sim_state = _sim_fn(geom, sume, recon, mask_flat)
        em = _irs_fn(slices_j, valid, sim_state, em, max_i, min_i,
                     excluded)
        em, _ = _estep_fn(slices_j, valid, sume, sim_state, em, excluded)
        _sync(em.weights)
        stats.sample("simulate+estep")

        for sr_it in range(rec_iterations):
            em, sim_state, recon = _inner_fn(
                geom, sume, slices_j, valid, em, sim_state, recon,
                vol_weights, mask_j, mask_flat, excluded,
                jnp.float32(alpha), jnp.float32(lam), jnp.float32(min_i),
                jnp.float32(max_i), jnp.int32(sr_it + 1))
        _sync(recon)
        stats.sample("superresolution loop")

        recon = mask_volume(recon, mask_j)

        # per-iteration observability: debug dumps (reconstruction.cc:1192
        # image%i_GPU.nii.gz and the Save* dumps), inclusion report to
        # log-evaluation.txt (Evaluate, .cc:4540), checkpoint save
        sw = np.asarray(em.slice_weight)
        if eval_log is not None:
            inside = np.asarray(sim_state.slice_inside)
            inc = np.nonzero((sw >= 0.5) & inside)[0]
            exc = np.nonzero((sw < 0.5) & inside)[0]
            outs = np.nonzero(~inside)[0]
            eval_log.write(
                "Iteration %d:\nIncluded slices: %s\nTotal: %d\n"
                "Excluded slices: %s\nTotal: %d\n"
                "Outside slices: %s\nTotal: %d\n"
                % (it, " ".join(map(str, inc)), len(inc),
                   " ".join(map(str, exc)), len(exc),
                   " ".join(map(str, outs)), len(outs)))
            eval_log.flush()
        if cfg.debug:
            from ..utils.tracing import check_finite
            check_finite((recon, em.weights, em.bias, em.scale,
                          em.slice_weight, sim_state.sim),
                         name=f"iteration {it}")
            write_nifti(Image(np.asarray(recon), recon_attr.copy()),
                        f"{cfg.log_prefix}image{it}.nii.gz")
            # confidence map + EM dumps (SaveConfidenceMap/SaveBiasFields/
            # SlicesInfo, .cc:4870-4937)
            write_nifti(Image(np.asarray(vol_weights), recon_attr.copy()),
                        f"{cfg.log_prefix}confidence_map{it}.nii.gz")
            np.savez(f"{cfg.log_prefix}em_state{it}.npz",
                     slice_weights=sw, scales=np.asarray(em.scale),
                     bias=np.asarray(em.bias),
                     voxel_weights=np.asarray(em.weights))
        if cfg.checkpoint_dir:
            from .checkpoint import save_checkpoint
            save_checkpoint(
                f"{cfg.checkpoint_dir}/checkpoint_iter{it:03d}.npz", it,
                Image(np.asarray(recon), recon_attr.copy()), transforms,
                slice_weights=sw, scales=np.asarray(em.scale),
                stack_factors=stack_factors)
        if iteration_hook is not None:
            iteration_hook(it, Image(np.asarray(recon), recon_attr.copy()),
                           np.asarray(transforms))
        stats.sample("iteration tail")

    if eval_log is not None:
        eval_log.close()

    # ----- final intensity restoration ------------------------------------
    # RestoreSliceIntensities (.cc:1003) + ScaleVolume (.cc:1034)
    factors = jnp.asarray(stack_factors)[jnp.asarray(batch.stack_index)]
    restored = jnp.where(slices_j > 0,
                         slices_j / factors[:, None, None], slices_j)
    from ..em.robust import scale_volume_factor
    scale = scale_volume_factor(restored, valid, em.weights,
                                em.slice_weight, sim_state.sim,
                                sim_state.simw)
    recon = jnp.where(recon > 0, recon * scale, recon)
    stats.sample("restore+scale")

    # --manualMask: push the first stack's manual segmentation through the
    # PSF with the final geometry (transformManualMaskwithPSF, .cc:4824)
    manual_vol = None
    if manual_img is not None:
        from ..ops.manual_mask import transform_manual_mask
        mslices = np.zeros_like(batch.data)
        idx0 = np.nonzero(batch.stack_index == 0)[0]
        for j, k in enumerate(idx0[:manual_img.attr.z]):
            im = manual_img.data[j]
            mslices[k, :im.shape[0], :im.shape[1]] = im
        # normalize over the mask-carrying (first-stack) slices only
        valid0 = valid & jnp.asarray(batch.stack_index == 0)[:, None, None]
        mvol = transform_manual_mask(ctx, geom, sume,
                                     jnp.asarray(mslices), valid0,
                                     mask_flat)
        manual_vol = Image(_crop_pad_z(np.asarray(mvol)), out_attr.copy())
        stats.sample("manual mask transform")

    # --bspline: alternative smooth reconstruction by multi-level B-spline
    # fitting to the scattered (restored) slice samples
    # (irtkBSplineReconstruction.cc:76 Reconstruct; off the main path)
    bspline_vol = None
    if cfg.bspline:
        from ..sr.bspline import bspline_reconstruct
        fwd = np.asarray(svr_core.slice_forward_matrices(
            recon_w2i_j, jnp.asarray(transforms, jnp.float32),
            slice_i2w_j))
        nb, hb, wb = batch.data.shape
        px, py = np.meshgrid(np.arange(wb, dtype=np.float32),
                             np.arange(hb, dtype=np.float32))
        pos = (fwd[:, None, None, :3, 0] * px[None, :, :, None]
               + fwd[:, None, None, :3, 1] * py[None, :, :, None]
               + fwd[:, None, None, :3, 3])
        keep = np.asarray(restored) > 0
        bvol = bspline_reconstruct(pos[keep], np.asarray(restored)[keep],
                                   recon_attr.shape_zyx)
        bvol = jnp.where(mask_j != 0, bvol, 0.0)
        bspline_vol = Image(_crop_pad_z(np.asarray(bvol)),
                            out_attr.copy())
        stats.sample("bspline reconstruction")

    out = Image(_crop_pad_z(np.asarray(recon)), out_attr.copy())
    return SVRResult(reconstructed=out, transforms=transforms,
                     slice_weights=np.asarray(em.slice_weight),
                     stack_factors=stack_factors, stats=stats,
                     excluded_slices=list(np.nonzero(small_slices)[0]),
                     slice_inside=np.asarray(sim_state.slice_inside),
                     manual_mask_volume=manual_vol,
                     bspline_reconstructed=bspline_vol)
