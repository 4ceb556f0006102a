"""Isolate stack registration on the per-slice-motion phantom: with both
stacks sharing identity STACK motion, stack_registrations should return
~identity for the non-template stack (per-slice jitter averages out)."""
import os
import sys
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, ROOT)
import jax

jax.config.update("jax_platforms", "cpu")

from phantom import make_ground_truth, simulate_stacks
from fetalreconstruction_tpu.core.image import Image
from fetalreconstruction_tpu.register.stack import stack_registrations
from fetalreconstruction_tpu.pipeline.svr import (transform_mask,
                                                  crop_image,
                                                  create_template, set_mask)

gt = make_ground_truth(n=28, spacing=1.5)
rng = np.random.default_rng(3)
slice_motions = []
for s in range(2):
    m = np.zeros((14, 6))
    m[:, :2] = rng.uniform(-3.0, 3.0, (len(m), 2))
    m[:, 5] = rng.uniform(-3.0, 3.0, len(m))
    slice_motions.append(m)
stacks, _ = simulate_stacks(gt, n_stacks=2, in_plane=2.0, dz=3.0,
                            noise=0.5, slice_motions=slice_motions)
mask = Image((gt.data > 1.0).astype(np.float32), gt.attr.copy())

m_tmpl = transform_mask(stacks[0], mask, np.eye(4))
stacks[0] = crop_image(stacks[0], m_tmpl)
recon_attr = create_template(stacks[0], 1.6)
recon_mask_img = set_mask(mask, recon_attr, 2.0)
tmask = transform_mask(stacks[0], recon_mask_img, np.eye(4))

for use_mask in (None, tmask):
    t = stack_registrations(stacks, 0, mask=use_mask)
    tag = "masked" if use_mask is not None else "unmasked"
    for i in range(2):
        d = np.linalg.norm(t[i][:3, 3])
        r = np.linalg.norm(t[i][:3, :3] - np.eye(3))
        print(f"{tag}: stack {i} |t| = {d:.2f} mm |R-I| = {r:.4f}")
