"""fetalreconstruction_tpu — motion-compensated super-resolution fetal MRI
reconstruction (SVR + PVR) in JAX.

A from-scratch JAX/XLA framework with the capabilities of
bkainz/fetalReconstruction: slice-/patch-to-volume rigid registration,
Gaussian/sinc PSF forward simulation and transpose accumulation, EM robust
statistics, bias correction, and edge-preserving super-resolution — designed
SPMD-first over a `slices` device mesh axis.
"""

__version__ = "0.1.0"
