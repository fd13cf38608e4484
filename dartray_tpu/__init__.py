"""dartray_tpu — a differentiable dust radiative-transfer framework in JAX.

A from-scratch JAX/Pallas reimplementation of the capabilities of DART-Ray
(Natale et al. 2014, 2017): HEALPix-directed adaptive ray tracing through an
adaptive 3D octree grid, radiation-field energy densities, anisotropic
scattering iterations, observer intensities / surface-brightness maps / SEDs,
and dust-emission calculations — designed for SPMD execution on
accelerator meshes with reverse-mode gradients through the transfer
physics.
"""

__version__ = "0.1.0"
