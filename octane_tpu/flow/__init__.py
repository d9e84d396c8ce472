"""Optical-flow engines: coarse-to-fine variational solver and patch match.

A redesign of oct_variational_optical_flow.cu (the cooperative-groups
mega-kernel becomes a per-level jitted program: XLA dataflow replaces the ~50
grid barriers, the CSR Euler-Lagrange system becomes a matrix-free coupled
5-point stencil, and the CG dot products become jnp reductions / psum) and of
oct_patch_match_optical_flow.cc (the serial spiral search becomes a vectorized
argmin over the offset square with spiral-order tie-breaking).
"""

from octane_tpu.flow.variational import variational_flow, solve_level
from octane_tpu.flow.patch_match import patch_match_flow
from octane_tpu.flow.dispatcher import compute_flow

__all__ = ["variational_flow", "solve_level", "patch_match_flow", "compute_flow"]
