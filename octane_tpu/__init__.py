"""octane_tpu: a JAX dense optical-flow / atmospheric-motion-vector engine.

A from-scratch JAX/XLA re-design with the capabilities of the reference
OCTANE CUDA/C++ tool (dense variational optical flow for GOES-R imagery,
patch-match flow, pixel->wind navigation, bilateral flow smoothing, temporal
frame interpolation, netCDF products):

  * compute path: jit-compiled jnp programs, one XLA program per image pair,
  * parallelism: spatial domain decomposition over a `jax.sharding.Mesh`
    with halo exchange (`shard_map` + `lax.ppermute`) and `psum` reductions,
  * IO: HDF5 (netCDF4-compatible) readers/writers via h5py.

Layer map (mirrors reference layers, see SURVEY.md section 1):
  config        <- include/offlags.h
  core/         <- oct_bicubic/binterp/gaussian/zoom/normalize + gradients
  nav/          <- oct_navcal_cuda / polar / merc / pix2uv
  flow/         <- oct_variational_optical_flow.cu, oct_patch_match, dispatcher
  post/         <- oct_srsal_cuda.cu, oct_interp.cc
  io/           <- oct_fileread.cc / oct_filewrite.cc + data model
  parallel/     <- (new capability: multi-device spatial sharding)
  pipeline/cli  <- main.cc
"""

from octane_tpu.config import OFConfig

__version__ = "0.1.0"

__all__ = ["OFConfig", "__version__"]
