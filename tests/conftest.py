import os

# Tests run on the CPU backend with a virtual 8-device mesh.  The
# host-device-count flag must be set before the CPU client initializes, and
# the platform is pinned through jax.config as well as the environment in
# case jax was imported before this file ran.
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".jax_cache"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
jax.config.update("jax_enable_x64", True)  # f64 navigation parity on CPU
