"""Typed configuration for the optical-flow engine.

Replaces the reference's flat ``OFFlags`` struct (include/offlags.h:4-72) and
the inline defaults in main.cc:53-108 with a validated dataclass.  Every knob
that influences numerics keeps the reference default so outputs are
drop-in comparable.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class OFConfig:
    """Optical-flow engine options.

    Reference: include/offlags.h (fields) and src/main.cc:53-108 (defaults).
    """

    # --- algorithm selection -------------------------------------------------
    algorithm: str = "variational"      # "variational" | "patch_match" | "hybrid"
                                        # (hybrid: patch-match init + variational refine)
    dozim: bool = True                  # Zimmer data-term normalization (-brox turns off)
    # --- variational solver weights (main.cc:77-88) --------------------------
    alpha: float = 5.0                  # smoothness weight
    lambda_: float = 1.0                # gradient-constancy weight
    lambdac: float = 0.0                # first-guess hinting weight
    scale_factor: float = 0.5           # pyramid scale factor (scaleF)
    kiters: int = 4                     # pyramid levels
    liters: int = 3                     # inner (relinearization) iterations
    cgiters: int = 30                   # max CG iterations
    cg_tol: float = 1e-4 ** 2           # CG stop: ||r||^2 <= tol (oct_variational_optical_flow.cu:1353)
    gnc_steps: int = 3                  # graduated non-convexity steps (hard-coded 3 in reference :604)
    # deprecated knobs no solver reads; carried for attr-for-attr product
    # parity (echoed on optical_flow_settings, oct_filewrite.cc:243, 247)
    filtsigma: float = 3.0              # main.cc:80 "deprecated"
    miters: int = 5                     # offlags.h:54, unused by any solver
    # --- patch match (main.cc:75-76) ----------------------------------------
    rad: int = 2                        # target patch radius
    srad: int = 2                       # search radius
    # --- channels ------------------------------------------------------------
    nchannels: int = 1                  # 1 + doc2 + doc3
    # --- grid / product selection -------------------------------------------
    grid: str = "goes"                  # "goes" | "polar" | "mercator"
    ir: bool = False                    # CTP stored as (T-300)*100 when True
    pixuv: bool = False                 # output raw pixel displacements only (-pd)
    do_cth: bool = False                # cloud-top-height ingest enabled
    do_firstguess: bool = False
    do_srsal: bool = False              # bilateral smoothing of the flow
    do_interp: bool = False             # temporal interpolation
    interp_cth_bicubic: bool = True     # -nncth switches CTH regrid to nearest neighbour
    deltat: float = 60.0                # interpolation frame period (seconds)
    # --- normalization overrides (-normmin/max[2|3]) -------------------------
    norm_min: Optional[float] = None
    norm_max: Optional[float] = None
    norm_min2: Optional[float] = None
    norm_max2: Optional[float] = None
    norm_min3: Optional[float] = None
    norm_max3: Optional[float] = None
    # --- output toggles (main.cc:98-101) -------------------------------------
    out_nav: bool = True
    out_raw: bool = True
    out_rad: bool = True
    out_ctp: bool = True
    # --- execution -----------------------------------------------------------
    mesh_shape: Tuple[int, int] = (1, 1)   # (rows, cols) spatial device mesh
    halo_warp: int = 16                    # warp-gather halo in sharded mode (px per side)
    solver: str = "pcg"                    # "pcg" (reference-exact Jacobi-PCG)
                                           # | "sor" (red-black SOR; parity
                                           # evidence in docs/PARITY.md)
    sor_omega: float = 1.9                 # SOR over-relaxation factor

    def __post_init__(self):
        if self.algorithm not in ("variational", "patch_match", "hybrid"):
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if self.grid not in ("goes", "polar", "mercator"):
            raise ValueError(f"unknown grid {self.grid!r}")
        if self.solver not in ("pcg", "sor"):
            raise ValueError(f"unknown solver {self.solver!r}")
        if not (0.0 < self.sor_omega < 2.0):
            raise ValueError("sor_omega must be in (0, 2)")
        if not (0.0 < self.scale_factor < 1.0):
            raise ValueError("scale_factor must be in (0, 1)")
        for name in ("kiters", "liters", "cgiters", "gnc_steps", "rad", "srad",
                     "nchannels"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")
        if self.nchannels > 3:
            raise ValueError("at most 3 channels are supported (doc2/doc3)")

    # The reference writes an integer algorithm code into the product file
    # (main.cc:362-379, key at oct_filewrite.cc:231).
    @property
    def oftype(self) -> int:
        if self.algorithm == "patch_match":
            return 4
        return 1 if self.dozim else 3   # hybrid products record the refiner

    @property
    def lambda_over_alpha(self) -> float:
        return self.lambda_ / self.alpha

    def replace(self, **kw) -> "OFConfig":
        return dataclasses.replace(self, **kw)
