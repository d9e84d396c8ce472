"""End-to-end pipeline: ingest -> flow -> navigation -> products.

Equivalent of the reference's main() orchestration
(src/main.cc:398-480): read the image pair (plus optional CTH, first guess
and extra channels), compute flow, write the product file, and optionally
synthesize temporally interpolated frames.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import jax.numpy as jnp

from octane_tpu.config import OFConfig
from octane_tpu.flow.dispatcher import compute_flow
from octane_tpu.io.datamodel import Scene
from octane_tpu.io.readers import read_scene, read_cth, read_first_guess
from octane_tpu.io.writers import write_product
from octane_tpu.post.temporal import interpolate_frame


def run_pipeline(
    file1: str,
    file2: str,
    cfg: OFConfig,
    outdir: str = "./",
    cth_file: Optional[str] = None,
    firstguess_file: Optional[str] = None,
    channel2: Optional[tuple] = None,
    channel3: Optional[tuple] = None,
    interp_dir: str = "./interpolation",
) -> List[str]:
    """Run the full flow pipeline; returns the list of files written."""
    os.makedirs(outdir, exist_ok=True)
    scene1 = read_scene(file1, cfg, donav=True, channel=1)
    scene2 = read_scene(file2, cfg, donav=False, channel=1)
    if cfg.grid == "goes":
        scene1.nav.g2x_offset = scene2.nav.x_offset
        scene1.nav.g2y_offset = scene2.nav.y_offset

    if cth_file is not None:
        cfg = cfg.replace(do_cth=True)
        read_cth(cth_file, scene1, cfg)
    if firstguess_file is not None:
        cfg = cfg.replace(do_firstguess=True)
        read_first_guess(firstguess_file, scene1)
    if channel2 is not None:
        read_scene(channel2[0], cfg, donav=False, channel=2, scene=scene1)
        read_scene(channel2[1], cfg, donav=False, channel=2, scene=scene2)
    if channel3 is not None:
        read_scene(channel3[0], cfg, donav=False, channel=3, scene=scene1)
        read_scene(channel3[1], cfg, donav=False, channel=3, scene=scene2)
    cfg = cfg.replace(nchannels=scene1.nchannels)

    compute_flow(scene1, scene2, cfg)

    suffix = {"goes": "", "polar": "_polar", "mercator": "_merc"}[cfg.grid]
    outname = os.path.join(outdir, f"outfile{suffix}.nc")
    written = [write_product(outname, scene1, cfg, interp=False)]

    if cfg.do_interp:
        written += interpolate_sequence(scene1, scene2, cfg, interp_dir)
    return written


def interpolate_sequence(scene1: Scene, scene2: Scene, cfg: OFConfig,
                         interp_dir: str) -> List[str]:
    """Write interpolated frames between the pair (main.cc:450-480 loop:
    frames every ``deltat`` seconds while frt < 1)."""
    from octane_tpu.flow.dispatcher import active_mesh

    os.makedirs(interp_dir, exist_ok=True)
    written = []
    step = cfg.deltat / scene1.dt
    frt = step
    idx = 1
    mesh = active_mesh(cfg)
    if mesh is not None:
        from octane_tpu.parallel.post import sharded_interpolate_frame
        # static splat halo from the actual flow, rounded up to bound the
        # number of distinct compiled programs across a sequence
        md = float(max(np.abs(scene1.u_pix).max(), np.abs(scene1.v_pix).max()))
        max_disp = max(8, int(-(-md // 8) * 8))
    while frt < 1.0 and (1.0 - frt) >= step / 2.0:
        if mesh is not None:
            img, occ = sharded_interpolate_frame(
                scene1.u_pix, scene1.v_pix, scene1.data, scene2.data,
                frt, mesh, max_disp=max_disp)
        else:
            img, occ = interpolate_frame(
                jnp.asarray(scene1.u_pix), jnp.asarray(scene1.v_pix),
                jnp.asarray(scene1.data), jnp.asarray(scene2.data), frt)
        img = np.asarray(img)
        # rescale normalized 0-255 image back to radiance counts
        # (oct_interp.cc:424-457) -- multithreaded native hot loop
        from octane_tpu.io.native import requantize
        counts = np.empty_like(scene1.raw_counts)
        for c in range(img.shape[0]):
            vmin, vmax = scene1.norm_ranges[c]
            counts[c] = requantize(img[c], vmin, vmax,
                                   scene1.nav.rad_scale[c],
                                   scene1.nav.rad_offset[c])
        scene1.occlusion = np.asarray(occ)
        scene1.frdt = float(frt)
        scene1.t_interp = scene1.t + scene1.dt * frt
        saved = scene1.raw_counts
        scene1.raw_counts = counts
        # per-grid naming matches the reference (oct_filewrite.cc:707-715)
        suffix = {"goes": "", "polar": "_polar", "mercator": "_merc"}[cfg.grid]
        path = os.path.join(interp_dir, f"outfile_interp{suffix}{idx}.nc")
        written.append(write_product(path, scene1, cfg, interp=True))
        scene1.raw_counts = saved
        idx += 1
        frt += step
    return written
