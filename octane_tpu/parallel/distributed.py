"""Multi-host execution: jax.distributed runtime + host-sharded ingest.

The reference is single-GPU/single-process; multi-host is a new capability.
Design (see SURVEY.md section 5 "long-context analog"): the full-disk grid is
row-sharded across hosts; each host reads only its row block of the input
files (hyperslab reads -- HDF5 handles partial IO natively), the global
device array is assembled with `jax.make_array_from_process_local_data`, and
from there the single-controller SPMD programs in
octane_tpu.parallel.sharded run unchanged -- halo traffic stays inside a
host's devices and crosses the network only at host-boundary rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax

try:
    import h5py
except ImportError:                                    # pragma: no cover
    h5py = None

from octane_tpu.config import OFConfig
from octane_tpu.parallel.mesh import make_mesh, flow_sharding, image_sharding


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None):
    """Bring up the jax.distributed runtime (no-op for a single process)."""
    if num_processes in (None, 1):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def host_row_block(h: int) -> Tuple[int, int]:
    """[row0, row1) of the global grid owned by this process (row sharding).

    Uses GSPMD's ceil-division convention so the block boundaries coincide
    with NamedSharding shard boundaries at non-divisible heights."""
    p = jax.process_count()
    i = jax.process_index()
    rows = -(-h // p)
    r0 = min(i * rows, h)
    r1 = min(r0 + rows, h)
    return r0, r1


def read_counts_block(path: str, var: str, row_range: Tuple[int, int]) -> np.ndarray:
    """Hyperslab read of one variable's row block (host-sharded ingest)."""
    if h5py is None:
        raise RuntimeError("h5py is required for file ingest")
    with h5py.File(path, "r") as f:
        return np.asarray(f[var][row_range[0]:row_range[1], :])


def global_array_from_blocks(local_block: np.ndarray, global_shape, mesh):
    """Assemble the distributed global array from per-process row blocks."""
    sharding = (flow_sharding(mesh) if len(global_shape) == 2
                else image_sharding(mesh))
    return jax.make_array_from_process_local_data(
        sharding, local_block, global_shape)


def distributed_variational_flow(geo1_local, geo2_local, global_shape,
                                 cfg: OFConfig, mesh=None, first_guess=None):
    """Multi-host entry: per-process local row blocks in, global flow out.

    Single-process callers can pass the full arrays (local == global).
    ``first_guess`` optionally supplies (u0, v0) pixel-displacement row
    blocks (navigated first-guess winds / sequence warm starts).
    """
    from octane_tpu.parallel.sharded import sharded_variational_flow

    if mesh is None:
        mesh = make_mesh((jax.device_count(), 1))
    if geo1_local.ndim == 2:
        geo1_local = geo1_local[None]
        geo2_local = geo2_local[None]
    c = geo1_local.shape[0]
    gshape_img = (c,) + tuple(global_shape)
    geo1 = global_array_from_blocks(np.asarray(geo1_local, np.float32),
                                    gshape_img, mesh)
    geo2 = global_array_from_blocks(np.asarray(geo2_local, np.float32),
                                    gshape_img, mesh)
    h_loc, w = geo1_local.shape[-2:]
    if (first_guess is not None and isinstance(first_guess[0], jax.Array)
            and not isinstance(first_guess[0], np.ndarray)):
        # already a global sharded array: device-resident warm start (the
        # sequence driver hands the previous pair's flow straight through,
        # no host round trip)
        u0, v0 = first_guess
    else:
        if first_guess is None:
            zeros = np.zeros((h_loc, w), np.float32)
            u0b, v0b = zeros, zeros
        else:
            u0b = np.asarray(first_guess[0], np.float32)
            v0b = np.asarray(first_guess[1], np.float32)
        u0 = global_array_from_blocks(u0b, tuple(global_shape), mesh)
        v0 = global_array_from_blocks(v0b, tuple(global_shape), mesh)
    return sharded_variational_flow(geo1, geo2, u0, v0, cfg, mesh)


def distributed_mesh(cfg: OFConfig):
    """(process_count * ry_local, rx) mesh: each process owns whole mesh
    rows, so row-block ingest matches the addressable shards and halo
    traffic crosses the network only at host-boundary rows."""
    p = jax.process_count()
    n_local = jax.local_device_count()
    ry, rx = cfg.mesh_shape
    if ry * rx != p * n_local:
        # default: all local devices spread along columns
        return make_mesh((p, n_local))
    if ry % p != 0:
        raise ValueError(
            f"mesh rows {ry} must be a multiple of process count {p}")
    return make_mesh((ry, rx))


def local_rows2d(garr, r0: int, r1: int, dtype=None) -> np.ndarray:
    """This process's [r0, r1) row band of a 2-D global sharded array
    (assembled from its addressable shards; no cross-host traffic)."""
    w = garr.shape[-1]
    blk = None
    for s in garr.addressable_shards:
        data = np.asarray(s.data)
        if blk is None:
            blk = np.zeros((r1 - r0, w), dtype or data.dtype)
        rs, cs = s.index[-2], s.index[-1]
        rs0 = rs.start or 0
        rs1 = garr.shape[-2] if rs.stop is None else rs.stop
        a0, a1 = max(rs0, r0), min(rs1, r1)
        if a0 >= a1:
            continue
        blk[a0 - r0:a1 - r0, cs] = data[a0 - rs0:a1 - rs0]
    return blk


def _write_part(path: str, fields: dict, r0: int, r1: int) -> None:
    with h5py.File(path, "w") as f:
        f.attrs["row0"] = r0
        f.attrs["row1"] = r1
        for name, arr in fields.items():
            f.create_dataset(name, data=arr)


def _part_sources(parts_dir: str, h: int, w: int, names_dtypes):
    """RowBlockSources over every process's part file (deterministic row
    ranges from host_row_block's formula)."""
    from octane_tpu.io.writers import RowBlockSource

    p = jax.process_count()
    rows = -(-h // p)
    parts = []
    for i in range(p):
        r0 = min(i * rows, h)
        r1 = min(r0 + rows, h)
        if r0 < r1:
            parts.append((f"{parts_dir}/part{i}.h5", r0, r1))
    return {name: RowBlockSource(parts, name, (h, w), dt)
            for name, dt in names_dtypes}


def run_pipeline_distributed(file1: str, file2: str, cfg: OFConfig,
                             outdir: str = "./",
                             cth_file=None, firstguess_file=None,
                             channel2=None, channel3=None,
                             interp_dir: str = "./interpolation",
                             first_guess_flow=None, out_index=None,
                             return_flow=False):
    """Multi-process pipeline: host-sharded ingest -> SPMD flow + winds ->
    parallel row-block product write.

    Feature-complete vs the reference's main() (src/main.cc:398-480): all
    three grid types (GOES / polar / mercator, like the reference's
    dispatcher oct_fileread.cc:871-895 + oct_filewrite.cc:707-715), CTH,
    first guess, channels 2/3 and temporal interpolation all run under
    -nprocs.  Every process hyperslab-reads its row block of every input
    (channel-2/3 and CTH regrids read margin-extended source hyperslabs --
    exact vs the full regrid, see core.zoom.zoom_*_image_rows); the global
    device arrays are assembled from the blocks; the solve, pix2uv, SRSAL
    and temporal interpolation run as the same SPMD programs as
    single-host.  The product write keeps memory and network traffic
    bounded: each process writes its row block of every 2-D variable to a
    part file (parallel disk IO on the shared filesystem, NO product-plane
    network traffic), then process 0 streams the parts into the final netCDF one
    block at a time (writers.RowBlockSource).
    """
    import os
    from jax.experimental import multihost_utils
    from octane_tpu.io.readers import read_scene, read_cth, read_first_guess
    from octane_tpu.io.writers import write_product, RowBlockStack
    from octane_tpu.parallel.post import sharded_pix2uv
    from octane_tpu.nav.winds import uv2pix

    goes = cfg.grid == "goes"
    if not goes and (cth_file is not None or channel2 is not None
                     or channel3 is not None):
        # the reference's flat-grid product schema has no CTP/Rad2/Rad3
        # variables (oct_filewrite.cc:353-704), matching the single-process
        # writer here -- reject rather than silently drop
        raise ValueError("CTH / extra channels are GOES-grid products")
    mesh = distributed_mesh(cfg)

    # global grid dims from the file header (cheap, every process)
    if h5py is None:
        raise RuntimeError("h5py is required for file ingest")
    with h5py.File(file1, "r") as f:
        h, w = f["Rad"].shape
        x_full = np.asarray(f["x"][()], np.int16)
        y_full = np.asarray(f["y"][()], np.int16)
    r0, r1 = host_row_block(h)

    scene1 = read_scene(file1, cfg, donav=True, channel=1, row_range=(r0, r1))
    scene2 = read_scene(file2, cfg, donav=False, channel=1, row_range=(r0, r1))
    if goes:
        scene1.nav.g2x_offset = scene2.nav.x_offset
        scene1.nav.g2y_offset = scene2.nav.y_offset
    else:
        scene1.nav.g2x_offset = scene1.nav.x_offset
        scene1.nav.g2y_offset = scene1.nav.y_offset
    if cth_file is not None:
        cfg = cfg.replace(do_cth=True)
        read_cth(cth_file, scene1, cfg, row_range=(r0, r1))
    if firstguess_file is not None:
        cfg = cfg.replace(do_firstguess=True)
        read_first_guess(firstguess_file, scene1, row_range=(r0, r1))
    for ch, files in ((2, channel2), (3, channel3)):
        if files is not None:
            read_scene(files[0], cfg, donav=False, channel=ch, scene=scene1,
                       row_range=(r0, r1))
            read_scene(files[1], cfg, donav=False, channel=ch, scene=scene2,
                       row_range=(r0, r1))
    cfg = cfg.replace(nchannels=scene1.nchannels)
    dt = scene2.t - scene1.t

    # first guess -> pixel displacements (elementwise on the local block,
    # oct_optical_flow.cc:52); a device-resident sequence warm start takes
    # priority
    first_guess = first_guess_flow
    if first_guess is None and cfg.do_firstguess and scene1.ufg is not None:
        u0b, v0b = uv2pix(scene1.ufg, scene1.vfg, scene1.lat, scene1.lon,
                          scene1.x, scene1.y, scene1.nav, dt, grid=cfg.grid)
        first_guess = (np.asarray(u0b), np.asarray(v0b))

    u, v = distributed_variational_flow(
        scene1.data, scene2.data, (h, w), cfg, mesh,
        first_guess=first_guess)
    uw, vw, ur, vr = sharded_pix2uv(u, v, scene1.nav, dt, mesh,
                                    grid=cfg.grid, pixuv=cfg.pixuv)
    ums = vms = None
    if not goes and not cfg.pixuv:
        # flat-grid products keep full-precision winds (oct_polarwrite
        # writes U/V as doubles, oct_filewrite.cc:401-402)
        from octane_tpu.parallel.post import sharded_pix2uv_ms
        ums, vms = sharded_pix2uv_ms(u, v, scene1.nav, dt, mesh,
                                     grid=cfg.grid)
    if cfg.do_srsal and scene1.cth is not None:
        from octane_tpu.parallel.post import sharded_srsal
        cth_g = global_array_from_blocks(
            np.asarray(scene1.cth, np.float32), (h, w), mesh)
        us, vs = sharded_srsal(u, v, cth_g, mesh)
    else:
        us, vs = u, v

    # CTP (elementwise, local block; oct_optical_flow.cc:71-88)
    ctp_blk = None
    if cfg.do_cth and scene1.cth is not None:
        cthv = np.asarray(scene1.cth)
        ctp_blk = (((cthv - 300.0) * 100.0) if cfg.ir else cthv
                   ).astype(np.int16)

    # ---- parallel row-block product write -----------------------------------
    os.makedirs(outdir, exist_ok=True)
    parts_dir = os.path.join(outdir, ".parts")
    os.makedirs(parts_dir, exist_ok=True)
    fields = {
        "Upix": local_rows2d(us, r0, r1, np.float32),
        "Vpix": local_rows2d(vs, r0, r1, np.float32),
    }
    if goes:
        fields["U"] = local_rows2d(uw, r0, r1).astype(np.int16)
        fields["V"] = local_rows2d(vw, r0, r1).astype(np.int16)
        fields["U_raw"] = local_rows2d(ur, r0, r1).astype(np.int16)
        fields["V_raw"] = local_rows2d(vr, r0, r1).astype(np.int16)
    elif ums is not None:
        fields["U_ms"] = local_rows2d(ums, r0, r1, np.float64)
        fields["V_ms"] = local_rows2d(vms, r0, r1, np.float64)
    names = ["Rad", "Rad2", "Rad3"]
    rad_dtype = np.int16 if goes else np.float32
    for c in range(scene1.raw_counts.shape[0]):
        fields[names[c]] = np.asarray(scene1.raw_counts[c], rad_dtype)
    if ctp_blk is not None:
        fields["CTP"] = ctp_blk
    _write_part(os.path.join(parts_dir, f"part{jax.process_index()}.h5"),
                fields, r0, r1)
    multihost_utils.sync_global_devices("octane_parts_done")

    scene1.x = x_full
    scene1.y = y_full
    scene1.dt = float(dt)
    written = []
    if jax.process_index() == 0:
        src = _part_sources(parts_dir, h, w,
                            [(k, fields[k].dtype) for k in fields])
        scene1.u_pix = src["Upix"]
        scene1.v_pix = src["Vpix"]
        if goes:
            scene1.u_wind = src["U"]
            scene1.v_wind = src["V"]
            scene1.u_raw = src["U_raw"]
            scene1.v_raw = src["V_raw"]
        elif "U_ms" in src:
            scene1.u_ms = src["U_ms"]
            scene1.v_ms = src["V_ms"]
        scene1.raw_counts = RowBlockStack(
            [src[names[c]] for c in range(scene1.raw_counts.shape[0])])
        if ctp_blk is not None:
            scene1.ctp = src["CTP"]
        suffix = {"goes": "", "polar": "_polar", "mercator": "_merc"}[cfg.grid]
        stem = (f"outfile{suffix}.nc" if out_index is None
                else f"outfile{suffix}_{out_index:03d}.nc")
        outname = os.path.join(outdir, stem)
        written.append(write_product(outname, scene1, cfg, interp=False))
    multihost_utils.sync_global_devices("octane_write_done")

    if cfg.do_interp:
        written += _interpolate_sequence_distributed(
            scene1, scene2, us, vs, (h, w), (r0, r1), cfg, interp_dir, mesh)
    if return_flow:
        return written, (us, vs)
    return written


def _interpolate_sequence_distributed(scene1, scene2, u, v, hw, row_range,
                                      cfg: OFConfig, interp_dir: str,
                                      mesh) -> list:
    """Temporal interpolation under -nprocs: the splat/fill/synthesis run
    mesh-sharded (parallel.post.sharded_interpolate_frame), each process
    requantizes and part-writes its row block, process 0 merges (same
    frame loop as pipeline.interpolate_sequence, main.cc:450-480)."""
    import os
    from jax.experimental import multihost_utils
    from octane_tpu.io.native import requantize
    from octane_tpu.io.writers import write_product, RowBlockStack
    from octane_tpu.parallel.post import sharded_interpolate_frame

    h, w = hw
    r0, r1 = row_range
    os.makedirs(interp_dir, exist_ok=True)
    parts_dir = os.path.join(interp_dir, ".parts")
    os.makedirs(parts_dir, exist_ok=True)
    im1 = global_array_from_blocks(
        np.asarray(scene1.data, np.float32),
        (scene1.data.shape[0], h, w), mesh)
    im2 = global_array_from_blocks(
        np.asarray(scene2.data, np.float32),
        (scene2.data.shape[0], h, w), mesh)
    umax = float(jnp_abs_max(u))
    vmax = float(jnp_abs_max(v))
    max_disp = max(8, int(-(-max(umax, vmax) // 8) * 8))

    written = []
    step = cfg.deltat / scene1.dt
    frt = step
    idx = 1
    names = ["Rad", "Rad2", "Rad3"]
    nchan = scene1.data.shape[0]
    saved_counts = scene1.raw_counts
    while frt < 1.0 and (1.0 - frt) >= step / 2.0:
        img, occ = sharded_interpolate_frame(u, v, im1, im2, frt, mesh,
                                             max_disp=max_disp)
        fields = {"Occlusion": local_rows2d(occ, r0, r1).astype(np.int16)}
        rad_dtype = np.int16 if cfg.grid == "goes" else np.float32
        for c in range(nchan):
            vmin, vmax_n = scene1.norm_ranges[c]
            blk = local_rows2d(img[c], r0, r1, np.float32)
            fields[names[c]] = requantize(blk, vmin, vmax_n,
                                          scene1.nav.rad_scale[c],
                                          scene1.nav.rad_offset[c]
                                          ).astype(rad_dtype)
        part = os.path.join(parts_dir, f"f{idx}_part{jax.process_index()}.h5")
        _write_part(part, fields, r0, r1)
        multihost_utils.sync_global_devices(f"octane_interp_{idx}")
        if jax.process_index() == 0:
            p = jax.process_count()
            rows = -(-h // p)
            parts = [(os.path.join(parts_dir, f"f{idx}_part{i}.h5"),
                      min(i * rows, h), min(min(i * rows, h) + rows, h))
                     for i in range(p) if min(i * rows, h) < h]
            from octane_tpu.io.writers import RowBlockSource
            scene1.occlusion = RowBlockSource(parts, "Occlusion",
                                              (h, w), np.int16)
            rad_dtype = np.int16 if cfg.grid == "goes" else np.float32
            scene1.raw_counts = RowBlockStack(
                [RowBlockSource(parts, names[c], (h, w), rad_dtype)
                 for c in range(nchan)])
            scene1.frdt = float(frt)
            scene1.t_interp = scene1.t + scene1.dt * frt
            suffix = {"goes": "", "polar": "_polar",
                      "mercator": "_merc"}[cfg.grid]
            path = os.path.join(interp_dir,
                                f"outfile_interp{suffix}{idx}.nc")
            written.append(write_product(path, scene1, cfg, interp=True))
            scene1.raw_counts = saved_counts
        multihost_utils.sync_global_devices(f"octane_interp_done_{idx}")
        idx += 1
        frt += step
    return written


def jnp_abs_max(a) -> float:
    """max |a| of a global sharded array (small replicated scalar)."""
    import jax.numpy as jnp
    return jax.jit(lambda x: jnp.max(jnp.abs(x)))(a)


# ---------------------------------------------------------------------------
# Multi-host sequence mode (BASELINE config 5 "across hosts")
# ---------------------------------------------------------------------------

def _seq_ckpt_path(checkpoint: str) -> str:
    return f"{checkpoint}.p{jax.process_index()}.h5"


def _save_seq_checkpoint(checkpoint: str, index: int, u_blk, v_blk,
                         r0: int, r1: int, key: str, files_done):
    """Row-block checkpoint: each process atomically writes ITS rows of the
    warm-start flow (no cross-host traffic, bounded memory -- the sequence
    analog of the pipeline's part-file product write)."""
    path = _seq_ckpt_path(checkpoint)
    tmp = path + ".tmp"
    with h5py.File(tmp, "w") as f:
        f.create_dataset("pair_index", data=np.int64(index))
        f.create_dataset("u_pix", data=np.asarray(u_blk, np.float32))
        f.create_dataset("v_pix", data=np.asarray(v_blk, np.float32))
        f.attrs["row0"] = r0
        f.attrs["row1"] = r1
        f.attrs["nprocs"] = jax.process_count()
        f.attrs["cfg_key"] = key
        f.attrs["files_done"] = "\n".join(files_done)
    import os
    os.replace(tmp, path)


def _load_seq_checkpoint(checkpoint: str, key: str, files, r0: int, r1: int):
    import os
    path = _seq_ckpt_path(checkpoint)
    if not os.path.exists(path):
        return None
    with h5py.File(path, "r") as f:
        def _s(a):
            return a.decode() if isinstance(a, bytes) else str(a)

        if _s(f.attrs.get("cfg_key", "")) != key:
            raise ValueError(
                "checkpoint was written by a run with different solver "
                "settings; delete it (or rerun with the original settings) "
                f"to resume: {path}")
        if int(f.attrs.get("nprocs", -1)) != jax.process_count() or \
                (int(f.attrs["row0"]), int(f.attrs["row1"])) != (r0, r1):
            raise ValueError(
                "checkpoint was written by a run with a different process "
                f"layout; resume with the same -nprocs: {path}")
        done = _s(f.attrs.get("files_done", "")).split("\n")
        if done != list(files[:len(done)]):
            raise ValueError(
                "checkpoint was written against a different frame list "
                f"(appending new frames is fine; reordering is not): {path}")
        return (int(f["pair_index"][()]),
                np.asarray(f["u_pix"][()]),
                np.asarray(f["v_pix"][()]))


def run_sequence_distributed(
    files,
    cfg: OFConfig,
    outdir: str = "./",
    checkpoint: Optional[str] = None,
    warm_start: bool = True,
    interp_dir: str = "./interpolation",
) -> list:
    """Multi-process sequence driver (sequence.run_sequence under -nprocs).

    Consecutive pairs run through run_pipeline_distributed; the previous
    pair's flow warm-starts the next solve DEVICE-RESIDENT (the global
    sharded array is handed straight back in -- no host gather, no
    network round trip; the reference's first-guess mechanism, main.cc:274-278,
    without the netCDF detour).  With ``checkpoint`` set, every process
    writes its row block of the warm-start flow after each pair and a
    rerun resumes from the first unprocessed pair.  Products are named
    exactly like the single-process sequence (outfile{suffix}_{i:03d}.nc;
    interpolated frames under pair_{i:03d}/ subdirectories).
    """
    import os
    from octane_tpu.sequence import _cfg_key

    if len(files) < 2:
        raise ValueError("a sequence needs at least two frames")
    if h5py is None:
        raise RuntimeError("h5py is required for file ingest")
    with h5py.File(files[0], "r") as f:
        var = "Rad" if "Rad" in f else "data"
        h, w = f[var].shape
    r0, r1 = host_row_block(h)
    mesh = distributed_mesh(cfg)
    key = _cfg_key(cfg)

    start = 0
    fg = None
    if checkpoint:
        state = _load_seq_checkpoint(checkpoint, key, files, r0, r1)
        if state is not None:
            idx, u_blk, v_blk = state
            start = idx + 1
            if warm_start:
                fg = (global_array_from_blocks(u_blk, (h, w), mesh),
                      global_array_from_blocks(v_blk, (h, w), mesh))

    written = []
    for i in range(start, len(files) - 1):
        out, (us, vs) = run_pipeline_distributed(
            files[i], files[i + 1], cfg, outdir=outdir,
            interp_dir=os.path.join(interp_dir, f"pair_{i:03d}"),
            first_guess_flow=fg, out_index=i, return_flow=True)
        written += out
        fg = (us, vs) if warm_start else None
        if checkpoint:
            _save_seq_checkpoint(
                checkpoint, i, local_rows2d(us, r0, r1, np.float32),
                local_rows2d(vs, r0, r1, np.float32), r0, r1, key,
                files[:i + 2])
    return written
