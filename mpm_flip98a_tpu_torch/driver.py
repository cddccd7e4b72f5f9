"""Simulation driver of the port (counterpart of `mpm_flip98a_tpu/driver.py`).

Reference: exec.py — the outer frame loop with 10,000 substeps per frame
(exec.py:20-26), `progressBar` (:28), `post_process` writing frames + VTK
(:29) and the end-of-run `Run Time` print (:31-32).

The port runs on one device (`--device`, default `cuda`) by either path,
as the JAX driver does.  `--path general` (the default) is the stabilized
solver `models/stabilized.run` on a `Particles` state in the scene's
dtype (float64 for `dam2d`, the reference workload), 2D or 3D.
`--path fast` is routed by the scene's dimension: `models/fast2d` for
`dam2d`, `dam2d_flip98`, `elastic_drop`, `snow2d` (a snow block dropped
on the floor), `sand2d` (a Drucker-Prager sand column collapsing),
`dam2d_obstacle` (a rigid cylinder in the run-out), `plow2d` (a
cylinder sweeping through the pool) and `dam2d_incompressible` (the FLIP
dam break with the incompressible projection, models/projection.py),
`models/fast3d` for `dam3d` and `dam3d_obstacle` (a rigid sphere).
Kinematic colliders see the simulation time: `step_frame` passes
`total_time` as the run's t0 when one of them moves (driver.py:233-250).
`--devices N` runs the fast path's slab-sharded form (driver.py:138-177):
N slab shards of the grid's axis 0 on that one device
(`parallel.SlabMesh`), `parallel/fast_domain` in 2D and
`parallel/fast_domain3d` in 3D, where `N0xN1` is the two-axis mesh (N0
slabs x N1 pencil columns; 3D only, ValueError in 2D as in JAX); the
general path takes one device only and raises ValueError otherwise, as in
JAX.  `--ranks` runs the same shards one per process instead, as JAX runs
one per chip (`parallel.RankMesh`, started by `parallel/launch.run_ranks`
with `--backend`, nccl by default, which needs a card per rank; several
ranks on one card take `--backend gloo`, asked for by name).  Rank r
holds shard r only; rank 0 alone prints and writes frames, from the
gathered state, and every rank writes its own shard file of a checkpoint
directory.

Checkpoints (driver.py:402-484): `--checkpoint PATH` writes the state at
the end, `--checkpoint-every N` writes `<frame dir>/restart.npz` every N
frames and `--resume PATH` restores one before the run, frame numbering
and simulation time continuing (`utils/checkpoint.py`).  A path ending in
`.npz` is one npz file, which either package reads; any other path is a
directory of one npz per shard (JAX writes Orbax there, which the port
cannot read).

CLI:  python -m mpm_flip98a_tpu_torch --scenario dam2d --frames 1 --no-gif
      python -m mpm_flip98a_tpu_torch --scenario dam2d_flip98 --path fast \
          --frames 2 --substeps 100 --no-gif
      python -m mpm_flip98a_tpu_torch --scenario elastic_drop --path fast \
          --frames 2 --substeps 200 --no-gif
      python -m mpm_flip98a_tpu_torch --scenario dam3d --path fast \
          --frames 2 --substeps 100 --no-gif
      python -m mpm_flip98a_tpu_torch --scenario sand2d --path fast \
          --frames 2 --substeps 200 --no-gif
      python -m mpm_flip98a_tpu_torch --scenario plow2d --path fast \
          --frames 2 --substeps 200 --no-gif
      python -m mpm_flip98a_tpu_torch --scenario dam3d_obstacle --path fast \
          --frames 2 --substeps 100 --no-gif
      python -m mpm_flip98a_tpu_torch --scenario dam2d_flip98 --path fast \
          --devices 4 --frames 2 --substeps 100 --no-gif
      python -m mpm_flip98a_tpu_torch --scenario dam2d_incompressible \
          --path fast --frames 2 --substeps 200 --no-gif
      python -m mpm_flip98a_tpu_torch --scenario dam3d --path fast \
          --devices 2x2 --frames 2 --substeps 100 --no-gif --checkpoint ck
      python -m mpm_flip98a_tpu_torch --scenario dam3d --path fast \
          --devices 2x2 --frames 1 --substeps 100 --no-gif --resume ck
      python -m mpm_flip98a_tpu_torch --scenario dam2d_flip98 --path fast \
          --devices 4 --ranks --backend gloo --frames 2 --substeps 100 --no-gif
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind
from mpm_flip98a_tpu_torch.models import colliders, fast2d, fast3d, scenes, stabilized
from mpm_flip98a_tpu_torch.parallel import SlabMesh, fast_domain, fast_domain3d, launch
from mpm_flip98a_tpu_torch.state import host_array, to_device
from mpm_flip98a_tpu_torch.utils import checkpoint as ckpt
from mpm_flip98a_tpu_torch.utils import io_vtk, native_io, render
from mpm_flip98a_tpu_torch.utils.progress import create_file_paths, progress_bar
from mpm_flip98a_tpu_torch.utils.timing import Timers, ThroughputMeter


def reference_scene(dtype=np.float64):
    """The exact reference workload (config.py:24-46): 8,450 particles,
    105^2 grid, dt = 1e-6, 10,000 substeps per 1e-2 s frame, 3 s total."""
    return scenes.dam_break_2d(dtype=dtype)


SCENARIOS = {
    "dam2d": lambda: reference_scene(),
    # FLIP blending pairs with the PIC (non-affine) scatter.
    "dam2d_flip98": lambda: scenes.dam_break_2d(
        dataclasses.replace(
            MPMConfig(), flip_blend=0.98, transfer=TransferKind.PIC
        )
    ),
    "elastic_drop": lambda: scenes.elastic_drop_2d(),
    "dam3d": lambda: scenes.dam_break_3d(),
    # The incompressible dam break: the Chorin projection, not the stiff
    # EOS, carries incompressibility (models/projection.py).
    "dam2d_incompressible": lambda: scenes.dam_break_2d(
        dataclasses.replace(
            MPMConfig(), flip_blend=0.98, transfer=TransferKind.PIC,
            incompressible=True,
        )
    ),
    # Snow (materials.SNOW): the corotated stress hardened by the tracked
    # plastic volume Jp (mls-mpm88-explained.cpp:17-19,67-69,164-177).
    "snow2d": lambda: scenes.snow_block_2d(),
    # Drucker-Prager sand (materials.SAND): a column collapsing into an
    # angle-of-repose pile (Klar et al. 2016).
    "sand2d": lambda: scenes.sand_column_2d(),
    # Rigid SDF collider: dam break splitting around a cylinder in the
    # run-out path.
    "dam2d_obstacle": lambda: scenes.dam_break_obstacle_2d(),
    # Kinematic collider: a cylinder sweeping through the pool at constant
    # velocity (center_velocity BC).
    "plow2d": lambda: scenes.plow_2d(),
    # 3D variant of the rigid-obstacle dam break.
    "dam3d_obstacle": lambda: scenes.dam_break_obstacle_3d(),
}

# Scenarios of the JAX package that this port does not run yet, with the
# ROADMAP queue 1 item that ports them: none left.
UNPORTED_SCENARIOS = {}


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1, item {item})")


def flip_sweep_scenes(alphas=(0.0, 0.5, 0.95, 0.98, 1.0)):
    """BASELINE.json configs[1]: the PIC/FLIP/APIC blend sweep on the dam
    break (driver.py:85-99).  alpha = 0 keeps the APIC affine transfer;
    alpha > 0 pairs FLIP with the PIC scatter."""
    return {
        f"alpha={a}": scenes.dam_break_2d(
            dataclasses.replace(
                MPMConfig(), flip_blend=a,
                transfer=TransferKind.APIC if a == 0.0 else TransferKind.PIC,
            )
        )
        for a in alphas
    }


def parse_devices(s: str):
    """`--devices`: "N" -> N slab shards, "N0xN1" -> (N0, N1), the two-axis
    3D mesh (driver.py:499-505)."""
    if "x" in s:
        n0, n1 = s.split("x")
        return (int(n0), int(n1))
    return int(s)


class Simulation:
    """Frame-loop driver around a (particles, scene) pair on one device.

    `path` "general" steps the `Particles` with `stabilized.run`; "fast"
    buckets them for `fast2d` / `fast3d`.  On the fast path `devices`
    N > 1 runs N slab shards on that device; (N0, N1) is the two-axis 3D
    mesh (N0 N1 shards).  Given `mesh`, a `parallel.RankMesh` of that
    shape, the Simulation is this rank's shard of the run: every rank
    builds one and steps it, and the frame and checkpoint calls are
    collective (rank 0 alone writes the frames)."""

    def __init__(
        self,
        particles,
        scene,
        path: str = "general",
        out_dir: str = "out",
        tag: Optional[str] = None,
        render_res: int = 512,
        io_async: bool = False,
        device="cuda",
        devices=1,
        mesh=None,
    ):
        if path not in ("general", "fast"):
            raise ValueError(f"path must be 'general' or 'fast', got {path!r}")
        if path == "general" and devices != 1:
            raise ValueError("--devices > 1 requires --path fast")
        # (n0, n1): the two-axis 3D mesh, slabs x pencil columns.
        self.device_grid = None
        if isinstance(devices, tuple):
            if scene.cfg.dim != 3:
                raise ValueError("--devices N0xN1 (two-axis mesh) is 3D-only; "
                                 "2D shards over a 1D slab mesh")
            self.device_grid = fast_domain3d.as_shards(devices)
            devices = self.device_grid[0] * self.device_grid[1]
        self.devices = devices
        if mesh is not None and (path != "fast" or (mesh.n0, mesh.n1) != (
                self.device_grid or (devices, 1))):
            raise ValueError(f"a {mesh.n0}x{mesh.n1} rank mesh runs --path fast with "
                             f"--devices {mesh.n0 if mesh.n1 == 1 else f'{mesh.n0}x{mesh.n1}'}")
        # Dimension routing: pencil buckets in 3D, row buckets in 2D.
        self._fast = fast3d if scene.cfg.dim == 3 else fast2d
        if path == "fast" and scene.cfg.dim == 3:
            fast3d.check_supported(scene, sharded=devices > 1)
        elif path == "fast":
            fast2d.check_supported(scene)
        self.scene = scene
        self.cfg = scene.cfg
        self.path = path
        self.device = torch.device(device if mesh is None else mesh.device)
        self.timers = Timers()
        mix = "mixed" if self.cfg.pressure_mixing_ratio > 0 else "pointwise"
        self.tag = tag or f"dt{self.cfg.dt:g}_{mix}"
        self.frame_dir, self.vtk_dir = create_file_paths(self.tag, out_dir)
        self.render_res = render_res
        self.frames = []
        self.frames_written = 0
        self.io_async = io_async
        self._io_pool = None
        self._io_futures = []
        self._host_cache = None
        self.total_time = 0.0
        self.frame_count = 0
        self._last_respec_frame = 0
        if path == "general":
            # The particles as they are (dtype kept) on the device
            # (driver.py:178-179).
            self.spec = None
            self.state = to_device(particles, self.device)
        elif devices > 1:
            # The slab-sharded path (driver.py:138-177) on `devices` shards.
            dom = fast_domain3d if self.cfg.dim == 3 else fast_domain
            n0, n1 = self.device_grid or (devices, 1)
            self.mesh = SlabMesh(n0, self.device, n1) if mesh is None else mesh
            if self.cfg.dim == 3:
                self.spec = dom.FastDomain3DSpec.for_particles(self.cfg, (n0, n1), particles)
            else:
                self.spec = dom.FastDomainSpec.for_particles(self.cfg, devices, particles)
            self.state = dom.distribute(particles, self.cfg, self.spec, self.mesh)
            self._sharded_run = dom.make_run(scene, self.spec, self.mesh)
        else:
            spec_cls = fast3d.FastSpec3D if self.cfg.dim == 3 else fast2d.FastSpec
            self.spec = spec_cls.for_particles(self.cfg, particles)
            self.state = self._fast.from_particles(particles, self.cfg, self.spec, self.device)
        self.stats = fast2d.RunStats()
        self.meter = ThroughputMeter(particles.n, self.cfg.stencil_size)

    # -- state access ----------------------------------------------------

    @property
    def ranked(self) -> bool:
        """One shard per process (a RankMesh): frames and checkpoints are
        collective."""
        return self.devices > 1 and self.path == "fast" and self.mesh.distributed

    @property
    def lead(self) -> bool:
        """This process prints and writes frames: rank 0 on ranks, else
        the one process."""
        return not self.ranked or self.mesh.rank == 0

    def global_state(self):
        """The fast path's whole bucket state: on ranks every rank's block
        gathered (collective), shard-major as SlabMesh holds it."""
        return fast_domain.collect(self.state, self.mesh) if self.ranked else self.state

    def _host_state(self) -> dict:
        """Per-frame cached host pull of the bucket state (positions() and
        material_colors() both need it every frame); collective on ranks."""
        if self._host_cache is None or self._host_cache[0] != self.frame_count:
            self._host_cache = (self.frame_count, self._fast.to_host(self.global_state()))
        return self._host_cache[1]

    def positions(self) -> np.ndarray:
        if self.path == "general":
            return host_array(self.state.x)
        h = self._host_state()
        return np.stack([h[f"x{a}"] for a in range(self.cfg.dim)], axis=-1)

    def material_colors(self) -> np.ndarray:
        """Per-particle RGB by material id (fluid blue, solids in the
        reference's impact-block palette, mls-mpm88-explained.cpp:194,199)."""
        if self.path == "general":
            mats = self.state.material.cpu().numpy().astype(np.int64)
        else:
            mats = self._host_state()["mat"].astype(np.int64)
        palette = np.array(
            [
                render._hex_rgb(c)
                for c in (0x2986CC, 0xED553B, 0xF2B134, 0xEDEDF4, 0xC2A878)
            ],
            np.uint8,
        )
        return palette[np.clip(mats, 0, len(palette) - 1)]

    # -- stepping --------------------------------------------------------

    def step_frame(self, n_substeps: Optional[int] = None) -> None:
        n = n_substeps or self.cfg.substeps_per_frame
        t0 = time.perf_counter()
        # Kinematic colliders see simulation time: total_time is the
        # substep-count clock (driver.py:233-250).
        sim_t0 = self.total_time if colliders.any_moving(self.scene.colliders) else None
        with self.timers.scope("substeps", sync=self.device):
            if self.path == "general":
                self.state = stabilized.run(self.state, self.scene, n, t0=sim_t0)
                self.stats.substeps += n
            elif self.devices > 1:
                self.state = self._sharded_run(self.state, n, self.stats, t0=sim_t0)
            else:
                self.state = self._fast.run(self.state, self.scene, self.spec, n, self.stats,
                                            t0=sim_t0)
        self.meter.update(n, time.perf_counter() - t0)
        self.total_time += n * self.cfg.dt
        self.frame_count += 1

    def post_process(self, write_vtk: bool = True, keep_frame: bool = True) -> None:
        """Render + export the current frame (exec.py:29 equivalent).

        Frame dumps without GIF assembly (keep_frame=False) go through the
        native rasterizer/PNG/binary-VTK library (utils/native_io.py) and,
        when `io_async`, run on a writer thread so frame IO overlaps the
        next frame's substeps.  The host pull stays on the main thread."""
        with self.timers.scope("post_process"):
            x = self.positions()
            colors = self.material_colors()
            if not self.lead:
                return
            self.frames_written += 1
            # Keep the gravity axis (the last) vertical: (x0, x1) in 2D,
            # the (x0, x2) side view in 3D.
            x2 = x[:, [0, x.shape[1] - 1]]
            png_path = f"{self.frame_dir}/{self.frame_count:05d}.png"
            vtk_path = f"{self.vtk_dir}/{self.frame_count:05d}.vtk"
            res, extent = self.render_res, self.cfg.domain_length

            def write_frame():
                if keep_frame or not native_io.frame_png(
                    png_path, x2, colors, res, extent
                ):
                    img = render.rasterize(
                        x2, res=res, extent=extent, colors=colors
                    )
                    render.write_png(img, png_path)
                    return img
                return None

            def write_all():
                img = write_frame()
                if write_vtk and not native_io.vtk_particles(vtk_path, x):
                    io_vtk.write_vtk_particles(vtk_path, x)
                return img

            if self.io_async and not keep_frame:
                self._submit_io(write_all)
            else:
                img = write_all()
                if keep_frame:
                    self.frames.append(img)

    def _maybe_respec(self) -> None:
        """Adaptive bucket-capacity re-spec between frames (driver.py:301-375).

        Per-row kernel work follows the bucket capacity, so as the dam
        collapse spreads the fluid over more, sparser rows, re-bucketing
        into a capacity sized from the current occupancy shrinks state and
        rebucket cost.  Capacity grows at once when the occupancy-sized
        capacity (headroom 1.15) exceeds the current one, so the in-run
        rebucket never overflows; it shrinks for a >= 37.5% reduction at
        most every 4 frames.  Sharded runs and the general path keep their
        layout (driver.py:326-330)."""
        if self.path != "fast" or self.devices > 1:
            return
        h = self._host_state()
        g = self.cfg.num_grids
        rows = [
            np.clip(np.floor(h[f"x{a}"] * self.cfg.inv_dx + fast2d.PAD - 0.5), 0, g - 1)
            .astype(np.int64)
            for a in range(self.cfg.dim - 1)   # the bucketed axes
        ]
        key = rows[0] * g + rows[1] if self.cfg.dim == 3 else rows[0]
        mx = int(np.bincount(key, minlength=g ** (self.cfg.dim - 1)).max())
        want = self._fast.capacity_for(mx)
        cap = self.spec.capacity
        grow = self._fast.capacity_for(mx, 1.15) > cap
        shrink = (
            want <= int(cap * 0.625)
            and self.frame_count - self._last_respec_frame >= 4
        )
        if not (shrink or grow) or want == cap:
            return
        new_spec = dataclasses.replace(self.spec, capacity=want)
        self.state = self._fast.rebucket(self.state, self.cfg, new_spec)
        self.spec = new_spec
        self._last_respec_frame = self.frame_count
        self._host_cache = None  # layout changed (values are identical)

    # -- checkpoints -----------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        """The state and the run clock (driver.py:402-416): a path ending in
        `.npz` is one npz (`checkpoint.save`), anything else a directory of
        one npz per shard (`checkpoint.save_sharded`).  On ranks both are
        collective: rank 0 writes the npz of the gathered state, and every
        rank its own shard file of the directory (`save_rank_shard`)."""
        meta = {"total_time": self.total_time, "frame_count": self.frame_count,
                "path": self.path}
        if self.ranked and not path.endswith(".npz"):
            ckpt.save_rank_shard(path, self.state, self.mesh, meta=meta)
        elif path.endswith(".npz"):
            state = self.global_state()
            if self.lead:
                ckpt.save(path, state, meta=meta)
        else:
            ckpt.save_sharded(path, self.state, meta=meta)

    def restore_checkpoint(self, path: str) -> None:
        """Restore a checkpoint of this scenario's layout (driver.py:
        418-455).  A shard directory restores onto the running state's
        layout and device; an npz loads onto the device, dtypes kept (a
        sharded npz is the mesh's whole shard-major state, so it needs no
        re-placement; on ranks each keeps its own block).  A single-device
        fast path takes the restored slot capacity, so a checkpoint written
        after `_maybe_respec` resumes."""
        if not path.endswith(".npz") and os.path.isdir(path):
            if self.ranked:
                self.state = ckpt.load_rank_shard(path, self.state, self.mesh)
            else:
                self.state = ckpt.load_sharded(path, self.state)
            meta = ckpt.load_sharded_meta(path)
        else:
            state = ckpt.load(path, type(self.state), "cpu" if self.ranked else self.device)
            if self.ranked:
                state = fast_domain.own_block(state, self.mesh.rank, self.mesh.n, self.device)
                state = dataclasses.replace(state, overflow=state.overflow[
                    self.mesh.rank:self.mesh.rank + 1].to(self.device))
            if self.devices > 1:
                for f in dataclasses.fields(state):
                    got, want = getattr(state, f.name), getattr(self.state, f.name)
                    if got.shape != want.shape:
                        raise ValueError(f"checkpoint field {f.name} has shape "
                                         f"{tuple(got.shape)}, the mesh's state "
                                         f"{tuple(want.shape)}: another layout")
            self.state = state
            meta = ckpt.load_meta(path)
        self.total_time = meta["total_time"]
        self.frame_count = meta["frame_count"]
        if self.path == "fast" and self.devices == 1:
            k = self.state.x0.shape[-1]
            if k != self.spec.capacity:
                self.spec = dataclasses.replace(self.spec, capacity=k)
        self._host_cache = None   # a restored state invalidates the frame cache

    def _submit_io(self, fn) -> None:
        import concurrent.futures as cf

        if self._io_pool is None:
            self._io_pool = cf.ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="mpm-io"
            )
        # Bound the backlog and surface writer exceptions promptly.
        pending = [f for f in self._io_futures if not f.done()]
        if len(pending) >= 4:
            cf.wait(pending, return_when=cf.FIRST_COMPLETED)
        done = [f for f in self._io_futures if f.done()]
        for f in done:
            f.result()  # re-raise writer errors on the main thread
            self._io_futures.remove(f)
        self._io_futures.append(self._io_pool.submit(fn))

    def drain_io(self) -> None:
        """Block until every queued frame write has finished (and re-raise
        any writer exception), then stop the writer threads."""
        for f in self._io_futures:
            f.result()
        self._io_futures.clear()
        if self._io_pool is not None:
            self._io_pool.shutdown()
            self._io_pool = None

    def run(
        self,
        n_frames: Optional[int] = None,
        substeps_per_frame: Optional[int] = None,
        gif: bool = True,
        verbose: bool = True,
        write_frames: bool = True,
        checkpoint_every: Optional[int] = None,
    ) -> None:
        """The reference outer loop (exec.py:20-29) + Run Time print (:31).
        `write_frames=False` skips the per-frame PNG/VTK output;
        `checkpoint_every` frames writes a rolling restart point,
        `<frame dir>/restart.npz` (driver.py:482-484)."""
        n_frames = n_frames or self.cfg.num_frames
        t_begin = time.time()
        sim_total = n_frames * (substeps_per_frame or self.cfg.substeps_per_frame) * self.cfg.dt
        verbose = verbose and self.lead
        for _ in range(n_frames):
            self.step_frame(substeps_per_frame)
            if verbose:
                progress_bar(
                    self.total_time,
                    sim_total,
                    extra=f"{self.meter.substeps_per_sec:.0f} sub/s",
                )
            if write_frames:
                self.post_process(keep_frame=gif)
            self._maybe_respec()
            if checkpoint_every and self.frame_count % checkpoint_every == 0:
                self.save_checkpoint(f"{self.frame_dir}/restart.npz")
        with self.timers.scope("post_process"):
            self.drain_io()  # async writes must land inside Run Time
        if gif and self.frames:
            render.write_gif(self.frames, f"{self.frame_dir}/output.gif")
        if verbose:
            print("Run Time:", time.time() - t_begin)  # exec.py:31-32
            print(
                f"substeps {self.stats.substeps}  rebuckets {self.stats.rebuckets}"
                f"  host reads {self.stats.host_reads}"
            )
            print(self.timers.summary())


def _run(sim: Simulation, args) -> Simulation:
    """--resume, the frames and --checkpoint of one Simulation (one per
    rank under --ranks)."""
    if args.resume:
        sim.restore_checkpoint(args.resume)
    sim.run(
        n_frames=args.frames,
        substeps_per_frame=args.substeps,
        gif=not args.no_gif,
        checkpoint_every=args.checkpoint_every,
    )
    if args.checkpoint:
        sim.save_checkpoint(args.checkpoint)
    return sim


def _rank_cli(mesh, args) -> dict:
    """One rank of `--ranks` (`launch.run_ranks`' worker): this rank's
    Simulation on `mesh`, run as the CLI asked; returns its counts."""
    p, scene = SCENARIOS[args.scenario]()
    sim = _run(Simulation(p, scene, path=args.path, out_dir=args.out,
                          io_async=not args.sync_io, devices=args.devices, mesh=mesh), args)
    return {"rank": mesh.rank, "frame_count": sim.frame_count, "total_time": sim.total_time,
            "substeps": sim.stats.substeps, "rebuckets": sim.stats.rebuckets,
            "overflow": int(sim.state.overflow.sum()), "frames_written": sim.frames_written,
            "frame_dir": sim.frame_dir}


def main(argv=None):
    """The CLI: the Simulation it ran, or under --ranks each rank's counts
    (`_rank_cli`), in rank order."""
    import argparse

    ap = argparse.ArgumentParser(description="MPM driver (PyTorch/CUDA port)")
    ap.add_argument(
        "--scenario", default="dam2d_flip98",
        choices=sorted({**SCENARIOS, **UNPORTED_SCENARIOS}),
    )
    ap.add_argument("--path", default="general", choices=["general", "fast"])
    ap.add_argument(
        "--devices", type=parse_devices, default=1,
        help="shard the fast path into N slabs on the one device (slab "
        "decomposition; requires --path fast), or N0xN1 for the two-axis 3D "
        "mesh (slabs x pencil columns)",
    )
    ap.add_argument(
        "--ranks", action="store_true",
        help="run the --devices shards one per process (torch.distributed), "
        "not all on one device",
    )
    ap.add_argument(
        "--backend", default="nccl", choices=["nccl", "gloo"],
        help="the ranks' torch.distributed backend: nccl needs a card per rank; "
        "gloo runs on the CPU and several ranks on one card",
    )
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--substeps", type=int, default=None)
    ap.add_argument("--out", default="out")
    ap.add_argument("--resume", default=None, help="checkpoint to restore (npz or shard "
                    "directory)")
    ap.add_argument("--checkpoint", default=None, help="write checkpoint at end (a path "
                    "ending in .npz: one file; else a directory of one npz per shard)")
    ap.add_argument(
        "--checkpoint-every", type=int, default=None, help="rolling restart every N frames"
    )
    ap.add_argument("--no-gif", action="store_true")
    ap.add_argument(
        "--sync-io", action="store_true",
        help="write frames on the main thread (default: async writer "
        "thread overlaps frame IO with the next frame's substeps)",
    )
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cuda:1")
    args = ap.parse_args(argv)

    if args.scenario in UNPORTED_SCENARIOS:
        raise _unported(f"scenario {args.scenario!r}", UNPORTED_SCENARIOS[args.scenario])
    if args.ranks:
        if args.path != "fast" or args.devices == 1:
            raise ValueError("--ranks runs the fast path's shards: pass --path fast and "
                             "--devices N (or N0xN1)")
        grid = args.devices if isinstance(args.devices, tuple) else None
        n = grid[0] * grid[1] if grid else args.devices
        return launch.run_ranks(_rank_cli, n, args=(args,), device=args.device,
                                backend=args.backend, grid=grid, timeout_s=600.0)
    p, scene = SCENARIOS[args.scenario]()
    sim = Simulation(
        p, scene, path=args.path, out_dir=args.out, io_async=not args.sync_io,
        device=args.device, devices=args.devices,
    )
    return _run(sim, args)
