"""The port's bfloat16 mode outside the substep, against the JAX package.

  scenes        every builder with dtype=torch.bfloat16 gives the bits of
                JAX's dtype=jnp.bfloat16 (float64 rounded through float32 to
                bf16), the same mass floor and config dtype;
  fast paths    bf16 particles are cast to float32 as JAX's
                `fast2d.from_particles` / `fast3d.from_particles` do: the
                spec equals JAX's, and a run is bitwise the run from the
                float32 cast, on one device and on SlabMesh shards;
  convert       a JAX bf16 array becomes a torch bf16 tensor with its bits;
  driver        `Simulation` on bf16 particles writes frames (positions
                widened to float32, exactly) on the general and fast paths;
                the general path's positions bitwise JAX's `Simulation`'s;
  checkpoints   bf16 fields as 2-byte records with the manifest dtype
                "bfloat16", JAX's layout: a JAX-written npz read bit for bit,
                the port's npz and shard-directory round trips bitwise, a
                bf16 run resumed bitwise.  JAX's own `checkpoint.load` cannot
                read such a file (TypeError on the |V2 records): a fault of
                the reference, held here as measured.
"""

import dataclasses
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu import driver as driver_jax
from mpm_flip98a_tpu.config import MPMConfig as MPMConfigJax
from mpm_flip98a_tpu.config import TransferKind as TransferKindJax
from mpm_flip98a_tpu.models import fast2d as fast2d_jax
from mpm_flip98a_tpu.models import fast3d as fast3d_jax
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu.state import Particles as ParticlesJax
from mpm_flip98a_tpu.utils import checkpoint as ckpt_jax
from mpm_flip98a_tpu_torch import convert, driver
from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind
from mpm_flip98a_tpu_torch.models import fast2d, fast3d, scenes
from mpm_flip98a_tpu_torch.state import Particles
from mpm_flip98a_tpu_torch.utils import checkpoint as ckpt
from mpm_flip98a_tpu_torch.utils import io_vtk

FAST = dict(num_grids=37, dt=2e-5, num_particles_x=16, num_particles_y=32)   # test_dtypes.py:14
FLIP = dict(flip_blend=0.98)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same(a, b) -> list:
    """Fields of two particle / bucket states whose bits differ."""
    return [f.name for f in dataclasses.fields(a)
            if not np.array_equal(_bits(getattr(a, f.name)), _bits(getattr(b, f.name)))]


def _cast32(p: Particles) -> Particles:
    return dataclasses.replace(p, **{f.name: getattr(p, f.name).float()
                                     for f in dataclasses.fields(p)
                                     if getattr(p, f.name).dtype == torch.bfloat16})


# ---------------------------------------------------------------------------
# Scenes
# ---------------------------------------------------------------------------

BUILDERS = {
    "dam_break_2d": lambda m, dt: m.dam_break_2d(_cfg(m), dtype=dt),
    "elastic_drop_2d": lambda m, dt: m.elastic_drop_2d(_cfg(m), dtype=dt),
    "snow_block_2d": lambda m, dt: m.snow_block_2d(_cfg(m), dtype=dt, particles_per_axis=12),
    "sand_column_2d": lambda m, dt: m.sand_column_2d(_cfg(m), dtype=dt,
                                                     particles_per_axis=(6, 14)),
    "dam_break_obstacle_2d": lambda m, dt: m.dam_break_obstacle_2d(_cfg(m), dtype=dt),
    "plow_2d": lambda m, dt: m.plow_2d(_cfg(m), dtype=dt),
    "slab_3d": lambda m, dt: m.slab_3d(16, (8, 8, 4), dtype=dt),
    "dam_break_3d": lambda m, dt: m.dam_break_3d(16, (8, 8, 8), dtype=dt),
    "elastic_drop_3d": lambda m, dt: m.elastic_drop_3d(dtype=dt),
    "dam_break_obstacle_3d": lambda m, dt: m.dam_break_obstacle_3d(16, (8, 8, 8), dtype=dt),
}


def _cfg(module):
    return (MPMConfigJax if module is scenes_jax else MPMConfig)(**FAST, dtype="bfloat16")


@pytest.mark.parametrize("name", list(BUILDERS))
def test_bf16_scene_builder_bitwise_jax(name):
    """The builder with dtype=torch.bfloat16 against JAX's with
    dtype=jnp.bfloat16: every particle field bit for bit, the mass floor,
    the config's dtype name, and the colliders."""
    pj, sj = BUILDERS[name](scenes_jax, jnp.bfloat16)
    pt, st = BUILDERS[name](scenes, torch.bfloat16)
    assert pt.x.dtype == torch.bfloat16
    assert not [f for f in pj.__dataclass_fields__
                if not np.array_equal(_bits(getattr(pj, f)), _bits(getattr(pt, f)))]
    assert st.mass_floor == sj.mass_floor
    assert st == convert.scene_from_fields(dataclasses.asdict(sj))
    assert st.cfg.dtype == "bfloat16" and st.cfg.torch_dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Fast paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["fast2d", "fast3d", "fast2d_slab2", "fast3d_slab2"])
def test_bf16_fast_path_is_the_float32_cast_run(case, tmp_path):
    """Bucketed fast-path state from bf16 particles bitwise that from their
    float32 cast after 10 substeps (one device; SlabMesh shards through
    `Simulation(devices=2)`), and the spec equal to JAX's for the bf16
    particles."""
    if case.startswith("fast2d"):
        p16, scene = scenes.dam_break_2d(MPMConfig(**FAST, **FLIP, transfer=TransferKind.PIC),
                                         dtype=torch.bfloat16)
        pj, _ = scenes_jax.dam_break_2d(
            MPMConfigJax(**FAST, **FLIP, transfer=TransferKindJax.PIC), dtype=jnp.bfloat16)
        mod, mod_jax, spec_cls = fast2d, fast2d_jax, fast2d.FastSpec
    else:
        p16, scene = scenes.dam_break_3d(16, (8, 8, 8), dtype=torch.bfloat16)
        pj, _ = scenes_jax.dam_break_3d(16, (8, 8, 8), dtype=jnp.bfloat16)
        mod, mod_jax, spec_cls = fast3d, fast3d_jax, fast3d.FastSpec3D
    scene32 = dataclasses.replace(scene, cfg=dataclasses.replace(scene.cfg, dtype="float32"))
    p32 = _cast32(p16)
    if case.endswith("slab2"):
        sims = [driver.Simulation(p, s, path="fast", device="cpu", devices=2,
                                  out_dir=str(tmp_path / str(i)))
                for i, (p, s) in enumerate(((p16, scene), (p32, scene32)))]
        for sim in sims:
            sim.step_frame(10)
        assert not _same(sims[0].global_state(), sims[1].global_state())
        return
    spec = spec_cls.for_particles(scene.cfg, p16)
    jspec = getattr(mod_jax, spec_cls.__name__).for_particles(
        convert_cfg(scene.cfg), pj)
    assert spec.capacity == jspec.capacity and spec == spec_cls.for_particles(scene.cfg, p32)
    runs = [mod.run(mod.from_particles(p, scene.cfg, spec, "cpu"), s, spec, 10)
            for p, s in ((p16, scene), (p32, scene32))]
    assert not _same(*runs)


def convert_cfg(cfg):
    """The port's MPMConfig as the JAX package's (same fields)."""
    return MPMConfigJax(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------

def test_bf16_convert_from_jax_arrays():
    """JAX bf16 arrays (numpy dtype "bfloat16") as torch bf16 tensors with
    the same bits: every field of a JAX bf16 scene, and the patterns of
    +-0, +-inf, NaN, subnormals and the extremes, at several shapes."""
    pj, _ = scenes_jax.elastic_drop_2d(MPMConfigJax(**FAST), dtype=jnp.bfloat16)
    pt = convert.particles_from_numpy({f: np.asarray(getattr(pj, f))
                                       for f in pj.__dataclass_fields__}, "cpu")
    assert not [f for f in pj.__dataclass_fields__
                if not np.array_equal(_bits(getattr(pj, f)), _bits(getattr(pt, f)))]
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 3.3e38, 1.0],
                        np.float32)
    for shape in ((9,), (3, 3), (1, 9, 1)):
        a = np.asarray(jnp.asarray(specials.reshape(shape)).astype(jnp.bfloat16))
        t = convert.bf16_tensor(a)
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == shape
        assert np.array_equal(_bits(t), _bits(a))
    assert convert.is_bf16(a) and not convert.is_bf16(specials)


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["general", "fast"])
def test_bf16_simulation_writes_frames(path, tmp_path):
    """Simulation on bf16 particles (the CPU): one frame of 5 substeps with
    its PNG and VTK; the VTK points are the state's positions widened to
    float32; on the general path the state stays bf16 and its positions
    equal JAX's Simulation's bit for bit."""
    cfg = MPMConfig(**FAST, **FLIP, transfer=TransferKind.PIC)
    p16, scene = scenes.dam_break_2d(cfg, dtype=torch.bfloat16)
    sim = driver.Simulation(p16, scene, path=path, device="cpu", out_dir=str(tmp_path))
    sim.run(1, 5, gif=False, verbose=False)
    x = sim.positions()
    assert x.dtype == np.float32 and np.isfinite(x).all()
    pts = io_vtk.read_vtk_points(os.path.join(sim.vtk_dir, "00001.vtk"))
    assert np.array_equal(pts[:, :2].astype(np.float32), x)
    assert os.path.exists(os.path.join(sim.frame_dir, "00001.png"))
    if path == "general":
        assert sim.state.x.dtype == torch.bfloat16
        assert np.array_equal(x, sim.state.x.float().numpy())
        pj, sj = scenes_jax.dam_break_2d(
            MPMConfigJax(**FAST, **FLIP, transfer=TransferKindJax.PIC), dtype=jnp.bfloat16)
        sim_jax = driver_jax.Simulation(pj, sj, path="general", out_dir=str(tmp_path / "jax"))
        sim_jax.step_frame(5)
        assert np.array_equal(_bits(sim_jax.state.x), _bits(sim.state.x))


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["jax_npz", "port_npz", "port_shard_dir", "resume"])
def test_bf16_checkpoint(case, tmp_path):
    """bf16 checkpoints in the JAX package's layout, bit for bit."""
    p16, scene = scenes.dam_break_2d(MPMConfig(**FAST), dtype=torch.bfloat16)
    if case == "jax_npz":
        pj, _ = scenes_jax.dam_break_2d(MPMConfigJax(**FAST), dtype=jnp.bfloat16)
        path = str(tmp_path / "jax.npz")
        ckpt_jax.save(path, pj)
        assert not _same(ckpt.load(path, Particles), p16)
        with np.load(path) as z:
            assert z["x"].dtype == np.dtype("V2")
        # The reference cannot read its own bf16 checkpoint (a fault of the
        # JAX package, not copied: the port reads it above).
        with pytest.raises(TypeError):
            ckpt_jax.load(path, ParticlesJax)
    elif case == "port_npz":
        path = str(tmp_path / "port.npz")
        ckpt.save(path, p16, meta={"k": 1})
        assert not _same(ckpt.load(path, Particles), p16)
        pj, _ = scenes_jax.dam_break_2d(MPMConfigJax(**FAST), dtype=jnp.bfloat16)
        ckpt_jax.save(str(tmp_path / "jax.npz"), pj, meta={"k": 1})
        with np.load(path) as a, np.load(str(tmp_path / "jax.npz")) as b:
            assert sorted(a.files) == sorted(b.files)
            assert str(a["__manifest__"]) == str(b["__manifest__"])
            assert all(a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
                       for k in a.files if k != "__manifest__")
    elif case == "port_shard_dir":
        path = str(tmp_path / "shards")
        ckpt.save_sharded(path, p16)
        assert not _same(ckpt.load_sharded(path, p16), p16)
    else:
        uninterrupted = driver.Simulation(p16, scene, device="cpu", out_dir=str(tmp_path / "a"))
        uninterrupted.step_frame(4)
        uninterrupted.step_frame(4)
        first = driver.Simulation(p16, scene, device="cpu", out_dir=str(tmp_path / "b"))
        first.step_frame(4)
        first.save_checkpoint(str(tmp_path / "ck.npz"))
        second = driver.Simulation(p16, scene, device="cpu", out_dir=str(tmp_path / "c"))
        second.restore_checkpoint(str(tmp_path / "ck.npz"))
        second.step_frame(4)
        assert second.state.x.dtype == torch.bfloat16
        assert not _same(second.state, uninterrupted.state)
