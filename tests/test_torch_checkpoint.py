"""Checkpoints of the port (`utils/checkpoint.py`, `Simulation.save_checkpoint`
/ `restore_checkpoint`, `--checkpoint`, `--resume`, `--checkpoint-every`)
against the JAX package, and the driver's two small leftovers
(`flip_sweep_scenes`, `stabilized.make_substep`).

The npz format is the JAX package's, so an npz written by either package
loads in the other bit for bit.  Resumed runs equal uninterrupted ones
bit for bit on the CPU (its `index_add_` and the plain versions sum in a
fixed order).  A JAX general-path run at 37^2 is checkpointed by the JAX
driver, resumed by the port's and continued; the continuation is held to
JAX's at tests/test_torch_general2d.py's float64 bound (1e-9 of each
field's scale after 20 substeps).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from mpm_flip98a_tpu import driver as driver_jax
from mpm_flip98a_tpu.config import MPMConfig as MPMConfigJax
from mpm_flip98a_tpu.config import TransferKind as TransferKindJax
from mpm_flip98a_tpu.models import fast2d as fast2d_jax
from mpm_flip98a_tpu.models import fast3d as fast3d_jax
from mpm_flip98a_tpu.models import mls_mpm as mls_jax
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu.state import MLS88Particles as MLS88Jax
from mpm_flip98a_tpu.state import Particles as ParticlesJax
from mpm_flip98a_tpu.utils import checkpoint as ckpt_jax
from mpm_flip98a_tpu_torch import driver
from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind
from mpm_flip98a_tpu_torch.models import fast2d, fast3d, mls_mpm, scenes, stabilized
from mpm_flip98a_tpu_torch.state import MLS88Particles, Particles
from mpm_flip98a_tpu_torch.utils import checkpoint as ckpt

FAST = dict(num_grids=37, dt=2e-5, num_particles_x=16, num_particles_y=32)
FLIP = dict(flip_blend=0.98)
SMALL3D = dict(num_grids=16, particles_per_axis=(6, 6, 10), dt=2e-5, dtype=np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads only contend with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_state(kind):
    """A state of each checkpointed type, built by the port on the CPU."""
    if kind == "Particles":
        return scenes.dam_break_2d(MPMConfig(**FAST))[0]
    if kind == "MLS88Particles":
        return mls_mpm.init_dam_break(n=300, device="cpu")
    if kind == "FluidBuckets":
        cfg = MPMConfig(**FAST, **FLIP, transfer=TransferKind.PIC)
        p, _ = scenes.dam_break_2d(cfg, dtype=np.float32)
        return fast2d.from_particles(p, cfg, fast2d.FastSpec.for_particles(cfg, p), "cpu")
    p, scene = scenes.dam_break_3d(**SMALL3D)
    return fast3d.from_particles(p, scene.cfg, fast3d.FastSpec3D.for_particles(scene.cfg, p),
                                 "cpu")


# JAX's bucketing as one program each: called eagerly they compile each
# of their operations on its own, seconds a scene.
from_particles2d_jax = jax.jit(fast2d_jax.from_particles, static_argnames=("cfg", "spec"))
from_particles3d_jax = jax.jit(fast3d_jax.from_particles, static_argnames=("cfg", "spec"))


def _jax_state(kind):
    """The same state built by the JAX package."""
    if kind == "Particles":
        return scenes_jax.dam_break_2d(MPMConfigJax(**FAST))[0]
    if kind == "MLS88Particles":
        return mls_jax.init_dam_break(n=300)
    if kind == "FluidBuckets":
        cfg = MPMConfigJax(**FAST, **FLIP, transfer=TransferKindJax.PIC)
        p, _ = scenes_jax.dam_break_2d(cfg, dtype=np.float32)
        return from_particles2d_jax(p, cfg, fast2d_jax.FastSpec.for_particles(cfg, p))
    p, scene = scenes_jax.dam_break_3d(**SMALL3D)
    return from_particles3d_jax(p, scene.cfg, fast3d_jax.FastSpec3D.for_particles(scene.cfg, p))


KINDS = ["Particles", "MLS88Particles", "FluidBuckets", "FluidBuckets3D"]
TYPES = {"Particles": (Particles, ParticlesJax), "MLS88Particles": (MLS88Particles, MLS88Jax),
         "FluidBuckets": (fast2d.FluidBuckets, fast2d_jax.FluidBuckets),
         "FluidBuckets3D": (fast3d.FluidBuckets3D, fast3d_jax.FluidBuckets3D)}


def _assert_same(got, want):
    names = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == names
    for name in names:
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("kind", KINDS)
def test_round_trip_is_bitwise(kind, tmp_path):
    """save then load: every field, dtype and shape; the suffix is
    normalised and `meta` rides the manifest."""
    state = _port_state(kind)
    ckpt.save(str(tmp_path / "ck"), state, meta={"frame_count": 3})
    got = ckpt.load(str(tmp_path / "ck.npz"), type(state))
    _assert_same(got, state)
    assert ckpt.load_meta(str(tmp_path / "ck")) == {"frame_count": 3}


@pytest.mark.parametrize("kind", KINDS)
def test_jax_npz_loads_in_the_port(kind, tmp_path):
    want = _jax_state(kind)
    ckpt_jax.save(str(tmp_path / "jax.npz"), want, meta={"total_time": 0.5})
    got = ckpt.load(str(tmp_path / "jax.npz"), TYPES[kind][0])
    _assert_same(got, want)
    _assert_same(got, _port_state(kind))     # the two packages build the same state
    assert ckpt.load_meta(str(tmp_path / "jax.npz")) == {"total_time": 0.5}


@pytest.mark.parametrize("kind", KINDS)
def test_port_npz_loads_in_jax(kind, tmp_path):
    state = _port_state(kind)
    ckpt.save(str(tmp_path / "port.npz"), state, meta={"frame_count": 1})
    got = ckpt_jax.load(str(tmp_path / "port.npz"), TYPES[kind][1])
    _assert_same(got, state)
    assert ckpt_jax.load_meta(str(tmp_path / "port.npz")) == {"frame_count": 1}


def test_npz_load_fills_missing_jp(tmp_path):
    """A checkpoint written before `Jp` existed loads with Jp = 1
    (tests/test_checkpoint_compat.py:22-40)."""
    p = _port_state("Particles")
    path = str(tmp_path / "old_ck")
    ckpt.save(path, p, meta={"substeps": 7})
    with np.load(path + ".npz", allow_pickle=False) as z:
        manifest = json.loads(str(z["__manifest__"]))
        fields = {k: z[k] for k in manifest["fields"] if k != "Jp"}
    del manifest["fields"]["Jp"]
    np.savez_compressed(path + ".npz", __manifest__=json.dumps(manifest), **fields)
    got = ckpt.load(path, Particles)
    np.testing.assert_array_equal(got.Jp.numpy(), 1.0)
    assert got.Jp.dtype == p.J.dtype
    np.testing.assert_array_equal(got.x.numpy(), p.x.numpy())
    assert ckpt.load_meta(path)["substeps"] == 7
    assert ckpt_jax.load(path, ParticlesJax).Jp.shape == p.J.shape


def test_type_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path / "ck.npz"), _port_state("Particles"))
    with pytest.raises(ValueError, match="holds Particles, requested FluidBuckets"):
        ckpt.load(str(tmp_path / "ck.npz"), fast2d.FluidBuckets)


def test_sharded_directory_round_trip_and_refusals(tmp_path):
    """One npz per shard (shard s: its block and overflow[s]) and the
    sidecar; another shard count or layout, or a directory without shard
    files (a JAX Orbax checkpoint), raises ValueError."""
    p, scene = driver.SCENARIOS["dam2d_flip98"]()
    sim = driver.Simulation(p, scene, path="fast", devices=4, device="cpu",
                            out_dir=str(tmp_path))
    path = str(tmp_path / "dir_ck")
    ckpt.save_sharded(path, sim.state, meta={"frame_count": 0})
    names = sorted(os.listdir(path))
    assert names == [f"shard-{s:05d}.npz" for s in range(4)]
    part = ckpt.load(os.path.join(path, names[1]), fast2d.FluidBuckets)
    rows = sim.state.x0.shape[0] // 4
    np.testing.assert_array_equal(part.x0.numpy(), sim.state.x0[rows:2 * rows].numpy())
    np.testing.assert_array_equal(part.overflow.numpy(), sim.state.overflow[1:2].numpy())
    assert ckpt.load_sharded_meta(path) == {"frame_count": 0}
    _assert_same(ckpt.load_sharded(path, sim.state), sim.state)
    two = driver.Simulation(p, scene, path="fast", devices=2, device="cpu",
                            out_dir=str(tmp_path))
    with pytest.raises(ValueError, match="4 shards"):
        ckpt.load_sharded(path, two.state)
    os.makedirs(tmp_path / "orbax" / "state")
    with pytest.raises(ValueError, match="npz checkpoints only"):
        ckpt.load_sharded(str(tmp_path / "orbax"), sim.state)


CLI_RUNS = {   # (scenario, path, devices, substeps, checkpoint name)
    "general_npz": ("dam2d", "general", "1", 3, "ck.npz"),
    "fast_npz": ("dam2d_flip98", "fast", "1", 5, "ck.npz"),
    "fast4_dir": ("dam2d_flip98", "fast", "4", 5, "ck"),
    "fast4_npz": ("dam2d_flip98", "fast", "4", 5, "ck.npz"),
    "dam3d_2x2_dir": ("dam3d", "fast", "2x2", 2, "ck"),
    "dam3d_2x2_npz": ("dam3d", "fast", "2x2", 2, "ck.npz"),
}


@pytest.mark.parametrize("case", list(CLI_RUNS))
def test_cli_resume_equals_the_uninterrupted_run(case, tmp_path):
    """2 frames uninterrupted against 1 frame, `--checkpoint`, a fresh
    process state, `--resume` and 1 frame: every field bitwise equal; the
    resumed run's frame is 00002.png (tests/test_cli.py:27-47); the
    general path keeps the scene's float64."""
    scenario, path, devices, n_sub, name = CLI_RUNS[case]
    base = ["--scenario", scenario, "--path", path, "--devices", devices, "--substeps",
            str(n_sub), "--no-gif", "--sync-io", "--device", "cpu"]
    whole = driver.main(base + ["--frames", "2", "--out", str(tmp_path / "whole")])
    ck = str(tmp_path / name)
    first = driver.main(base + ["--frames", "1", "--out", str(tmp_path / "a"), "--checkpoint", ck])
    assert os.path.isdir(ck) == (not name.endswith(".npz"))
    resumed = driver.main(base + ["--frames", "1", "--out", str(tmp_path / "b"),
                                  "--resume", ck])
    assert resumed.frame_count == 2 and resumed.total_time == pytest.approx(whole.total_time)
    assert os.listdir(resumed.frame_dir) == ["00002.png"]
    if path == "general":
        assert resumed.state.x.dtype == torch.float64
    _assert_same(resumed.state, whole.state)
    assert first.frame_count == 1


def test_cli_checkpoint_every_on_shards(tmp_path):
    """`--checkpoint-every 1 --devices 4`: `restart.npz` after each frame,
    the whole shard-major state with its frame count and time."""
    sim = driver.main(["--scenario", "dam2d_flip98", "--path", "fast", "--devices", "4",
                       "--frames", "2", "--substeps", "3", "--no-gif", "--sync-io",
                       "--device", "cpu", "--out", str(tmp_path), "--checkpoint-every", "1"])
    ck = os.path.join(sim.frame_dir, "restart.npz")
    meta = ckpt.load_meta(ck)
    assert meta["frame_count"] == 2 and meta["path"] == "fast"
    assert meta["total_time"] == pytest.approx(6 * sim.cfg.dt)
    _assert_same(ckpt.load(ck, fast2d.FluidBuckets), sim.state)
    assert sim.state.overflow.shape == (4,)


def test_resume_after_respec(tmp_path):
    """A checkpoint written with another bucket capacity restores with the
    spec's capacity taken from the state (tests/test_utils_and_driver.py:
    165-182)."""
    cfg = MPMConfig(**FAST, **FLIP, transfer=TransferKind.PIC)
    p, scene = scenes.dam_break_2d(cfg, dtype=np.float32)

    def sim_at(out, capacity=None):
        sim = driver.Simulation(p, scene, path="fast", out_dir=str(out), device="cpu")
        if capacity is not None:
            sim.spec = dataclasses.replace(sim.spec, capacity=capacity)
            sim.state = fast2d.from_particles(p, cfg, sim.spec, "cpu")
            sim._host_cache = None
        return sim

    sim = sim_at(tmp_path, capacity=512)
    sim.run(n_frames=1, substeps_per_frame=5, gif=False, verbose=False)
    ck = str(tmp_path / "ck_respec.npz")
    sim.save_checkpoint(ck)
    sim2 = sim_at(tmp_path / "r")
    assert sim2.spec.capacity == 256
    sim2.restore_checkpoint(ck)
    assert sim2.spec.capacity == 512 and sim2._host_cache is None
    np.testing.assert_array_equal(sim2.positions(), sim.positions())
    sim2.run(n_frames=1, substeps_per_frame=5, gif=False, verbose=False)
    sim.run(n_frames=1, substeps_per_frame=5, gif=False, verbose=False)
    np.testing.assert_array_equal(sim2.positions(), sim.positions())


def test_jax_general_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX driver runs 20 float64 substeps of the 37^2 dam break on the
    general path and checkpoints; the port's driver resumes the npz and
    runs 20 more, against JAX's own continuation: 1e-9 of each field's
    scale (tests/test_torch_general2d.py's float64 bound after 20)."""
    p, scene = scenes_jax.dam_break_2d(MPMConfigJax(**FAST))
    sim_j = driver_jax.Simulation(p, scene, path="general", out_dir=str(tmp_path / "jax"))
    sim_j.run(n_frames=1, substeps_per_frame=20, gif=False, verbose=False)
    ck = str(tmp_path / "general.npz")
    sim_j.save_checkpoint(ck)
    sim_j.run(n_frames=1, substeps_per_frame=20, gif=False, verbose=False)
    p_t, scene_t = scenes.dam_break_2d(MPMConfig(**FAST))
    sim = driver.Simulation(p_t, scene_t, out_dir=str(tmp_path / "port"), device="cpu")
    sim.restore_checkpoint(ck)
    assert sim.frame_count == 1 and sim.state.x.dtype == torch.float64
    sim.run(n_frames=1, substeps_per_frame=20, gif=False, verbose=False, write_frames=False)
    assert sim.total_time == pytest.approx(sim_j.total_time)
    for name in ("x", "v", "C", "F", "J"):
        want = np.asarray(getattr(sim_j.state, name))
        got = getattr(sim.state, name).numpy()
        scale = np.abs(want - 1.0 if name == "J" else want).max()
        assert np.abs(got - want).max() <= 1e-9 * scale, name


def test_flip_sweep_scenes_match_jax():
    want = driver_jax.flip_sweep_scenes()
    got = driver.flip_sweep_scenes()
    assert list(got) == list(want)
    for name, (p, scene) in got.items():
        pj, sj = want[name]
        assert p.n == 8450
        assert (scene.cfg.flip_blend, scene.cfg.transfer.value) == (
            sj.cfg.flip_blend, sj.cfg.transfer.value)
        for f in ("x", "v", "C", "F", "J", "volume0", "mass", "material"):
            np.testing.assert_array_equal(getattr(p, f).numpy(), np.asarray(getattr(pj, f)),
                                          err_msg=f"{name} {f}")


def test_make_substep_is_one_substep():
    p, scene = scenes.dam_break_2d(MPMConfig(**FAST))
    step = stabilized.make_substep(scene)
    _assert_same(step(p), stabilized.run(p, scene, 1))
