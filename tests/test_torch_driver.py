"""The port's entry points on the CPU: CLI, imports without JAX, no fallback."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from mpm_flip98a_tpu_torch import driver
from mpm_flip98a_tpu_torch.models import fast2d
from mpm_flip98a_tpu_torch.utils import io_vtk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads only contend with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_python(code_or_args, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, *code_or_args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_cli_runs_one_frame_on_cpu(tmp_path):
    sim = driver.main([
        "--scenario", "dam2d_flip98", "--path", "fast", "--frames", "1",
        "--substeps", "20", "--no-gif", "--sync-io", "--out", str(tmp_path),
        "--device", "cpu",
    ])
    assert sim.stats.substeps == sim.stats.host_reads == 20
    assert sim.frame_count == 1 and int(sim.state.overflow) == 0
    x = sim.positions()
    assert x.shape == (8450, 2) and np.isfinite(x).all()
    assert os.path.exists(os.path.join(sim.frame_dir, "00001.png"))
    pts = io_vtk.read_vtk_points(os.path.join(sim.vtk_dir, "00001.vtk"))
    np.testing.assert_allclose(pts[:, :2], x, rtol=1e-6)
    assert sim.meter.substeps == 20


def test_cli_runs_dam3d_on_cpu(tmp_path):
    """The 3D scenario through the CLI: routed to fast3d by its dimension."""
    assert "dam3d" in driver.SCENARIOS and "dam3d" not in driver.UNPORTED_SCENARIOS
    sim = driver.main([
        "--scenario", "dam3d", "--path", "fast", "--frames", "1", "--substeps", "2",
        "--no-gif", "--sync-io", "--out", str(tmp_path), "--device", "cpu",
    ])
    assert sim.stats.substeps == sim.stats.host_reads == 2
    assert sim.frame_count == 1 and int(sim.state.overflow) == 0
    x = sim.positions()
    assert x.shape == (24 * 24 * 48, 3) and np.isfinite(x).all()
    assert os.path.exists(os.path.join(sim.frame_dir, "00001.png"))
    pts = io_vtk.read_vtk_points(os.path.join(sim.vtk_dir, "00001.vtk"))
    np.testing.assert_allclose(pts, x, rtol=1e-6)


def test_cli_runs_elastic_drop_on_cpu(tmp_path):
    """The JAX driver's elastic_drop scenario (fluid + neo-Hookean block,
    APIC, 105^2): the prepped-P2G branch through the CLI."""
    assert "elastic_drop" in driver.SCENARIOS
    assert "elastic_drop" not in driver.UNPORTED_SCENARIOS
    sim = driver.main([
        "--scenario", "elastic_drop", "--path", "fast", "--frames", "1",
        "--substeps", "5", "--no-gif", "--sync-io", "--out", str(tmp_path),
        "--device", "cpu",
    ])
    assert not fast2d.uses_fused(sim.scene)
    assert sim.stats.substeps == sim.stats.host_reads == 5
    assert sim.frame_count == 1 and int(sim.state.overflow) == 0
    x = sim.positions()
    assert x.shape == (11931, 2) and np.isfinite(x).all()
    assert len(np.unique(sim.material_colors(), axis=0)) == 2   # fluid and block
    assert os.path.exists(os.path.join(sim.frame_dir, "00001.png"))


def test_unported_entry_points_raise(tmp_path):
    """Every JAX scenario and entry point is ported: dam2d_incompressible
    runs (tests/test_torch_projection.py), and the two entry points that
    raised until the two-axis mesh (item 7) and checkpoints (item 2) were
    ported now run: `--devices 2x2` (dam3d on 2 x 2 windows) and
    `--checkpoint` (tests/test_torch_checkpoint.py holds them in full)."""
    assert driver.UNPORTED_SCENARIOS == {}
    assert "dam2d_incompressible" in driver.SCENARIOS
    out = ["--out", str(tmp_path), "--device", "cpu", "--frames", "1", "--substeps", "1",
           "--no-gif", "--sync-io"]
    for extra, check in (
        (["--scenario", "dam3d", "--path", "fast", "--devices", "2x2"],
         lambda sim: sim.mesh.n0 == sim.mesh.n1 == 2 and int(sim.state.overflow.sum()) == 0),
        (["--checkpoint", str(tmp_path / "ck.npz")],
         lambda sim: os.path.exists(tmp_path / "ck.npz") and sim.frame_count == 1),
    ):
        assert check(driver.main(out + extra)), extra


@pytest.mark.parametrize("scenario,devices,substeps", [
    ("dam2d_flip98", "4", 5), ("dam3d", "2", 2),
], ids=["2d", "3d"])
def test_cli_runs_slab_shards_on_cpu(tmp_path, scenario, devices, substeps):
    """`--devices N`: N slab shards on the one device, through the CLI."""
    sim = driver.main([
        "--scenario", scenario, "--path", "fast", "--devices", devices, "--frames", "1",
        "--substeps", str(substeps), "--no-gif", "--sync-io", "--out", str(tmp_path),
        "--device", "cpu",
    ])
    n = int(devices)
    assert sim.devices == n and sim.mesh.n == n and sim.spec.n_shards == n
    assert sim.stats.substeps == sim.stats.host_reads == substeps
    assert sim.state.overflow.shape == (n,) and int(sim.state.overflow.sum()) == 0
    p, _ = driver.SCENARIOS[scenario]()
    x = sim.positions()
    assert x.shape == (p.n, sim.cfg.dim) and np.isfinite(x).all()
    assert os.path.exists(os.path.join(sim.frame_dir, "00001.png"))


def test_devices_parsing(tmp_path):
    assert driver.parse_devices("1") == 1
    assert driver.parse_devices("8") == 8
    assert driver.parse_devices("2x4") == (2, 4)
    p, scene = driver.SCENARIOS["dam3d"]()
    # N0xN1: the two-axis mesh, N0 N1 shards on the one device.
    sim = driver.Simulation(p, scene, path="fast", devices=(2, 2), device="cpu",
                            out_dir=str(tmp_path))
    assert sim.devices == 4 and (sim.mesh.n0, sim.mesh.n1) == (2, 2)
    assert (sim.spec.n_shards1, sim.spec.rows_per_shard1) == (2, 32)
    p2, scene2 = driver.SCENARIOS["dam2d_flip98"]()
    with pytest.raises(ValueError, match="3D-only"):
        driver.Simulation(p2, scene2, path="fast", devices=(2, 2), device="cpu",
                          out_dir=str(tmp_path))
    # One shard along axis 1 is the one-axis slab mesh.
    sim = driver.Simulation(p, scene, path="fast", devices=(2, 1), device="cpu",
                            out_dir=str(tmp_path))
    assert sim.devices == 2 and sim.spec.n_shards0 == 2


def test_cuda_device_without_a_card_raises(tmp_path):
    """No CPU fallback: asking for the card without one is an error."""
    assert not torch.cuda.is_available()
    with pytest.raises((RuntimeError, AssertionError)):
        driver.main(["--frames", "1", "--substeps", "1", "--out", str(tmp_path),
                     "--device", "cuda"])


def test_port_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mpm_flip98a_tpu'] = None\n"
        "import mpm_flip98a_tpu_torch as m\n"
        "names = [i.name for i in pkgutil.walk_packages(m.__path__, m.__name__ + '.')]\n"
        "for n in names:\n"
        "    if n != 'mpm_flip98a_tpu_torch.__main__':\n"
        "        importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert not [k for k in sys.modules if k.startswith('jax') and sys.modules[k]]\n"
        "print(len(names))\n"
    )
    r = _run_python(["-c", code])
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 15


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "script_alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    cwd = ROOT
    if alone:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    r = _run_python(["chip_smoke.py"], cwd=cwd)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_cli_default_path_is_general(tmp_path):
    """`--path` defaults to general, as in the JAX CLI (driver.py:498)."""
    sim = driver.main(["--scenario", "dam2d", "--device", "cpu", "--frames", "1",
                       "--substeps", "2", "--no-gif", "--sync-io", "--out", str(tmp_path)])
    assert sim.path == "general" and sim.stats.substeps == 2
    assert sim.state.x.dtype == torch.float64 and sim.state.x.shape == (8450, 2)
    assert os.path.exists(os.path.join(sim.frame_dir, "00001.png"))
    assert np.array_equal(sim.positions(), sim.state.x.numpy())
    assert len(np.unique(sim.material_colors(), axis=0)) == 1


def test_cli_dam2d_matches_jax_general(tmp_path):
    """`--scenario dam2d --device cpu --frames 1 --substeps 2` against JAX
    `Simulation(path="general")` from the same scene: every field within
    1e-12 of its scale (float64, the reference configuration)."""
    import dataclasses

    from mpm_flip98a_tpu import driver as driver_jax

    sim = driver.main(["--scenario", "dam2d", "--device", "cpu", "--frames", "1",
                       "--substeps", "2", "--no-gif", "--sync-io", "--out", str(tmp_path)])
    p, scene = driver_jax.SCENARIOS["dam2d"]()
    ref = driver_jax.Simulation(p, scene, path="general", out_dir=str(tmp_path / "jax"))
    ref.step_frame(2)
    assert sim.total_time == ref.total_time
    for f in dataclasses.fields(ref.state):
        want = np.asarray(getattr(ref.state, f.name))
        got = getattr(sim.state, f.name).numpy()
        assert got.dtype == want.dtype, f.name
        scale = np.abs(np.asarray(ref.state.x)).max() if f.name == "consistency" else (
            np.abs(want).max())
        assert np.abs(got - want).max() <= 1e-12 * scale, f.name


@pytest.mark.parametrize("scenario", sorted(driver.SCENARIOS))
def test_general_path_runs_every_ported_scenario(tmp_path, scenario):
    sim = driver.main(["--scenario", scenario, "--device", "cpu", "--frames", "1",
                       "--substeps", "1", "--no-gif", "--sync-io", "--out", str(tmp_path)])
    p, _ = driver.SCENARIOS[scenario]()
    assert sim.path == "general" and sim.state.x.dtype == p.x.dtype
    x = sim.positions()
    assert x.shape == (p.n, sim.cfg.dim) and np.isfinite(x).all()


def test_general_path_takes_one_device(tmp_path):
    p, scene = driver.SCENARIOS["dam2d"]()
    for devices in (2, (2, 1)):
        with pytest.raises(ValueError, match="requires --path fast"):
            driver.Simulation(p, scene, devices=devices, device="cpu", out_dir=str(tmp_path))
    with pytest.raises(ValueError, match="requires --path fast"):
        driver.main(["--scenario", "dam2d", "--devices", "2", "--device", "cpu", "--frames",
                     "1", "--substeps", "1", "--out", str(tmp_path)])
