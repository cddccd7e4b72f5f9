"""The fast paths one shard per rank (`parallel.RankMesh`) against the port's `SlabMesh` and the JAX package.

Every case runs in one launch of 4 gloo ranks on the CPU
(tests/torch_fast_rank_jobs.py holds the rank worker and the scenes);
the references are made while the ranks work.  The first reference is the
port's `SlabMesh` run from the same particles, which
tests/test_torch_fast_domain*.py hold to JAX's `shard_map`: where no sum
crosses ranks the ranks reproduce it bit for bit, slot for slot:

- 2D at 37^2, a split column whose slots migrate both ways over 100
  substeps (`fast_domain`);
- 3D at 16^3 on 4 slabs and on the 2 x 2 rank grid, 20 substeps with a
  rebucket (`fast_domain3d`), and a 2 x 2 run whose axis-1 legs deliver
  zeros, which must fail that comparison;
- `RankMesh(grid=(2, 2))`'s shifts against `SlabMesh(2, cpu, 2)`;
- per-rank checkpoint directories, cross-resumed with `SlabMesh` ones.

Sums that cross ranks (gloo's all_reduce adds in its own order) are held
to stated tolerances: the projection and CSF case (its CG's dot products
and maxima) to tests/test_projection.py's 1e-4 of v's max, with x to
1e-6; `fast_replicated` (its grid psum) to tests/test_parallel_fast.py's
1e-6 on x against one device.  Against JAX directly: the 2D layout and
`fast_replicated.distribute` bit for bit, the 2D rank run against JAX
`fast_domain.make_run` on `make_mesh(4)` over 20 substeps and
`fast_replicated` against JAX's `make_run` over 10, slot for slot, with
tests/test_torch_fast_domain.py's 1e-5 on x.  JAX's kernels run in
Pallas interpret mode; the port runs its plain versions.
"""

import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_fast_rank_jobs as jobs
from mpm_flip98a_tpu.config import MPMConfig as MPMConfigJax
from mpm_flip98a_tpu.config import TransferKind as TransferKindJax
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu.parallel import fast_domain as fd_jax
from mpm_flip98a_tpu.parallel import fast_replicated as fr_jax
from mpm_flip98a_tpu.parallel import make_mesh
from mpm_flip98a_tpu_torch import driver
from mpm_flip98a_tpu_torch.models import fast2d
from mpm_flip98a_tpu_torch.parallel import SlabMesh, launch
from mpm_flip98a_tpu_torch.parallel import fast_domain as fd
from mpm_flip98a_tpu_torch.parallel import fast_domain3d as fd3
from mpm_flip98a_tpu_torch.parallel import fast_replicated as fr
from mpm_flip98a_tpu_torch.utils import checkpoint as ckpt
from mpm_flip98a_tpu_torch.utils.timing import profiler_trace

N = jobs.N
CPU = torch.device("cpu")
SNAPSHOTS = (20, 100)
STEPS3D = 20
EXT_STEPS = 5
REPLICATED_STEPS = 10
CKPT_STEPS = (5, 5)               # before and after the checkpoint
EXT_TOL = {"x": 1e-6, "v": 1e-4}   # x absolute; v of its max
JAX_X_TOL = 1e-5                   # tests/test_torch_fast_domain.py
REPLICATED_X_TOL = 1e-6            # tests/test_parallel_fast.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slab2d(name, snapshots):
    p, scene = jobs.scene2d(name)
    spec = jobs.spec2d(p, scene)
    mesh = SlabMesh(N, CPU)
    b = fd.distribute(p, scene.cfg, spec, mesh)
    out, run, done = {"start": jobs.host(b)}, fd.make_run(scene, spec, mesh), 0
    for n_sub in snapshots:
        b = run(b, n_sub - done)
        done = n_sub
        out[n_sub] = jobs.host(b)
    return out


def _slab3d(grid):
    p, scene = jobs.scene3d()
    spec = jobs.spec3d(p, scene, grid)
    n0, n1 = grid or (N, 1)
    mesh = SlabMesh(n0, CPU, n1)
    b = fd3.distribute(p, scene.cfg, spec, mesh)
    return {"start": jobs.host(b), "end": jobs.host(fd3.make_run(scene, spec, mesh)(b, STEPS3D))}


def _jax_migrate():
    """The "migrate" particles in JAX, its 4-shard layout and its run."""
    p_t, _ = jobs.scene2d("migrate")
    p, scene = scenes_jax.dam_break_2d(MPMConfigJax(
        **jobs.FAST_KW, flip_blend=0.98, transfer=TransferKindJax.PIC), dtype=np.float32)
    p = dataclasses.replace(p, x=jnp.asarray(p_t.x.numpy()), v=jnp.asarray(p_t.v.numpy()))
    mesh = make_mesh(N)
    spec = fd_jax.FastDomainSpec.for_particles(scene.cfg, N, p, headroom=2.0)
    b = fd_jax.distribute(p, scene.cfg, spec, mesh)
    out = fd_jax.make_run(scene, spec, mesh)(b, SNAPSHOTS[0])
    return _jax_host(b), _jax_host(out)


def _jax_host(b):
    return {f: np.asarray(getattr(b, f)) for f in b.__dataclass_fields__}


def _jax_replicated():
    p, scene = scenes_jax.dam_break_2d(MPMConfigJax(**jobs.FAST_KW), dtype=np.float32)
    mesh = make_mesh(N)
    b, spec = fr_jax.distribute(p, scene.cfg, mesh)
    return _jax_host(b), _jax_host(fr_jax.make_run(scene, spec, mesh)(b, REPLICATED_STEPS))


def _single_replicated(name):
    p, scene = jobs.scene2d(name)
    spec = fast2d.FastSpec.for_particles(scene.cfg, p, headroom=2.0)
    b = fast2d.run(fast2d.from_particles(p, scene.cfg, spec, CPU), scene, spec,
                   REPLICATED_STEPS)
    h = fast2d.to_host(b)
    return np.stack([h["x0"], h["x1"]], axis=-1)


def _slab_sim(tmp):
    p, scene = jobs.scene2d("migrate")
    return driver.Simulation(p, scene, path="fast", devices=N, device="cpu", out_dir=tmp)


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    """Every case on 4 gloo ranks in one launch, its references made while
    the ranks work, and the `--ranks` CLI launched beside it."""
    tmp = str(tmp_path_factory.mktemp("fast_ranks"))
    dirs = {k: os.path.join(tmp, k) for k in ("slab_ck", "ranks_ck", "cli", "sims")}
    slab = _slab_sim(dirs["sims"])
    slab.step_frame(CKPT_STEPS[0])
    slab.save_checkpoint(dirs["slab_ck"])
    slab.save_checkpoint(dirs["slab_ck"] + ".npz")
    blocks = np.random.default_rng(3).normal(0.0, 1.0, (N, 5, 3, 2)).astype(np.float32)
    work = [
        dict(kind="shifts", blocks=blocks),
        dict(kind="2d", scene="migrate", snapshots=SNAPSHOTS),
        dict(kind="2d", scene="ext", snapshots=(EXT_STEPS,)),
        dict(kind="3d", grid=None, n=STEPS3D),
        dict(kind="3d", grid=(2, 2), n=STEPS3D),
        dict(kind="3d", grid=(2, 2), n=STEPS3D, fault=True),
        dict(kind="checkpoint", out=dirs["sims"], first=CKPT_STEPS[0], second=CKPT_STEPS[1],
             slab_dir=dirs["slab_ck"], ranks_dir=dirs["ranks_ck"]),
        dict(kind="replicated", scene="replicated", n=REPLICATED_STEPS),
        dict(kind="replicated", scene="prepped", n=REPLICATED_STEPS),
    ]
    cli = ["--scenario", "dam2d_flip98", "--path", "fast", "--devices", str(N), "--ranks",
           "--backend", "gloo", "--device", "cpu", "--frames", "2", "--substeps", "3",
           "--no-gif", "--sync-io", "--out", dirs["cli"]]
    with ThreadPoolExecutor(8) as pool:
        ranks = pool.submit(launch.run_ranks, jobs.run_jobs, N, args=(work,), device="cpu",
                            backend="gloo", timeout_s=60.0, deadline_s=300.0)
        cli_run = pool.submit(driver.main, cli)
        refs = {
            "jax_migrate": pool.submit(_jax_migrate),
            "jax_replicated": pool.submit(_jax_replicated),
            "migrate": pool.submit(_slab2d, "migrate", SNAPSHOTS),
            "ext": pool.submit(_slab2d, "ext", (EXT_STEPS,)),
            "3d": pool.submit(_slab3d, None),
            "2x2": pool.submit(_slab3d, (2, 2)),
            "single_replicated": pool.submit(_single_replicated, "replicated"),
            "single_prepped": pool.submit(_single_replicated, "prepped"),
        }
        slab.step_frame(CKPT_STEPS[1])
        refs = {k: f.result() for k, f in refs.items()}
        per_rank = ranks.result()
        cli_out = cli_run.result()
    return dict(per_rank=per_rank, refs=refs, slab=slab, dirs=dirs, blocks=blocks,
                cli=cli_out, tmp=tmp)


def _result(ranked, j):
    """Job j's result as rank 0 returned it (its gathered states are every
    rank's)."""
    return ranked["per_rank"][0][j]


def _assert_bitwise(got, want, what):
    for name, a in want.items():
        b = got[name]
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), f"{what}: {name} differs"


def _live(state, n):
    return (state["mask"] > 0).reshape(n, -1).sum(1)


def test_every_rank_gathers_the_same_state(ranked):
    for j in (1, 3, 4):
        for r in range(1, N):
            _assert_bitwise(ranked["per_rank"][r][j]["start"], _result(ranked, j)["start"],
                            f"job {j} rank {r}")


@pytest.mark.parametrize("case,j", [("migrate", 1), ("3d", 3), ("2x2", 4)])
def test_rank_layout_equals_slab_mesh(ranked, case, j):
    _assert_bitwise(_result(ranked, j)["start"], ranked["refs"][case]["start"], case)


def test_2d_layout_equals_jax(ranked):
    want, _ = ranked["refs"]["jax_migrate"]
    _assert_bitwise(_result(ranked, 1)["start"], want, "layout against JAX")


def test_2d_migrating_run_bitwise(ranked):
    """100 substeps: slots leave shard 1 both ways, and every field of every
    slot equals SlabMesh's bit for bit, at 20 substeps and at 100."""
    got, want = _result(ranked, 1), ranked["refs"]["migrate"]
    for n_sub in SNAPSHOTS:
        _assert_bitwise(got[n_sub], want[n_sub], f"after {n_sub} substeps")
    before, after = _live(got["start"], N), _live(got[SNAPSHOTS[-1]], N)
    assert before.tolist()[0] == before.tolist()[2] == 0
    assert after[0] > 0 and after[2] > 0 and after.sum() == before.sum()
    assert got["rebuckets"] > 0 and int(got[SNAPSHOTS[-1]]["overflow"].sum()) == 0


def test_2d_rank_run_matches_jax(ranked):
    """20 substeps against JAX `fast_domain.make_run` on 4 devices, slot for
    slot: the same live slots, x to 1e-5, v to 1e-5 of its max."""
    _, want = ranked["refs"]["jax_migrate"]
    got = _result(ranked, 1)[SNAPSHOTS[0]]
    np.testing.assert_array_equal(got["mask"], want["mask"])
    for name in ("x0", "x1"):
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=JAX_X_TOL, err_msg=name)
    v, vj = np.stack([got["v0"], got["v1"]]), np.stack([want["v0"], want["v1"]])
    assert np.abs(v - vj).max() <= 1e-5 * np.abs(vj).max()


@pytest.mark.parametrize("case,j", [("3d", 3), ("2x2", 4)])
def test_3d_run_bitwise(ranked, case, j):
    """20 substeps with slots crossing the window edges (a rebucket on
    every rank), every field equal to SlabMesh's bit for bit."""
    got = _result(ranked, j)
    _assert_bitwise(got["end"], ranked["refs"][case]["end"], case)
    assert got["rebuckets"] > 0 and int(got["end"]["overflow"].sum()) == 0
    assert (_live(got["end"], N) != _live(got["start"], N)).any()


def test_zeroed_axis1_legs_fail_the_2x2_comparison(ranked):
    got, want = _result(ranked, 5)["end"], ranked["refs"]["2x2"]["end"]
    on = want["mask"] > 0
    v = np.stack([got[f"v{a}"] for a in range(3)])
    vw = np.stack([want[f"v{a}"] for a in range(3)])
    differs = not np.array_equal(got["mask"], want["mask"]) or \
        np.abs(v - vw)[:, on].max() > 1e-3 * np.abs(vw).max()
    assert differs


@pytest.mark.parametrize("op", ["shift_left", "shift_right"])
@pytest.mark.parametrize("axis", [0, 1])
def test_two_axis_shifts_equal_slab_mesh(ranked, op, axis):
    want = getattr(SlabMesh(2, CPU, 2), op)(torch.from_numpy(ranked["blocks"]), axis=axis)
    for r in range(N):
        np.testing.assert_array_equal(ranked["per_rank"][r][0][f"{op} {axis}"], want[r].numpy())


@pytest.mark.parametrize("kind", ["dir", "npz"])
def test_ranks_resume_a_slab_mesh_checkpoint(ranked, kind):
    """A SlabMesh shard directory, and its whole-state npz, resumed on the
    ranks: the run goes on bit for bit as SlabMesh's."""
    got = _result(ranked, 6)
    _assert_bitwise(got[kind], jobs.host(ranked["slab"].state), f"{kind} resumed on ranks")
    assert got[kind + "_frame_count"] == ranked["slab"].frame_count == 2


def test_ranks_write_the_slab_mesh_npz(ranked):
    a, b = (np.load(ranked["dirs"][k] + ".npz") for k in ("ranks_ck", "slab_ck"))
    with a, b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert np.array_equal(a[f], b[f]), f


def test_slab_mesh_resumes_a_rank_directory(ranked):
    dirs = ranked["dirs"]
    for s in range(N):      # the ranks wrote the files SlabMesh writes
        name = ckpt.SHARD_FILE.format(s)
        with np.load(os.path.join(dirs["ranks_ck"], name)) as a, \
                np.load(os.path.join(dirs["slab_ck"], name)) as b:
            assert sorted(a.files) == sorted(b.files)
            for f in a.files:
                assert np.array_equal(a[f], b[f]), (name, f)
    with open(dirs["ranks_ck"] + ".meta.json") as f:
        assert json.load(f)["meta"]["frame_count"] == 1
    sim = _slab_sim(dirs["sims"])
    sim.restore_checkpoint(dirs["ranks_ck"])
    sim.step_frame(CKPT_STEPS[1])
    _assert_bitwise(jobs.host(sim.state), jobs.host(ranked["slab"].state), "resumed on SlabMesh")


def test_projection_and_csf_within_tolerance(ranked):
    """The CG's dot products and the CSF maxima cross ranks: 5 substeps
    against SlabMesh slot for slot, x to 1e-6, v to 1e-4 of its max."""
    got, want = _result(ranked, 2)[EXT_STEPS], ranked["refs"]["ext"][EXT_STEPS]
    np.testing.assert_array_equal(got["mask"], want["mask"])
    for a in ("0", "1"):
        np.testing.assert_allclose(got["x" + a], want["x" + a], rtol=0, atol=EXT_TOL["x"])
    v, vw = np.stack([got["v0"], got["v1"]]), np.stack([want["v0"], want["v1"]])
    assert np.abs(v - vw).max() <= EXT_TOL["v"] * np.abs(vw).max()
    assert int(got["overflow"].sum()) == 0


def test_fast_replicated_distribute_equals_jax(ranked):
    """Each rank's round-robin share, concatenated along K, is JAX's layout,
    bit for bit (host-side and as the ranks hold it)."""
    want, _ = ranked["refs"]["jax_replicated"]
    p, scene = jobs.scene2d("replicated")
    spec = fr.share_spec(p, scene.cfg, N)
    shares = [fast2d.from_particles(fr.share(p, r, N), scene.cfg, spec, CPU) for r in range(N)]
    for name, a in want.items():
        if name == "overflow":
            continue
        host = torch.cat([getattr(b, name) for b in shares], dim=1).numpy()
        assert np.array_equal(host, a), name
    _assert_bitwise(_result(ranked, 7)["start"], want, "ranks' layout")


def test_fast_replicated_run(ranked):
    """10 substeps, one grid all_reduce a substep: against JAX's make_run
    slot for slot (x to 1e-6) and against one device on sorted positions
    (x to 1e-6, tests/test_parallel_fast.py)."""
    got = _result(ranked, 7)
    _, want = ranked["refs"]["jax_replicated"]
    np.testing.assert_array_equal(got["end"]["mask"], want["mask"])
    for name in ("x0", "x1"):
        np.testing.assert_allclose(got["end"][name], want[name], rtol=0, atol=REPLICATED_X_TOL)
    assert int(got["end"]["overflow"].sum()) == 0
    order = lambda x: x[np.lexsort((x[:, 1], x[:, 0]))]
    single = ranked["refs"]["single_replicated"]
    np.testing.assert_allclose(order(got["positions"]), order(single), rtol=0,
                               atol=REPLICATED_X_TOL)
    g = jobs.FAST_KW["num_grids"]
    for r in range(N):      # the folded (G, 5, G) float32 sums, once a substep
        rec = ranked["per_rank"][r][7]
        assert rec["psum_calls"] == REPLICATED_STEPS
        assert rec["psum_bytes"] == REPLICATED_STEPS * g * 5 * g * 4


def test_fast_replicated_prepped_branch(ranked):
    """The stabilized switch set (`p2g`'s prepped branch, F-bar's and
    mixing's nodal averages from the summed grid): 10 substeps against one
    device on sorted positions, x to 1e-6."""
    got = _result(ranked, 8)
    assert int(got["end"]["overflow"].sum()) == 0
    order = lambda x: x[np.lexsort((x[:, 1], x[:, 0]))]
    np.testing.assert_allclose(order(got["positions"]), order(ranked["refs"]["single_prepped"]),
                               rtol=0, atol=REPLICATED_X_TOL)
    assert all(r[8]["psum_calls"] == REPLICATED_STEPS for r in ranked["per_rank"])


def test_cli_ranks_write_frames_from_rank0(ranked):
    out = ranked["cli"]
    assert [r["rank"] for r in out] == list(range(N))
    assert [r["frames_written"] for r in out] == [2, 0, 0, 0]
    assert all(r["frame_count"] == 2 and r["substeps"] == 6 and r["overflow"] == 0 for r in out)
    for k in (1, 2):
        assert os.path.exists(os.path.join(out[0]["frame_dir"], f"{k:05d}.png"))


def test_ranks_flag_needs_the_sharded_fast_path(tmp_path):
    for extra in (["--devices", "4"], ["--path", "fast"]):
        with pytest.raises(ValueError, match="--ranks"):
            driver.main(["--ranks", "--device", "cpu", "--out", str(tmp_path)] + extra)


def test_grid_reduce_keeps_the_unfused_route(monkeypatch):
    """MPM_P2G_GRID=1 never swallows a grid_reduce (fast2d.py:564)."""
    monkeypatch.setenv("MPM_P2G_GRID", "1")
    _, scene = jobs.scene2d("replicated")
    assert fast2d.routes(scene)[0]
    assert not fast2d.routes(scene, grid_reduce=lambda g: g)[0]


def test_profiler_trace_writes_a_trace(tmp_path):
    with profiler_trace(str(tmp_path), device="cpu") as prof:
        torch.ones(64).cumsum(0)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / files[0]) as f:
        assert "traceEvents" in json.load(f)
    assert len(prof.key_averages()) > 0
