"""The order that the general path's scatter plan gives, on the CPU.

On the card the scatter (`ops/cuda/scatter.py`, csrc/scatter.cu) sorts
the particles, one key each, and each node merges the runs of its 3^d key
cells by particle index.  `walk` below is that walk written plainly in
torch, a test oracle that no path calls: each node's S runs of
`stencil_plan` (or its one run of `segment_plan`) merged by particle
index, then summed from +0 one add after another.  It is held bitwise to
the CPU's `index_add_` (the plain version) on the real inputs of general
substeps (37^2 in 2D, 16^3 in 3D, float32 and float64), on taps clipped
at the walls, on a slab context with `_live`'s keep and a nonzero base
shift, on a dense cell with thousands of particles at one point, and on
the one-tap cell sums.  The same rows summed in a shuffled order differ
in the last bits, so the comparison can fail.
"""

import functools

import numpy as np
import pytest
import torch

from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind
from mpm_flip98a_tpu_torch.models import scenes, stabilized
from mpm_flip98a_tpu_torch.ops import weights
from mpm_flip98a_tpu_torch.ops.cuda import scatter
from mpm_flip98a_tpu_torch.parallel import domain
from mpm_flip98a_tpu_torch.state import Particles

DTYPES = [torch.float32, torch.float64]
STAB = dict(use_fbar=True, use_penalty_ebc=True, pressure_mixing_ratio=1.0, flip_blend=0.98,
            transfer=TransferKind.PIC)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _node_runs(plan, grid_shape, taps):
    """(node, tap, particle) of every row the plan's runs give, node by
    node, each node's runs in tap order."""
    d = len(grid_shape)
    nodes = int(np.prod(grid_shape))
    if taps == 1:
        key = torch.arange(nodes)[:, None]
    else:
        coords = torch.from_numpy(np.indices(grid_shape).reshape(d, -1).T.copy())
        cell = coords[:, None, :] + 2 - torch.from_numpy(weights.stencil_offsets(d)).long()
        key = torch.zeros(cell.shape[:2], dtype=torch.int64)
        for k in range(d):
            key = key * (grid_shape[k] + 2) + cell[..., k]
    starts = plan.starts.long()
    lo, n_in = starts[key].reshape(-1), (starts[key + 1] - starts[key]).reshape(-1)
    pair = torch.repeat_interleave(torch.arange(nodes * key.shape[1]), n_in)
    first = torch.repeat_interleave(torch.cumsum(n_in, 0) - n_in, n_in)
    pos = torch.repeat_interleave(lo, n_in) + torch.arange(len(pair)) - first
    return pair // key.shape[1], pair % key.shape[1], plan.order[pos].long()


def walk(values, plan, grid_shape, shuffle=None):
    """Test oracle: each node's runs merged by particle index, summed from
    +0 one add after another; (nodes, c).  values: (N, S, c) rows of the
    stencil form (S = 1: the one-tap form's rows).  With `shuffle` (a
    torch.Generator) each node adds its rows in a random order instead."""
    n, taps, c = values.shape
    nodes = int(np.prod(grid_shape))
    node, tap, part = _node_runs(plan, grid_shape, taps)
    # A particle reaches a node through one tap at most, so the merged
    # order by particle index is the order by row position.
    key = node * n + part
    assert len(torch.unique(key)) == len(key)
    if shuffle is not None:
        key = node * len(key) + torch.randperm(len(key), generator=shuffle)
    by = torch.argsort(key)
    node, rows = node[by], values[part[by], tap[by]]
    count = torch.bincount(node, minlength=nodes)
    first = torch.cumsum(count, 0) - count
    acc = torch.zeros((nodes, c), dtype=values.dtype)
    for j in range(int(count.max()) if len(node) else 0):
        live = torch.nonzero(count > j)[:, 0]
        acc[live] = acc[live] + rows[first[live] + j]
    return acc


def _check_plan(plan, base, grid_shape, keep=None):
    """Every run ascending by particle index; the particles left out of
    every run are those with no tap in bounds or keep False."""
    n = base.shape[0]
    order = plan.order.long()
    inside = torch.ones(n, dtype=torch.bool)
    for k, g in enumerate(grid_shape):
        inside &= (base[:, k] >= -2) & (base[:, k] < g)
    if keep is not None:
        inside &= keep
    runs = int(plan.starts[-1])
    assert runs == int(inside.sum()) and inside[order[:runs]].all()
    assert not inside[order[runs:]].any()
    cell = torch.zeros(n, dtype=torch.int64)
    for k, g in enumerate(grid_shape):
        cell = cell * (g + 2) + base[:, k] + 2
    ran = order[:runs]
    step = ran[1:] > ran[:-1]
    same = cell[ran][1:] == cell[ran][:-1]
    assert (step | ~same).all() and (cell[ran][1:] >= cell[ran][:-1]).all()


def _held(values, base, grid_shape, keep=None, control=True):
    """The plan's walk bitwise `stencil_add_plain` (index_add_); a shuffled
    walk is not."""
    d = len(grid_shape)
    plan = scatter.stencil_plan(base, grid_shape, keep)
    _check_plan(plan, base, grid_shape, keep)
    offsets = weights.stencil_offsets(d)
    want = scatter.stencil_add_plain(values, base, offsets, grid_shape)
    assert torch.equal(scatter.stencil_add(values, base, offsets, grid_shape), want)
    assert torch.equal(walk(values, plan, grid_shape), want)
    if control:
        shuffled = walk(values, plan, grid_shape, shuffle=torch.Generator().manual_seed(0))
        assert not torch.equal(shuffled, want)
    return want


def _spy(call):
    """The stencil and one-tap scatters `call()` makes, in order."""
    seen, real_s, real_a = [], scatter.stencil_add, scatter.scatter_add

    def stencil(values, base, offsets, grid_shape, plan=None):
        seen.append(("stencil", values, base, tuple(grid_shape)))
        return real_s(values, base, offsets, grid_shape, plan)

    def one_tap(values, flat, nodes, plan=None):
        seen.append(("one_tap", values, flat, nodes))
        return real_a(values, flat, nodes, plan)

    scatter.stencil_add, scatter.scatter_add = stencil, one_tap
    try:
        out = call()
    finally:
        scatter.stencil_add, scatter.scatter_add = real_s, real_a
    return seen, out


def _scene(dim, dtype):
    npd = np.float32 if dtype == torch.float32 else np.float64
    if dim == 2:
        cfg = MPMConfig(num_grids=37, dt=2e-5, num_particles_x=16, num_particles_y=32,
                        dtype=np.dtype(npd).name, **STAB)
        return scenes.dam_break_2d(cfg, dtype=npd)
    return scenes.dam_break_3d(num_grids=16, particles_per_axis=(6, 6, 10), dt=2e-5,
                               dtype=npd, **STAB)


@functools.lru_cache(maxsize=None)
def captures(dim, dtype):
    """The scatters of one general substep after a few (37^2 or 16^3):
    the F-bar cell sums, the projection pass and the momentum P2G."""
    p, scene = _scene(dim, dtype)
    p = stabilized.run(p, scene, 10 if dim == 2 else 4)
    seen, _ = _spy(lambda: stabilized.substep(p, scene))
    return p, scene, seen


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("dim", [2, 3])
def test_walk_is_index_add_on_general_substeps(dim, dtype):
    _, _, seen = captures(dim, dtype)
    assert [s[0] for s in seen] == ["one_tap", "stencil", "stencil"]
    for kind, values, where, shape in seen:
        if kind == "stencil":
            assert values.shape[1] == 3**dim and values.dtype == dtype
            _held(values, where, shape)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("dim", [2, 3])
def test_one_tap_cell_sums(dim, dtype):
    """The F-bar cell sums: one run a cell, bare rows in ascending
    position; the plan's walk is index_add_, a shuffled one is not."""
    _, _, seen = captures(dim, dtype)
    _, values, flat, nodes = seen[0]
    plan = scatter.segment_plan(flat, nodes)
    want = scatter.scatter_add_plain(values, flat, nodes)
    assert torch.equal(walk(values[:, None], plan, (nodes,)), want)
    # The control on rows of many magnitudes (early cell sums are sums of
    # equal rows, which no order changes).
    scale = 10.0 ** np.random.default_rng(dim).uniform(-4, 4, (len(values), 1))
    values = values * torch.from_numpy(scale).to(dtype)
    want = scatter.scatter_add_plain(values, flat, nodes)
    assert torch.equal(walk(values[:, None], plan, (nodes,)), want)
    assert not torch.equal(walk(values[:, None], plan, (nodes,),
                                shuffle=torch.Generator().manual_seed(1)), want)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("dim", [2, 3])
def test_clipped_taps_at_the_walls(dim, dtype):
    """Bases on and past every wall: taps out of bounds add nothing (the
    CPU's clipped rows are +0; the walk never reads them), particles with
    no tap in bounds belong to no run."""
    rng = np.random.default_rng(11 + dim)
    shape = (9, 7) if dim == 2 else (6, 5, 7)
    n = 1500
    base = np.stack([rng.integers(-4, g + 2, n) for g in shape], axis=1)
    base[:40] = -2                            # one tap in bounds, at the corner
    base[40:80] = np.asarray(shape) - 1       # one tap in bounds, at the far corner
    values = rng.normal(0.0, 1.0, (n, 3**dim, 4)) * 10.0 ** rng.uniform(-5, 5, (n, 1, 1))
    want = _held(torch.from_numpy(values).to(dtype), torch.from_numpy(base), shape)
    assert want.abs().sum() > 0


def _slab_inputs(dtype):
    """A 2D slab context as `domain.context` builds it (shard 1 of 8,
    nonzero base shift), its particles laid out by `domain.layout` with
    inert slots (mass 0, parked at the slab centre), one substep captured."""
    p, scene = _scene(2, dtype)
    p = stabilized.run(p, scene, 10)
    cfg, n_shards, s = scene.cfg, 8, 1
    spec = domain.DomainSpec.for_particles(cfg, n_shards, p, headroom=3.0)
    full, _ = domain.layout(p, scene, spec)
    cap, L, H = spec.capacity, spec.rows_per_shard, domain.H
    mine = Particles(**{k: torch.from_numpy(np.ascontiguousarray(a[s * cap:(s + 1) * cap]))
                        for k, a in full.items()})
    rows = torch.arange(L + 2 * H)
    shift = torch.tensor([s * L - H, 0])
    ctx = stabilized.GridContext(
        node_shape=(L + 2 * H, cfg.num_grids), cell_shape=(L + 2 * H, cfg.num_cells),
        base_shift=shift, row_index0=s * L - H + rows, own_rows=(rows >= H) & (rows < L + H))
    seen, _ = _spy(lambda: stabilized.substep(mine, scene, ctx))
    return mine, ctx, seen


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_slab_context_with_keep(dtype):
    """A slab: localised bases on the shard's node shape, `_live`'s keep
    (the inert slots, all at one point, left out of the plan): the walk
    over the kept particles alone is index_add_ over every row."""
    p, ctx, seen = _slab_inputs(dtype)
    keep = stabilized._live(p, ctx)
    assert keep is not None and 0 < int((~keep).sum()) < len(keep)
    stencils = [s for s in seen if s[0] == "stencil"]
    assert len(stencils) == 2
    for _, values, base, shape in stencils:
        assert shape == ctx.node_shape and int(ctx.base_shift[0]) != 0
        _held(values, base, shape, keep)
        # Without keep the inert slots' +-0 rows join one cell's run: the
        # same sums bit for bit.
        assert torch.equal(walk(values, scatter.stencil_plan(base, shape), shape),
                           walk(values, scatter.stencil_plan(base, shape, keep), shape))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("dim", [2, 3])
def test_dense_cell(dim, dtype):
    """Thousands of particles at one point (one key cell) among a sparse
    crowd: every node around it merges one long run with short ones."""
    rng = np.random.default_rng(21 + dim)
    shape = (12, 10) if dim == 2 else (7, 6, 8)
    sparse = np.stack([rng.integers(-1, g, 600) for g in shape], axis=1)
    dense = np.tile(np.asarray(shape) // 2, (3000, 1))
    base = np.concatenate([sparse, dense])
    perm = rng.permutation(len(base))         # the dense particles spread over the indices
    base = base[perm]
    values = rng.normal(0.0, 1.0, (len(base), 3**dim, 3)) * 10.0 ** rng.uniform(-4, 4,
                                                                                  (len(base), 1, 1))
    plan = scatter.stencil_plan(torch.from_numpy(base), shape)
    assert int((plan.starts[1:] - plan.starts[:-1]).max()) >= 3000
    _held(torch.from_numpy(values).to(dtype), torch.from_numpy(base), shape)


def test_stencil_add_checks_its_inputs():
    base = torch.zeros((10, 2), dtype=torch.int64)
    vals = torch.zeros((10, 9, 3))
    offsets = weights.stencil_offsets(2)
    with pytest.raises(TypeError):
        scatter.stencil_add(vals.half(), base, offsets, (5, 5))
    with pytest.raises(ValueError):
        scatter.stencil_add(vals[:, :4], base, offsets, (5, 5))
    with pytest.raises(ValueError):
        scatter.stencil_add(vals[0], base, offsets, (5, 5))
    with pytest.raises(ValueError):                   # no kernel, no plain route
        scatter.stencil_add(vals.to("meta"), base.to("meta"), offsets, (5, 5))
    with pytest.raises(ValueError):
        scatter.stencil_plan(base, (2**16, 2**16))
