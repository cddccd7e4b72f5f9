"""The tile planner of the 3D P2G + grid-update kernel, on the CPU.

`p2g3d_grid` launches one block per tile of target pencils; the planner
(`ops/cuda/transfer3d.plan_p2g3d_grid`) picks the tile and the z band of
its shared slab, and `TilePlan.tile` / `.sources` decode a block as the
kernel (csrc/p2g3d_grid.cu) decodes blockIdx.x.  These tests hold the
plan to what the kernel relies on: every target pencil of the padded grid
(and of every shard window in the raw mode) owned by exactly one block, no
tile across two shards, each block's source rows exactly those that can
reach its tile, and the slab within the card's shared memory.
"""

import numpy as np
import pytest

from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

GRIDS = [
    # (R0, R1, shards): tile multiples, ragged rows, a window narrower than
    # a tile, and shard windows that the tile does not divide.
    (16, 16, 1), (13, 21, 1), (256, 256, 1), (1, 1, 1), (3, 40, 1),
    (15, 13, 3), (64, 64, 4), (20, 7, 4), (256, 256, 4), (36, 9, 6),
]


@pytest.mark.parametrize("nch", [7, 11])
@pytest.mark.parametrize("g2", [32, 37, 64, 128, 256, 512])
def test_slab_fits_the_shared_memory(nch, g2):
    plan = tk3.plan_p2g3d_grid(nch, g2, 256, 256)
    assert plan.smem == 4 * plan.t0 * plan.t1 * (nch * plan.band + 1)
    # BLOCKS_PER_SM blocks, each with the system's 1 KB and the kernel's
    # static arrays, share the SM's 228 KB; none exceeds the opt-in limit.
    assert plan.smem <= 232_448   # Hopper's opt-in limit per block
    assert tk3.BLOCKS_PER_SM * (plan.smem + 1_024 + tk3.SMEM_STATIC) <= tk3.SMEM_SM == 233_472
    assert min(g2, tk3.MIN_BAND) <= plan.band <= g2
    # The widest band that fits: one more column would not.
    if plan.band < g2:
        assert 4 * plan.t0 * plan.t1 * (nch * (plan.band + 1) + 1) > tk3.SMEM_BLOCK


@pytest.mark.parametrize("nch,g2,bands", [(7, 37, False), (7, 64, True), (11, 37, False),
                                          (11, 64, True), (7, 256, True), (11, 512, True)])
def test_z_bands_only_where_the_slab_does_not_hold_g2(nch, g2, bands):
    assert (tk3.plan_p2g3d_grid(nch, g2, 64, 64).band < g2) == bands


@pytest.mark.parametrize("nch", [7, 11])
@pytest.mark.parametrize("g2", [16, 32, 256])
def test_the_tile_shrinks_before_the_band_drops_below_min_band(nch, g2):
    """The planner takes the first of TILES whose slab holds min(G2,
    MIN_BAND) z columns: every larger tile would hold fewer."""
    plan = tk3.plan_p2g3d_grid(nch, g2, 256, 256)
    need = min(g2, tk3.MIN_BAND)
    at = tk3.TILES.index((plan.t0, plan.t1))
    assert plan.band >= need
    for t0, t1 in tk3.TILES[:at]:
        assert (tk3.SMEM_BLOCK // 4 - t0 * t1) // (t0 * t1 * nch) < need


@pytest.mark.parametrize("nch", [7, 11])
@pytest.mark.parametrize("r0,r1,shards", GRIDS)
def test_tiles_cover_every_target_pencil_once(r0, r1, shards, nch):
    plan = tk3.plan_p2g3d_grid(nch, 64, r0, r1, shards)
    l0 = r0 // shards
    owners = np.zeros((shards, l0 + 4, r1 + 4), dtype=int)
    for b in range(plan.blocks):
        shard, q0lo, q0hi, q1lo, q1hi = plan.tile(b)
        # Inside one shard's window of L0 + 4 planes, never across two.
        assert 0 <= shard < shards
        assert 0 <= q0lo < q0hi <= l0 + 4 and 0 <= q1lo < q1hi <= r1 + 4
        assert q0hi - q0lo <= plan.t0 and q1hi - q1lo <= plan.t1
        owners[shard, q0lo:q0hi, q1lo:q1hi] += 1
    assert (owners == 1).all()


@pytest.mark.parametrize("r0,r1,shards", GRIDS)
def test_sources_are_the_rows_that_reach_the_tile(r0, r1, shards):
    """A slot in source row i puts its taps on window planes i .. i + 4
    (base row i - 1 .. i + 1, three taps from plane base + 1), so plane q
    takes rows q - 4 .. q of its own shard."""
    plan = tk3.plan_p2g3d_grid(7, 32, r0, r1, shards)
    l0 = r0 // shards
    for b in range(plan.blocks):
        _, q0lo, q0hi, q1lo, q1hi = plan.tile(b)
        for (lo, hi), (qlo, qhi), rows in zip(plan.sources(b), ((q0lo, q0hi), (q1lo, q1hi)),
                                              (l0, r1)):
            reach = [i for i in range(rows) if i + 4 >= qlo and i <= qhi - 1]
            assert list(range(lo, hi + 1)) == reach


def test_every_tile_has_room_for_its_sources():
    """The kernel keeps each source pencil's live count and chunk offset in
    static arrays of MAX_SOURCES entries."""
    assert all((t0 + 4) * (t1 + 4) <= tk3.MAX_SOURCES == 144 for t0, t1 in tk3.TILES)


def test_tiles_go_in_raster_order_axis_1_fastest():
    plan = tk3.plan_p2g3d_grid(7, 256, 256, 256)
    first = [plan.tile(b)[1:] for b in range(plan.nt1 + 1)]
    assert all(t[0] == 0 for t in first[:-1]) and first[-1][0] == plan.t0
    assert [t[2] for t in first[:-1]] == [plan.t1 * j for j in range(plan.nt1)]

