"""The launch plan of the 3D P2G + grid-update gather, on the CPU.

`p2g3d_grid` (csrc/p2g3d_grid.cu) launches one block per (shard, tile of
5 x GRID3D_ROWS target planes, z band); the planner
(`ops/cuda/transfer3d.plan_p2g3d_grid`) picks the band and how many
records a block stages at once (`cap`), and `GridPlan.tile` / `.sources`
/ `.columns` decode a block as the kernel decodes blockIdx.
These tests hold the plan to what the kernel relies on: every target node
of the padded grid (and of every shard window in the raw mode) owned by
exactly one block, no tile across two shards, each block's source rows
exactly those that can reach its tile, and the shared memory within the
card's.  Two CPU models hold the order of the sums: the kernel's counting
sort, warp by warp in any order, lists a chunk's entries (a slot and a
tile row) as a stable sort by key (tile row, base z column); and a
block's walk (its sequence of source slots, its parts of GRID3D_SEQ tags,
its chunks of at most `cap` entries and rounds of columns) lists every
tap of every slot exactly once, each node's in the order of a stable sort
by (chunk, base z column, source pencil, slot).
"""

import itertools

import numpy as np
import pytest

from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

SMEM_OPTIN = 232_448   # Hopper's opt-in shared memory per block
RESERVED = 1_024       # the system's share per block
THREADS, WARPS = tk3.GRID3D_THREADS, tk3.GRID3D_THREADS // 32

GRIDS = [
    # (R0, R1, shards): tile multiples, ragged rows, a window narrower than
    # a tile, and shard windows that the tile does not divide.
    (16, 16, 1), (13, 21, 1), (256, 256, 1), (1, 1, 1), (3, 40, 1),
    (15, 13, 3), (64, 64, 4), (20, 7, 4), (256, 256, 4), (36, 9, 6),
]


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
        assert q0hi - q0lo <= tk3.NT and q1hi - q1lo <= tk3.GRID3D_ROWS
        owners[shard, q0lo:q0hi, q1lo:q1hi] += 1
    assert (owners == 1).all()
    # The kernel's launch: gridDim.x = shards x ceil((L0 + 4) / 5) x
    # ceil((R1 + 4) / GRID3D_ROWS).
    assert plan.blocks == shards * -(-(l0 + 4) // 5) * -(-(r1 + 4) // tk3.GRID3D_ROWS)


@pytest.mark.parametrize("r0,r1,shards", GRIDS)
def test_sources_are_the_rows_that_reach_the_tile(r0, r1, shards):
    """A slot in source row i puts its taps on window planes i .. i + 4
    (base row i - 1 .. i + 1, three taps from plane base + 1), so plane q
    takes rows q - 4 .. q of its own shard: at most 9 x (GRID3D_ROWS + 4)
    pencils."""
    plan = tk3.plan_p2g3d_grid(7, 32, r0, r1, shards)
    l0 = r0 // shards
    for b in range(plan.blocks):
        _, q0lo, q0hi, q1lo, q1hi = plan.tile(b)
        for (lo, hi), (qlo, qhi), rows in zip(plan.sources(b), ((q0lo, q0hi), (q1lo, q1hi)),
                                              (l0, r1)):
            reach = [i for i in range(rows) if i + 4 >= qlo and i <= qhi - 1]
            assert list(range(lo, hi + 1)) == reach
        (a0, b0), (a1, b1) = plan.sources(b)
        assert max(b0 - a0 + 1, 0) * max(b1 - a1 + 1, 0) <= 9 * (tk3.GRID3D_ROWS + 4)


@pytest.mark.parametrize("apic", [False, True], ids=["pic", "apic"])
@pytest.mark.parametrize("nch", [7, 11])
@pytest.mark.parametrize("g2", [16, 32, 37, 64, 128, 256, 512])
def test_shared_memory_is_what_the_kernel_asks_for_and_fits(g2, nch, apic):
    """The kernel's launch computes the same bytes from `cap`: the chunk's
    records, the round's sums (GRID3D_ROWS x 5 x nch x GRID3D_COLS floats),
    the sort's (key, warp) counters and key starts, 257 step starts and
    8192 2-byte tags; two blocks share an SM."""
    plan = tk3.plan_p2g3d_grid(nch, g2, 256, 256, apic=apic)
    rec = 4 + (9 if apic else 3) + 9 + nch - 6
    assert plan.rec == 16 * -(-rec // 4)
    rows, cols = tk3.GRID3D_ROWS, tk3.GRID3D_COLS
    keys = rows * (cols + 2)
    fixed = (4 * (rows * tk3.NT * nch * cols + keys * WARPS + keys + 1 + 256 + 1)
             + 2 * tk3.GRID3D_SEQ)
    assert plan.smem == fixed + plan.cap * plan.rec
    assert plan.smem <= SMEM_OPTIN
    blocks = tk3.GRID3D_BLOCKS_PER_SM
    assert blocks * (plan.smem + RESERVED + tk3.GRID3D_SMEM_STATIC) <= tk3.SMEM_SM == 233_472
    # A chunk starts below cap - 32 GRID3D_ROWS entries (a step adds at
    # most that many): the kernel takes cap > 64 GRID3D_ROWS.  The chunk is
    # the longest that fits: one more record would not.
    assert plan.cap > 64 * rows
    more = plan.smem + plan.rec
    assert blocks * (more + RESERVED + tk3.GRID3D_SMEM_STATIC) > tk3.SMEM_SM


@pytest.mark.parametrize("g2", [1, 16, 256, 512, 513, 1000, 2049])
def test_bands_are_equal_and_own_every_column_once(g2):
    plan = tk3.plan_p2g3d_grid(7, g2, 16, 16)
    owners = [0] * g2
    for by in range(plan.bands):
        c0, c1 = plan.columns(by)
        # As the kernel decodes blockIdx.y: zb = by band, bw = min(band, G2 - zb).
        assert (c0, c1) == (by * plan.band, by * plan.band + min(plan.band, g2 - by * plan.band))
        for c in range(c0, c1):
            owners[c] += 1
    assert owners == [1] * g2
    # The fewest bands of at most 512 columns, cut as evenly as they go.
    n = -(-g2 // tk3.GRID3D_MAX_BAND)
    assert plan.bands == n and plan.band == -(-g2 // n) <= tk3.GRID3D_MAX_BAND


def test_tiles_go_in_raster_order_axis_1_fastest():
    plan = tk3.plan_p2g3d_grid(7, 256, 256, 256)
    first = [plan.tile(b)[1:] for b in range(plan.nt1 + 1)]
    assert [t[0] for t in first] == [0] * plan.nt1 + [tk3.NT]
    assert [t[2] for t in first[:-1]] == list(range(0, 260, tk3.GRID3D_ROWS))


def test_the_main_path_stages_a_pencil_row_of_kept_slots_at_once():
    """The 8M slab's stress mode (7 channels, PIC: 80-byte records) stages
    over a thousand records a chunk, the 11-channel modes (96 and 112
    bytes) over seven hundred; the slab's 45 (54 with two rows a tile)
    source pencils hold some 5,760 (6,900) live slots, within one part of
    GRID3D_SEQ tags."""
    assert tk3.plan_p2g3d_grid(7, 256, 256, 256, apic=False).cap > 1000
    assert tk3.plan_p2g3d_grid(11, 256, 256, 256, apic=False).cap > 800
    assert tk3.plan_p2g3d_grid(11, 128, 128, 128, apic=True).cap > 700
    assert 54 * 128 < tk3.GRID3D_SEQ


# ---------------------------------------------------------------------------
# CPU models of the order of the sums
# ---------------------------------------------------------------------------


def _step_ranges(sa, sb):
    """Each warp's contiguous range of steps [wa, wb) of a chunk's steps
    [sa, sb), as the kernel cuts them."""
    span = -(-(sb - sa) // WARPS)
    out = []
    for w in range(WARPS):
        wa = min(sb, sa + w * span)
        out.append((wa, min(sb, wa + span)))
    return out


def _counting_sort(keys, nkeys, ranges, warp_order):
    """The kernel's list of a chunk's entries: keys[v] the keys of slot v's
    entries (a key at most once a slot), ranges[w] warp w's steps of 32
    slots [wa, wb); count_step per (key, warp), exclusive_scan key-major,
    place_tag (each lane's rank among the step's lanes with that key), the
    warps run in `warp_order`.  Returns the entries (v, key) in list order
    and the key starts."""
    cnt = np.zeros(nkeys * WARPS, dtype=np.int64)
    slots = lambda w: range(32 * ranges[w][0], min(32 * ranges[w][1], len(keys)))
    for w in warp_order:
        for v in slots(w):
            for k in keys[v]:
                cnt[k * WARPS + w] += 1
    first = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    starts = [int(first[k * WARPS]) for k in range(nkeys)] + [int(cnt.sum())]
    order = [None] * int(cnt.sum())
    for w in warp_order:
        wa, wb = ranges[w]
        for st in range(wa, wb):
            lanes = range(32 * st, min(32 * st + 32, len(keys)))
            for k in sorted({k for v in lanes for k in keys[v]}):
                members = [v for v in lanes if k in keys[v]]
                for rank, v in enumerate(members):
                    order[int(first[k * WARPS + w]) + rank] = (v, k)
                first[k * WARPS + w] += len(members)
    return order, starts


@pytest.mark.parametrize("n,nb,seed", [(1, 3, 0), (37, 3, 1), (300, 5, 2), (768, 20, 3),
                                       (1024, 34, 4), (1000, 2, 5), (513, 30, 6),
                                       (256, 8, 7)])
def test_the_counting_sort_is_a_stable_sort_in_any_warp_order(n, nb, seed):
    rng = np.random.default_rng(seed)
    tags = rng.integers(-1, nb, (n, 2))
    keys = [[r * nb + int(tags[v, r]) for r in range(2) if tags[v, r] >= 0] for v in range(n)]
    want = sorted(((v, k) for v in range(n) for k in keys[v]), key=lambda e: (e[1], e[0]))
    nsteps = -(-n // 32)
    for order in (range(WARPS), reversed(range(WARPS)), rng.permutation(WARPS)):
        got, starts = _counting_sort(keys, 2 * nb, _step_ranges(0, nsteps), list(order))
        assert got == want
        assert starts == [sum(1 for e in want if e[1] < k) for k in range(2 * nb + 1)]


def _buckets(r0, r1, k, g2, seed, crowd=None):
    """Ragged pencils of gx (global on axis 1, shard-local on axis 0 is the
    caller's), slots outside the margin on both axes and z past both
    edges, as the card tests make them; `crowd` fills the pencils of a
    pair of slices to K."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, k + 1, (r0, r1))
    counts[::4, ::3] = 0
    if crowd is not None:
        counts[crowd] = k
    shape = (r0, r1, k)
    gx0 = np.arange(r0)[:, None, None] + rng.choice([-1, 0, 1, 2], shape) + 0.5 + rng.random(shape)
    gx1 = np.arange(r1)[None, :, None] + rng.choice([-1, 0, 1, -2], shape) + 0.5 + rng.random(shape)
    gx2 = rng.uniform(-1.0, g2 + 1.0, shape).astype(np.float32)
    return (gx0.astype(np.float32), gx1.astype(np.float32), gx2), counts


def _block_lists(plan, gx, counts, block, by, cap, part):
    """A CPU model of one block's walk (csrc/p2g3d_grid.cu): its sequence of
    source slots, walk 0's z range, its rounds of columns, its parts of
    `part` slots and its chunks of steps starting below cap - 64 entries,
    each chunk's list as the counting sort orders it.  Returns
    {(plane0, plane1, z): [(chunk, base z, sequence slot, slot), ...]} in
    the order each node sums them (slot: (row, i1, k)); and the number of
    chunks."""
    shard, q0lo, q0hi, q1lo, q1hi = plan.tile(block)
    h0, h1 = q0hi - q0lo, q1hi - q1lo
    (a0, b0), (a1, b1) = plan.sources(block)
    zb, ze = plan.columns(by)
    seq = []
    for i0 in range(a0, b0 + 1):
        for i1 in range(a1, b1 + 1):
            row = shard * plan.l0 + i0
            seq += [(row, i0, i1, k) for k in range(min(int(counts[row, i1]), gx[0].shape[2]))]

    def classify(v):
        """(base z, first axis-0 tile plane, the tile rows its axis-1 taps
        land on) of a kept slot, else None."""
        row, i0, i1, k = seq[v]
        base = [float(np.floor(np.float32(g[row, i1, k]) - np.float32(0.5))) for g in gx]
        rows = [r for r in range(h1) if 0 <= q1lo + r - 1 - base[1] <= 2]
        keep = (abs(base[0] - i0) <= 1 and abs(base[1] - i1) <= 1
                and -2 <= base[0] + 1 - q0lo <= h0 - 1 and rows
                and zb - 2 <= base[2] <= ze - 1)
        return (int(base[2]), int(base[0]) + 1 - q0lo, rows) if keep else None

    kept = [classify(v) for v in range(len(seq))]
    bases = [c[0] for c in kept if c is not None]
    lists, chunks = {}, 0
    if not bases:
        return lists, chunks
    zlo, zhi = max(zb, min(bases)), min(ze - 1, max(bases) + 2)
    nrow = tk3.GRID3D_ROWS
    cols, cmax = tk3.GRID3D_COLS, cap - 32 * nrow
    for c_lo in range(zlo, zhi + 1, cols):
        nr = min(cols, zhi - c_lo + 1)
        nb = nr + 2
        for s0 in range(0, len(seq), part):
            ns = min(part, len(seq) - s0)
            keys = [[] if c is None or not c_lo - 2 <= c[0] < c_lo - 2 + nb else
                     [r * nb + c[0] - (c_lo - 2) for r in c[2]] for c in kept[s0:s0 + ns]]
            nsteps = -(-ns // 32)
            step_entries = [sum(len(keys[v]) for v in range(32 * st, min(32 * st + 32, ns)))
                            for st in range(nsteps)]
            estart = np.concatenate([[0], np.cumsum(step_entries)[:-1]]).astype(int)
            entries = sum(step_entries)
            first_step = lambda e: int(np.searchsorted(estart, e, side="left"))
            j = 0
            while j * cmax < entries:
                sa, sb = first_step(j * cmax), first_step((j + 1) * cmax)
                chunk_keys = [k if sa <= v // 32 < sb else [] for v, k in enumerate(keys)]
                order, starts = _counting_sort(chunk_keys, nrow * nb, _step_ranges(sa, sb),
                                               range(WARPS))
                assert len(order) <= cap
                for r in range(h1):
                    for col in range(nr):
                        for pos in range(starts[r * nb + col], starts[r * nb + col + 3]):
                            v, _ = order[pos]
                            base2, t0, _ = kept[s0 + v]
                            slot = seq[s0 + v]
                            for j0 in range(3):
                                if 0 <= t0 + j0 < h0:
                                    key = (q0lo + t0 + j0, q1lo + r, c_lo + col)
                                    lists.setdefault(key, []).append(
                                        (chunks, base2, s0 + v, (slot[0], slot[2], slot[3])))
                chunks += 1
                j += 1
    return lists, chunks


@pytest.mark.parametrize("r0,r1,shards,k,g2,cap,part,crowd", [
    (6, 5, 1, 24, 12, 2000, 1024, None),   # one chunk, one round
    (7, 4, 1, 40, 9, 150, 1024, (slice(2, 4), slice(1, 3))),   # crowded: several chunks
    (7, 4, 1, 40, 9, 150, 700, (slice(2, 4), slice(1, 3))),    # and parts of tags
    (8, 3, 2, 20, 150, 256, 1024, None),   # shards; data over 150 columns: rounds
    (5, 6, 1, 16, 600, 512, 1024, None),   # two z bands
])
def test_every_tap_is_listed_once_in_a_fixed_order(r0, r1, shards, k, g2, cap, part, crowd):
    gx, counts = _buckets(r0, r1, k, g2, seed=r0 * 10 + g2, crowd=crowd)
    l0 = r0 // shards
    gx = (gx[0] - (np.arange(r0) // l0 * l0)[:, None, None].astype(np.float32), gx[1], gx[2])
    plan = tk3.plan_p2g3d_grid(7, g2, r0, r1, shards)
    got, most = {}, 0
    for b, by in itertools.product(range(plan.blocks), range(plan.bands)):
        lists, n = _block_lists(plan, gx, counts, b, by, cap, part)
        most = max(most, n)
        for (p0, p1, z), items in lists.items():
            node = (plan.tile(b)[0], p0, p1, z)
            assert node not in got          # one block owns each node
            # Each node's list: a stable sort by (chunk, base z column,
            # source pencil, slot), the sequence order within a chunk.
            assert [i[:3] for i in items] == sorted(i[:3] for i in items)
            got[node] = sorted(i[3] for i in items)
    # Against the taps computed slot by slot: each live in-margin slot's
    # 27 taps, z taps outside [0, G2) dropped, each listed exactly once.
    want = {}
    for row, i1 in itertools.product(range(r0), range(r1)):
        shard, i0 = divmod(row, l0)
        for kk in range(min(int(counts[row, i1]), k)):
            base = [int(np.floor(np.float32(g[row, i1, kk]) - np.float32(0.5))) for g in gx]
            if abs(base[0] - i0) > 1 or abs(base[1] - i1) > 1:
                continue
            for j0, j1, j2 in itertools.product(range(3), repeat=3):
                if 0 <= base[2] + j2 < g2:
                    node = (shard, base[0] + 1 + j0, base[1] + 1 + j1, base[2] + j2)
                    want.setdefault(node, []).append((row, i1, kk))
    assert got == {node: sorted(v) for node, v in want.items()} and got
    # The crowded cases sum some block's entries in several chunks.
    assert most > 1 or crowd is None
