"""The launch plans of the fixed-order P2G gathers, on the CPU.

`p2g`, `p2g_fused` and `p2g_grid` (csrc/p2g.cu, one gather on the
prepped, the fused or either of them over every shard's bucket rows)
launch one block per (bucket row, column band), and `p2g3d`
(csrc/p2g3d.cu) one per (i0, axis-1 row, z band); the planners
(`ops/cuda/transfer2d.plan_p2g`, `plan_p2g_fused`,
`transfer3d.plan_p2g3d`) pick the band and the number of slot records a
block stages at a time, and `GatherPlan.columns` decodes blockIdx.y as the
kernels do.  These tests hold the plans to what
the kernels rely on: every output column owned by exactly one band, the
bands as the kernels cut them, and the shared memory that the kernels'
launch asks for within Hopper's opt-in limit and, with the staging window
the planner picked, within an SM at the planned blocks per SM.
"""

import pytest

from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk
from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

SMEM_OPTIN = 232_448   # Hopper's opt-in shared memory per block
SMEM_SM = 233_472      # an SM's shared memory (228 KB)
RESERVED = 1_024       # the system's share per block

# (G, K): the bench and drop1M rows at 513^2, the ragged test shapes, the
# column-band case at G = 2049 and a narrow grid with crowded rows.
SHAPES_2D = [(513, 4096), (513, 5376), (37, 256), (513, 1024), (2049, 512), (64, 2048),
             (1, 16)]
# (G, K) of p2g_grid: bench 1M's shape on one device and in 4 shards (the
# sharded path's buckets are 25% wider: 5120 slots), stab1M's 4 shards
# alike, the ragged card-test shapes, the tent case at G = 2049 and a
# narrow grid.
SHAPES_GRID = [(513, 4096), (513, 5120), (513, 512), (2049, 1024), (2049, 5120), (37, 256)]
# (G2, K): the 8M slab and drop3d pencils, the ragged test shapes, the z
# bands at G2 = 2049 and a crowded pencil.
SHAPES_3D = [(256, 512), (128, 1280), (16, 128), (64, 128), (2049, 128), (32, 1024), (1, 8)]


def _plans():
    for g, k in SHAPES_2D:
        for nch in (tk.P2G_CH, tk.P2G_CH_EXT):
            for apic in (False, True):
                rec = 4 * -(-(5 + 4 * apic + 4 + nch - 4) // 4)
                yield ("2d", g, k, nch, apic), tk.plan_p2g(nch, g, k, apic), dict(
                    rec=rec, order=k, warps=tk.P2G_WARPS, blocks=tk.P2G_BLOCKS_PER_SM,
                    max_band=tk.P2G_MAX_BAND)
    for g, k in SHAPES_2D:
        for apic in (False, True):
            rec = 4 * -(-(5 + 4 * apic + 4 + 1) // 4)
            yield ("fused", g, k, tk.P2G_CH_FUSED, apic), tk.plan_p2g_fused(g, k, apic), dict(
                rec=rec, order=k, warps=tk.P2G_WARPS, blocks=tk.P2G_BLOCKS_PER_SM,
                max_band=tk.P2G_MAX_BAND)
    for g, k in SHAPES_GRID:
        for nch in (tk.P2G_CH_FUSED, tk.P2G_CH, tk.P2G_CH_EXT):
            for apic in (False, True):
                rec = 4 * -(-(5 + 4 * apic + 4 + nch - 4) // 4)
                yield ("grid", g, k, nch, apic), tk.plan_p2g(nch, g, k, apic), dict(
                    rec=rec, order=k, warps=tk.P2G_WARPS, blocks=tk.P2G_BLOCKS_PER_SM,
                    max_band=tk.P2G_MAX_BAND)
    for g, k in SHAPES_3D:
        for nch in (tk3.P2G_CH, tk3.P2G_CH_EXT):
            for apic in (False, True):
                rec = 4 * -(-(4 + (9 if apic else 3) + 9 + nch - 6) // 4)
                yield ("3d", g, k, nch, apic), tk3.plan_p2g3d(nch, g, k, apic), dict(
                    rec=rec, order=tk3.NT * k, warps=tk3.P2G3D_WARPS,
                    blocks=tk3.P2G3D_BLOCKS_PER_SM, max_band=tk3.P2G3D_MAX_BAND)


PLANS = list(_plans())
IDS = ["%s_g%d_k%d_ch%d_%s" % (*case[:4], "apic" if case[4] else "pic") for case, _, _ in PLANS]


@pytest.mark.parametrize("case,plan,want", PLANS, ids=IDS)
def test_every_column_is_owned_by_exactly_one_band(case, plan, want):
    g = case[1]
    owners = [0] * g
    for by in range(plan.bands):
        c0, c1 = plan.columns(by)
        # As the kernels decode blockIdx.y: c0 = by band, bw = min(band, G - c0).
        assert (c0, c1) == (by * plan.band, by * plan.band + min(plan.band, g - by * plan.band))
        assert 0 <= c0 < c1 <= g
        for c in range(c0, c1):
            owners[c] += 1
    assert owners == [1] * g
    # The kernels' launch: gridDim.y = (G + band - 1) / band.
    assert plan.bands == (g + plan.band - 1) // plan.band


@pytest.mark.parametrize("case,plan,want", PLANS, ids=IDS)
def test_bands_are_equal_and_no_wider_than_the_limit(case, plan, want):
    g = case[1]
    assert 1 <= plan.band <= min(g, want["max_band"])
    # The fewest bands of at most max_band columns, cut as evenly as they go.
    n = -(-g // want["max_band"])
    assert plan.bands == n and plan.band == -(-g // n)


@pytest.mark.parametrize("case,plan,want", PLANS, ids=IDS)
def test_shared_memory_is_what_the_kernel_asks_for_and_fits(case, plan, want):
    """The kernels' launch computes the same bytes from (band, cap): the
    staged records, the (band + 2) x warps sort counters, band + 3 bin
    starts, the list of source slots and as many 2-byte tags."""
    order = want["order"]
    assert plan.rec == 4 * want["rec"] and plan.order == order
    assert plan.smem == (plan.cap * plan.rec
                         + 4 * ((plan.band + 2) * want["warps"] + plan.band + 3 + order)
                         + 2 * (order + order % 2))
    assert plan.smem <= SMEM_OPTIN
    assert min(tk.MIN_CAP, max(order, 1)) <= plan.cap <= max(order, 1)
    # Past MIN_CAP the window is the widest that lets the planned blocks
    # share an SM.
    if plan.cap > tk.MIN_CAP:
        assert want["blocks"] * (plan.smem + RESERVED + tk.SMEM_STATIC) <= SMEM_SM


@pytest.mark.parametrize("blocks", [2, 3, 4])
def test_the_window_grows_with_the_budget_of_fewer_blocks(blocks):
    plan = tk.plan_gather(513, 14, 4096, 256, 8, blocks)
    wider = tk.plan_gather(513, 14, 4096, 256, 8, blocks - 1)
    assert wider.cap >= plan.cap and wider.band == plan.band


def test_a_bucket_too_large_for_the_shared_memory_raises():
    with pytest.raises(ValueError, match="shared memory"):
        tk.plan_p2g(tk.P2G_CH_EXT, 513, 60_000, True)
    with pytest.raises(ValueError, match="shared memory"):
        tk3.plan_p2g3d(tk3.P2G_CH_EXT, 256, 12_000, True)


@pytest.mark.parametrize("plan", [
    lambda k: tk.plan_p2g_fused(513, k, False),
    lambda k: tk.plan_p2g_fused(513, k, True),
    lambda k: tk.plan_p2g(tk.P2G_CH_EXT, 513, k, True),
    lambda k: tk.plan_p2g(tk.P2G_CH_EXT, 2049, k, False),
], ids=["fused_pic", "fused_apic", "ch9_apic", "ch9_g2049"])
def test_the_fused_and_grid_plans_raise_past_their_k_limit(plan):
    """A bucket row's K slots are listed in shared memory: the largest K
    that fits plans, the next multiple of 128 past the limit raises and
    names its slots."""
    k = 128
    while True:
        try:
            plan(k + 128)
        except ValueError:
            break
        k += 128
    assert k >= 30_000                    # far past the scenes' 4,096-5,376
    assert plan(k).smem <= SMEM_OPTIN
    with pytest.raises(ValueError, match=f"{k + 128} source slots.*shared memory"):
        plan(k + 128)


def test_the_3d_main_path_stages_every_kept_slot_at_once():
    """At the 8M slab (relfloor3d: K = 512, 11 channels, PIC) a block keeps
    some 384 of its five 128-slot pencils' slots: even all 640 fit one
    window, so csrc/p2g3d.cu places them straight from its registers."""
    assert tk3.plan_p2g3d(tk3.P2G_CH_EXT, 256, 512, False).cap >= 640
