"""`parallel.mesh.RankMesh` on 2 and 4 gloo ranks against `SlabMesh` on the same blocks.

Each rank holds one block of a seeded (n, ...) stack; the rank mesh's
collectives (point-to-point shifts with zero fill at the ends, `psum`,
`pmax`, `any`, `all_gather`) must give each rank what `SlabMesh` gives
that shard of the stack, bit for bit (the blocks hold small integers, so
every sum is exact in any order).  A rank that raises surfaces in the
parent with its traceback, and a collective that the other rank never
joins fails within the process group's timeout (on the rank that times
out first; its neighbour may see the connection close first).  The four
launches run at once.
"""

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from mpm_flip98a_tpu_torch.parallel import SlabMesh, launch
from mpm_flip98a_tpu_torch.parallel.mesh import shared_cards

SHAPE = (5, 3)
MISMATCH_TIMEOUT_S = 2.0
METHODS = ("shift_left", "shift_right", "psum", "pmax", "any", "all_gather")


def _blocks(n, seed):
    rng = np.random.default_rng(seed)
    return {
        "float64": rng.integers(-50, 50, (n,) + SHAPE).astype(np.float64),
        "float32": rng.integers(-50, 50, (n,) + SHAPE).astype(np.float32),
        "int64": rng.integers(-50, 50, (n,) + SHAPE).astype(np.int64),
        "flags": (rng.random((n, 4)) < 0.3).astype(np.int32),
    }


def _calls(n, seed):
    calls = []
    for kind, blocks in _blocks(n, seed).items():
        for m in (("any",) if kind == "flags" else METHODS[:4] + METHODS[5:]):
            calls.append(([m] * n, blocks, [{}] * n))
    # Variable row counts: rank i sends i rows to the left, so rank i
    # receives i + 1 rows from rank i + 1 (the last rank none).
    rows = [np.arange(i * 2, dtype=np.float64).reshape(i, 2) for i in range(n)]
    calls.append((["shift_left"] * n, rows,
                  [{"rows": i + 1 if i + 1 < n else 0} for i in range(n)]))
    return calls


def _outcome(call):
    """(what the launch returned or raised, its seconds)."""
    t0 = time.perf_counter()
    try:
        out = call()
    except Exception as e:    # the test reads what the launch raised
        out = e
    return out, time.perf_counter() - t0


@pytest.fixture(scope="module")
def launched():
    two_ranks = np.ones((2, 3))
    runs = {
        2: lambda: launch.run_ranks(launch.mesh_calls, 2, args=(_calls(2, 0),), device="cpu",
                                    backend="gloo", timeout_s=30.0, deadline_s=120.0),
        4: lambda: launch.run_ranks(launch.mesh_calls, 4, args=(_calls(4, 1),), device="cpu",
                                    backend="gloo", timeout_s=30.0, deadline_s=120.0),
        # Rank 1 raises (a RankMesh has one axis) while rank 0 waits on it.
        "raises": lambda: launch.run_ranks(
            launch.mesh_calls, 2, device="cpu", backend="gloo", timeout_s=30.0,
            deadline_s=120.0,
            args=([(["shift_left", "shift_left"], two_ranks, [{}, {"axis": 1}])],)),
        # Rank 0 waits on a shift, rank 1 on a psum: neither ever completes.
        "mismatch": lambda: launch.run_ranks(
            launch.mesh_calls, 2, device="cpu", backend="gloo", timeout_s=MISMATCH_TIMEOUT_S,
            deadline_s=120.0, args=([(["shift_left", "psum"], two_ranks, [{}, {}])],)),
    }
    with ThreadPoolExecutor(len(runs)) as pool:
        futures = {k: pool.submit(_outcome, run) for k, run in runs.items()}
        return {k: f.result() for k, f in futures.items()}



@pytest.mark.parametrize("n", [2, 4])
def test_collectives_equal_slab_mesh(launched, n):
    got = launched[n][0]
    assert not isinstance(got, Exception), got
    slab = SlabMesh(n, torch.device("cpu"))
    for j, (methods, blocks, _) in enumerate(_calls(n, 0 if n == 2 else 1)[:-1]):
        stack = torch.from_numpy(blocks)
        if methods[0] == "all_gather":
            want = [blocks] * n
        elif methods[0] in ("psum", "pmax", "any"):
            want = [getattr(slab, methods[0])(stack).numpy()] * n
        else:
            want = getattr(slab, methods[0])(stack).numpy()
        for r in range(n):
            assert got[r][j].dtype == np.asarray(want[r]).dtype, (methods[0], blocks.dtype)
            np.testing.assert_array_equal(got[r][j], want[r], err_msg=f"{methods[0]} rank {r}")


@pytest.mark.parametrize("n", [2, 4])
def test_shift_left_with_row_counts(launched, n):
    got = [launched[n][0][r][-1] for r in range(n)]
    for r in range(n):
        want = (np.arange((r + 1) * 2, dtype=np.float64).reshape(r + 1, 2) if r + 1 < n
                else np.zeros((0, 2)))
        np.testing.assert_array_equal(got[r], want)


def test_a_raising_rank_surfaces_in_the_parent(launched):
    err = launched["raises"][0]
    assert isinstance(err, launch.RankError), err
    assert "rank 1 of 2 failed" in str(err) and "a RankMesh has one axis" in str(err)


def test_a_mismatched_collective_fails_within_its_timeout(launched):
    err, seconds = launched["mismatch"]
    assert isinstance(err, launch.RankError), err
    assert "Timed out" in str(err) or "Connection closed by peer" in str(err), str(err)[-2000:]
    # Starting two ranks takes a few seconds; a hang would run to the
    # 120 s deadline.
    assert seconds < MISMATCH_TIMEOUT_S + 40.0, seconds


def test_shared_cards():
    assert shared_cards(["h:a", "h:b", "h:a"]) == [0, 2]
    assert shared_cards(["h:a", "h:b"]) == []
