"""The port's kernels and their glue against the reference.

On the CPU the kernel wrappers run their plain versions, so these tests
hold the wrappers' plumbing (trash row, masks, chunk padding, tile
bucketing, the plan) and the plain versions against the reference's
oracles (``repro.kernels.ref``), bit for bit.  The installed JAX cannot
trace the Pallas propagate kernels themselves, so the oracles, not the
Pallas calls, are the reference.  ``tests/test_torch_cuda.py`` holds the
CUDA kernels against their plain versions on the card.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax                                           # noqa: E402
import jax.numpy as jnp                              # noqa: E402
import torch                                         # noqa: E402

from repro.kernels import ops as jops                # noqa: E402
from repro.kernels import ref as jref                # noqa: E402
from repro.kernels.bitmap_update import bitmap_update as j_bitmap_update  # noqa: E402
from repro.kernels.bitmap_update import (  # noqa: E402
    bitmap_update_batch as j_bitmap_update_batch)
from repro_torch.interop import planes_from_numpy, planes_to_numpy  # noqa: E402
from repro_torch.kernels import bitmap_update as kbu  # noqa: E402
from repro_torch.kernels import msbfs_propagate as kmod  # noqa: E402
from repro_torch.kernels import ops, ref             # noqa: E402

TILE, BLOCK = 16, 32

# the reference oracles, jitted: one XLA compile per shape instead of one
# per eager op keeps this file fast on the CPU
_planes_ref = jax.jit(jref.msbfs_propagate_planes_ref, static_argnames="op")
_msgs_ref = jax.jit(jref.msbfs_propagate_msgs_ref, static_argnames="op")
_bucket_ref = jax.jit(jops._bucket_edges_by_tile, static_argnums=(3, 4, 5))


def _p(words, dev="cpu"):
    return planes_from_numpy(words, dev)


def _i(a, dev="cpu"):
    return torch.from_numpy(np.asarray(a, np.int32)).to(dev)


def _b(a, dev="cpu"):
    return torch.from_numpy(np.asarray(a, bool)).to(dev)


def _assert_outputs(got, want, what=""):
    for g, w, name in zip(got, want, ("new", "seen", "cnt")):
        g = (planes_to_numpy(g) if name != "cnt"
             else g.numpy().astype(np.int64))
        w = np.asarray(w)
        if name == "cnt":
            w = w.astype(np.int64)
        np.testing.assert_array_equal(g.reshape(-1), w.reshape(-1),
                                      err_msg=f"{what}: {name}")


# ---------------------------------------------------------------------------
# whole-array kernel (K1) and ops.msbfs_propagate — tests/test_kernels.py
# ---------------------------------------------------------------------------

def _propagate_case(n_rows, nw, m, seed):
    rng = np.random.default_rng(seed)
    frontier = rng.integers(0, 2**32, (n_rows, nw), dtype=np.uint32)
    frontier[-1] = 0                       # trash-row contract
    seen = rng.integers(0, 2**32, (n_rows, nw), dtype=np.uint32)
    seen[-1] = 0xFFFFFFFF
    src = rng.integers(0, n_rows, m, dtype=np.int32)   # duplicates likely
    tgt = rng.integers(0, n_rows, m, dtype=np.int32)
    return frontier, seen, src, tgt


@pytest.mark.parametrize("op", ["or", "max"])
@pytest.mark.parametrize("n_rows,nw,m", [(33, 1, 64), (65, 2, 128),
                                         (129, 1, 256), (17, 3, 96)])
def test_planes_kernel_plain_vs_reference(n_rows, nw, m, op):
    f, s, src, tgt = _propagate_case(n_rows, nw, m, seed=m + nw)
    got = kmod.msbfs_propagate_planes(_p(f), _p(s), _i(src), _i(tgt), op=op)
    want = _planes_ref(jnp.asarray(f), jnp.asarray(s), jnp.asarray(src),
                       jnp.asarray(tgt), op=op)
    _assert_outputs(got, want)


@pytest.mark.parametrize("op", ["or", "max"])
def test_planes_combine_ops_disagree_on_collisions(op):
    """Colliding targets whose OR differs from their unsigned max."""
    f, s, src, tgt = _propagate_case(65, 2, 192, seed=21)
    tgt[:64] = tgt[0]
    got = kmod.msbfs_propagate_planes(_p(f), _p(s), _i(src), _i(tgt), op=op)
    args = [jnp.asarray(a) for a in (f, s, src, tgt)]
    want = _planes_ref(*args, op=op)
    _assert_outputs(got, want)
    other = _planes_ref(*args, op="max" if op == "or" else "or")
    assert not np.array_equal(np.asarray(want[0]), np.asarray(other[0]))


def test_rejects_unknown_op():
    f, s, src, tgt = _propagate_case(17, 1, 8, seed=1)
    with pytest.raises(ValueError, match="op"):
        kmod.msbfs_propagate_planes(_p(f), _p(s), _i(src), _i(tgt), op="xor")
    with pytest.raises(ValueError, match="op"):
        ref.msbfs_propagate_planes_ref(_p(f), _p(s), _i(src), _i(tgt),
                                       op="xor")


@pytest.mark.parametrize("op", ["or", "max"])
@pytest.mark.parametrize("tile_rows", [0, None, 16])
def test_ops_masks_and_pads(op, tile_rows):
    """Invalid / OOR (negative and >= n) edges drop, m is not a chunk
    multiple, the count is exact — whole-array, auto and tiled plans."""
    rng = np.random.default_rng(5)
    n, nw, m = 50, 2, 777
    f = rng.integers(0, 2**32, (n, nw), dtype=np.uint32)
    s = rng.integers(0, 2**32, (n, nw), dtype=np.uint32)
    src = rng.integers(-2, n + 3, m).astype(np.int32)
    tgt = rng.integers(-2, n + 3, m).astype(np.int32)
    valid = rng.random(m) < 0.7
    new, vout, cnt = ops.msbfs_propagate(_p(f), _p(s), _i(src), _i(tgt),
                                         _b(valid), block_edges=128, op=op,
                                         tile_rows=tile_rows)
    ok = valid & (src >= 0) & (src < n) & (tgt >= 0) & (tgt < n)
    msg = np.where(ok[:, None], f[np.clip(src, 0, n - 1)], 0)
    want = _msgs_ref(jnp.asarray(s), jnp.asarray(msg), jnp.asarray(tgt),
                     jnp.asarray(ok), op=op)
    _assert_outputs((new, vout, cnt), want)
    if op == "or":                         # independent per-edge loop
        cand = np.zeros_like(f)
        for e in range(m):
            if ok[e]:
                cand[tgt[e]] |= f[src[e]]
        np.testing.assert_array_equal(planes_to_numpy(new), cand & ~s)


def test_ops_empty_edge_list():
    f = np.ones((8, 1), np.uint32)
    s = np.zeros((8, 1), np.uint32)
    new, vout, cnt = ops.msbfs_propagate(_p(f), _p(s), _i([]), _i([]),
                                         _b([]))
    assert int(cnt) == 0 and not new.any()
    np.testing.assert_array_equal(planes_to_numpy(vout), s)


# ---------------------------------------------------------------------------
# tiled kernel (K2), bucketing, msgs form — tests/test_msbfs_tiled.py
# ---------------------------------------------------------------------------

def _planes(n, nw, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2**32, (n, nw), dtype=np.uint32),
            rng.integers(0, 2**32, (n, nw), dtype=np.uint32))


def _assert_tiled_matches(frontier, seen, src, tgt, valid, op="or"):
    """Tiled == whole-array == the reference's msgs oracle, bit for bit."""
    n = frontier.shape[0]
    args = (_p(frontier), _p(seen), _i(src), _i(tgt), _b(valid))
    got_t = ops.msbfs_propagate(*args, block_edges=BLOCK, op=op,
                                tile_rows=TILE)
    got_w = ops.msbfs_propagate(*args, block_edges=BLOCK, op=op,
                                tile_rows=0)
    ok = valid & (src >= 0) & (src < n) & (tgt >= 0) & (tgt < n)
    msg = np.where(ok[:, None], frontier[np.clip(src, 0, n - 1)], 0)
    want = _msgs_ref(
        jnp.asarray(seen), jnp.asarray(msg), jnp.asarray(tgt),
        jnp.asarray(ok), op=op)
    _assert_outputs(got_t, want, "tiled")
    _assert_outputs(got_w, want, "whole")
    # the msgs entry on the same edges
    got_m = ops.msbfs_propagate_msgs(_p(seen), _p(msg.astype(np.uint32)),
                                     _i(tgt), _b(valid), tile_rows=TILE,
                                     block_edges=BLOCK, op=op)
    _assert_outputs(got_m, want, "msgs")


@pytest.mark.parametrize("batch", [1, 32, 48])
@pytest.mark.parametrize("op", ["or", "max"])
def test_tiled_random(batch, op):
    nw = (batch + 31) // 32
    n, m = 100, 700
    frontier, seen = _planes(n, nw, seed=batch * 7 + len(op))
    rng = np.random.default_rng(batch * 13 + len(op))
    src = rng.integers(-2, n + 3, m).astype(np.int32)
    tgt = rng.integers(-2, n + 3, m).astype(np.int32)
    valid = rng.random(m) < 0.85
    _assert_tiled_matches(frontier, seen, src, tgt, valid, op=op)


def test_tiled_tile_boundary_straddling():
    n, nw = 8 * TILE, 2
    frontier, seen = _planes(n, nw, seed=3)
    bounds = np.arange(TILE, n, TILE, dtype=np.int32)
    tgt = np.tile(np.concatenate([bounds - 1, bounds, bounds + 1,
                                  np.asarray([0, n - 1], np.int32)]), 5)
    src = np.random.default_rng(4).integers(0, n, tgt.size).astype(np.int32)
    _assert_tiled_matches(frontier, seen, src, tgt, np.ones(tgt.size, bool))


@pytest.mark.parametrize("op", ["or", "max"])
def test_tiled_hub_source_spans_tiles(op):
    n = 6 * TILE
    frontier, seen = _planes(n, 1, seed=11)
    tgt = np.arange(0, 5 * TILE, dtype=np.int32)
    src = np.full(tgt.size, 7, np.int32)
    _assert_tiled_matches(frontier, seen, src, tgt, np.ones(tgt.size, bool),
                          op=op)


def test_tiled_hub_target_overflows_chunk():
    n = 5 * TILE
    frontier, seen = _planes(n, 1, seed=17)
    m = 6 * BLOCK + 11
    rng = np.random.default_rng(18)
    src = rng.integers(0, n, m).astype(np.int32)
    tgt = np.full(m, 2 * TILE + 3, np.int32)
    tgt[::13] = rng.integers(0, n, tgt[::13].size)
    _assert_tiled_matches(frontier, seen, src, tgt, np.ones(m, bool))


def test_tiled_empty_tiles_and_all_invalid():
    frontier, seen = _planes(7 * TILE, 1, seed=23)
    _assert_tiled_matches(frontier, seen, np.arange(40, dtype=np.int32),
                          np.full(40, 3, np.int32), np.ones(40, bool))
    frontier, seen = _planes(3 * TILE, 1, seed=29)
    _assert_tiled_matches(frontier, seen, np.arange(50, dtype=np.int32),
                          np.arange(50, dtype=np.int32) % (3 * TILE),
                          np.zeros(50, bool))


@pytest.mark.parametrize("n", [TILE + 1, 3 * TILE - 1, 37])
def test_tiled_rows_not_tile_multiple(n):
    frontier, seen = _planes(n, 1, seed=n)
    rng = np.random.default_rng(n + 1)
    src = rng.integers(0, n, 200).astype(np.int32)
    tgt = rng.integers(0, n, 200).astype(np.int32)
    _assert_tiled_matches(frontier, seen, src, tgt, np.ones(200, bool))


@pytest.mark.parametrize("num_tiles,tile_rows,block,m", [
    (4, 16, 32, 150), (7, 16, 32, 40), (3, 10, 8, 90), (1, 64, 1024, 5)])
def test_bucket_edges_equal_reference(num_tiles, tile_rows, block, m):
    """``_bucket_edges_by_tile`` outputs equal the reference's (plain jnp
    there, so it runs on the CPU), dropped slots included."""
    rng = np.random.default_rng(m + num_tiles)
    n = num_tiles * tile_rows
    msg = rng.integers(0, 2**32, (m, 2), dtype=np.uint32)
    tgt = rng.integers(-3, n + 3, m).astype(np.int32)
    ok = (rng.random(m) < 0.8) & (tgt >= 0) & (tgt < n)
    msg = np.where(ok[:, None], msg, 0).astype(np.uint32)
    *got, tile_chunks = ops._bucket_edges_by_tile(
        _p(msg), _i(tgt), _b(ok), num_tiles, tile_rows, block)
    want = _bucket_ref(jnp.asarray(msg), jnp.asarray(tgt), jnp.asarray(ok),
                       num_tiles, tile_rows, block)
    np.testing.assert_array_equal(planes_to_numpy(got[0]),
                                  np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.dtype == torch.int32
    # the run heads: each tile's chunks that hold its edges
    counts = np.bincount(tgt[ok] // tile_rows, minlength=num_tiles)
    np.testing.assert_array_equal(tile_chunks.numpy(), -(-counts // block))
    assert tile_chunks.dtype == torch.int32
    # the tiled kernel's plain version on that stream == the msgs oracle
    seen = rng.integers(0, 2**32, (n, 2), dtype=np.uint32)
    out = kmod.msbfs_propagate_planes_tiled(_p(seen), *got, tile_chunks,
                                            tile_rows, block)
    want_o = _msgs_ref(jnp.asarray(seen), jnp.asarray(msg),
                       jnp.asarray(tgt), jnp.asarray(ok))
    _assert_outputs(out, want_o)


def _pad_heavy_stream(num_tiles=6, tile_rows=16, block=8, m=40_000,
                      real=30, seed=3):
    """A budgeted edge list of ``m`` slots with only ``real`` valid edges:
    its stream ends in thousands of pad chunks, all ridden by the last
    tile.  Returns (msg, tgt, ok, bucketing outputs)."""
    rng = np.random.default_rng(seed)
    n = num_tiles * tile_rows
    msg = np.zeros((m, 2), np.uint32)
    ok = np.zeros(m, bool)
    at = rng.choice(m, real, replace=False)
    ok[at] = True
    msg[at] = rng.integers(1, 2**32, (real, 2), dtype=np.uint32)
    tgt = rng.integers(0, n, m).astype(np.int32)
    tgt[at[:5]] = n - 1                       # the last tile has edges too
    out = ops._bucket_edges_by_tile(_p(msg), _i(tgt), _b(ok), num_tiles,
                                    tile_rows, block)
    return msg, tgt, ok, out


def test_run_ends_stop_at_real_chunks():
    """K2's runs end at each tile's real chunks: with thousands of
    trailing pad chunks, the last tile's run is its real chunks only,
    where its chunks in ``chunk_tile`` span them all."""
    t_, tr, blk = 6, 16, 8
    msg, tgt, ok, (sm, st, ct, tc) = _pad_heavy_stream(t_, tr, blk)
    nc = ct.shape[0]
    counts = np.bincount(tgt[ok] // tr, minlength=t_)
    assert counts[-1] >= 5
    first = np.searchsorted(ct.numpy(), np.arange(t_))
    trailing = nc - first[-1] - tc[-1].item()
    assert trailing > 4000                    # the pad chunks of the budget
    run_first, work_off = kmod._tile_runs(ct, tc, t_, blk)
    np.testing.assert_array_equal(run_first.numpy(), first * blk)
    np.testing.assert_array_equal(np.diff(work_off.numpy()),
                                  -(-counts // blk) * blk)
    assert np.diff(work_off.numpy())[-1] == -(-counts[-1] // blk) * blk
    # every slot past a run's end carries a zero message
    live = np.zeros(sm.shape[0], bool)
    for f, w in zip(run_first.numpy(), np.diff(work_off.numpy())):
        live[f: f + w] = True
    assert not sm.numpy()[~live].any()
    # the runs read no pad chunk: far fewer slots than the stream holds
    assert work_off[-1].item() == (-(-counts // blk)).sum() * blk
    assert work_off[-1].item() < (nc - 4000) * blk
    # a run never reaches past the next tile's first chunk
    short = torch.full((t_,), nc, dtype=torch.int32)
    _, capped = kmod._tile_runs(ct, short, t_, blk)
    np.testing.assert_array_equal(np.diff(capped.numpy()),
                                  np.diff(np.append(first, nc)) * blk)


@pytest.mark.parametrize("op", ["or", "max"])
def test_tiled_wrapper_tile_chunks_equal_none(op):
    """Given the run heads, K2's wrapper gives the words and count of its
    plain version, which reads every chunk (no run heads), and of the
    msgs oracle; a run-head array of the wrong length is refused."""
    t_, tr, blk = 6, 16, 8
    msg, tgt, ok, (sm, st, ct, tc) = _pad_heavy_stream(t_, tr, blk, seed=7)
    n = t_ * tr
    seen = np.random.default_rng(8).integers(0, 2**32, (n, 2),
                                             dtype=np.uint32)
    got = kmod.msbfs_propagate_planes_tiled(_p(seen), sm, st, ct, tc, tr,
                                            blk, op=op)
    for g, w in zip(got, ref.msbfs_propagate_planes_tiled_ref(
            _p(seen), sm, st, ct, tr, blk, op=op)):
        assert torch.equal(g, w)
    want = _msgs_ref(jnp.asarray(seen), jnp.asarray(msg), jnp.asarray(tgt),
                     jnp.asarray(ok), op=op)
    _assert_outputs(got, want)
    with pytest.raises(ValueError, match="tile_chunks"):
        kmod.msbfs_propagate_planes_tiled(_p(seen), sm, st, ct, tc[1:], tr,
                                          blk, op=op)


@pytest.mark.parametrize("num_tiles,m", [(1, 50), (7, 400), (290, 20_000)])
def test_key_start_counts_equal_scatter_add(num_tiles, m):
    """The bucket counts from the sorted keys equal a ``scatter_add_``
    count of the same keys, the dropped edges' bin included."""
    rng = np.random.default_rng(num_tiles)
    keys = torch.from_numpy(rng.integers(0, num_tiles + 1, m).astype(
        np.int16))
    keys_sorted, _ = torch.sort(keys, stable=True)
    starts = ops._key_starts(keys_sorted, num_tiles + 1)
    want = torch.zeros(num_tiles + 1, dtype=torch.int64)
    want.scatter_add_(0, keys.to(torch.int64), torch.ones(m,
                                                          dtype=torch.int64))
    assert starts[0] == 0 and starts[-1] == m
    np.testing.assert_array_equal((starts[1:] - starts[:-1]).numpy(),
                                  want.numpy())


def test_propagate_plan_semantics():
    nw = 2
    small = ops.propagate_plan(100, nw)
    assert small == dict(tiled=False, tile_rows=0, num_tiles=1,
                         footprint_bytes=4 * 101 * nw * 4)
    big_n = kmod.MAX_SMEM_PER_BLOCK             # footprint >> budget
    tr = ops._auto_tile_rows(nw)
    big = ops.propagate_plan(big_n, nw, tile_rows=tr)
    assert big["tiled"] and big["tile_rows"] == tr
    assert big["num_tiles"] == -(-big_n // big["tile_rows"])
    assert big["tile_rows"] % 8 == 0
    assert big["tile_rows"] * nw * 4 <= kmod.MAX_SMEM_PER_BLOCK
    assert not ops.propagate_plan(big_n, nw, tile_rows=0)["tiled"]
    forced = ops.propagate_plan(100, nw, tile_rows=16)
    assert forced["tiled"] and forced["num_tiles"] == 7
    with pytest.raises(ValueError):
        ops.propagate_plan(100, nw, tile_rows=-1)
    # rmat20 at B=64 and B=256: the auto plan is the whole-array kernel,
    # the faster wave in chip_smoke.py's turns on the H100 at both
    for b in (64, 256):
        r20 = ops.propagate_plan(1 << 20, -(-b // 32))
        assert not r20["tiled"]
        assert r20["footprint_bytes"] == 4 * ((1 << 20) + 1) * (b // 32) * 4
    # an explicit plan is the reference's, given the card's budget
    for n_rows in (100, 70000):
        for t in (0, 16, tr):
            j = jops.propagate_plan(n_rows, nw, tile_rows=t,
                                    vmem_bytes=kmod.MAX_SMEM_PER_BLOCK)
            assert j == ops.propagate_plan(n_rows, nw, tile_rows=t)


@pytest.mark.parametrize("n_rows,nw", [(100, 1), (70_000, 1),
                                       ((1 << 20) + 32, 2), (1 << 20, 8),
                                       (1 << 22, 2)])
def test_propagate_plan_auto_is_whole_array(n_rows, nw):
    """Inside the L2 and far outside it, the auto plan never tiles; the
    reference's rule (tile past its VMEM budget) would tile all but the
    smallest."""
    plan = ops.propagate_plan(n_rows, nw)
    assert plan == dict(tiled=False, tile_rows=0, num_tiles=1,
                        footprint_bytes=4 * (n_rows + 1) * nw * 4)
    assert plan == ops.propagate_plan(n_rows, nw, tile_rows=0)


@pytest.mark.parametrize("nw", [3, 4, 8])
def test_bucket_edges_wide_rows_equal_reference(nw):
    """Rows of 16 and 32 bytes (gathered as 8-byte pieces) and of 12
    bytes bucket as the reference does."""
    rng = np.random.default_rng(nw)
    num_tiles, tile_rows, block, m = 5, 16, 32, 700
    n = num_tiles * tile_rows
    msg = rng.integers(0, 2**32, (m, nw), dtype=np.uint32)
    tgt = rng.integers(-3, n + 3, m).astype(np.int32)
    ok = (rng.random(m) < 0.8) & (tgt >= 0) & (tgt < n)
    msg = np.where(ok[:, None], msg, 0).astype(np.uint32)
    got = ops._bucket_edges_by_tile(_p(msg), _i(tgt), _b(ok), num_tiles,
                                    tile_rows, block)
    want = _bucket_ref(jnp.asarray(msg), jnp.asarray(tgt), jnp.asarray(ok),
                       num_tiles, tile_rows, block)
    np.testing.assert_array_equal(planes_to_numpy(got[0]),
                                  np.asarray(want[0]))
    for g, w in zip(got[1:3], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_auto_block_edges():
    for m in (1, 1000, 300_000, 50_000_000):
        be = ops._auto_block_edges(m, 2)
        assert be % 1024 == 0 and be >= 1024
        assert be == jops._auto_block_edges(m, 2, kmod.MAX_SMEM_PER_BLOCK)


# ---------------------------------------------------------------------------
# P3 kernels K4 (bitmap_update) and K3 (bitmap_update_batch) and their ops
# entries — tests/test_kernels.py; the Pallas calls run in interpret mode
# ---------------------------------------------------------------------------

def _words_np(shape, seed, fill=None):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, shape, dtype=np.uint32)
    if fill is not None:
        w[...] = fill
    return w


@pytest.mark.parametrize("rows,block_rows", [(8, 8), (16, 16), (64, 16),
                                             (256, 8)])
def test_bitmap_update_plain_vs_pallas(rows, block_rows):
    c = _words_np((rows, 128), rows)
    v = _words_np((rows, 128), rows + 1)
    want = j_bitmap_update(jnp.asarray(c), jnp.asarray(v),
                           block_rows=block_rows)
    # the plain version takes the TPU's [rows, 128] tiles as well as the
    # wrapper's flat words
    _assert_outputs(ref.bitmap_update_ref(_p(c), _p(v)), want)
    _assert_outputs(kbu.bitmap_update(_p(c).reshape(-1), _p(v).reshape(-1)),
                    want)


@pytest.mark.parametrize("g,rows", [(1, 16), (2, 32), (3, 16)])
def test_bitmap_update_batch_plain_vs_pallas(g, rows):
    c = _words_np((g, rows, 128), g * rows)
    v = _words_np((g, rows, 128), g * rows + 1)
    c[-1] = 0xFFFFFFFF                       # all-ones planes, bit 31 set
    want = j_bitmap_update_batch(jnp.asarray(c), jnp.asarray(v),
                                 block_rows=16)
    _assert_outputs(ref.bitmap_update_batch_ref(_p(c), _p(v)), want)
    _assert_outputs(kbu.bitmap_update_batch(_p(c).reshape(g, -1),
                                            _p(v).reshape(g, -1)), want)


_ODD_W = [1, 31, 127, 128, 129, 131, 1000, 17 * 128, 5000]


@pytest.mark.parametrize("w", _ODD_W)
def test_fused_frontier_update_odd_sizes(w):
    """Every w the reference pads to 128-word rows and 16-row blocks (its
    TPU grid plan) gives the reference's words and count unpadded."""
    c, v = _words_np((w,), w), _words_np((w,), w + 1)
    if w == 31:
        c[:] = 0xFFFFFFFF
    got = ops.fused_frontier_update(_p(c), _p(v))
    want = jops.fused_frontier_update(jnp.asarray(c), jnp.asarray(v))
    _assert_outputs(got, want, f"w={w}")
    assert got[2].shape == ()


@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("w", [1, 31, 129, 1000])
def test_fused_frontier_update_batch_odd_sizes(g, w):
    c, v = _words_np((g, w), g * w), _words_np((g, w), g * w + 7)
    v[0] = 0                                  # a plane with nothing seen
    got = ops.fused_frontier_update_batch(_p(c), _p(v))
    want = jops.fused_frontier_update_batch(jnp.asarray(c), jnp.asarray(v))
    _assert_outputs(got, want, f"g={g} w={w}")
    assert tuple(got[2].shape) == (g,)


def test_p3_wrappers_check_their_inputs():
    """A tensor on the CPU takes the plain body; the wrappers otherwise
    refuse what the kernels cannot take (no card here: the CUDA checks
    are in tests/test_torch_cuda.py)."""
    c, v = _p(_words_np((5,), 1)), _p(_words_np((5,), 2))
    kbu.reset_launches()
    kbu.bitmap_update(c, v)
    kbu.bitmap_update_batch(c[None], v[None])
    assert kbu.LAUNCHES == {"bitmap_update": 0, "bitmap_update_batch": 0}
    with pytest.raises(ValueError, match="unsupported device"):
        kbu.bitmap_update(c.to("meta"), v.to("meta"))


# K3 on the engine's rows: int32[n, nw], plane j in column j, held against
# the reference's planes-major K3 on the transposed words (Pallas in
# interpret mode), outputs transposed back

def _rows_case(n, nw, seed):
    """[n, nw] words with an all-ones column of new (cand all ones over
    nothing seen), an all-zero one (everything seen) where nw > 1, and
    bit 31 set in about half the other words."""
    c, v = _words_np((n, nw), seed), _words_np((n, nw), seed + 1)
    c[:, 0], v[:, 0] = 0xFFFFFFFF, 0
    if nw > 1:
        v[:, -1] = 0xFFFFFFFF
    return c, v


def _assert_rows_outputs(got, want_t, nw, what=""):
    """``got`` from the rows form; ``want_t`` the planes-major outputs of
    the transposed words ([nw, ...]), transposed back here."""
    nf, vo, cnt = want_t
    want = (np.asarray(nf).reshape(nw, -1).T, np.asarray(vo).reshape(nw, -1).T,
            np.asarray(cnt).reshape(-1))
    _assert_outputs(got, want, what)
    assert tuple(got[2].shape) == (nw, 1, 1)


@pytest.mark.parametrize("nw", [1, 2, 3, 8])
def test_bitmap_update_rows_plain_vs_pallas(nw):
    """The Pallas kernel itself: n = 2048 rows make [nw, 16, 128] tiles."""
    n = 2048
    c, v = _rows_case(n, nw, nw)
    want = j_bitmap_update_batch(jnp.asarray(c.T.reshape(nw, -1, 128)),
                                 jnp.asarray(v.T.reshape(nw, -1, 128)),
                                 block_rows=16)
    got = kbu.bitmap_update_rows(_p(c), _p(v))
    _assert_rows_outputs(got, want, nw, f"nw={nw}")
    _assert_rows_outputs(ref.bitmap_update_rows_ref(_p(c), _p(v)), want, nw,
                         f"ref nw={nw}")


@pytest.mark.parametrize("nw", [1, 2, 3, 8])
@pytest.mark.parametrize("n", [1, 31, 129, 1000])
def test_fused_frontier_update_rows_odd_sizes(n, nw):
    """Odd row counts: the reference pads the transposed planes to its
    tiles (``ops.fused_frontier_update_batch``); the rows form takes them
    as they are."""
    c, v = _rows_case(n, nw, 10 * n + nw)
    got = ops.fused_frontier_update_rows(_p(c), _p(v))
    nf, vo, cnt = jops.fused_frontier_update_batch(jnp.asarray(c.T),
                                                   jnp.asarray(v.T))
    _assert_outputs(got, (np.asarray(nf).T, np.asarray(vo).T, cnt),
                    f"n={n} nw={nw}")
    assert tuple(got[2].shape) == (nw,)
    assert int(got[2][0]) == 32 * n                # the all-ones column
    if nw > 1:
        assert int(got[2][-1]) == 0                # the all-seen column


def test_bitmap_update_rows_wrapper_contract():
    """The rows form takes contiguous int32[n, nw] pairs of one shape and
    nothing else, on the CPU as on the card (it never copies a strided
    input); it returns fresh outputs, leaves its inputs as they were and
    counts no launch on the CPU."""
    c, v = _rows_case(40, 3, 7)
    ct, vt = _p(c), _p(v)
    c0, v0 = ct.clone(), vt.clone()
    kbu.reset_launches()
    nf, vo, cnt = kbu.bitmap_update_rows(ct, vt)
    assert kbu.LAUNCHES == {"bitmap_update": 0, "bitmap_update_batch": 0}
    assert torch.equal(ct, c0) and torch.equal(vt, v0)
    spans = [(t.data_ptr(), t.data_ptr() + 4 * t.numel())
             for t in (ct, vt, nf, vo, cnt)]
    for i in range(2, 5):                          # no output overlaps
        for j in range(i):
            assert spans[i][1] <= spans[j][0] or spans[j][1] <= spans[i][0]
    with pytest.raises(ValueError, match="contiguous"):
        kbu.bitmap_update_rows(_p(c.T.copy()).T, vt)
    with pytest.raises(ValueError, match="contiguous"):
        kbu.bitmap_update_rows(ct, _p(v.T.copy()).T)
    with pytest.raises(ValueError, match="shape mismatch"):
        kbu.bitmap_update_rows(ct, vt[:-1])
    with pytest.raises(ValueError, match="2-D"):
        kbu.bitmap_update_rows(ct.reshape(-1), vt.reshape(-1))
    with pytest.raises(TypeError):
        kbu.bitmap_update_rows(ct.to(torch.int64), vt.to(torch.int64))
    with pytest.raises(ValueError, match="unsupported device"):
        kbu.bitmap_update_rows(ct.to("meta"), vt.to("meta"))
    assert kbu.LAUNCHES == {"bitmap_update": 0, "bitmap_update_batch": 0}


@pytest.mark.parametrize("nw", [1, 2, 3, 8])
def test_p3_bytes_of_each_form(nw):
    """One int32 count a plane in every form: nw for the rows form, whose
    leading dimension is the row count, not the plane count."""
    n = 70
    words = 4 * n * nw * 4
    rows = _p(_words_np((n, nw), 1))
    assert kbu.p3_bytes(rows, rows=True) == words + 4 * nw
    assert kbu.p3_bytes(rows.T.contiguous()) == words + 4 * nw
    assert kbu.p3_bytes(rows.reshape(-1)) == 4 * n * nw * 4 + 4
