"""The port's step analysis (``repro_torch.launch.step_analysis``) against
hand counts, mirroring ``tests/test_hlo_analysis.py``, and its FLOPs
against the reference's HLO analysis of the same programs."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp                                     # noqa: E402

from repro.launch.hlo_analysis import analyze_hlo_text      # noqa: E402
from repro_torch.kernels import bitmap_update as kbu        # noqa: E402
from repro_torch.kernels import csr_gather as kcg           # noqa: E402
from repro_torch.kernels import expand_frontier as kef      # noqa: E402
from repro_torch.kernels import flash_attention as kfa      # noqa: E402
from repro_torch.kernels import msbfs_propagate as kmod     # noqa: E402
from repro_torch.kernels import ops, ref                    # noqa: E402
from repro_torch.kernels import pull_spmv as kps            # noqa: E402
from repro_torch.launch.roofline import roofline_terms      # noqa: E402
from repro_torch.launch.step_analysis import StepAnalysis   # noqa: E402
from test_torch_dispatcher import run_ranks                 # noqa: E402

KEYS = ["flops", "bytes", "collective_bytes", "collective_count",
        "collective_by_op"]


def _count(fn, *args) -> dict:
    with StepAnalysis() as a:
        fn(*args)
    out = a.result()
    assert list(out) == KEYS
    roofline_terms(out)                  # takes the result unchanged
    return out


def _f32(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def test_single_matmul():
    a, b = _f32(64, 128), _f32(128, 32, seed=1)
    out = _count(lambda x, y: x @ y, a, b)
    assert out["flops"] == 2 * 64 * 128 * 32
    assert out["bytes"] == (64 * 128 + 128 * 32 + 64 * 32) * 4
    assert (out["collective_bytes"], out["collective_count"],
            out["collective_by_op"]) == (0.0, 0, {})


def test_loop_multiplies_trip_count():
    def fn(x):
        for _ in range(7):
            x = x @ x
        return x

    out = _count(fn, _f32(16, 16))
    # 7 iterations x one 16^3 matmul, reading x once and writing its result
    assert out["flops"] == 7 * 2 * 16 ** 3
    assert out["bytes"] == 7 * 2 * 16 * 16 * 4


def test_nested_loop_multiplies():
    def fn(x):
        for _ in range(5):
            for _ in range(3):
                x = x @ x
        return x

    assert _count(fn, _f32(8, 8))["flops"] == 5 * 3 * 2 * 8 ** 3


def test_views_move_no_bytes():
    x = _f32(8, 12)

    def views(x):
        v = x.view(4, 24).reshape(2, 48)[:, 8:40].unsqueeze(0)
        v = v.expand(3, 2, 32).permute(2, 0, 1)
        return x.t(), x[3], x.detach(), x.unbind(0), v

    assert _count(views, x) == dict(zip(KEYS, (0.0, 0.0, 0.0, 0, {})))
    # a real copy is counted: the strided read and the contiguous write
    assert _count(lambda x: x.t().contiguous(), x)["bytes"] == 2 * 8 * 12 * 4


def test_host_copies_are_not_counted():
    x = _f32(32, 4)

    def host(x):
        x.to("meta")                              # another device
        torch.empty((32, 4), device="meta").copy_(x)
        x.sum().item()                            # a scalar to the host
        return x.numpy()

    # only the sum moves bytes: the matrix read, one float written
    assert _count(host, x)["bytes"] == 32 * 4 * 4 + 4
    # a value the host made, copied in: the card takes it from the host
    w = torch.zeros(8, dtype=torch.int32)

    def put(w):
        w[3] = 7
        w[torch.tensor(5)] = 1
        w[:2].copy_(torch.tensor([4, 5]))

    assert _count(put, w)["bytes"] == 0 and w.tolist() == [4, 5, 0, 7, 0, 1,
                                                           0, 0]
    # a copy on one device is traffic: f32 read, int64 written
    assert _count(lambda x: x.to(torch.int64), x)["bytes"] == 32 * 4 * 12


def test_in_place_and_out_ops():
    x, y = _words((16,), 0), _words((16,), 1)
    assert _count(lambda: x.bitwise_and_(y))["bytes"] == 3 * 16 * 4
    assert _count(lambda: x.copy_(y))["bytes"] == 2 * 16 * 4
    assert _count(lambda: torch.cumsum(y, 0, out=x))["bytes"] == 2 * 16 * 4
    assert _count(lambda: torch.empty(1000))["bytes"] == 0


def test_an_op_without_a_rule_raises():
    with pytest.raises(NotImplementedError, match="aten.dot"):
        _count(torch.dot, _f32(4), _f32(4, seed=1))
    with StepAnalysis():
        with pytest.raises(RuntimeError, match="already counting"):
            with StepAnalysis():
                pass


def _words(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        -2**31, 2**31 - 1, shape).astype(np.int32))


def _ints(low, high, n, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        low, high, n).astype(np.int32))


def _k1():
    n, nw, m = 40, 2, 96
    f, s = _words((n, nw), 1), _words((n, nw), 2)
    f[::3] = 0                                     # zero messages
    src, tgt = _ints(-2, n + 2, m, 3), _ints(-2, n + 2, m, 4)
    valid = torch.from_numpy(np.random.default_rng(5).random(m) < 0.7)
    args = (f, s, src, tgt, "or", valid, torch.tensor(80, dtype=torch.int32))
    cost = kmod.propagate_traffic(f, src, tgt, valid, args[-1])
    assert cost["slots"] == 80 and 0 < cost["live"] < cost["real"] < 80
    return kmod.msbfs_propagate_planes, args, cost["bytes"], 0.0, \
        ref.msbfs_propagate_planes_ref(*args)


def _k2():
    n, nw, m, tr, be = 50, 3, 120, 16, 8
    f, s = _words((n, nw), 6), _words((n, nw), 7)
    f[::2] = 0
    src, tgt = _ints(0, n, m, 8), _ints(0, n, m, 9)
    ok = torch.from_numpy(np.random.default_rng(10).random(m) < 0.8)
    args = ops._tiled_inputs(s, f, src, tgt, ok, tr, be)
    sp, msg, stgt, ct, heads = args
    nbytes = kmod.tiled_traffic(sp, msg, heads, be)
    assert nbytes == (int(heads.sum()) * be * nw * 4
                      + int((msg != 0).any(1).sum()) * 4
                      + 3 * sp.numel() * 4 + 4)
    return (kmod.msbfs_propagate_planes_tiled, (*args, tr, be, "or"), nbytes,
            0.0, ref.msbfs_propagate_planes_tiled_ref(sp, msg, stgt, ct, tr,
                                                      be))


def _k3():
    c, v = _words((3, 70), 11), _words((3, 70), 12)
    return (kbu.bitmap_update_batch, (c, v), 4 * 210 * 4 + 3 * 4, 0.0,
            ref.bitmap_update_batch_ref(c, v))


def _k3_rows():
    # the engine's [n, nw] rows: nw counts, not n
    c, v = _words((70, 3), 11), _words((70, 3), 12)
    return (kbu.bitmap_update_rows, (c, v), 4 * 210 * 4 + 3 * 4, 0.0,
            ref.bitmap_update_rows_ref(c, v))


def _k4():
    c, v = _words((129,), 13), _words((129,), 14)
    return (kbu.bitmap_update, (c, v), 4 * 129 * 4 + 4, 0.0,
            ref.bitmap_update_ref(c, v))


def _k5():
    edges = _words((7, 4), 15)
    ids = torch.tensor([0, 3, 3, -1, 12, 6, 0], dtype=torch.int32)
    # pages 0, 3, 6 (twice: -1 wraps, 12 clamps) -> 3 distinct, 7 written
    return (kcg.gather_pages, (edges, ids), (3 + 7) * 4 * 4 + 7 * 4, 0.0,
            ref.gather_pages_ref(edges, ids))


def _k6():
    nb, b, ncb, lanes, rb = 5, 16, 3, 8, 4
    rng = np.random.default_rng(16)
    blocks = torch.from_numpy((rng.random((nb, b, b)) < 0.3).astype(
        np.float32)).to(torch.bfloat16)
    brow = torch.tensor([0, 0, 2, 3, 3], dtype=torch.int32)
    bcol = torch.tensor([1, 2, 0, 0, 2], dtype=torch.int32)
    f = torch.from_numpy((rng.random((ncb, b, lanes)) < 0.5).astype(
        np.float32)).to(torch.bfloat16)
    args = (blocks, brow, bcol, None, f, rb)
    nbytes = nb * b * b * 2 + ncb * b * lanes * 2 + rb * b * lanes * 4 \
        + 2 * nb * 4
    return (kps.pull_spmv_blocks, args, nbytes, 2.0 * nb * b * b * lanes,
            ref.pull_spmv_blocks_ref(*args))


def _k7():
    q, k, v = (_f32(2, 128, 32, seed=s) for s in (17, 18, 19))
    return (kfa.flash_attention, (q, k, v), 4 * 2 * 128 * 32 * 4,
            4.0 * 2 * 128 * 128 * 32 / 2,
            ref.flash_attention_ref(q, k, v, causal=True))


def _expand():
    # 9 vertices, lists of 0, 3, 1, 0, 2, ... ; the mask takes 1, 2, 4, 7:
    # 3 + 1 + 2 + 2 = 8 edges into a budget of 6
    indptr = torch.tensor([0, 0, 3, 4, 4, 6, 6, 6, 8, 9], dtype=torch.int32)
    indices = torch.arange(9, dtype=torch.int32)
    mask = torch.zeros(9, dtype=torch.bool)
    mask[[1, 2, 4, 7]] = True
    nbytes = 9 + 4 * 10 + 4 * 6 + 9 * 6 + 4
    return (kef.expand_frontier, (mask, indptr, indices, 6), nbytes, 0.0,
            ref.expand_frontier_ref(mask, indptr, indices, 6))


@pytest.mark.parametrize("case,name", [
    (_k1, "msbfs_propagate_planes"), (_k2, "msbfs_propagate_planes_tiled"),
    (_k3, "bitmap_update_batch"), (_k3_rows, "bitmap_update_batch"),
    (_k4, "bitmap_update"),
    (_k5, "gather_pages"), (_k6, "pull_spmv_blocks"),
    (_k7, "flash_attention"), (_expand, "expand_frontier")])
def test_kernel_call_counts_once_at_its_own_bytes(case, name):
    """Each wrapper's plain body (the CPU's) counts as one op at the bytes
    and FLOPs its bound counts; none of the body's aten ops is counted,
    and the result is the plain version's."""
    fn, args, nbytes, flops, want = case()
    with StepAnalysis() as a:
        got = fn(*args)
    assert a.kernels == {name: {"calls": 1, "bytes": nbytes,
                                "flops": flops}}
    assert a.result() == dict(zip(KEYS, (flops, nbytes, 0.0, 0, {})))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)


def test_kernel_calls_add_up_in_a_wave():
    """A packed wave on the kernel path (the wrappers' plain bodies on the
    CPU) reports one K1 call a level, beside its aten glue."""
    from repro_torch.core import MultiSourceBFSRunner, build_local_graph
    from repro_torch.graph import get_dataset

    ds = get_dataset("tiny-16-4")
    g = build_local_graph(ds.csr, ds.csc, device="cpu")
    runner = MultiSourceBFSRunner(g, use_kernels=True, tile_rows=0)
    with StepAnalysis() as a:
        res = runner.run(np.arange(8))
    k1 = a.kernels["msbfs_propagate_planes"]
    assert k1["calls"] == res.iterations and k1["flops"] == 0.0
    assert a.result()["bytes"] > k1["bytes"] > 0


# -- collectives on 4 gloo ranks --------------------------------------------

_COLLECTIVES = """
from repro_torch.launch.step_analysis import StepAnalysis
x = torch.arange(4 * 6, dtype=torch.int32).reshape(4, 6) + rank
out = torch.empty_like(x)
v = torch.ones(5, dtype=torch.int64)
with StepAnalysis() as a:
    dist.all_to_all_single(out, x)
    dist.all_reduce(v)
    dist.all_reduce(v)
r = a.result()
# 96 bytes cross the all-to-all, 40 each all-reduce, per rank
assert r["collective_by_op"] == {"all-to-all": 96.0, "all-reduce": 80.0}, r
assert r["collective_count"] == 3 and r["collective_bytes"] == 176.0, r
# their input and output buffers: 96 + 96, then 40 + 40 twice
assert r["bytes"] == 352.0 and r["flops"] == 0.0, r
assert int(v[0]) == 16, v
"""


def test_collectives_on_four_gloo_ranks(tmp_path):
    run_ranks(_COLLECTIVES, 4, tmp_path)


# -- FLOPs against the reference's HLO analysis ------------------------------

def _hlo(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def test_dot_chain_flops_equal_hlo_analysis():
    shapes = ((24, 40), (40, 56), (56, 8))
    want = analyze_hlo_text(_hlo(
        lambda a, b, c: (a @ b) @ c,
        *(jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes)))
    got = _count(lambda a, b, c: (a @ b) @ c,
                 *(_f32(*s, seed=i) for i, s in enumerate(shapes)))
    assert got["flops"] == want["flops"] == 2 * 24 * 40 * 56 + 2 * 24 * 56 * 8


def test_loop_of_eight_dots_flops_equal_hlo_analysis():
    def jfn(x):
        def body(c, _):
            return c @ c, ()
        c, _ = jax.lax.scan(body, x, None, length=8)
        return c

    def tfn(x):
        for _ in range(8):
            x = x @ x
        return x

    want = analyze_hlo_text(_hlo(jfn, jax.ShapeDtypeStruct((32, 32),
                                                           jnp.float32)))
    assert _count(tfn, _f32(32, 32))["flops"] == want["flops"] \
        == 8 * 2 * 32 ** 3
