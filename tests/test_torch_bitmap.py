"""The port's packed-plane bitmap ops against the reference's jnp ones.

Words are random uint32 (bit 31 set in about half of them); the port
holds them as int32 with the same bits.  Every comparison is bit-exact."""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax                                    # noqa: E402
import jax.numpy as jnp                        # noqa: E402
import torch                                   # noqa: E402

from repro.core import bitmap as jb            # noqa: E402
from repro_torch.core import bitmap as tb      # noqa: E402
from repro_torch.interop import planes_from_numpy, planes_to_numpy  # noqa: E402

CPU = "cpu"


def _words(shape, seed):
    w = np.random.default_rng(seed).integers(0, 2**32, shape,
                                             dtype=np.uint32)
    assert (w >= 2**31).any()                  # bit 31 is exercised
    return w


def _t(words):
    return planes_from_numpy(words, CPU)


def _u32(t):
    return planes_to_numpy(t)


def test_num_words():
    for b in (1, 31, 32, 33, 64, 65):
        assert tb.num_words(b) == jb.num_words(b)


@pytest.mark.parametrize("shape", [(5,), (7, 40), (3, 4, 33), (2, 64)])
def test_pack_unpack_rows(shape):
    rng = np.random.default_rng(sum(shape))
    mask = rng.random(shape) < 0.5
    mask[..., -1] = True                        # a high bit is set
    got = tb.pack_rows(torch.from_numpy(mask))
    want = np.asarray(jb.pack_rows(jnp.asarray(mask)))
    np.testing.assert_array_equal(_u32(got), want)
    words = _words(want.shape, 3)
    for nb in (None, shape[-1]):
        np.testing.assert_array_equal(
            tb.unpack_rows(_t(words), nb).numpy(),
            np.asarray(jb.unpack_rows(jnp.asarray(words), nb)))


def test_pack_unpack_flat():
    mask = np.random.default_rng(1).random(77) < 0.5
    np.testing.assert_array_equal(
        _u32(tb.pack(torch.from_numpy(mask))),
        np.asarray(jb.pack(jnp.asarray(mask))))
    words = _words(4, 2)
    np.testing.assert_array_equal(
        tb.unpack(_t(words), 100).numpy(),
        np.asarray(jb.unpack(jnp.asarray(words), 100)))


@pytest.mark.parametrize("nb", [1, 5, 31, 32, 33, 48, 64, 96])
def test_plane_mask(nb):
    np.testing.assert_array_equal(_u32(tb.plane_mask(nb)),
                                  np.asarray(jb.plane_mask(nb)))


def test_popcount_any_rows():
    words = _words((50, 3), 4)
    words[::7] = 0
    words[3] = 0xFFFFFFFF
    words[4] = 0x80000000
    t = _t(words)
    assert int(tb.popcount(t)) == int(jb.popcount(jnp.asarray(words)))
    np.testing.assert_array_equal(
        tb.popcount_rows(t).numpy(),
        np.asarray(jb.popcount_rows(jnp.asarray(words))))
    np.testing.assert_array_equal(
        tb.any_rows(t).numpy(), np.asarray(jb.any_rows(jnp.asarray(words))))


@pytest.mark.parametrize("b", [1, 5, 32, 33])
def test_pad_slice_plane_slots(b):
    roots = np.arange(b, dtype=np.int32) * 3
    for fill in (None, 0, 9):
        got, gb = tb.pad_plane_slots(roots, fill)
        want, wb = jb.pad_plane_slots(roots, fill)
        np.testing.assert_array_equal(got, want)
        assert gb == wb
    rows = np.arange(64 * 2).reshape(64, 2)
    np.testing.assert_array_equal(tb.slice_plane_rows(rows, b),
                                  jb.slice_plane_rows(rows, b))
    with pytest.raises(ValueError):
        tb.pad_plane_slots(np.zeros((2, 2), np.int32))
    with pytest.raises(TypeError):
        tb.pad_plane_slots(roots, fill=1.5)
    with pytest.raises(ValueError):
        tb.pad_plane_slots(roots, fill=-1)


@pytest.mark.parametrize("nw", [1, 2, 3])
def test_scatter_or_rows(nw):
    """Duplicates OR together, negative and >= r rows drop, existing bits
    survive, the accumulator is not written in place."""
    rng = np.random.default_rng(11 + nw)
    r, m = 40, 500
    words = _words((r, nw), nw)
    idx = rng.integers(-4, r + 6, m).astype(np.int32)
    msg = _words((m, nw), nw + 10)
    acc = _t(words)
    got = tb._scatter_or_rows(acc, torch.from_numpy(idx), _t(msg))
    want = np.asarray(jax.jit(jb._scatter_or_rows)(
        jnp.asarray(words), jnp.asarray(idx), jnp.asarray(msg)))
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(_u32(acc), words)


def test_segment_or_rows_at_segment_ends():
    """The port returns the whole-segment OR on every slot; the reference
    returns the inclusive scan.  They agree at each segment's last slot
    (the slots callers read), including a leading slot with no start."""
    rng = np.random.default_rng(13)
    e_, nw = 300, 2
    msg = _words((e_, nw), 5)
    first = np.zeros(e_, bool)
    first[np.sort(rng.choice(np.arange(1, e_), 25, replace=False))] = True
    got = _u32(tb.segment_or_rows(_t(msg), torch.from_numpy(first)))
    want = np.asarray(jax.jit(jb.segment_or_rows)(jnp.asarray(msg),
                                                  jnp.asarray(first)))
    ends = np.flatnonzero(np.append(first[1:], True))
    np.testing.assert_array_equal(got[ends], want[ends])
