"""The radix sort's plain version and its wrapper, on the CPU.

``radix_sort_pairs_plain`` (what the kernel is held to on the card) against
``numpy.argsort(kind="stable")`` and the JAX reference's own stable
``jax.lax.sort``, on the key families of the card tests (seeded numpy
keys); the dedup sort's composition of stable sorts against the
reference's lexicographic ``lax.sort``; ``sort_scratch``'s sizes and the
path it picks; and the argument checks of the wrapper, which refuse a
scratch that does not fit, mismatched shapes and tensors off the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu_torch import _build
from jepsen_tpu_torch.ops import wgl_level as lv
from jepsen_tpu_torch.testing import SORT_KEY_FAMILIES, sort_keys


def _values(nb, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(n) for _ in range(nb)]).astype(np.int32)


def _ref_sort(keys, vals):
    """Each member's row through ``jax.lax.sort`` on (u32 key, value), one
    key, stable: the reference's sort primitive."""
    out = [jax.lax.sort((jnp.asarray(k.view(np.uint32)), jnp.asarray(v)), num_keys=1,
                        is_stable=True) for k, v in zip(keys, vals)]
    return (np.stack([np.asarray(a).view(np.int32) for a, _ in out]),
            np.stack([np.asarray(b) for _, b in out]))


@pytest.mark.parametrize("family", SORT_KEY_FAMILIES)
@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("n", [1, 31, 2048, 16385])
def test_plain_sort_matches_numpy_and_jax(n, nb, family):
    keys = sort_keys(family, nb, n, seed=n * 10 + nb)
    vals = _values(nb, n, seed=n)
    kt, vt = torch.from_numpy(keys.copy()), torch.from_numpy(vals.copy())
    lv.radix_sort_pairs(kt, vt, lv.sort_scratch(n, "cpu", nb))
    order = np.argsort(keys.view(np.uint32), axis=1, kind="stable")
    np.testing.assert_array_equal(kt.numpy(), np.take_along_axis(keys, order, 1))
    np.testing.assert_array_equal(vt.numpy(), np.take_along_axis(vals, order, 1))
    rk, rv = _ref_sort(keys, vals)
    np.testing.assert_array_equal(kt.numpy(), rk)
    np.testing.assert_array_equal(vt.numpy(), rv)


def test_plain_sort_leaves_a_stopped_member_untouched():
    keys = sort_keys("random", 3, 500, seed=4)
    vals = _values(3, 500, seed=4)
    ctl = torch.zeros((3, lv.CTL_SIZE), dtype=torch.int32)
    ctl[:, lv.CTL_GO] = 1
    ctl[1, lv.CTL_GO] = 0
    kt, vt = torch.from_numpy(keys.copy()), torch.from_numpy(vals.copy())
    lv.radix_sort_pairs_plain(kt, vt, None, ctl)
    np.testing.assert_array_equal(kt[1].numpy(), keys[1])
    np.testing.assert_array_equal(vt[1].numpy(), vals[1])
    rk, rv = _ref_sort(keys[[0, 2]], vals[[0, 2]])
    np.testing.assert_array_equal(kt[[0, 2]].numpy(), rk)
    np.testing.assert_array_equal(vt[[0, 2]].numpy(), rv)


@pytest.mark.parametrize("seed", range(3))
def test_stable_sorts_compose_to_the_reference_dedup_order(seed):
    """The dedup order, built as a take and a stable sort per key from the
    last to the first (``_dedup_stages``), is the reference's lexicographic
    ``lax.sort(..., num_keys=2)`` with the row index as the payload; the
    compaction sort of (fprio, iota) is its two-key sort too."""
    rng = np.random.default_rng(seed)
    n = 3000
    fkey = rng.integers(0, 40, size=n).astype(np.uint32) << np.uint32(25)
    ocol = rng.integers(0, 4, size=n).astype(np.uint32)
    perm = torch.arange(n, dtype=torch.int32)[None]
    keys = torch.zeros((1, n), dtype=torch.int32)
    for col in (ocol, fkey):
        src = torch.from_numpy(col.view(np.int32)[:, None].copy())
        lv.take_col_reference(src, 0, perm[0], keys[0])
        lv.radix_sort_pairs(keys, perm, lv.sort_scratch(n, "cpu"))
    iota = jnp.arange(n, dtype=jnp.uint32)
    want = jax.lax.sort((jnp.asarray(fkey), jnp.asarray(ocol), iota), num_keys=2)[2]
    np.testing.assert_array_equal(perm[0].numpy(), np.asarray(want).astype(np.int32))
    fprio = sort_keys("top_byte", 1, n, seed=seed)
    order = torch.arange(n, dtype=torch.int32)[None]
    lv.radix_sort_pairs(torch.from_numpy(fprio.copy()), order, lv.sort_scratch(n, "cpu"))
    want = jax.lax.sort((jnp.asarray(fprio[0].view(np.uint32)), iota), num_keys=2)[1]
    np.testing.assert_array_equal(order[0].numpy(), np.asarray(want).astype(np.int32))


@pytest.mark.parametrize("nb", [1, 8])
@pytest.mark.parametrize("n", [1, 2048, 16384, 16385, 32768, 1048576])
def test_sort_scratch_sizes(n, nb):
    """One block holds a member up to the crossover and needs no scratch;
    above it the Onesweep path's ping-pong rows and zeroed state: a header
    per member and two look-back words per (member, tile, digit)."""
    tmp, state = lv.sort_scratch(n, "cpu", nb)
    if n <= _build.SORT_CTA_MAX:
        assert lv.sort_path((tmp, state)) == "cta"
        assert tuple(tmp.shape) == (2, nb, 0) and state.numel() == 0
    else:
        tiles = -(-n // _build.SORT_TILE)
        assert lv.sort_path((tmp, state)) == "onesweep"
        assert tuple(tmp.shape) == (2, nb, n)
        assert state.numel() == nb * (_build.SORT_HDR + 2 * 256 * tiles)
        assert int(state.abs().sum()) == 0
    assert tmp.dtype == state.dtype == torch.int32


def test_sort_scratch_paths():
    tmp, state = lv.sort_scratch(100, "cpu", 2, path="onesweep")
    assert tuple(tmp.shape) == (2, 2, 100) and state.numel() == 2 * (_build.SORT_HDR + 512)
    with pytest.raises(ValueError, match="one block holds"):
        lv.sort_scratch(_build.SORT_CTA_MAX + 1, "cpu", path="cta")
    with pytest.raises(ValueError, match="unknown sort path"):
        lv.sort_scratch(100, "cpu", path="bitonic")


@pytest.mark.parametrize("L,path", [(16384, "cta"), (32768, "onesweep")])
def test_workspace_sort_scratch_follows_the_row_count(L, path):
    """A workspace's sort scratch is made once for its L: the main path's
    16384 rows take the one-block path, the batch's 32768 Onesweep."""
    g = lv.Geometry(F=L // 4, W=32, KO=1, S=1, ND=64, NO=32, B=1, SEL=True, two_stage=True,
                    P=L)
    ws = lv.BatchWorkspace(g, 2, "cpu")
    assert g.L == L and lv.sort_path(ws.sort) == path
    assert tuple(ws.sort[0].shape) == ((2, 2, 0) if path == "cta" else (2, 2, L))


@pytest.fixture
def as_if_on_the_card(monkeypatch):
    """The wrapper's argument packing with the device checks stubbed out,
    so its shape and scratch checks run on CPU tensors."""
    monkeypatch.setattr(lv, "_check_cuda", lambda *ts: None)
    monkeypatch.setattr(lv, "_stream", lambda: 0)


def _pairs(nb, n):
    return (torch.zeros((nb, n), dtype=torch.int32), torch.zeros((nb, n), dtype=torch.int32))


def test_sort_args_pack_each_path(as_if_on_the_card):
    """The one-block path passes no scratch (null pointers); Onesweep its
    ping-pong rows and state."""
    keys, vals = _pairs(2, 300)
    args = lv._radix_sort_pairs_args(keys, vals, lv.sort_scratch(300, "cpu", 2), None)
    assert [getattr(a, "value", a) for a in args[2:7]] == [None, None, None, 300, 2]
    scratch = lv.sort_scratch(300, "cpu", 2, path="onesweep")
    args = lv._radix_sort_pairs_args(keys, vals, scratch, None)
    assert [a.value for a in args[2:5]] == [scratch[0][0].data_ptr(),
                                            scratch[0][1].data_ptr(), scratch[1].data_ptr()]


@pytest.mark.parametrize("case", ["short", "one_block_too_big", "members", "values", "rank",
                                  "ctl", "too_long"])
def test_sort_args_refuse(as_if_on_the_card, case):
    keys, vals = _pairs(1, 5000)
    scratch, ctl = lv.sort_scratch(5000, "cpu"), None
    if case == "short":
        scratch = lv.sort_scratch(4096, "cpu", path="onesweep")
    elif case == "one_block_too_big":
        keys, vals = _pairs(1, _build.SORT_CTA_MAX + 1)
    elif case == "members":
        keys, vals = _pairs(3, 5000)
        scratch = lv.sort_scratch(5000, "cpu", 2, path="onesweep")
    elif case == "values":
        vals = torch.zeros((1, 4999), dtype=torch.int32)
    elif case == "rank":
        keys, vals = keys[0], vals[0]
    elif case == "ctl":
        ctl = torch.zeros((2, lv.CTL_SIZE), dtype=torch.int32)
    else:
        keys = vals = torch.zeros((1, 1), dtype=torch.int32).expand(1, 2**30)
        scratch = lv.sort_scratch(16, "cpu", path="onesweep")
    with pytest.raises(ValueError, match="radix_sort_pairs"):
        lv._radix_sort_pairs_args(keys, vals, scratch, ctl)


def test_sort_args_refuse_tensors_off_the_card():
    """On the CPU the wrapper takes the plain version; the kernel's packing
    refuses any tensor that does not lie on the card."""
    keys, vals = _pairs(1, 64)
    with pytest.raises(ValueError, match="expected cuda"):
        lv._radix_sort_pairs_args(keys, vals, lv.sort_scratch(64, "cpu"), None)
