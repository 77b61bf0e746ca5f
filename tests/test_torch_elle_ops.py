"""The port's Elle closure primitives against the JAX reference on the CPU.

The same numpy-seeded edge arrays go through the reference's
``batched_closure_kernel(pad, epad)`` and the port's plain
``batched_closure`` (``torch_device="cpu"``); the packed words and the SCC
labels must be bit-identical. Also the host bit packing, the bucket and
edge-pad tables, and ``closure_rows_packed``.
"""

import random

import numpy as np
import pytest
import torch

from jepsen_tpu.elle import graph as ref_graph
from jepsen_tpu.elle import ops as ref
from jepsen_tpu_torch.elle import ops


def _edges(kind: str, n: int, rng: np.random.Generator):
    if kind == "empty":
        return [], []
    if kind == "acyclic":
        s = list(range(n - 1)) + list(range(0, n - 2, 3))
        return s, [v + 1 for v in range(n - 1)] + [v + 2 for v in range(0, n - 2, 3)]
    if kind == "cycle":
        return list(range(n)), [(v + 1) % n for v in range(n)]
    ne = 2 * n
    return rng.integers(0, n, ne).tolist(), rng.integers(0, n, ne).tolist()


def _batch(pad: int, nb: int, kind: str, seed: int):
    """nb members at bucket pad: graphs of kind ``kind`` on n <= pad nodes
    (the last member of a batch is a random graph, so members differ)."""
    rng = np.random.default_rng(seed)
    members = []
    for b in range(nb):
        n = int(rng.integers(pad // 2 + 1, pad + 1))
        members.append(_edges(kind if b < nb - 1 or nb == 1 else "random", n, rng))
    epad = ref.edge_pad(max(len(s) for s, _ in members))
    padded = [ref.pad_edges(s, d, pad, epad) for s, d in members]
    return np.stack([p[0] for p in padded]), np.stack([p[1] for p in padded]), epad


@pytest.mark.parametrize("pad", [128, 256, 512])
@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("kind", ["empty", "acyclic", "cycle", "random"])
def test_closure_and_labels_bit_identical(pad, nb, kind):
    S, D, epad = _batch(pad, nb, kind, seed=pad * 7 + nb * 3 + len(kind))
    want_pk, want_lb = ref.batched_closure_kernel(pad, epad)(S, D)
    got_pk, got_lb = ops.batched_closure(S, D, pad, torch_device="cpu")
    assert got_pk.dtype == torch.int32 and got_pk.shape == (nb, pad, pad // 32)
    assert np.array_equal(got_pk.numpy().view(np.uint32), np.asarray(want_pk))
    assert np.array_equal(got_lb.numpy(), np.asarray(want_lb))


def test_stages_compose_to_the_closure():
    """adjacency -> ceil(log2 pad) squarings -> labels_pack is the closure
    (the wrappers on CPU tensors take the plain versions)."""
    S, D, _ = _batch(128, 2, "random", seed=4)
    a = ops.adjacency(torch.from_numpy(S), torch.from_numpy(D), 128)
    assert a.dtype == torch.float32 and set(a.unique().tolist()) <= {0.0, 1.0}
    for _ in range(ops.closure_steps(128)):
        a = ops.square(a)
    pk, lb = ops.labels_pack(a)
    want_pk, want_lb = ops.batched_closure(S, D, 128, torch_device="cpu")
    assert torch.equal(pk, want_pk) and torch.equal(lb, want_lb)
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}  # nothing launched on the CPU


def test_padding_edges_add_nothing():
    """Padding edges carry the sacrificial index pad and are dropped; an
    edge into pad-1 is a real edge."""
    pad = 128
    s, d = ref.pad_edges([0, 1], [1, 0], pad, 256)
    a = ops.adjacency_plain(torch.from_numpy(s[None]), torch.from_numpy(d[None]), pad)
    assert int(a.sum()) == 2 and a[0, 0, 1] == 1 and a[0, 1, 0] == 1
    s, d = ref.pad_edges([5], [pad - 1], pad, 256)
    a = ops.adjacency_plain(torch.from_numpy(s[None]), torch.from_numpy(d[None]), pad)
    assert int(a.sum()) == 1 and a[0, 5, pad - 1] == 1


@pytest.mark.parametrize("shape", [(1, 1), (3, 31), (5, 32), (7, 33), (64, 130)])
def test_pack_roundtrip_matches_reference(shape):
    m = np.random.default_rng(shape[1]).random(shape) < 0.3
    packed = ops.pack_bits_host(m)
    assert np.array_equal(packed, ref.pack_bits_host(m))
    assert np.array_equal(ops.unpack_bits_host(packed, shape[1]), m)
    for i in range(shape[0]):
        for j in range(shape[1]):
            assert ops.row_bit(packed[i], j) == ref.row_bit(packed[i], j) == m[i, j]


def test_plain_pack_matches_host_pack():
    a = (torch.rand((2, 128, 128), generator=torch.Generator().manual_seed(1)) < 0.2).float()
    pk, _ = ops.labels_pack_plain(a)
    for b in range(2):
        assert np.array_equal(pk[b].numpy().view(np.uint32),
                              ops.pack_bits_host(a[b].numpy() > 0))


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 300, 8192, 8193, 20000])
def test_bucket_and_pad_tables(n):
    assert ops.BUCKETS == ref.BUCKETS and ops.CEILING == ref.CEILING
    assert ops.bucket_for(n) == ref.bucket_for(n)
    assert ops.closure_pad(n) == ref.closure_pad(n)
    assert ops.edge_pad(n) == ref.edge_pad(n)
    assert ops.packed_closure_bytes(n) == ref.packed_closure_bytes(n)
    assert ops.dense_closure_bytes(n) == ref.dense_closure_bytes(n)
    if n:
        s = list(range(n))[:50]
        for a, b in zip(ops.pad_edges(s, s, ops.closure_pad(n), ops.edge_pad(len(s))),
                        ref.pad_edges(s, s, ref.closure_pad(n), ref.edge_pad(len(s)))):
            assert np.array_equal(a, b) and a.dtype == b.dtype


def _closure_cases():
    rng = random.Random(3)
    cases = [(5, []), (5, [(2, 2)]), (6, [(0, 1), (1, 0), (3, 4), (4, 3)]),
             (4, [(0, 1), (1, 2), (2, 3)])]
    for n in (127, 128, 129):
        cases.append((n, [(i, (i + 1) % n) for i in range(n)]))
    for n in (17, 200):
        cases.append((n, [(rng.randrange(n), rng.randrange(n)) for _ in range(3 * n)]))
    return cases


@pytest.mark.parametrize("case", range(len(_closure_cases())))
def test_closure_rows_packed_matches_reference(case):
    n, edges = _closure_cases()[case]
    srcs = [a for a, _ in edges]
    dsts = [b for _, b in edges]
    want_pk, want_lb = ref.closure_rows_packed(srcs, dsts, n)
    got_pk, got_lb = ops.closure_rows_packed(srcs, dsts, n, torch_device="cpu")
    assert got_pk.dtype == np.uint32 and np.array_equal(got_pk, want_pk)
    assert np.array_equal(got_lb, want_lb)
    assert ops.sccs_from_labels(got_lb, got_pk, n) == ref.sccs_from_labels(want_lb, want_pk, n)
    adj = np.zeros((n, n), np.uint8)
    for a, b in edges:
        adj[a, b] = 1
    pad = ops.closure_pad(n)
    assert np.array_equal(ops.unpack_bits_host(got_pk[:n], pad)[:, :n],
                          ref_graph.closure_host(adj, 1))


def test_env_override_read_per_call(monkeypatch):
    for env, flag in [(None, None), (None, True), (None, False), ("0", True), ("1", False),
                      ("off", None), ("", False)]:
        if env is None:
            monkeypatch.delenv("JEPSEN_ELLE_DEVICE", raising=False)
        else:
            monkeypatch.setenv("JEPSEN_ELLE_DEVICE", env)
        assert ops.resolve_device(flag) == ref.resolve_device(flag), (env, flag)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="power of two"):
        ops._check_pad(96, 1)
    with pytest.raises(ValueError, match="members"):
        ops._check_pad(128, 0)
    with pytest.raises(ValueError, match="expected cuda"):
        ops._check("elle_square", torch.zeros(1, 128, 128, dtype=torch.bfloat16),
                   torch.bfloat16, (1, 128, 128))


def test_square_wrappers_refuse_a_misaligned_view():
    """The square's TMA needs 16-byte-aligned bases: a contiguous view at an
    odd element offset is refused, an aligned one passes."""
    flat = torch.zeros(128 * 128 + 8, dtype=torch.bfloat16)
    ops._check_aligned("elle_square", flat[8:].view(1, 128, 128))
    view = flat[1:1 + 128 * 128].view(1, 128, 128)
    assert view.is_contiguous()
    with pytest.raises(ValueError, match="16-byte"):
        ops._check_aligned("elle_square", view)


def _extreme_edges(kind: str, pad: int):
    """A complete graph on all pad nodes (self loops included), where every
    path count of a squaring reaches pad, or an edgeless one."""
    if kind == "edgeless":
        return [], []
    nodes = np.arange(pad)
    return np.repeat(nodes, pad).tolist(), np.tile(nodes, pad).tolist()


@pytest.mark.parametrize("pad", [128, 256])
@pytest.mark.parametrize("kind", ["complete", "edgeless"])
def test_closure_of_extreme_graphs_bit_identical(pad, kind):
    s, d = _extreme_edges(kind, pad)
    epad = ref.edge_pad(len(s))
    S, D = (x[None] for x in ref.pad_edges(s, d, pad, epad))
    want_pk, want_lb = ref.batched_closure_kernel(pad, epad)(S, D)
    got_pk, got_lb = ops.batched_closure(S, D, pad, torch_device="cpu")
    assert np.array_equal(got_pk.numpy().view(np.uint32), np.asarray(want_pk))
    assert np.array_equal(got_lb.numpy(), np.asarray(want_lb))
    bits = int(np.unpackbits(got_pk.numpy().view(np.uint8)).sum())
    assert bits == (pad * pad if kind == "complete" else 0)
