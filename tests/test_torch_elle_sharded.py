"""The port's mesh-sharded Elle closure (``elle.ops.sharded_closure``) and
the engine's ``mesh=`` path against the JAX reference's on the CPU.

The reference runs its ``shard_map`` closure on the conftest's 8 virtual
CPU devices; the port runs on ``make_mesh(D, device="cpu")``, D shards on
the CPU device, where every stage takes its plain PyTorch version. The
packed closures must be bit-identical, the result maps and engine reports
equal, and the fault policy is the port's documented divergence: only an
out-of-memory on CPU tensors folds to the host."""

import random

import numpy as np
import pytest
import torch

import jepsen_tpu.elle as R
import jepsen_tpu_torch.elle as P
from jepsen_tpu.elle import append as r_append
from jepsen_tpu.elle import ops as r_ops
from jepsen_tpu.elle import wr as r_wr
from jepsen_tpu.history import History as RHistory
from jepsen_tpu.history import Op as ROp
from jepsen_tpu.parallel import make_mesh as ref_make_mesh
from jepsen_tpu_torch.elle import append as p_append
from jepsen_tpu_torch.elle import engine as p_engine
from jepsen_tpu_torch.elle import graph as p_graph
from jepsen_tpu_torch.elle import ops as p_ops
from jepsen_tpu_torch.elle import wr as p_wr
from jepsen_tpu_torch.parallel import Mesh, make_mesh
from jepsen_tpu_torch.testing import lagged_append_history, lagged_wr_history

_REF_MESHES = {}


def _random_typed_graph(rng, n, extra_edges=False):
    g = R.DepGraph(n)
    kinds = [R.WW, R.WW, R.WR, R.RW] + ([R.RT, R.PROC] if extra_edges else [])
    for _ in range(3 * n):
        g.add(rng.randrange(n), rng.randrange(n), rng.choice(kinds))
    return g


def port_graph(g):
    """The port's DepGraph with the reference graph's edges in its
    insertion order (the witness walks follow adjacency order)."""
    out = P.DepGraph(g.n)
    for (s, d), k in g.edges.items():
        out.add(s, d, k)
    return out


def to_ref_history(h):
    return RHistory([ROp(o.type, o.process, o.f, o.value, time=o.time, index=o.index)
                     for o in h], reindex=False)


def ref_mesh(d):
    """One reference mesh per size: its closure programs are cached per
    mesh object."""
    if d not in _REF_MESHES:
        _REF_MESHES[d] = ref_make_mesh(d, shape=(d, 1))
    return _REF_MESHES[d]


def cpu_mesh(d):
    return make_mesh(d, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain stages run many small ops: one intra-op thread each keeps
    a worker from oversubscribing the cores the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_ambient_kill_switch(monkeypatch):
    """The kill-switches override the arguments; an ambient one would make
    every mode here the same mode."""
    monkeypatch.delenv("JEPSEN_ELLE_EXCHANGE", raising=False)
    monkeypatch.delenv("JEPSEN_ELLE_DEVICE", raising=False)


def _graph(name):
    """(srcs, dsts, n) of each differential graph."""
    if name == "random40":  # tests/test_elle.py's sharded case
        rng = random.Random(5)
        n = 40
        edges = [(rng.randrange(n), rng.randrange(n)) for _ in range(110)]
    elif name == "edgeless":
        n, edges = 30, []
    elif name == "ring300":  # pad 512, one big cycle with chords
        n = 300
        edges = [(i, (i + 1) % n) for i in range(n)] + [(i, (7 * i + 3) % n)
                                                      for i in range(0, n, 17)]
    else:  # self-loops beside a short chain and a 2-cycle
        n = 50
        edges = [(3, 3), (10, 10), (10, 11), (11, 12), (20, 21), (21, 20), (49, 49),
                 (0, 1), (1, 2)]
    return [a for a, _ in edges], [b for _, b in edges], n


@pytest.mark.parametrize("mode", ["packed", "dense"])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["random40", "edgeless", "ring300", "self_loops"])
def test_sharded_closure_matches_reference(name, d, mode):
    srcs, dsts, n = _graph(name)
    want = np.asarray(r_ops.sharded_closure(srcs, dsts, n, ref_mesh(d), exchange=mode))
    got = p_ops.sharded_closure(srcs, dsts, n, cpu_mesh(d), exchange=mode)
    assert got.dtype == np.uint32 and got.shape == want.shape
    assert got.shape[0] == p_ops.sharded_pad(n, d)
    assert np.array_equal(got, want)
    if name == "random40":  # and the host closure (tests/test_elle.py:872-890)
        adj = np.zeros((n, n), np.uint8)
        adj[srcs, dsts] = 1
        host = p_graph.closure_host(adj, 1)
        assert np.array_equal(p_ops.unpack_bits_host(got[:n], got.shape[0])[:, :n], host)


def test_sharded_closure_refuses_a_mesh_that_is_not_a_power_of_two():
    with pytest.raises(ValueError):
        r_ops.sharded_closure([0], [1], 4, ref_mesh(3))
    with pytest.raises(ValueError, match="power-of-two"):
        p_ops.sharded_closure([0], [1], 4, cpu_mesh(3))


def test_resolve_exchange_as_reference(monkeypatch):
    for mod in (r_ops, p_ops):
        monkeypatch.setenv("JEPSEN_ELLE_EXCHANGE", "dense")
        assert mod.resolve_exchange("packed") == "dense"
        monkeypatch.delenv("JEPSEN_ELLE_EXCHANGE")
        assert mod.resolve_exchange(None) == "packed"
        assert mod.resolve_exchange("Dense ") == "dense"
        with pytest.raises(ValueError):
            mod.resolve_exchange("bogus")
    monkeypatch.setenv("JEPSEN_ELLE_EXCHANGE", "bogus")
    with pytest.raises(ValueError):
        p_ops.sharded_closure([0], [1], 4, cpu_mesh(2), exchange="packed")


def test_shard_exchange_bytes_per_step_matches_reference():
    for n in (64, 256, 1000, 8192):
        for d in (1, 2, 4, 8, 64):
            for mode in ("packed", "dense"):
                assert p_ops.shard_exchange_bytes_per_step(n, d, mode) == \
                    r_ops.shard_exchange_bytes_per_step(n, d, mode), (n, d, mode)
            assert p_ops.shard_exchange_bytes_per_step(n, d, "packed") * 16 == \
                p_ops.shard_exchange_bytes_per_step(n, d, "dense")
    with pytest.raises(ValueError):
        p_ops.shard_exchange_bytes_per_step(64, 2, "bogus")


@pytest.mark.parametrize("pad,n_edges", [(128, 0), (128, 300), (256, 2000), (512, 40)])
def test_edge_words_equal_pack_bits_host(pad, n_edges):
    """The host builds the entry words from the edge list (duplicates
    included) with no dense matrix; they are the packed adjacency."""
    rng = np.random.default_rng(pad + n_edges)
    s = rng.integers(0, pad, n_edges)
    d = rng.integers(0, pad, n_edges)
    adj = np.zeros((pad, pad), bool)
    adj[s, d] = True
    got = p_ops.edge_words(s.tolist(), d.tolist(), pad)
    assert got.dtype == np.uint32 and np.array_equal(got, p_ops.pack_bits_host(adj))


@pytest.mark.parametrize("r,w,m", [(8, 4, 128), (5, 3, 91), (1, 2, 33), (16, 1, 32)])
def test_unpack_plain_matches_reference(r, w, m):
    """Row 10b's plain version against ``_unpack_device`` on the JAX CPU,
    m cutting inside a word included."""
    import jax.numpy as jnp

    words = np.random.default_rng(r * w + m).integers(0, 2**32, (r, w), dtype=np.uint64)
    words = words.astype(np.uint32)
    want = np.asarray(r_ops._unpack_device(jnp.asarray(words), m))
    got = p_ops.unpack_plain(torch.from_numpy(words.view(np.int32)), m)
    assert got.dtype == torch.float32 and tuple(got.shape) == (r, m)
    assert np.array_equal(got.numpy() > 0, want)
    assert set(np.unique(got.numpy())) <= {0.0, 1.0}


@pytest.mark.parametrize("r,c", [(4, 32), (7, 128), (32, 512)])
def test_pack_rows_plain_matches_reference(r, c):
    import jax.numpy as jnp

    bits = np.random.default_rng(r + c).random((r, c)) < 0.3
    want = np.asarray(r_ops._pack_device(jnp.asarray(bits)))
    got = p_ops.pack_rows_plain(torch.from_numpy(bits.astype(np.float32)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert np.array_equal(p_ops.unpack_plain(got, c).numpy() > 0, bits)


@pytest.mark.parametrize("d", [1, 2, 8])
def test_block_square_plain_matches_one_reference_step(d):
    """One sharded step of shard 0, ``min(b + b @ full, 1)``, against the
    reference's bf16 step on the JAX CPU; the gather of contiguous blocks
    is the full matrix itself."""
    import jax.numpy as jnp

    pad = 256
    full = (np.random.default_rng(d).random((pad, pad)) < 0.02).astype(np.float32)
    b = full[: pad // d]
    want = np.asarray(jnp.minimum(jnp.asarray(b, jnp.bfloat16)
                                  + jnp.asarray(b, jnp.bfloat16) @ jnp.asarray(full, jnp.bfloat16),
                                  jnp.bfloat16(1.0))).astype(np.float32)
    gathered = p_ops.gather_plain(torch.from_numpy(full), d)
    assert torch.equal(gathered, torch.from_numpy(full))
    got = p_ops.block_square_plain(torch.from_numpy(b), gathered)
    assert np.array_equal(got.numpy(), want)


# -- the engine's mesh= path ----------------------------------------------------


@pytest.mark.parametrize("d", [2, 8])
@pytest.mark.parametrize("seed", [16, 17])
def test_cycle_anomalies_on_a_mesh_match_reference_and_host(seed, d):
    """tests/test_elle.py:1082-1091 at D = 2 and 8: every closure through
    the sharded closure; result and report equal the reference's and the
    result the host path's."""
    g = _random_typed_graph(random.Random(seed), 48, extra_edges=True)
    kw = dict(device=True, extra=("realtime", "process"))
    r_rep, p_rep = {}, {}
    want = R.cycle_anomalies(g, mesh=ref_mesh(d), report=r_rep, **kw)
    got = P.cycle_anomalies(port_graph(g), mesh=cpu_mesh(d), report=p_rep, **kw)
    host = P.cycle_anomalies(port_graph(g), device=False, extra=kw["extra"])
    assert got == want == host
    assert p_rep == r_rep
    assert p_rep["engine"] == "device" and p_rep["chunks"] >= 3 and not p_rep.get("causes")


def test_mesh_closures_are_the_bucketed_closures():
    """The views of the mesh path have no labels; their bits are the
    bucketed kernel's at the same pad."""
    g = port_graph(_random_typed_graph(random.Random(18), 100))
    masks = [P.WW, P.WW | P.WR, P.WW | P.WR | P.RW]
    bucketed = p_engine.graph_closures(g, masks, torch_device="cpu")
    sharded = p_engine.graph_closures(g, masks, mesh=cpu_mesh(4))
    for m in masks:
        assert sharded[m].labels is None
        assert np.array_equal(sharded[m].packed, bucketed[m].packed)
        assert sharded[m].sccs() == bucketed[m].sccs()


@pytest.mark.parametrize("kind", ["append", "wr"])
@pytest.mark.parametrize("seed", [3, 4])
def test_checks_on_a_mesh_match_reference(kind, seed):
    """append.check and wr.check with mesh=, on small lagged histories (a
    stale read in the lag window closes a cycle), result maps and
    reports equal to the reference's."""
    if kind == "append":
        h = lagged_append_history(seed, 160, (40, 100), depth=6)
        r_fn, p_fn, kw = r_append.check, p_append.check, dict(additional_graphs=("process",))
    else:
        h = lagged_wr_history(seed, 160, (40, 100), depth=6)
        r_fn, p_fn, kw = r_wr.check, p_wr.check, dict(wfr_keys=True)
    r_rep, p_rep = {}, {}
    want = r_fn(to_ref_history(h), device=True, mesh=ref_mesh(2), report=r_rep, **kw)
    got = p_fn(h, device=True, mesh=cpu_mesh(2), report=p_rep, **kw)
    assert got == want and p_rep == r_rep
    assert p_rep["engine"] == "device" and not p_rep.get("causes")
    plain = p_fn(h, device=True, torch_device="cpu", **kw)
    assert {k: v for k, v in got.items() if k != "engine"} == \
        {k: v for k, v in plain.items() if k != "engine"}
    if seed == 3:
        assert got["valid"] is False


# -- the fault policy (ROADMAP.md, divergence 1) --------------------------------


def test_mesh_of_three_folds_in_the_reference_and_raises_in_the_port():
    g = _random_typed_graph(random.Random(19), 40)
    r_rep = {}
    want = R.cycle_anomalies(g, device=True, mesh=ref_mesh(3), report=r_rep)
    codes = {c["code"] for c in r_rep["causes"]}
    assert codes == {"elle_device_oom"} and r_rep["engine"] == "host"
    assert all(c["params"]["sharded"] is True for c in r_rep["causes"])
    with pytest.raises(ValueError, match="power-of-two"):
        P.cycle_anomalies(port_graph(g), device=True, mesh=cpu_mesh(3), report={})
    assert want == P.cycle_anomalies(port_graph(g), device=False)


def _boom(*_a, **_kw):
    raise torch.OutOfMemoryError("CUDA out of memory: injected")


def test_oom_on_cpu_tensors_folds_typed_as_reference(monkeypatch):
    g = _random_typed_graph(random.Random(20), 60)
    monkeypatch.setattr(r_ops, "sharded_closure", _boom)
    monkeypatch.setattr(p_ops, "sharded_closure", _boom)
    r_rep, p_rep = {}, {}
    want = R.cycle_anomalies(g, device=True, mesh=ref_mesh(2), report=r_rep)
    got = P.cycle_anomalies(port_graph(g), device=True, mesh=cpu_mesh(2), report=p_rep)
    assert got == want
    strip = lambda rep: [(c["code"], {k: v for k, v in c["params"].items() if k != "error"})
                         for c in rep["causes"]]  # noqa: E731
    assert strip(p_rep) == strip(r_rep) == [
        ("elle_device_oom", {"n": 60, "n_devices": 2, "sharded": True})]
    assert p_rep["engine"] == r_rep["engine"] == "host"


def test_oom_on_the_gpu_raises_naming_the_closure(monkeypatch):
    calls = []

    def boom(srcs, dsts, n, mesh, exchange=None):
        calls.append(n)
        _boom()

    monkeypatch.setattr(p_engine, "mesh_device", lambda _m, _d: torch.device("cuda"))
    monkeypatch.setattr(p_ops, "sharded_closure", boom)
    g = port_graph(_random_typed_graph(random.Random(13), 60))
    rep = {}
    with pytest.raises(torch.OutOfMemoryError, match=r"n=60 at pad 256 on 8 shard"):
        P.cycle_anomalies(g, device=True, mesh=Mesh((8, 1), ("dp", "mp"), "cuda"), report=rep)
    assert calls == [60] and not rep.get("causes")


def test_a_torch_device_that_is_not_the_meshs_raises():
    g = port_graph(_random_typed_graph(random.Random(21), 30))
    with pytest.raises(ValueError, match="not the mesh's device"):
        P.cycle_anomalies(g, device=True, mesh=cpu_mesh(2), torch_device="cuda")
    with pytest.raises(ValueError, match="not the mesh's device"):
        P.cycle_anomalies(g, device=True, mesh=Mesh((2, 1), ("dp", "mp"), "cuda"),
                          torch_device="cpu")
    with pytest.raises(ValueError, match="not the mesh's device"):
        p_append.check(lagged_append_history(3, 20), device=True, mesh=cpu_mesh(2),
                       torch_device="cuda")
    # The mesh's own device, named or not, is accepted.
    assert P.cycle_anomalies(g, device=True, mesh=cpu_mesh(2), torch_device="cpu") == \
        P.cycle_anomalies(g, device=False)
