"""Port vs JAX package: ``parallel/multihost.py`` in one process on the CPU.

``initialize``'s environment rules: the JAX package's message when
``MG_GCN_COORDINATOR`` is set and a companion variable is missing; no error
when the caller passes ``num_processes`` and ``process_id`` itself (the JAX
package reads the variables first and raises there, ADVICE.md's eager env
read); a second call changes nothing; no coordinator at all raises. The
route rule for card tensors. The port's placement, ``dist.shard`` and
``dist.replicate`` (of a mapped ``features.bin`` too), against JAX's
``shard_put``, ``replicate_put``, ``tree_shard_put`` and
``load_row_sharded`` on conftest's CPU mesh. The two-process paths are
``tests/test_torch_port_multiprocess.py``'s."""

import socket

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from mg_gcn_tpu.parallel import dist as jdist
from mg_gcn_tpu.parallel import multihost as jmultihost
from mg_gcn_tpu_torch.formats import read_dense, write_dense
from mg_gcn_tpu_torch.parallel import dist, multihost
from tests.torch_port_dist_cases import cpu_ring

ENV = ("MG_GCN_COORDINATOR", "MG_GCN_NUM_PROCESSES", "MG_GCN_PROCESS_ID", "MG_GCN_LOCAL_DEVICE_IDS")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    yield
    multihost.shutdown()


@pytest.mark.parametrize("missing", ["MG_GCN_NUM_PROCESSES", "MG_GCN_PROCESS_ID"])
def test_initialize_missing_companion_raises_jax_message(monkeypatch, missing):
    monkeypatch.setenv("MG_GCN_COORDINATOR", "localhost:1")
    for var in ("MG_GCN_NUM_PROCESSES", "MG_GCN_PROCESS_ID"):
        if var != missing:
            monkeypatch.setenv(var, "0" if var == "MG_GCN_PROCESS_ID" else "2")
    with pytest.raises(ValueError) as got:
        multihost.initialize()
    with pytest.raises(ValueError) as want:
        jmultihost.initialize()
    assert str(got.value) == str(want.value)
    assert missing in str(got.value) and multihost.process_count() == 1


def test_initialize_explicit_keywords_need_no_env(monkeypatch, capfd):
    """With the coordinator in the environment and the counts passed as
    keywords, the port starts a world of one; the JAX package raises for
    the variables it did not need. A second call is a no-op."""
    monkeypatch.setenv("MG_GCN_COORDINATOR", f"localhost:{_free_port()}")
    with pytest.raises(ValueError, match="MG_GCN_NUM_PROCESSES is missing"):
        jmultihost.initialize(num_processes=1, process_id=0)
    multihost.initialize(num_processes=1, process_id=0, timeout=60)
    world = multihost._WORLD
    assert (multihost.process_index(), multihost.process_count(), multihost.route()) == (0, 1, "gloo")
    assert "multihost: process 0 of 1" in capfd.readouterr().err
    multihost.initialize(num_processes=4, process_id=3)  # already joined: nothing changes
    assert multihost._WORLD is world and capfd.readouterr().err == ""
    x = torch.arange(6.0).reshape(2, 3)
    assert [t.tolist() for t in multihost.all_gather(x)] == [x.tolist()]
    assert multihost.broadcast_object({"a": 1}) == {"a": 1}
    multihost.shutdown()
    assert multihost.process_count() == 1 and multihost.route() is None


def test_initialize_local_device_ids_from_env(monkeypatch):
    monkeypatch.setenv("MG_GCN_COORDINATOR", f"tcp://localhost:{_free_port()}")
    monkeypatch.setenv("MG_GCN_NUM_PROCESSES", "1")
    monkeypatch.setenv("MG_GCN_PROCESS_ID", "0")
    monkeypatch.setenv("MG_GCN_LOCAL_DEVICE_IDS", "0,1")
    multihost.initialize(timeout=60)
    assert multihost.local_device_ids() == (0, 1) and multihost.process_count() == 1


@pytest.mark.parametrize("kw,message", [
    ({}, "no coordinator: set MG_GCN_COORDINATOR"),
    ({"coordinator_address": "localhost:1"}, "a coordinator needs num_processes and process_id"),
    ({"coordinator_address": "localhost:1", "num_processes": 1, "process_id": 0, "bogus": 1},
     "unknown initialize keywords"),
])
def test_initialize_refusals(kw, message):
    with pytest.raises((ValueError, TypeError), match=message):
        multihost.initialize(**kw)
    assert multihost.process_count() == 1


A, B, C = ("h", "GPU-a"), ("h", "GPU-b"), ("h", "GPU-c")


@pytest.mark.parametrize("cards,route", [
    ([None, None], "gloo"),
    ([(A,), (B,)], "nccl"),
    ([(A,), (A,)], "staged"),  # two processes on one card: NCCL refuses a second rank
    ([(("h1", "0"),), (("h2", "0"),)], "nccl"),  # card 0 of two hosts
    ([(A,), None], "staged"),
    ([(A,), (B,), (A,)], "staged"),
    ([(A, B), (B, C)], "staged"),  # the processes share their second card
    ([(A, B), (B,)], "staged"),
])
def test_route_rule(cards, route):
    assert multihost.choose_route(cards) == route


def test_route_rule_refuses_several_cards_a_process_on_nccl():
    """NCCL gets one rank a process, on one card: a process that names two
    distinct cards is refused there rather than run on one of them."""
    with pytest.raises(ValueError, match="the NCCL route takes one card a process"):
        multihost.choose_route([(A, B), (C,)])


def test_card_identity_lists_distinct_cards(monkeypatch):
    """Every card a process names is in its identity, each once, so an
    overlap on any card (not only the first) shows."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: type("P", (), {"uuid": f"GPU-{i}"})())
    host = socket.gethostname()
    assert multihost._card_identity((1, 2, 1)) == ((host, "GPU-1"), (host, "GPU-2"))
    assert multihost.choose_route([multihost._card_identity((0, 1)), multihost._card_identity((1, 2))]) == "staged"


def test_one_process_helpers_reduce():
    """Not joined: a world of one; the exchange helpers pass through."""
    x = torch.ones(3)
    assert multihost.all_gather(x)[0] is x and multihost.exchange([], []) == []
    assert multihost.broadcast_object(5) == 5


@pytest.mark.parametrize("parts", [2, 4])
def test_shard_put_equals_jax(parts):
    """``dist.shard``, the port's placement, against JAX's ``shard_put``."""
    x = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    got = dist.shard(x, cpu_ring(parts))
    want = jmultihost.shard_put(x, jdist.make_mesh(parts))
    assert len(got) == parts
    for t, shard in zip(got, sorted(want.addressable_shards, key=lambda s: s.index[0].start)):
        assert np.array_equal(t.numpy(), np.asarray(shard.data))
    assert np.array_equal(torch.cat(got).numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="do not split into 3 equal partitions"):
        dist.shard(x[:10], cpu_ring(3))


def test_replicate_and_tree_shard_put_equal_jax():
    """``dist.replicate`` against JAX's ``replicate_put``, and ``dist.shard``
    leaf by leaf against JAX's ``tree_shard_put``."""
    mesh, ring = jdist.make_mesh(4), cpu_ring(4)
    params = [{"W": np.arange(12, dtype=np.float32).reshape(3, 4), "b": np.ones((1, 4), np.float32)}]
    want = jmultihost.replicate_put(params, mesh)
    got = dist.replicate([{k: torch.from_numpy(v) for k, v in p.items()} for p in params], ring)
    assert len(got) == 1  # one replica a distinct device
    for k in ("W", "b"):
        assert np.array_equal(got[0][0][k].numpy(), np.asarray(want[0][k]))
    tree = {"x": np.arange(32, dtype=np.float32).reshape(16, 2), "y": [np.arange(16, dtype=np.int32)]}
    rows = NamedSharding(mesh, PartitionSpec(jdist.GRAPH_AXIS))
    jtree = jmultihost.tree_shard_put(tree, mesh, {"x": rows, "y": [rows]})
    for leaf, jleaf in ((tree["x"], jtree["x"]), (tree["y"][0], jtree["y"][0])):
        placed = dist.shard(leaf, ring)
        assert np.array_equal(torch.cat(placed).numpy(), np.asarray(jleaf))
        assert [t.shape[0] for t in placed] == [len(leaf) // 4] * 4


def test_load_row_sharded_equals_jax(tmp_path):
    """A mapped ``features.bin`` placed by ``dist.shard`` against JAX's
    ``load_row_sharded``: the blocks are private contiguous copies."""
    x = np.random.default_rng(1).random((32, 16)).astype(np.float32)
    path = str(tmp_path / "features.bin")
    write_dense(path, x, np.float32)
    mapped = read_dense(path, mmap=True)
    assert isinstance(mapped, np.memmap)
    got = dist.shard(mapped, cpu_ring(4))
    want = jmultihost.load_row_sharded(path, jdist.make_mesh(4))
    assert np.array_equal(torch.cat(got).numpy(), np.asarray(want))
    assert all(t.is_contiguous() and t.shape == (8, 16) for t in got)
    got[0][0, 0] = 5.0  # a private copy, never the read-only mapping
    assert float(dist.shard(read_dense(path, mmap=True), cpu_ring(4))[0][0, 0]) == float(x[0, 0])


def test_ring_ownership_one_process():
    ring = dist.make_mesh(4, ["cpu"] * 4)
    assert (ring.parts, ring.world, ring.rank, list(ring.local), ring.first) == (4, 1, 0, [0, 1, 2, 3], 0)
    assert [ring.owner(j) for j in range(4)] == [0] * 4
    two = dist.Ring((torch.device("cpu"),) * 2, world=2, rank=1)
    assert (two.parts, list(two.local), [two.owner(j) for j in range(4)]) == (4, [2, 3], [0, 0, 1, 1])
    assert jax.process_count() == 1


class _Posted:
    """A ``P2POp`` that only records what it would post."""

    def __init__(self, op, tensor, peer, group=None, tag=0):
        self.op, self.tensor, self.peer, self.tag = op, tensor, peer, tag


def _deliver_as_nccl(monkeypatch, run):
    """``run(ring)`` on each process of a two-process ring of 4 partitions,
    every message recorded in the order its process posts it, then
    delivered as NCCL pairs messages: a process's k-th send to a peer fills
    that peer's k-th receive from it, tags unread (the tags must agree all
    the same). Returns both processes' results."""
    import torch.distributed as tdist

    monkeypatch.setattr(tdist, "P2POp", _Posted)
    posted, outs = {}, []
    for rank in (0, 1):
        ops = posted[rank] = []
        monkeypatch.setattr(tdist, "batch_isend_irecv", lambda batch, ops=ops: ops.extend(batch) or [])
        outs.append(run(dist.Ring((torch.device("cpu"),) * 2, world=2, rank=rank)))
    for src, dst in ((0, 1), (1, 0)):
        sends = [o for o in posted[src] if o.op is tdist.isend and o.peer == dst]
        recvs = [o for o in posted[dst] if o.op is tdist.irecv and o.peer == src]
        assert [o.tag for o in sends] == [o.tag for o in recvs], (src, dst)
        for s, r in zip(sends, recvs):
            r.tensor.copy_(s.tensor)
    return outs


@pytest.mark.parametrize("back", [False, True])
def test_exchanges_post_a_peers_messages_in_the_order_it_receives_them(monkeypatch, back):
    """At P = 4 over two processes, ``dist._all_to_all`` and
    ``dist._permute`` (shifts 1, -1, 2, 3), forward and backward, post
    each peer's sends in the tag order in which that peer posts the
    matching receives, so that NCCL, which pairs them by posting order and
    ignores tags, delivers every block where it belongs: each partition
    gets what a one-process exchange gives it."""
    pieces = [[torch.full((2, 3), float(10 * j + k)) for k in range(4)] for j in range(4)]
    one = dist._all_to_all(pieces, cpu_ring(4))
    two = _deliver_as_nccl(monkeypatch, lambda ring: dist._all_to_all([pieces[j] for j in ring.local], ring,
                                                                         position=5, back=back))
    for k in range(4):
        assert [float(t[0, 0]) for t in two[k // 2][k % 2]] == [float(t[0, 0]) for t in one[k]], k
    blocks = [torch.full((2, 3), float(j)) for j in range(4)]
    for shift in (1, -1, 2, 3):
        one = dist._permute(blocks, shift, cpu_ring(4))
        two = _deliver_as_nccl(monkeypatch, lambda ring: dist._permute([blocks[j] for j in ring.local], shift, ring,
                                                                          position=7, back=back))
        assert [float(two[j // 2][j % 2][0, 0]) for j in range(4)] == [float(t[0, 0]) for t in one], shift
