"""The port's mesh, its id-exchange lookup and its shard-local row updates
against the JAX package's, on the CPU.

Placement: each rank's mesh coordinates and row ranges against JAX's
``make_mesh`` / ``param_shardings`` on the 8-device CPU mesh of
``tests/conftest.py``. The shard-local updates run in one process, looped
over the shards of a ``Mesh(4, 2)`` that knows its coordinates only,
against JAX's ``shard_map`` versions on ``make_mesh(data=4, model=2)``. The
exchange runs on 2 and 4 gloo ranks (``spawn_ranks``, ``file://``
rendezvous under ``tmp_path``, one thread a rank) against JAX's
``sharded_lookup`` on meshes of the same shape.

The spawned ranks import this module, so JAX is imported inside the tests
that use it, never at the top.

Tolerances: the exchange's rows are copies (exact); its table gradient
sums each row's slots in another order than JAX's scatter-add (rtol 1e-6);
the updates are the same float32 formulas (rtol 1e-6, exact where a row is
left alone).
"""

import numpy as np
import pytest
import torch

from news_recsys_tpu_torch.models.rankers import build_ranker
from news_recsys_tpu_torch.ops.fused_lookup_pool import fused_lookup_pool
from news_recsys_tpu_torch.parallel import distributed
from news_recsys_tpu_torch.parallel.mesh import Mesh, param_shardings
from news_recsys_tpu_torch.parallel.sharded_embedding import sharded_lookup, sharded_lookup_pool
from news_recsys_tpu_torch.training import sparse_step as tss

from tests.test_torch_cuda import train_cfg

torch.set_num_threads(2)
V, D = 512, 8
OOB = tss.OOB_ROW
LAYOUTS = [(8, 1), (4, 2), (2, 4), (1, 8)]


# -- placement -----------------------------------------------------------------


@pytest.mark.parametrize("data,model", LAYOUTS + [(-1, 2)])
def test_mesh_coordinates_match_jax(data, model):
    import jax

    from news_recsys_tpu.parallel.mesh import make_mesh

    jmesh = make_mesh(data, model)
    devices = jax.devices()
    for r in range(8):
        mesh = Mesh(data, model, rank=r, world=8)
        where = np.argwhere(jmesh.devices == devices[r])
        assert [tuple(where[0])] == [mesh.coords()] and mesh.shape == dict(jmesh.shape)


@pytest.mark.parametrize("data,model", LAYOUTS)
def test_row_ranges_match_jax_param_shardings(data, model):
    """Each device's rows of a JAX-sharded (1024, 8) table and (128, 8) table
    are the port rank's ``row_range``; a dense kernel and a 1-D leaf stay
    whole on every rank."""
    import jax
    import jax.numpy as jnp

    from news_recsys_tpu.parallel.mesh import make_mesh
    from news_recsys_tpu.parallel.mesh import param_shardings as jparam_shardings

    jmesh = make_mesh(data, model)
    params = {"params": {"embedder": {"arena_d8": jnp.zeros((1024, 8)),
                                      "category": jnp.zeros((128, 8)),
                                      "bias_1d": jnp.zeros((16,))},
                         "Dense_0": {"kernel": jnp.zeros((8, 4))}}}
    placed = jax.device_put(params, jparam_shardings(params, jmesh))
    devices = jax.devices()
    for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        sharded = path[1].key == "embedder" and leaf.ndim == 2 and model > 1
        for shard in leaf.addressable_shards:
            mesh = Mesh(data, model, rank=devices.index(shard.device), world=8)
            rows = shard.index[0]
            start, stop = (mesh.row_range(leaf.shape[0]) if sharded else (0, leaf.shape[0]))
            assert (rows.start or 0, leaf.shape[0] if rows.stop is None else rows.stop) \
                == (start, stop)


@pytest.mark.parametrize("model", [1, 2])
def test_param_shardings_shard_every_table(model):
    """Every table under ``embedder`` shards over the model axis when it has
    more than one rank; the tower and the cross stack are replicated."""
    net = build_ranker(train_cfg(False), device="cpu")
    got = param_shardings(net, Mesh(1, model, rank=0, world=model))
    tables = {n for n in got if n.startswith("embedder.tables.")}
    assert tables == {"embedder.tables.user_id", "embedder.tables.item_id",
                      "embedder.tables.category"}
    assert {n for n, axis in got.items() if axis} == (tables if model > 1 else set())


def test_batch_slice_must_divide():
    mesh = Mesh(2, 2, rank=3, world=4)
    assert mesh.batch_slice(64) == slice(32, 64) and mesh.row_range(512) == (256, 512)
    with pytest.raises(ValueError, match="not divisible by the mesh's data axis"):
        mesh.batch_slice(63)
    with pytest.raises(ValueError, match="!= 4 processes"):
        Mesh(3, 2, rank=0, world=4)


# -- shard-local updates -----------------------------------------------------------


def sorted_slots(rng, n_real=40):
    """The sorted layout of a sharded step: slots below the table's range
    (-1), real rows in both shards (a few named twice, with the same summed
    gradient), and out-of-range slots (``OOB_ROW``), whose gradients are
    nonzero here so that dropping them is what keeps them out."""
    ids = np.sort(rng.integers(1, V - 1, n_real))
    ids[5] = ids[4]
    g = rng.standard_normal((n_real, D)).astype(np.float32)
    g[5] = g[4]
    rows = np.concatenate([[-1, -1], ids, [OOB] * 3]).astype(np.int32)
    grads = np.concatenate([rng.standard_normal((2, D)), g,
                            rng.standard_normal((3, D))]).astype(np.float32)
    return rows, grads


def port_sharded(update, arrays, rows, grads, *args):
    """``update`` on each shard of a (data 4, model 2) mesh's rank 0 and 1,
    concatenated."""
    outs = []
    for s in range(2):
        mesh = Mesh(4, 2, rank=s, world=8)
        parts = [torch.from_numpy(a[slice(*mesh.row_range(V))].copy()) for a in arrays]
        update(mesh)(*parts, torch.from_numpy(rows), torch.from_numpy(grads), *args)
        outs.append([p.numpy() for p in parts])
    return [np.concatenate(x) for x in zip(*outs)]


def test_sharded_adagrad_update_matches_jax():
    import jax.numpy as jnp

    from news_recsys_tpu.parallel.mesh import make_mesh
    from news_recsys_tpu.training import sparse_step as jss

    rng = np.random.default_rng(0)
    table = rng.standard_normal((V, D)).astype(np.float32)
    table[0] = 0.0
    acc = np.full(V, 0.1, np.float32)
    rows, grads = sorted_slots(rng)
    jt, ja = jss.make_sharded_adagrad_update(make_mesh(4, 2))(
        jnp.asarray(table), jnp.asarray(acc), jnp.asarray(rows), jnp.asarray(grads), 0.05)
    pt, pa = port_sharded(tss.make_sharded_adagrad_update, (table, acc), rows, grads, 0.05)
    np.testing.assert_allclose(pt, np.asarray(jt), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pa, np.asarray(ja), rtol=1e-6, atol=1e-7)
    untouched = np.setdiff1d(np.arange(V), rows)
    assert np.array_equal(pt[untouched], table[untouched]) and np.array_equal(pa[0], acc[0])
    assert not np.array_equal(pt[rows[2]], table[rows[2]])


def test_sharded_rowwise_update_matches_jax():
    """``sparse_adamw`` on shards: the padding row 0 and the spare row V-1,
    reached only by dropped slots, keep their values (weight decay would
    move the spare row were it written)."""
    import jax.numpy as jnp

    from news_recsys_tpu.parallel.mesh import make_mesh
    from news_recsys_tpu.training import sparse_step as jss

    rng = np.random.default_rng(1)
    table = rng.standard_normal((V, D)).astype(np.float32)
    table[0] = 0.0
    mu = rng.standard_normal((V, D)).astype(np.float32) * 0.01
    nu = np.abs(rng.standard_normal((V, D))).astype(np.float32) * 0.01
    rows, grads = sorted_slots(rng)
    hp = (1e-2, 3, 0.9, 0.999, 1e-8, 0.01)
    jout = jss.make_sharded_rowwise_update(make_mesh(4, 2))(
        jnp.asarray(table), jnp.asarray(mu), jnp.asarray(nu), jnp.asarray(rows),
        jnp.asarray(grads), *hp)
    pout = port_sharded(tss.make_sharded_rowwise_update, (table, mu, nu), rows, grads, *hp)
    for p, j in zip(pout, jout):
        np.testing.assert_allclose(p, np.asarray(j), rtol=1e-6, atol=1e-7)
    for before, after in zip((table, mu, nu), pout):
        assert np.array_equal(after[[0, V - 1]], before[[0, V - 1]])


def test_sharded_joint_dedup_routes_foreign_slots_out():
    """Two tables in one joint dedup: sharded, each table's rows stay sorted,
    its own slots keep their rows and summed gradients (those of the
    one-device layout), and every other slot lies outside ``[0, V)`` (-1 or
    ``OOB_ROW``), so no shard writes it; on one device they clip onto row 0
    and the spare row."""
    rng = np.random.default_rng(2)
    vocab = {"a": (300, 4), "b": (400, 4)}
    per_table = {t: [(torch.from_numpy(rng.integers(0, v, 64).astype(np.int32)),
                      torch.from_numpy(rng.standard_normal((64, d)).astype(np.float32)), 0)]
                 for t, (v, d) in vocab.items()}
    spare = {"a": 383, "b": 511}
    one = tss._joint_dedup(per_table, vocab, spare)
    sharded = tss._joint_dedup(per_table, vocab, {t: OOB for t in vocab}, sharded=True)
    for t, (v, _) in vocab.items():
        rows, g = sharded[t]
        rows1, g1 = one[t]
        assert bool((rows[1:] >= rows[:-1]).all())
        mine = (rows >= 1) & (rows < v)
        assert torch.equal(rows[mine], rows1[mine]) and torch.equal(g[mine], g1[mine])
        assert bool(((rows[~mine] == -1) | (rows[~mine] == OOB)).all())
        assert bool((g[~mine] == 0).all()) and int((~mine).sum()) > 0
        assert bool(((rows1[~mine] == 0) | (rows1[~mine] >= v)).all())


# -- the exchange on gloo ranks --------------------------------------------------


def exchange_case(rng, layout, ids_shape, bad=False, pool=False):
    ids = rng.integers(0, V, ids_shape).astype(np.int32)
    ids.reshape(-1)[::7] = 0
    if bad:
        ids.reshape(-1)[[1, 3, 5]] = [V, V + 9, -1]
    case = {"layout": layout, "table": rng.standard_normal((V, D)).astype(np.float32),
            "ids": ids, "bad": bad, "pool": pool}
    case["table"][0] = 0.0
    out_shape = (ids_shape[0], D) if pool else (*ids_shape, D)
    case["w"] = rng.standard_normal(out_shape).astype(np.float32)
    if pool:
        case["mask"] = (rng.random(ids_shape) < 0.8).astype(np.float32)
    return case


def exchange_worker(rank, cases):
    """Every case's lookup (or pool) on this rank's shard and batch slice,
    and its shard's gradient of ``sum(out * w)``."""
    meshes = {lay: Mesh(*lay) for lay in sorted({c["layout"] for c in cases})}
    out = []
    for c in cases:
        mesh = meshes[c["layout"]]
        shard = torch.from_numpy(c["table"][slice(*mesh.row_range(V))].copy()).requires_grad_()
        sl = mesh.batch_slice(c["ids"].shape[0])
        ids = torch.from_numpy(c["ids"][sl])
        if c["pool"]:
            y = sharded_lookup_pool(shard, ids, torch.from_numpy(c["mask"][sl]), mesh)
        else:
            y = sharded_lookup(shard, ids, mesh)
        if not c["bad"]:
            (y * torch.from_numpy(c["w"][sl])).sum().backward()
        out.append((mesh.coords(), y.detach().numpy(),
                    None if shard.grad is None else shard.grad.numpy()))
    stats = [m.stats for m in meshes.values()]
    return (out, sum(s.calls for s in stats), sum(s.host_copies for s in stats),
            host_fetches(rank, meshes, cases))


def host_fetches(rank, meshes, cases):
    """What every rank fetches of the last mesh's first case: the whole table
    from the model axis's shards, the whole id batch from the data axis's
    slices, the main process's name and a broadcast string."""
    lay = sorted(meshes)[-1]
    mesh, case = meshes[lay], next(c for c in cases if c["layout"] == lay)
    shard = torch.from_numpy(case["table"][slice(*mesh.row_range(V))].copy())
    ids = torch.from_numpy(case["ids"][mesh.batch_slice(case["ids"].shape[0])])
    return {"table": distributed.fetch_to_host(shard, mesh.groups["model"]),
            "tree": distributed.fetch_pytree_to_host({"t": [shard]}, mesh.groups["model"]),
            "batch": distributed.host_local_batch_to_global({"ids": ids},
                                                            mesh.groups["data"])["ids"],
            "main": distributed.is_main_process(), "rank": distributed.process_index(),
            "world": distributed.process_count(),
            "ts": distributed.broadcast_str(f"stamp-{rank}")}


def assemble(results, i, layout):
    """(the whole output in batch order, the whole table gradient) of case
    ``i``: each data slice from its model group, whose ranks must agree, and
    each shard's gradient summed over the data axis."""
    data, model = layout
    by = {coords: (y, g) for coords, y, g in (r[0][i] for r in results)}
    for d in range(data):
        for m in range(1, model):
            np.testing.assert_array_equal(by[(d, m)][0], by[(d, 0)][0])
    y = np.concatenate([by[(d, 0)][0] for d in range(data)])
    if by[(0, 0)][1] is None:
        return y, None
    g = np.concatenate([sum(by[(d, m)][1] for d in range(data)) for m in range(model)])
    return y, g


@pytest.fixture(scope="module")
def exchanges(tmp_path_factory):
    """(cases, results) of one spawn of 2 ranks and one of 4."""
    rng = np.random.default_rng(5)
    runs = {}
    for world, layouts in ((2, [(1, 2)]), (4, [(1, 4), (2, 2)])):
        cases = []
        for lay in layouts:
            cases += [exchange_case(rng, lay, (32,)), exchange_case(rng, lay, (16, 6)),
                      exchange_case(rng, lay, (16, 6), bad=True),
                      exchange_case(rng, lay, (16, 6), pool=True),
                      exchange_case(rng, lay, (16, 6), bad=True, pool=True)]
        init = f"file://{tmp_path_factory.mktemp('rdv')}/store"
        runs[world] = (cases, distributed.spawn_ranks(exchange_worker, world, (cases,),
                                                      init_method=init, threads=1,
                                                      timeout=180))
    return runs


def jax_lookup(case):
    """JAX's ``sharded_lookup`` on a mesh of the case's layout over the first
    devices, and its table gradient of ``sum(out * w)``."""
    import jax
    import jax.numpy as jnp

    from news_recsys_tpu.parallel.mesh import make_mesh
    from news_recsys_tpu.parallel.sharded_embedding import sharded_lookup as jsharded_lookup

    data, model = case["layout"]
    jmesh = make_mesh(data, model, devices=jax.devices()[:data * model])
    ids, w = jnp.asarray(case["ids"]), jnp.asarray(case["w"])

    def loss(t):
        y = jsharded_lookup(t, ids, jmesh)
        return (y * w).sum(), y

    (_, y), g = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(case["table"]))
    return np.asarray(y), np.asarray(g)


@pytest.mark.parametrize("world,i", [(2, i) for i in range(2)]
                         + [(4, i) for i in (0, 1, 5, 6)])
def test_exchange_lookup_matches_jax(exchanges, world, i):
    """1-D and 2-D ids (padding 0 included) at (1, 2), (1, 4) and (2, 2): the
    rows exactly JAX's, and the table gradient."""
    cases, results = exchanges[world]
    case = cases[i]
    y, g = assemble(results, i, case["layout"])
    jy, jg = jax_lookup(case)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_allclose(g, jg, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world,i", [(2, 2), (4, 2), (4, 7)])
def test_exchange_reads_nan_out_of_range(exchanges, world, i):
    """An id at V or beyond, or negative, reads a NaN row, as the one-device
    ``take`` reads it; JAX's masked ``psum`` reads zeros there (the named
    divergence). Every other row is JAX's."""
    cases, results = exchanges[world]
    case = cases[i]
    y, _ = assemble(results, i, case["layout"])
    jy, _ = jax_lookup(case)
    bad = (case["ids"] < 0) | (case["ids"] >= V)
    assert bad.sum() == 3
    assert np.isnan(y[bad]).all() and (jy[bad] == 0).all()
    np.testing.assert_array_equal(y[~bad], jy[~bad])


@pytest.mark.parametrize("world,i", [(2, 3), (2, 4), (4, 3), (4, 8), (4, 9)])
def test_exchange_pool_matches_one_device(exchanges, world, i):
    """The pool over the compact table of the exchanged rows against
    ``fused_lookup_pool`` over the whole table (its plain version): the
    same pooled rows, bit for bit, and the same table gradient (bit for bit
    at data 1; summed over the data axis in another order at data 2). An
    example holding an out-of-range id pools to NaN."""
    cases, results = exchanges[world]
    case = cases[i]
    y, g = assemble(results, i, case["layout"])
    table = torch.from_numpy(case["table"]).requires_grad_()
    ref = fused_lookup_pool(table, torch.from_numpy(case["ids"]), torch.from_numpy(case["mask"]))
    np.testing.assert_array_equal(y, ref.detach().numpy())
    if case["bad"]:
        assert np.isnan(y).any(axis=1).sum() == len({1 // 6, 3 // 6, 5 // 6})
        return
    (ref * torch.from_numpy(case["w"])).sum().backward()
    if case["layout"][0] == 1:
        np.testing.assert_array_equal(g, table.grad.numpy())
    else:
        np.testing.assert_allclose(g, table.grad.numpy(), rtol=1e-6, atol=1e-7)


def test_exchange_counts_its_collectives(exchanges):
    """Every rank made collectives, and no host copy (CPU tensors: gloo takes
    them as they are)."""
    for world, (_, results) in exchanges.items():
        for _, calls, copies, _ in results:
            assert calls > 0 and copies == 0


@pytest.mark.parametrize("world", [2, 4])
def test_host_fetches(exchanges, world):
    """``fetch_to_host`` and ``fetch_pytree_to_host`` give every rank the
    whole table from its shards, ``host_local_batch_to_global`` the whole
    batch from its slices in batch order; process 0 is the main one and
    its string wins the broadcast."""
    cases, results = exchanges[world]
    lay = sorted({c["layout"] for c in cases})[-1]
    case = next(c for c in cases if c["layout"] == lay)
    for r, (*_, got) in enumerate(results):
        np.testing.assert_array_equal(got["table"], case["table"])
        np.testing.assert_array_equal(got["tree"]["t"][0], case["table"])
        np.testing.assert_array_equal(got["batch"].numpy(), case["ids"])
        assert (got["main"], got["rank"], got["world"], got["ts"]) == (r == 0, r, world,
                                                                        "stamp-0")


# -- starting and running ranks ---------------------------------------------------


def test_failed_start_raises(monkeypatch, tmp_path):
    """No torchrun environment, a coordinator without its count, or a group
    whose other rank never comes: each raises, nothing runs on one process."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError):
        distributed.initialize_distributed(device="cpu")
    with pytest.raises(ValueError, match="--num-processes and --process-id"):
        distributed.initialize_distributed("127.0.0.1:1", device="cpu")
    from datetime import timedelta
    with pytest.raises(Exception, match="[Tt]ime"):
        distributed.initialize_distributed(f"file://{tmp_path}/store", 2, 0, device="cpu",
                                           timeout=timedelta(seconds=2))
    assert not torch.distributed.is_initialized()


def failing_worker(rank):
    if rank == 1:
        raise ValueError("rank one stops here")
    return rank


def test_spawn_ranks_raises_on_a_failed_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*rank one stops here"):
        distributed.spawn_ranks(failing_worker, 2, init_method=f"file://{tmp_path}/store",
                                threads=1, timeout=60)


def test_local_device(monkeypatch):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert distributed.local_device("cpu", 3) == torch.device("cpu")
    assert distributed.local_device("cuda:1", 3) == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert distributed.local_device("cuda", 0) == torch.device("cuda", 2)
    assert distributed.init_url("h:5") == "tcp://h:5"
    assert distributed.init_url("file:///x") == "file:///x"
    assert distributed.default_backend("cuda:0") == "nccl"
    assert distributed.default_backend("cpu") == "gloo"
