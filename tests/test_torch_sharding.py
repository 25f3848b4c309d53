"""The port's sharding rules, per-rank views, elastic restore and the wire
and audit of its new collectives, held to the JAX package's
(``repro.distributed.sharding``).

The reference's rule functions read a mesh's ``axis_names`` and
``devices.shape`` only, so they run here on a duck-typed mesh (``devices
= np.empty(shape)``) at the production sizes, with no child process; the
port runs on ``make_mesh(..., "cpu")``.  ``param_pspecs`` (both modes),
``batch_pspec`` and ``cache_pspecs`` are compared entry by entry for every
arch of the registry (``meliso-mvm`` has no model), full and reduced, on
2 x 4, 16 x 16 and 2 x 16 x 16 meshes, with the abstract batch and cache
trees of both packages' registries beside them (shapes and dtypes)."""
import tempfile
import types

import jax
import numpy as np
import pytest
import torch

from _torch_port import few_threads  # noqa: F401
from jax.sharding import PartitionSpec as JP
from repro.configs import registry as jreg
from repro.distributed import sharding as jsh
from repro_torch.analysis import collective_wire, measure_cost
from repro_torch.analysis import verify as tverify
from repro_torch.configs import SHAPES, get_arch
from repro_torch.configs import registry as treg
from repro_torch.distributed import CheckpointManager
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.collectives import (compressed_psum,
                                                 ring_collective_matmul)
from repro_torch.launch import make_mesh, pmax, pmean, ppermute, psum
from repro_torch.models import params as PM

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def duck_mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def port_mesh(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, "cpu")


def jax_specs(tree):
    """[(keystr path, spec tuple)] of a tree of jax PartitionSpecs."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in flat]


def port_specs(tree):
    return [(p, tuple(s)) for p, s in PM.tree_paths(tree)]


def jax_avals(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
            for p, a in flat]


def port_avals(tree):
    return [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in PM.tree_paths(tree)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", treg.ARCHS)
def test_rules_equal_the_references(arch, reduced, mesh):
    """Every rule of the port gives the reference's spec on every leaf:
    the parameters under ``tp`` and ``fsdp_tp`` (the combined ("pod",
    "data") FSDP candidate on the 3-axis mesh), each assigned shape's
    batch leaves, and each decode shape's caches (the port's ``len`` a
    host tensor of the reference's shape)."""
    ja, ta = jreg.get_arch(arch), get_arch(arch)
    jcfg = ja.reduced() if reduced else ja.model
    tcfg = ta.reduced() if reduced else ta.model
    jm, tm = duck_mesh(mesh), port_mesh(mesh)
    jspecs = jreg.model_module(jcfg).init_specs(jcfg)
    tspecs = treg.model_module(tcfg).init_specs(tcfg)
    for mode in ("tp", "fsdp_tp"):
        want = jax_specs(jsh.param_pspecs(jspecs, jm, mode))
        got = port_specs(tsh.param_pspecs(tspecs, tm, mode))
        assert got == want, mode
    for name in ta.shapes:
        shape = SHAPES[name]
        got = treg.input_specs(ta, name, reduced)
        assert list(got) == list(jreg.input_specs(ja, name, reduced))
        for k in got:
            assert port_avals(got[k]) == jax_avals(
                jreg.input_specs(ja, name, reduced)[k]), (name, k)
        if shape.kind in ("train", "prefill"):
            jb = jreg.batch_specs(ja, shape, reduced)
            tb = treg.batch_specs(ta, shape, reduced)
            assert port_avals(tb) == jax_avals(jb), name
            want = jax_specs(jax.tree.map(
                lambda l: jsh.batch_pspec(l.shape, jm, shape.global_batch),
                jb))
            got = port_specs(PM.tree_map(
                lambda l: tsh.batch_pspec(l.shape, tm, shape.global_batch),
                tb))
            assert got == want, name
        else:
            jc = jreg.decode_cache_specs(ja, shape, reduced)
            tc = treg.decode_cache_specs(ta, shape, reduced)
            assert port_avals(tc) == jax_avals(jc), name
            assert all(t.device.type == ("cpu" if p.endswith("['len']")
                                         else "meta")
                       for p, t in PM.tree_paths(tc)), name
            want = jax_specs(jsh.cache_pspecs(jc, jm, shape.global_batch))
            got = port_specs(tsh.cache_pspecs(tc, tm, shape.global_batch))
            assert got == want, name


def test_resolve_pspec_cases_of_the_reference():
    """``tests/test_framework.py``'s divisibility cases: a divisible dim
    shards, a non-divisible vocab replicates, a repeated logical axis
    falls through; a scalar ``len`` gets ``P()``."""
    sizes = {"data": 16, "model": 16, "pod": 2}
    rules = {"vocab": ("model",), "embed": ("data",), "mlp": ("model",),
             None: ()}
    for shape, axes, rule in (((151936, 2048), ("vocab", "embed"), rules),
                              ((51865, 2048), ("vocab", "embed"), rules),
                              ((64, 64), ("embed", "embed"),
                               {"embed": ("data",), None: ()})):
        assert tuple(tsh.resolve_pspec(shape, axes, rule, sizes)) == \
            tuple(jsh.resolve_pspec(shape, axes, rule, sizes))
    tree = {"k": torch.empty((24, 128, 32768, 8, 128), device="meta"),
            "len": torch.zeros((), dtype=torch.int32)}
    got = tsh.cache_pspecs(tree, make_mesh((1, 1), ("data", "model"), "cpu"),
                           128)
    assert got["len"] == tsh.P() and tuple(got["len"]) == ()
    assert tsh.P(("data",), None) == tsh.P("data", None)
    assert tuple(tsh.P((), None)) == tuple(JP((), None)) == (None, None)


def _block(t, idx, counts):
    sl = tuple(slice(i * (n // c), (i + 1) * (n // c))
               for i, n, c in zip(idx, t.shape, counts))
    return t[sl]


@pytest.mark.parametrize("spec,mesh_shape,axes", [
    (("data", "model"), (2, 4), ("data", "model")),
    ((None, "model", None), (2, 4), ("data", "model")),
    (("model", None, "data"), (2, 4), ("data", "model")),
    ((("pod", "data"), "model"), (2, 2, 2), ("pod", "data", "model")),
    ((("model", "data"),), (2, 4), ("data", "model")),
    ((), (2, 4), ("data", "model")),
])
def test_shard_unshard_round_trip_as_views(spec, mesh_shape, axes):
    """``shard`` gives rank r the block JAX places there (a dim over
    several axes split row-major over them), each a view of the one
    tensor; ``unshard`` joins them back exactly; a replicated tensor's
    blocks are the tensor itself."""
    mesh = make_mesh(mesh_shape, axes, "cpu")
    sh = tsh.NamedSharding(mesh, tsh.P(*spec))
    t = torch.arange(8 * 16 * 24, dtype=torch.float32).reshape(8, 16, 24)
    blocks = tsh.shard(t, sh)
    sizes = dict(zip(axes, mesh_shape))
    dims = [() if p is None else (p,) if isinstance(p, str) else p
            for p in tuple(sh.spec) + (None,) * (t.ndim - len(sh.spec))]
    counts = [int(np.prod([sizes[a] for a in d])) for d in dims]
    for r, b in enumerate(blocks):
        c = mesh.coords(r)
        idx = []
        for d in dims:
            i = 0
            for a in d:
                i = i * sizes[a] + c[a]
            idx.append(i)
        assert torch.equal(b, _block(t, idx, counts)), r
        assert b.untyped_storage().data_ptr() == \
            t.untyped_storage().data_ptr()
    back = tsh.unshard(blocks, sh)
    assert torch.equal(back, t)
    if not any(spec):
        assert all(b is t for b in blocks) and back is t


def test_shard_refuses_what_a_mesh_cannot_split():
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    t = torch.zeros(6, 6)
    for spec in (tsh.P(None, "model"), tsh.P("pod"), tsh.P("data", "data"),
                 tsh.P(None, None, "model")):
        with pytest.raises(ValueError):
            tsh.shard(t, tsh.NamedSharding(mesh, spec))


def test_elastic_restore_across_meshes():
    """The reference's elastic restore: reduced qwen3-1.7b saved under a 2
    x 4 mesh's ``tp`` shardings restores under a 4 x 2 mesh's
    ``fsdp_tp`` bit for bit, each leaf on the mesh's device; a sharding
    that does not divide a leaf raises."""
    cfg = get_arch("qwen3-1.7b").reduced()
    mod = treg.model_module(cfg)
    specs = mod.init_specs(cfg)
    prm = PM.materialize(specs, 0, device="cpu")
    m1 = make_mesh((2, 4), ("data", "model"), "cpu")
    m2 = make_mesh((4, 2), ("data", "model"), "cpu")
    sh1 = tsh.param_shardings(specs, m1, "tp")
    sh2 = tsh.param_shardings(specs, m2, "fsdp_tp")
    assert port_specs(PM.tree_map(lambda s: s.spec, sh1)) != \
        port_specs(PM.tree_map(lambda s: s.spec, sh2))
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d)
        ck.save(7, {"params": prm}, blocking=True)
        template = {"params": PM.tree_map(torch.zeros_like, prm)}
        got = ck.restore(template, shardings={"params": sh2})
        assert ck.latest_step() == 7
        for (pa, a), (pb, b) in zip(PM.tree_paths(prm),
                                    PM.tree_paths(got["params"])):
            assert pa == pb and torch.equal(a, b) and b.device == \
                m2.lead_device
        bad = make_mesh((1, 3), ("data", "model"), "cpu")
        with pytest.raises(ValueError, match="does not split"):
            ck.restore(template, shardings={"params": PM.tree_map(
                lambda _: tsh.NamedSharding(bad, tsh.P("model")), sh1)})


def test_new_collectives_on_a_mesh():
    """``pmax`` / ``pmean`` group as ``psum`` does (the ranks off the
    axes, in rank order); ``ppermute`` moves each rank's tensor to its
    destination index and gives zeros where nothing arrives."""
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    xs = [torch.full((3,), float(r)) for r in range(8)]
    s, mx, mn = psum(mesh, xs, "model"), pmax(mesh, xs, "model"), \
        pmean(mesh, xs, "model")
    for r in range(8):
        row = range(4 * (r // 4), 4 * (r // 4) + 4)
        assert torch.equal(s[r], torch.full((3,), float(sum(row))))
        assert torch.equal(mx[r], torch.full((3,), float(max(row))))
        assert torch.equal(mn[r], torch.full((3,), sum(row) / 4.0))
    got = ppermute(mesh, xs, "model", [(0, 1), (1, 2), (2, 3)])
    for r in range(8):
        j = r % 4
        want = xs[r - 1] if j > 0 else torch.zeros(3)
        assert torch.equal(got[r], want)
    with pytest.raises(ValueError):
        ppermute(mesh, xs, "model", [(0, 1), (1, 1)])


def test_ppermute_is_billed_as_a_collective_permute():
    """The ring matmul's n ``ppermute`` calls are each a collective-permute
    of one shard (G bytes, the reference's ``hlo_parse`` formula), not an
    all-gather; ``compressed_psum``'s pmax and psum are all-reduces; the
    collective audit counts the psum and a pmean (a psum in the
    reference's jaxpr), not the pmax or a permute."""
    from repro.analysis import hlo_parse
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    ws = [w[16 * (r % 4):16 * (r % 4 + 1)] for r in range(8)]
    got = measure_cost(ring_collective_matmul, mesh, [x] * 8, ws, "model")
    shard_bytes = 16 * 32 * 4
    line = (f"  %c = f32[16,32]{{1,0}} collective-permute(f32[16,32]{{1,0}} "
            f"%p), source_target_pairs={{{{0,1}},{{1,2}},{{2,3}},{{3,0}}}}")
    (want,) = hlo_parse.parse_collectives(line)
    assert want["wire"] == shard_bytes == \
        collective_wire("collective-permute", shard_bytes, 4)
    assert got.wire_by_op == {"collective-permute": 4 * want["wire"]}
    g = [torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
         for _ in range(8)]
    got = measure_cost(compressed_psum, mesh, g, "data")
    ring = 2 * 4 * (2 - 1) / 2 + 2 * 4 * 32 * (2 - 1) / 2
    assert got.wire_by_op == {"all-reduce": ring}
    rep = tverify.collective_audit(compressed_psum, mesh, g, "data",
                                   allowed_axes=("data",))
    assert rep.summary["psums"] == 1 and rep.summary["gathers"] == 0
    assert not rep.violations
    rep = tverify.collective_audit(ring_collective_matmul, mesh, [x] * 8, ws,
                                   "model", allowed_axes=("model",))
    assert rep.summary["psums"] == 0 and rep.summary["gathers"] == 0
    rep = tverify.collective_audit(pmean, mesh, g, "model",
                                   allowed_axes=("data",))
    assert rep.summary["psums"] == 1 and len(rep.violations) == 1


def test_exports_are_the_references():
    """``repro_torch.distributed`` exports the reference's names, and
    ``repro_torch.launch`` the reference's ``launch.steps`` beside the
    mesh; each sharding function of the reference has its port."""
    import repro.distributed as jdist
    import repro.launch.steps as jsteps
    import repro_torch.distributed as tdist
    import repro_torch.launch as tlaunch
    assert set(tdist.__all__) == set(jdist.__all__)
    assert set(jsteps.__all__) <= set(tlaunch.__all__)
    assert all(callable(getattr(tlaunch, n)) for n in jsteps.__all__)
    assert set(jsh.__all__) <= set(tsh.__all__)
