"""The port's sharded execution held to the JAX package's:
``compressed_psum`` and ``ring_collective_matmul`` on a 2 x 4 mesh
(``repro.distributed.collectives``), ``moe_apply``'s tensor-parallel path
on 2 x 4, 1 x 4 and 2 x 1 (the reference's ``shard_map``,
``repro.models.moe``), and ``build_cell``'s cells on 2 x 4
(``repro.launch.steps``); the sharded train step is
``tests/test_torch_sharded_train.py``'s.

The reference needs 8 devices, which exist only under
``XLA_FLAGS=--xla_force_host_platform_device_count=8``: ONE child process
(a module-scoped fixture) runs every reference case and writes an
``.npz``; the port runs the same inputs (numpy, fixed seeds) in this
process on ``make_mesh(..., "cpu")``, every rank on the CPU.  Analog MoE
runs inject the reference's DAC draws through ``Runtime.draw``: inside
``shard_map`` every rank draws under the same key at its own shape, and
so does the port's rank loop.  Capacity is per data rank, so a split
batch is not the local path: parity is against the reference's
``shard_map``, and the local path is met on a 1 x 1 mesh (bit for bit).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_port import DacDraws, few_threads, rel  # noqa: F401
from repro_torch.configs import SHAPES, get_arch
from repro_torch.configs.base import RRAMBackendConfig
from repro_torch.configs.registry import decode_cache_specs
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.collectives import (compressed_psum,
                                                 ring_collective_matmul)
from repro_torch.distributed.fault_tolerance import _leaves
from repro_torch.interop import params_from_numpy
from repro_torch.launch import build_cell, make_mesh
from repro_torch.models import moe as pmoe
from repro_torch.models import params as PM
from repro_torch.models.common import Runtime

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
MESHES = {"2x4": (2, 4), "1x4": (1, 4), "2x1": (2, 1)}
BATCHES = (4, 1)                # 4 splits over data = 2, 1 does not
MOE_T = 8
JKEY, PKEY = 5, 5
CELL_ARCHS = ("qwen3-1.7b", "mixtral-8x7b", "whisper-tiny")

CHILD = textwrap.dedent("""
    import json, sys
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_arch
    from repro.configs.base import RRAMBackendConfig
    from repro.core.compat import set_mesh, shard_map
    from repro.distributed.collectives import (compressed_psum,
                                               ring_collective_matmul)
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import build_cell
    from repro.models import moe as M
    from repro.models import params as PM
    from repro.models.common import Runtime

    def rng(shape, seed):
        return np.random.default_rng(seed).standard_normal(shape) \\
            .astype(np.float32)

    MESHES, BATCHES, MOE_T = {MESHES}, {BATCHES}, {MOE_T}
    out, info = {{}}, {{}}
    mesh = make_mesh((2, 4), ("data", "model"))

    # compressed_psum (two steps, the second with the error feedback) and
    # the ring matmul.
    g = rng((8, 64), 1)
    def red(x, e):
        return compressed_psum(x, "data", e)
    f = jax.jit(shard_map(red, mesh=mesh,
                          in_specs=(P("data", None), P("data", None)),
                          out_specs=(P("data", None), P("data", None))))
    o1, r1 = f(g, np.zeros_like(g))
    o2, r2 = f(g, r1)
    f0 = jax.jit(shard_map(lambda x: compressed_psum(x, "data", None),
                           mesh=mesh, in_specs=P("data", None),
                           out_specs=(P("data", None), P("data", None))))
    o0, r0 = f0(g)
    for k, v in dict(cp_out0=o0, cp_res0=r0, cp_out1=o1, cp_res1=r1,
                     cp_out2=o2, cp_res2=r2).items():
        out[k] = np.asarray(v)
    x, w = rng((16, 64), 2), rng((64, 32), 3)
    rm = jax.jit(shard_map(lambda xx, ww: ring_collective_matmul(
        xx, ww, "model"), mesh=mesh, in_specs=(P(None, None),
        P("model", None)), out_specs=P(None, None), check_vma=False))
    out["ring"] = np.asarray(rm(x, w))

    # moe_apply's shard_map path, digital and analog.
    cfg = get_arch("mixtral-8x7b").reduced()
    lp = PM.materialize(M.moe_specs(cfg), jax.random.PRNGKey(0))
    jr = RRAMBackendConfig(enabled=True, dw_dtype="float32", lam=1e-2)
    # A programmed tree's leaves (w_tilde within 5 % of w, dw the rest):
    # what moe_apply reads of an image, without the programming loops.
    prog = {{}}
    for i, (name, sub) in enumerate(sorted(lp.items())):
        w = np.asarray(sub["w"])
        wt = (w * (1 + 0.05 * rng(w.shape, 30 + i))).astype(np.float32)
        prog[name] = {{"w": w, "w_tilde": wt, "dw": w - wt}}
    for k, v in jax.tree_util.tree_flatten_with_path(prog)[0]:
        out["moe_tree" + jax.tree_util.keystr(k)] = np.asarray(v)
    for name, shape in MESHES.items():
        m = make_mesh(shape, ("data", "model"))
        for b in BATCHES:
            xb = rng((b, MOE_T, cfg.d_model), 10 + b)
            rts = [Runtime(rram=rram, key=jax.random.PRNGKey({JKEY}),
                           mesh=m, batch_axes=("data",))
                   for rram in (None, jr)]
            with set_mesh(m):     # one compile for both kinds
                got = jax.jit(lambda d, p, xx: [
                    M.moe_apply(t, xx, cfg, rt)
                    for t, rt in zip((d, p), rts)])(lp, prog, xb)
            for kind, (o, a) in zip(("digital", "analog"), got):
                tag = f"moe/{{name}}/{{b}}/{{kind}}"
                out[tag + "/out"] = np.asarray(o)
                out[tag + "/aux"] = np.asarray(a)

    # build_cell's cells: argument avals, specs, donation, meta.
    def avals(tree):
        return [[jax.tree_util.keystr(p), list(v.shape), str(v.dtype)]
                for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]
    def specs(tree):
        flat = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda s: isinstance(s, NamedSharding))[0]
        return [[jax.tree_util.keystr(p), [list(e) if isinstance(e, tuple)
                                           else e for e in s.spec]]
                for p, s in flat]
    for arch in {CELL_ARCHS}:
        a = get_arch(arch)
        for shape in a.shapes:
            c = build_cell(a, shape, mesh, reduced=True)
            info[arch + "/" + shape] = {{
                "args": avals(c.args), "in": specs(c.in_shardings),
                "out": specs(c.out_shardings), "donate": list(c.donate),
                "meta": c.meta}}
            if shape.startswith("prefill"):
                fn = c.fn
                info[arch + "/" + shape]["out_avals"] = avals(
                    jax.eval_shape(fn, *c.args))
    out["cells"] = np.array(json.dumps(info))
    np.savez(sys.argv[1], **out)
""").format(MESHES=MESHES, BATCHES=BATCHES, MOE_T=MOE_T, JKEY=JKEY,
            CELL_ARCHS=CELL_ARCHS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every JAX reference case, from one child with 8 host devices."""
    path = tmp_path_factory.mktemp("sharded") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    done = subprocess.run([sys.executable, "-c", CHILD, str(path)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    with np.load(path) as f:
        return dict(f)


def mesh(shape):
    return make_mesh(shape, ("data", "model"), device="cpu")


def rng(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def tree_of(ref, prefix):
    """A nested dict of tensors from the ``prefix``-keyed leaves."""
    out = {}
    for key, v in ref.items():
        if not key.startswith(prefix + "["):
            continue
        parts = [p.strip("'") for p in key[len(prefix) + 1:-1].split("][")]
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(v)
    return params_from_numpy(out, "cpu")


def test_compressed_psum_matches_the_reference(ref):
    """Output and residual within 1e-6 of the reference's, without and
    with error feedback; the int8 error against the exact sum under the
    reference's 0.02 bound; the residual is the input minus what was
    sent."""
    g = torch.from_numpy(rng((8, 64), 1))
    m = mesh((2, 4))
    sh = tsh.NamedSharding(m, tsh.P("data", None))
    xs = tsh.shard(g, sh)
    o0, r0 = compressed_psum(m, xs, "data")
    o1, r1 = compressed_psum(m, xs, "data", [torch.zeros_like(x) for x in xs])
    o2, r2 = compressed_psum(m, xs, "data", r1)
    for name, got in (("cp_out0", o0), ("cp_res0", r0), ("cp_out1", o1),
                      ("cp_res1", r1), ("cp_out2", o2), ("cp_res2", r2)):
        full = tsh.unshard(got, sh).numpy()
        assert np.max(np.abs(full - ref[name])) <= 1e-6, name
    exact = g[:4] + g[4:]
    err = float((o0[0] - exact).abs().max() / exact.abs().max())
    assert err < 0.02
    for r in range(m.size):
        partner = m.rank({**m.coords(r), "data": 1 - m.coords(r)["data"]})
        scale = torch.maximum(xs[r].abs().max(),
                              xs[partner].abs().max()) / 127.0
        q = torch.clamp(torch.round(xs[r] / scale), -127, 127)
        assert torch.equal(r0[r], xs[r] - q * scale)
    assert float((o2[0] + o0[0] - 2 * exact).abs().max()) < \
        float((2 * o0[0] - 2 * exact).abs().max())


def test_ring_collective_matmul_matches_the_reference(ref):
    x, w = torch.from_numpy(rng((16, 64), 2)), torch.from_numpy(
        rng((64, 32), 3))
    m = mesh((2, 4))
    ws = tsh.shard(w, tsh.NamedSharding(m, tsh.P("model", None)))
    ys = ring_collective_matmul(m, [x] * m.size, ws, "model")
    for y in ys:
        assert rel(y, ref["ring"]) <= TOL
        assert rel(y, x @ w) <= TOL
        assert y.dtype == x.dtype


@pytest.fixture(scope="module")
def moe_tree(ref):
    """Reduced Mixtral's MoE tree with ``w_tilde`` / ``dw`` beside each
    ``w`` (the reference's draws: ``w_tilde`` within 5 % of ``w``): the
    digital tree holds the ``w``s alone."""
    prog = tree_of(ref, "moe_tree")
    digital = {k: {"w": v["w"]} for k, v in prog.items()}
    return digital, prog


@pytest.mark.parametrize("kind", ["digital", "analog"])
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("name", sorted(MESHES))
def test_moe_tensor_parallel_matches_shard_map(ref, moe_tree, name, b, kind):
    """Each rank's output summed over the model axis, aux averaged as the
    reference averages it: within 1e-5 rel-L2 and aux within 1e-6 of the
    reference's ``shard_map`` path; an analog run draws its DAC noise
    under salts 1, 2, 3 on every rank (the body traced once), at the
    rank's shapes, and leaves the salt at 3."""
    cfg = get_arch("mixtral-8x7b").reduced()
    digital, prog = moe_tree
    tree, rram = (digital, None) if kind == "digital" else \
        (prog, RRAMBackendConfig(enabled=True, dw_dtype="float32", lam=1e-2))
    m = mesh(MESHES[name])
    draws = DacDraws(jax.random.PRNGKey(JKEY), PKEY)
    rt = Runtime(rram=rram, key=PKEY, draw=draws, mesh=m)
    x = torch.from_numpy(rng((b, MOE_T, cfg.d_model), 10 + b))
    out, aux = pmoe.moe_apply(tree, x, cfg, rt)
    tag = f"moe/{name}/{b}/{kind}"
    assert rel(out, ref[tag + "/out"]) <= TOL
    assert abs(float(aux) - float(ref[tag + "/aux"])) <= 1e-6
    if kind == "analog":
        assert draws.calls == [(None, s) for s in (1, 2, 3)] * m.size
        assert rt._salt == 3


@pytest.mark.parametrize("kind", ["digital", "analog"])
def test_moe_one_by_one_mesh_is_the_local_path(moe_tree, kind):
    """A 1 x 1 mesh runs the local path bit for bit: the same output, aux
    and draws; a model axis that does not divide d_ff raises."""
    cfg = get_arch("mixtral-8x7b").reduced()
    digital, prog = moe_tree
    tree, rram = (digital, None) if kind == "digital" else \
        (prog, RRAMBackendConfig(enabled=True, dw_dtype="float32", lam=1e-2))
    x = torch.from_numpy(rng((2, MOE_T, cfg.d_model), 20))
    got = pmoe.moe_apply(tree, x, cfg, Runtime(rram=rram, key=PKEY,
                                               mesh=mesh((1, 1))))
    want = pmoe.moe_apply(tree, x, cfg, Runtime(rram=rram, key=PKEY))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="does not split"):
        pmoe.moe_apply(tree, x, cfg, Runtime(rram=rram, mesh=mesh((1, 3))))


def port_avals(tree):
    return [[p, list(t.shape), str(t.dtype).replace("torch.", "")]
            for p, t in _leaves(tree)]


def port_specs(tree):
    return [[p, [list(e) if isinstance(e, tuple) else e for e in s.spec]]
            for p, s in _leaves(tree)]


@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_build_cell_equals_the_references(ref, arch):
    """For every assigned shape on 2 x 4, reduced: the arguments' shapes
    and dtypes (meta tensors; the host ``count`` and caches' ``len``), the
    in / out specs, ``donate`` and ``meta`` equal the reference's cell;
    a prefill's caches equal what ``jax.eval_shape`` of the reference's
    prefill gives."""
    info = json.loads(str(ref["cells"]))
    a = get_arch(arch)
    for shape in a.shapes:
        want = info[arch + "/" + shape]
        c = build_cell(a, shape, mesh((2, 4)), reduced=True)
        assert port_avals(c.args) == want["args"], shape
        assert port_specs(c.in_shardings) == want["in"], shape
        assert port_specs(c.out_shardings) == want["out"], shape
        assert list(c.donate) == want["donate"] and c.meta == want["meta"]
        for p, t in _leaves(c.args):
            assert t.device.type == ("cpu" if p.endswith(("['len']",
                                                         ".count"))
                                     else "meta"), (shape, p)
        if shape.startswith("prefill"):
            caches = decode_cache_specs(a, SHAPES[shape], reduced=True)
            logits, cache_avals = want["out_avals"][0], \
                want["out_avals"][1:]
            cfg = a.reduced()
            assert logits == ["[0]", [SHAPES[shape].global_batch, 1,
                                      cfg.vocab_pad], cfg.compute_dtype]
            assert [["[1]" + p, s, d] for p, s, d in port_avals(caches)] \
                == cache_avals
