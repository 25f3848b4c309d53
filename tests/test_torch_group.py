"""Grouped execution in the port held to the JAX package's
``AnalogMatrixGroup``: ``program_group`` with the programming draws
injected, ``group()`` stacking, ``group_mvm`` / ``group_rmvm`` on both
backends (``"cuda"`` against the JAX ``backend="pallas"``, whose kernels run
in interpret mode) with the DAC draws injected, the grouped crossbar stages,
``chain_mvm`` with every activation, the default key schedule against solo
member calls, the MoE dict source in JAX's leaf order, every input form, the
member views and stats, the live (m, n) image the ``cuda`` path hands its
kernels, ``group_from_numpy``, and the validation errors of
tests/test_group.py (all but "default key inside jit", which has no torch
counterpart)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port import (block_dac_eta, few_threads,  # noqa: F401
                         group_block_dac_eta, group_program_eta,
                         group_whole_dac_eta, member_keys, rel, rng_array)
from repro.core import crossbar as jcb
from repro.core import devices as jdev
from repro.core import virtualization as jvirt
from repro.engine import AnalogEngine as JaxEngine
from repro_torch.core import crossbar
from repro_torch.core.prng import fold_in
from repro_torch.engine import (CHAIN_ACTIVATIONS, AnalogEngine,
                                AnalogMatrix, AnalogMatrixGroup,
                                _tree_leaves)
from repro_torch.interop import config_from_dict, group_from_numpy

TOL = 1e-5
SIZE, M, N = 4, 100, 90
KEY = jax.random.PRNGKey(7)


def configs(**kw):
    """tests/test_group.py's make_cfg geometry, both packages."""
    cfg = jcb.CrossbarConfig(device=jdev.get_device("taox-hfox"),
                             geom=jvirt.MCAGeometry(2, 2, 32, 32), k_iters=5,
                             ec=True, **kw)
    return cfg, config_from_dict(dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def stack():
    return rng_array((SIZE, M, N), 80, 0.1)


def jax_group(cfg, a, backend="reference"):
    eng = JaxEngine(cfg, backend="pallas" if backend == "cuda" else backend)
    return eng, eng.program_group(jnp.asarray(a), KEY)


def port_group(jg, pcfg, backend):
    return group_from_numpy(np.asarray(jg.at_blocks), np.asarray(jg.da_blocks),
                            jg.shape, pcfg, "cpu", backend=backend)


def dac_eta(key, cfg, pcfg, jg, batch, backend, transpose):
    """The per-member DAC draws of a JAX group call under ``key``."""
    mb, nb = jg.at_blocks.shape[1:3]
    if backend == "cuda":
        cap = pcfg.geom.capacity[0 if transpose else 1]
        return torch.from_numpy(group_whole_dac_eta(
            key, (mb if transpose else nb) * cap, batch, jg.size, transpose))
    return torch.from_numpy(group_block_dac_eta(key, cfg, mb, nb, batch,
                                                jg.size, transpose))


# ---------------------------------------------------------------- programming
def test_program_group_matches_jax_and_solo(stack):
    """With the reference's per-member programming draws injected, the
    port's group image equals JAX's ``program_group`` (the bound of the
    solo program parity test); without, member g is the port's solo
    ``program(a[g], fold_in(key, g))`` bit for bit."""
    cfg, pcfg = configs()
    _, jg = jax_group(cfg, stack)
    eng = AnalogEngine(pcfg, device="cpu")
    mb, nb = jg.at_blocks.shape[1:3]
    G = eng.program_group(stack, 0, eta=torch.from_numpy(
        group_program_eta(KEY, cfg, mb, nb, SIZE)))
    assert isinstance(G, AnalogMatrixGroup) and G.size == SIZE
    assert G.shape == (M, N) and G.at_blocks.shape == jg.at_blocks.shape
    for g in range(SIZE):
        assert rel(G.at_blocks[g], jg.at_blocks[g]) <= TOL
        assert rel(G.da_blocks[g], jg.da_blocks[g]) <= TOL
    G = eng.program_group(stack, 5)
    assert G.member_keys == [fold_in(5, g) for g in range(SIZE)]
    for g in range(SIZE):
        A = eng.program(stack[g], fold_in(5, g))
        assert torch.equal(G.at_pad[g], A.at_pad)
        assert torch.equal(G.da_pad[g], A.da_pad)


def test_group_of_handles_equals_program_group(stack):
    """``group()`` stacks programmed handles verbatim: equal to
    ``program_group`` under the same member keys bit for bit, with the
    handles' keys and their summed write cost."""
    _, pcfg = configs()
    eng = AnalogEngine(pcfg, device="cpu")
    G1 = eng.program_group(stack, 5)
    handles = [eng.program(stack[g], fold_in(5, g)) for g in range(SIZE)]
    G2 = eng.group(handles)
    assert torch.equal(G1.at_pad, G2.at_pad)
    assert torch.equal(G1.da_pad, G2.da_pad)
    assert G2.member_keys == G1.member_keys
    assert G2.base_key == handles[0].base_key
    assert G2.write_stats.energy_j == pytest.approx(G1.write_stats.energy_j,
                                                    rel=1e-12)
    for g, A in enumerate(handles):
        assert torch.equal(G2.member(g).at_pad, A.at_pad)


# ------------------------------------------------------------------- execution
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_group_mvm_and_rmvm_match_jax(stack, backend, batch):
    """Both directions, one input per member, against the JAX group on the
    same image (``"cuda"`` vs ``backend="pallas"``), member g's DAC draws
    those of ``fold_in(key, g)``: rel-L2 <= 1e-5 per member.  Batch 1 uses
    the ``(size, n)`` form, whose output has no batch axis."""
    cfg, pcfg = configs()
    jeng, jg = jax_group(cfg, stack, backend)
    G = port_group(jg, pcfg, backend)
    k = jax.random.fold_in(KEY, 3)
    shape_x = (SIZE, N) if batch == 1 else (SIZE, N, batch)
    shape_y = (SIZE, M) if batch == 1 else (SIZE, M, batch)
    x, y = rng_array(shape_x, 81), rng_array(shape_y, 82)
    for transpose, u, out in ((False, x, M), (True, y, N)):
        run = jeng.group_rmvm if transpose else jeng.group_mvm
        want = np.asarray(run(jg, jnp.asarray(u), key=k))
        eta = dac_eta(k, cfg, pcfg, jg, batch, backend, transpose)
        prun = G.engine.group_rmvm if transpose else G.engine.group_mvm
        got = prun(G, torch.from_numpy(u), eta=eta)
        assert tuple(got.shape) == want.shape == (
            (SIZE, out) if batch == 1 else (SIZE, out, batch))
        for g in range(SIZE):
            assert rel(got[g], want[g]) <= TOL


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_group_thomas_tier2_matches_jax(stack, backend):
    """The exact Thomas tier-2 at lam = 1e-2 (on ``"cuda"`` one
    ``thomas_solve`` over the (rows, g * batch) panel), both directions."""
    cfg, pcfg = configs(denoise_method="thomas", lam=1e-2)
    jeng, jg = jax_group(cfg, stack, backend)
    G = port_group(jg, pcfg, backend)
    k = jax.random.fold_in(KEY, 4)
    x, y = rng_array((N, 3), 83), rng_array((M, 3), 84)  # shared input
    for transpose, u in ((False, x), (True, y)):
        run = jeng.group_rmvm if transpose else jeng.group_mvm
        want = np.asarray(run(jg, jnp.asarray(u), key=k))
        eta = dac_eta(k, cfg, pcfg, jg, 3, backend, transpose)
        prun = G.engine.group_rmvm if transpose else G.engine.group_mvm
        got = prun(G, torch.from_numpy(u), eta=eta)
        for g in range(SIZE):
            assert rel(got[g], want[g]) <= TOL


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("transpose", [False, True])
def test_grouped_stages_match_jax(stack, transpose, use_kernel):
    """``crossbar.grouped_block_mvm`` / ``_rmvm`` against the JAX stages
    under the same member keys, per-block draws injected, with and without
    the kernel tile step."""
    cfg, pcfg = configs()
    _, jg = jax_group(cfg, stack)
    G = port_group(jg, pcfg, "reference")
    keys = jnp.stack(member_keys(jax.random.fold_in(KEY, 5), SIZE))
    u = rng_array((SIZE, M if transpose else N, 2), 85)
    stage = jcb.grouped_block_rmvm if transpose else jcb.grouped_block_mvm
    want = np.asarray(stage(jg.at_blocks, jg.da_blocks, jnp.asarray(u), keys,
                            cfg, m=M, n=N, use_kernel=use_kernel))
    eta = dac_eta(jax.random.fold_in(KEY, 5), cfg, pcfg, jg, 2, "reference",
                  transpose)
    pstage = crossbar.grouped_block_rmvm if transpose \
        else crossbar.grouped_block_mvm
    got = pstage(G.at_pad, G.da_pad, torch.from_numpy(u), [0] * SIZE, pcfg,
                 m=M, n=N, use_kernel=use_kernel, eta=eta)
    for g in range(SIZE):
        assert rel(got[g], want[g]) <= TOL


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_default_key_schedule_matches_member_calls(stack, backend):
    """With no key, group call c of member g draws what a solo handle with
    the member's key draws on its call c: equal bit for bit to
    ``member(g)`` executed twice, both directions sharing one counter."""
    _, pcfg = configs()
    eng = AnalogEngine(pcfg, backend=backend, device="cpu")
    G = eng.program_group(stack, 5)
    views = [G.member(g) for g in range(SIZE)]
    x, y = rng_array((N, 2), 86), rng_array((M,), 87)
    for _ in range(2):
        Y = eng.group_mvm(G, x)
        for g, A in enumerate(views):
            assert torch.equal(Y[g], eng.mvm(A, x))
    Z = eng.group_rmvm(G, y)
    for g, A in enumerate(views):
        assert torch.equal(Z[g], eng.rmvm(A, y))
    assert G.calls == 3 and all(A.calls == 3 for A in views)


def test_moe_dict_source_in_jax_leaf_order(stack):
    """A dict of experts programs in JAX's pytree leaf order (sorted keys,
    not insertion order): equal to the stack in sorted-key order, and the
    leaf order of a nested source is ``jax.tree_util.tree_leaves``'."""
    _, pcfg = configs()
    eng = AnalogEngine(pcfg, device="cpu")
    experts = {"expert_2": stack[0], "expert_10": stack[1],
               "expert_1": stack[2], "expert_3": stack[3]}
    order = sorted(experts)
    assert order == ["expert_1", "expert_10", "expert_2", "expert_3"]
    G = eng.program_group(experts, 9)
    S = eng.program_group(np.stack([experts[k] for k in order]), 9)
    assert torch.equal(G.at_pad, S.at_pad) and torch.equal(G.da_pad, S.da_pad)
    nested = {"b": [stack[0], {"z": stack[1], "a": stack[2]}], "a": stack[3],
              "n": None}
    assert [id(v) for v in _tree_leaves(nested)] == \
        [id(v) for v in jax.tree_util.tree_leaves(nested)]


def test_group_input_forms(stack):
    """``(n,)`` and ``(n, batch)`` go to every member, ``(size, n)`` and
    ``(size, n, batch)`` one per member; a 2-D shape that is both reads per
    member; other shapes raise."""
    _, pcfg = configs()
    eng = AnalogEngine(pcfg, device="cpu")
    G = eng.program_group(stack, 5)
    x = rng_array((N,), 88)
    y1 = eng.group_mvm(G, x, key=3)
    y2 = eng.group_mvm(G, np.stack([x] * SIZE), key=3)
    y3 = eng.group_mvm(G, np.broadcast_to(x[None, :, None], (SIZE, N, 2)),
                       key=3)
    y4 = eng.group_mvm(G, np.stack([x, x], 1), key=3)
    assert y1.shape == y2.shape == (SIZE, M)
    assert y3.shape == y4.shape == (SIZE, M, 2)
    assert torch.equal(y1, y2) and torch.equal(y3, y4)
    assert eng.group_rmvm(G, rng_array((M, 3), 89), key=3).shape == \
        (SIZE, N, 3)
    with pytest.raises(ValueError):
        eng.group_mvm(G, np.zeros((SIZE + 1, N), np.float32), key=3)
    with pytest.raises(ValueError):
        eng.group_mvm(G, np.zeros((77,), np.float32), key=3)
    with pytest.raises(ValueError):
        eng.group_mvm(G, np.zeros((SIZE, N + 1, 2), np.float32), key=3)
    with pytest.raises(ValueError, match="G.T @ y"):
        eng.group_rmvm(G, x, key=3)
    # size == n: the (size, n) reading wins over (n, batch).
    sq = AnalogEngine(pcfg, device="cpu").program_group(
        rng_array((3, 5, 3), 90), 1)
    u = rng_array((3, 3), 91)
    per_member = sq.engine.group_mvm(sq, u, key=2)
    assert per_member.shape == (3, 5)
    assert torch.equal(per_member,
                       sq.engine.group_mvm(sq, u[:, :, None], key=2)[:, :, 0])


# ------------------------------------------------------------------------ chain
@pytest.mark.parametrize("activation,backend", [
    (None, "reference"), ("relu", "reference"), ("tanh", "reference"),
    ("gelu", "reference"), ("relu", "cuda"), ("gelu", "cuda")])
def test_chain_mvm_matches_jax(activation, backend):
    """A 4-layer chain of 96^2 members against JAX ``chain_mvm`` with the
    per-member, per-block DAC draws injected (on ``"cuda"`` each block's
    product goes through ``ec_matmul``, as JAX's pallas chain through its
    tile kernel): rel-L2 <= 1e-5.  ``gelu`` is the tanh form."""
    cfg, pcfg = configs()
    sq = rng_array((SIZE, 96, 96), 92, 96 ** -0.5)
    jeng, jg = jax_group(cfg, sq, backend)
    G = port_group(jg, pcfg, backend)
    k = jax.random.fold_in(KEY, 10)
    h = rng_array((96, 2), 93)
    want = np.asarray(jeng.chain_mvm(jg, jnp.asarray(h), key=k,
                                     activation=activation))
    mb, nb = jg.at_blocks.shape[1:3]
    eta = torch.from_numpy(group_block_dac_eta(k, cfg, mb, nb, 2, SIZE))
    got = G.engine.chain_mvm(G, torch.from_numpy(h), activation=activation,
                             eta=eta)
    assert got.shape == (96, 2)
    assert rel(got, want) <= TOL
    if activation == "gelu":
        erf = torch.nn.functional.gelu(torch.linspace(-3, 3, 61))
        assert rel(CHAIN_ACTIVATIONS["gelu"](torch.linspace(-3, 3, 61)),
                   erf) > 1e-5        # the tanh form, not torch's default


def test_chain_default_keys_equal_member_loop():
    """``chain_mvm`` under a key equals the loop over ``member(g)`` with
    ``fold_in(key, g)`` and the activation between (1-D input)."""
    _, pcfg = configs()
    eng = AnalogEngine(pcfg, device="cpu")
    G = eng.program_group(rng_array((3, 96, 96), 94, 96 ** -0.5), 2)
    h = torch.from_numpy(rng_array((96,), 95))
    want = h
    for g in range(3):
        want = torch.relu(eng.mvm(G.member(g), want, key=fold_in(6, g)))
    got = eng.chain_mvm(G, h, key=6, activation="relu")
    assert got.shape == (96,) and torch.equal(got, want)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("grouped", [False, True])
def test_cuda_path_reads_only_the_live_image(stack, monkeypatch, grouped,
                                             transpose):
    """The image's padding is exact zeros, so the ``cuda`` backend hands its
    EC kernel the live (m, n) view of each (padded) image and panels of the
    live contraction length; the result equals the padded product."""
    from repro_torch import kernels
    _, pcfg = configs()
    eng = AnalogEngine(pcfg, backend="cuda", device="cpu")
    G = eng.program_group(stack, 5)
    assert G.at_pad.shape == (SIZE, 128, 128)
    assert not (G.at_pad[:, M:].any() or G.at_pad[:, :, N:].any()
                or G.da_pad[:, M:].any() or G.da_pad[:, :, N:].any())
    name = ("ec_group_" if grouped else "ec_") + \
        ("rmatmul" if transpose else "matmul")
    seen, errs, run = [], [], getattr(kernels, name)
    full = (G.at_pad, G.da_pad) if grouped else (G.at_pad[1], G.da_pad[1])

    def spy(at, da, u, u_t):
        seen.append((tuple(at.shape), at.data_ptr(), tuple(u.shape)))
        out = run(at, da, u, u_t)
        pad = (0, 0, 0, 128 - u.shape[0])
        want = run(*full, F.pad(u, pad), F.pad(u_t, pad))
        errs.append(rel(out, want[:out.shape[0]]))
        return out

    monkeypatch.setattr(kernels, name, spy)
    rows, width = (N, M) if transpose else (M, N)
    x = rng_array((SIZE, width, 2), 99)
    if grouped:
        got = (eng.group_rmvm if transpose else eng.group_mvm)(G, x, key=3)
        image = (SIZE, M, N)
    else:
        A = G.member(1)
        got = (A.T if transpose else A).engine._execute(
            A, x[1], 3, None, transpose=transpose)[0][None]
        image = (M, N)
    assert seen == [(image, G.at_pad[0 if grouped else 1].data_ptr(),
                     (width, 2 * (SIZE if grouped else 1)))]
    assert errs[0] <= 1e-6
    assert got.shape[-2:] == (rows, 2) and bool(torch.isfinite(got).all())


# ----------------------------------------------------------------- views, stats
def test_member_views_and_stats(stack):
    """``member(g)`` views the stacks (no copy) with the member's key and a
    1/size share of the write cost; write stats are size x the solo cost,
    input stats size x a solo call's; ``G @ x``; ``release()`` frees 0."""
    cfg, pcfg = configs()
    eng = AnalogEngine(pcfg, device="cpu")
    G = eng.program_group(stack, 5)
    A = eng.program(stack[0], 5)
    assert G.write_stats.energy_j == pytest.approx(
        SIZE * A.write_stats.energy_j, rel=1e-6)
    jeng, jg = jax_group(cfg, stack)
    assert G.write_stats.energy_j == pytest.approx(jg.write_stats.energy_j,
                                                   rel=1e-6)
    member = G.member(1)
    assert isinstance(member, AnalogMatrix) and member.shape == (M, N)
    assert member.at_pad.data_ptr() == G.at_pad[1].data_ptr()
    assert member.base_key == G.member_keys[1]
    assert member.write_stats.energy_j == pytest.approx(
        A.write_stats.energy_j, rel=1e-6)
    with pytest.raises(IndexError):
        G.member(SIZE)
    for transpose in (False, True):
        gs = G.input_write_stats(batch=4, transpose=transpose)
        js = jg.input_write_stats(batch=4, transpose=transpose)
        ss = eng.input_write_stats(A, batch=4, transpose=transpose)
        assert gs.energy_j == pytest.approx(SIZE * ss.energy_j, rel=1e-6)
        assert gs.energy_j == pytest.approx(js.energy_j, rel=1e-6)
        assert gs.latency_s == pytest.approx(js.latency_s, rel=1e-6)
    _, st = eng.group_mvm_with_stats(G, rng_array((N, 4), 96), key=1)
    assert st == G.input_write_stats(4)
    _, st = eng.group_rmvm_with_stats(G, rng_array((M, 2), 97), key=1)
    assert st == G.input_write_stats(2, transpose=True)
    assert (G @ rng_array((N,), 98)).shape == (SIZE, M)
    assert G.image_nbytes == 2 * SIZE * 128 * 128 * 4
    assert G.release() == 0


def test_group_from_numpy():
    """A JAX group's stacks carried across: the padded layout, default
    member keys ``fold_in(0, g)``, given keys, and the shape checks."""
    cfg, pcfg = configs()
    _, jg = jax_group(cfg, rng_array((2, 70, 100), 99))
    at, da = np.asarray(jg.at_blocks), np.asarray(jg.da_blocks)
    G = group_from_numpy(at, da, jg.shape, pcfg, "cpu")
    assert G.at_pad.shape == (2, 128, 128) and G.shape == (70, 100)
    assert G.member_keys == [fold_in(0, 0), fold_in(0, 1)]
    assert rel(G.at_pad[1, :64, 64:], at[1, 0, 1]) == 0.0
    assert rel(G.member(0).dense(),
               np.asarray(jg.member(0).at_blocks).transpose(0, 2, 1, 3)
               .reshape(128, 128)[:70, :100] + np.asarray(
                   jg.member(0).da_blocks).transpose(0, 2, 1, 3)
               .reshape(128, 128)[:70, :100]) <= 1e-7
    assert group_from_numpy(at, da, jg.shape, pcfg, "cpu",
                            member_keys=[4, 5]).member_keys == [4, 5]
    with pytest.raises(ValueError):
        group_from_numpy(at[0], da[0], jg.shape, pcfg, "cpu")
    with pytest.raises(ValueError):
        group_from_numpy(at, da, jg.shape, pcfg, "cpu", member_keys=[1])
    with pytest.raises(ValueError):
        group_from_numpy(at, da[:, :1], jg.shape, pcfg, "cpu")


# -------------------------------------------------------------------- validation
def test_group_validation(stack):
    """The errors of tests/test_group.py::test_group_validation (mixed
    shapes, arrays mixed with producers, empty group(), the solo API on a
    group, cross-engine execution; a producer group on a local engine:
    ValueError, as the reference raises), and those of ``group()`` and
    ``chain_mvm``."""
    _, pcfg = configs()
    eng = AnalogEngine(pcfg, device="cpu")
    other = AnalogEngine(dataclasses.replace(pcfg, k_iters=3), device="cpu")
    G = eng.program_group(stack, 5)
    x = rng_array((N,), 100)
    with pytest.raises(ValueError):
        eng.program_group([stack[0], stack[1][:64]], 5)
    with pytest.raises(ValueError):
        eng.program_group([stack[0], lambda i, j: stack[1]], 5)
    with pytest.raises(ValueError):
        eng.program_group([], 5)
    with pytest.raises(ValueError, match="execution='streamed'"):
        eng.program_group([lambda i, j: stack[0]] * 2, 5, shape=(M, N))
    with pytest.raises(ValueError):
        eng.group([])
    with pytest.raises(TypeError):
        eng.mvm(G, x)
    with pytest.raises(ValueError):
        other.group_mvm(G, x, key=1)
    with pytest.raises(TypeError):
        eng.group_mvm(G.member(0), x, key=1)
    A, B = eng.program(stack[0], 1), eng.program(stack[1][:64], 2)
    with pytest.raises(ValueError):
        eng.group([A, B])
    with pytest.raises(ValueError):
        eng.group([A, A.T])
    with pytest.raises(ValueError):
        eng.group([A, other.program(stack[1], 2)])
    with pytest.raises(TypeError):
        eng.chain_mvm(A, x, key=1)
    with pytest.raises(ValueError):
        eng.chain_mvm(G, x, key=1)                  # non-square members
    sq = eng.program_group(rng_array((2, 96, 96), 101), 3)
    with pytest.raises(ValueError):
        eng.chain_mvm(sq, rng_array((96,), 102), key=1, activation="swoosh")
    with pytest.raises(ValueError):
        eng.chain_mvm(sq, rng_array((95,), 103), key=1)
