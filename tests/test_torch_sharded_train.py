"""The port's sharded train step held to the JAX package's on a 2 x 4
mesh: ``build_cell``'s train branch (``repro.launch.steps``) for reduced
qwen3-1.7b and mixtral-8x7b, whose MoE layers run tensor-parallel.

As ``tests/test_torch_sharded.py`` does, ONE child process with 8 host
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=8``) runs the
reference's jitted sharded step, its inputs sharded by the cell's
``in_shardings``, and writes an ``.npz`` with the parameters it started
from; the port runs the same step eagerly on ``make_mesh(..., "cpu")``.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import few_threads  # noqa: F401
from repro_torch.configs import TrainConfig, get_arch, model_module
from repro_torch.distributed import sharding as tsh
from repro_torch.interop import params_from_numpy
from repro_torch.launch import build_cell, make_mesh
from repro_torch.models import params as PM
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_loop import make_train_step

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
TRAIN_ARCHS = ("qwen3-1.7b", "mixtral-8x7b")
TRAIN_BATCH = (8, 16)
TRAIN_MICRO = 4

CHILD = textwrap.dedent("""
    import sys
    import jax
    import numpy as np
    from repro.configs import get_arch, model_module
    from repro.configs.base import TrainConfig
    from repro.core.compat import set_mesh
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import build_cell
    from repro.models import params as PM
    from repro.train.optimizer import adamw_init

    out = {{}}
    mesh = make_mesh((2, 4), ("data", "model"))
    # The sharded train step, as build_cell builds it.
    tok = np.random.default_rng(4).integers(0, 256, {TRAIN_BATCH}) \\
        .astype(np.int32)
    for arch in {TRAIN_ARCHS}:
        a = get_arch(arch)
        cfg = a.reduced()
        prm = PM.materialize(model_module(cfg).init_specs(cfg),
                             jax.random.PRNGKey(0))
        for k, v in jax.tree_util.tree_flatten_with_path(prm)[0]:
            out["train/" + arch + jax.tree_util.keystr(k)] = np.asarray(v)
        # remat changes no value: the reference compiles faster without.
        cell = build_cell(a, "train_4k", mesh, reduced=True,
                          tcfg=TrainConfig(microbatch={TRAIN_MICRO},
                                           remat="none"))
        step = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                       out_shardings=cell.out_shardings)
        args = jax.device_put((prm, adamw_init(prm),
                               {{"tokens": tok, "labels": tok}}),
                              cell.in_shardings)
        with set_mesh(mesh):
            _, _, met = step(*args)
        out["train/" + arch + "/loss"] = np.asarray(met["loss"])
        out["train/" + arch + "/grad_norm"] = np.asarray(met["grad_norm"])

    np.savez(sys.argv[1], **out)
""").format(TRAIN_ARCHS=TRAIN_ARCHS, TRAIN_BATCH=TRAIN_BATCH,
            TRAIN_MICRO=TRAIN_MICRO)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's sharded steps, from one child with 8 host devices."""
    path = tmp_path_factory.mktemp("sharded_train") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    done = subprocess.run([sys.executable, "-c", CHILD, str(path)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    with np.load(path) as f:
        return dict(f)


def mesh(shape):
    return make_mesh(shape, ("data", "model"), device="cpu")


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


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_train_step_matches_the_references(ref, arch):
    """``build_cell``'s train step on 2 x 4 (microbatch 4 of a batch of 8,
    remat "block", ``grad_shardings`` checked) against the reference's
    jitted sharded step: loss and grad_norm within 1e-5 relative.  A MoE
    layer's capacity and aux are per data rank, so the step is not the
    unsharded step at the same microbatch (here 7e-3 apart in the loss,
    over the reference's own 1e-3 bound for GSPMD-only sharding): it is
    the port's unsharded step at microbatch 4 / 2, whose microbatches are
    the data ranks' token groups (equal token counts, so the means
    agree), within 1e-5.  Without a MoE the sharded step equals the
    unsharded step at microbatch 4 exactly."""
    a = get_arch(arch)
    cfg = a.reduced()
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, TRAIN_BATCH).astype(np.int32))
    batch = {"tokens": tok, "labels": tok}
    tcfg = TrainConfig(microbatch=TRAIN_MICRO)
    params = tree_of(ref, "train/" + arch)
    cell = build_cell(a, "train_4k", mesh((2, 4)), reduced=True, tcfg=tcfg)
    _, _, met = cell.fn(params, adamw_init(params), batch)
    for k in ("loss", "grad_norm"):
        want = float(ref[f"train/{arch}/{k}"])
        assert abs(float(met[k]) - want) <= TOL * abs(want), k
    local = {}
    for micro in (TRAIN_MICRO, TRAIN_MICRO // 2):
        params = tree_of(ref, "train/" + arch)
        step = make_train_step(model_module(cfg), cfg,
                               TrainConfig(microbatch=micro))
        local[micro] = step(params, adamw_init(params), batch)[2]
    for k in ("loss", "grad_norm"):
        want = float(local[TRAIN_MICRO // 2][k])
        assert abs(float(met[k]) - want) <= TOL * abs(want), k
        if cfg.family != "moe":
            assert float(met[k]) == float(local[TRAIN_MICRO][k]), k
    three = mesh((1, 3))
    for bad in (PM.tree_map(lambda _: tsh.NamedSharding(three, tsh.P(
            "model")), cell.in_shardings[0]),
                {k: v for k, v in cell.in_shardings[0].items()
                 if k != "embed"}):
        with pytest.raises(ValueError, match="grad_shardings"):
            make_train_step(model_module(cfg), cfg, tcfg,
                            grad_shardings=bad)(params, adamw_init(params),
                                                batch)


