"""The port's training slice held to the JAX package's on reduced qwen3-1.7b
(2 layers, d_model 64): the learning-rate schedule and the global norm,
AdamW fed the same gradients (float32 and bfloat16 parameters), the
synthetic batches of every family, one jitted train step (with and without
microbatches) against the port's eager step, a reference checkpoint
restored into the port's Trainer and the port's into the reference's, and
the port's twin of ``test_trainer_loss_decreases_and_resumes``.

The gradient of a step is compared through the first moment after it:
from a zero state ``m = (1 - b1) * clip_scale * g``.  Adam's first step
turns a near-zero gradient into +-lr, so the parameters after a step are
compared as the change's rel-L2."""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import few_threads, rel, rng_array, to_np  # noqa: F401
from repro.configs import get_arch as jget_arch
from repro.configs import model_module as jmodel_module
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import pipeline as jpipe
from repro.distributed import CheckpointManager as JCheckpointManager
from repro.models import params as jPM
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch.configs import get_arch, model_module
from repro_torch.configs.base import TrainConfig
from repro_torch.data import pipeline as ppipe
from repro_torch.distributed import CheckpointManager
from repro_torch.interop import params_from_numpy
from repro_torch.models import params as pPM
from repro_torch.train import optimizer as popt
from repro_torch.train import train_loop as ptl

# lr_schedule / global_norm, relative: two float32 ulps.  XLA's float32
# cos on the CPU is not always correctly rounded (at step 28 of 5 + 35 it
# gives -0.47386876 for cos(2.0644753), whose value is -0.473868773 and
# whose float32 torch and numpy give, -0.47386879): one ulp that the
# schedule carries to 1.4e-7.
SCHED_TOL = 2.4e-7
ADAM_TOL = 1e-6         # adamw_update fed the same gradients
STEP_TOL = 1e-5         # a train step's loss and gradient (through m)
CHANGE_TOL = 1e-3       # the parameters' change over a step, rel-L2
ARCH = "qwen3-1.7b"
FAMILIES = ["qwen3-1.7b", "mixtral-8x7b", "rwkv6-1.6b", "zamba2-1.2b",
            "whisper-tiny", "llama-3.2-vision-11b"]
B, T = 4, 16


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def leaves(tree):
    """Copies of a port tree's leaves as float32 numpy arrays, in walk
    order."""
    return [np.array(to_np(t.to(torch.float32)))
            for _, t in pPM.tree_paths(tree)]


def jleaves(tree):
    return [np.asarray(jnp.asarray(a, jnp.float32))
            for a in jax.tree.leaves(tree)]


def reference_setup(seed=0):
    jcfg = jget_arch(ARCH).reduced()
    jmod = jmodel_module(jcfg)
    jparams = jPM.materialize(jmod.init_specs(jcfg), jax.random.PRNGKey(seed))
    cfg = get_arch(ARCH).reduced()
    return jcfg, jmod, jparams, cfg, model_module(cfg)


def tcfgs(**kw):
    kw = {"lr": 1e-3, "warmup_steps": 2, "total_steps": 20, **kw}
    return JTrainConfig(**kw), TrainConfig(**kw)


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ----------------------------------------------------------------- optimizer
def test_lr_schedule_and_global_norm_match_reference():
    for kw in ({"warmup_steps": 5, "total_steps": 40},
               {"warmup_steps": 0, "total_steps": 1},
               {"warmup_steps": 7, "total_steps": 7}):
        jcfg, cfg = tcfgs(lr=3e-4, **kw)
        for step in range(0, 45):
            want = jopt.lr_schedule(jcfg, jnp.asarray(step, jnp.int32))
            got = popt.lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert abs(float(got) - float(want)) <= SCHED_TOL * max(
                abs(float(want)), 1e-30), (kw, step)
    tree = {"a": rng_array((5, 7), 1), "b": {"c": rng_array((3,), 2, 10.0),
                                             "d": rng_array((4, 4, 2), 3)}}
    want = float(jopt.global_norm(tree))
    got = popt.global_norm(params_from_numpy(tree, "cpu"))
    assert abs(float(got) - want) <= SCHED_TOL * want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """Two steps from a zero state on the same gradients (the second over
    the clip), every parameter, moment and the count."""
    jcfg, cfg = tcfgs(lr=1e-2, warmup_steps=1, weight_decay=0.1,
                      grad_clip=1.0)
    shapes = {"w": (6, 5), "s": (5,), "n": {"k": (3, 4, 2)}}
    jdt = jnp.dtype(dtype)
    jp = jax.tree.map(lambda s: jnp.asarray(rng_array(s, sum(s)), jdt),
                      shapes, is_leaf=lambda s: isinstance(s, tuple))
    p = params_from_numpy(np_tree(jp), "cpu")
    assert all(t.dtype == pPM.torch_dtype(dtype)
               for _, t in pPM.tree_paths(p))
    jstate, state = jopt.adamw_init(jp), popt.adamw_init(p)
    assert all(t.dtype == torch.float32 and not bool(t.any())
               for _, t in pPM.tree_paths(state.m))
    for k, scale in enumerate((0.05, 3.0)):
        g = jax.tree.map(lambda s: rng_array(s, 100 + k + sum(s), scale),
                         shapes, is_leaf=lambda s: isinstance(s, tuple))
        jg = jax.tree.map(lambda a: jnp.asarray(a, jdt), g)
        jp, jstate, jm = jopt.adamw_update(jg, jstate, jp, jcfg)
        p, state, m = popt.adamw_update(params_from_numpy(np_tree(jg), "cpu"),
                                        state, p, cfg)
        for got, want in ((leaves(p), jleaves(jp)),
                          (leaves(state.m), jleaves(jstate.m)),
                          (leaves(state.v), jleaves(jstate.v))):
            for a, b in zip(got, want):
                assert rel(a, b) <= ADAM_TOL
        assert int(state.count) == int(jstate.count) == k + 1
        assert state.count.dtype == torch.int32
        for key in ("grad_norm", "lr"):
            assert rel(m[key], jm[key]) <= ADAM_TOL


# ---------------------------------------------------------------------- data
@pytest.mark.parametrize("name", FAMILIES)
def test_synthetic_batch_matches_reference(name):
    """Every array of every family's batch, bit for bit, through
    ``synthetic_batch``, ``batches`` and the Prefetcher."""
    jcfg, cfg = jget_arch(name).reduced(), get_arch(name).reduced()
    want = jpipe.synthetic_batch(jcfg, 3, 12, step=5, seed=4)
    got = ppipe.synthetic_batch(cfg, 3, 12, step=5, seed=4)
    assert sorted(got) == sorted(want)
    extra = {"whisper": "frames", "llama_vision": "patches"}.get(cfg.family)
    assert extra is None or extra in got
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k])
    it, jit_ = ppipe.batches(cfg, 2, 8, seed=1, start_step=3), \
        jpipe.batches(jcfg, 2, 8, seed=1, start_step=3)
    pre = ppipe.Prefetcher(ppipe.batches(cfg, 2, 8, seed=1, start_step=3),
                           device="cpu")
    for _ in range(3):
        a, b, c = next(it), next(jit_), next(pre)
        for k in b:
            assert np.array_equal(a[k], b[k])
            assert isinstance(c[k], torch.Tensor) and c[k].device.type == "cpu"
            assert np.array_equal(to_np(c[k]), b[k])
    pre.stop()


# ---------------------------------------------------------------- train step
@pytest.mark.parametrize("microbatch,remat", [(None, "none"), (2, "block")])
def test_train_step_matches_jitted_reference(microbatch, remat):
    jcfg, jmod, jparams, cfg, mod = reference_setup()
    jt, pt = tcfgs(microbatch=microbatch, remat=remat)
    batch = jpipe.synthetic_batch(jcfg, B, T, step=0)
    p = params_from_numpy(np_tree(jparams), "cpu")
    before = leaves(p)
    jnew, jstate, jm = jax.jit(jtl.make_train_step(jmod, jcfg, jt))(
        jparams, jopt.adamw_init(jparams), batch)
    step = ptl.make_train_step(mod, cfg, pt)
    new, state, m = step(p, popt.adamw_init(p), torch_batch(batch))
    assert new is p                               # updated in place
    assert rel(m["loss"], jm["loss"]) <= STEP_TOL
    assert rel(m["grad_norm"], jm["grad_norm"]) <= STEP_TOL
    assert rel(m["lr"], jm["lr"]) <= SCHED_TOL
    for got, want in zip(leaves(state.m), jleaves(jstate.m)):
        assert rel(got, want) <= STEP_TOL
    for got, want, b0 in zip(leaves(new), jleaves(jnew), before):
        assert rel(got - b0, want - b0) <= CHANGE_TOL


def _run_reference(jtr, jcfg, start, n):
    return jtr.run(jpipe.batches(jcfg, B, T, start_step=start), n)


def test_checkpoints_cross_between_the_trainers():
    """A reference Trainer's checkpoint (2 steps) restores into the port's
    Trainer built from other parameters, bit for bit; 3 more steps on each
    side agree; the port's checkpoint then restores into the reference's
    Trainer bit for bit."""
    jcfg, jmod, jparams, cfg, mod = reference_setup()
    jt, pt = tcfgs(microbatch=2)
    with tempfile.TemporaryDirectory() as d:
        jck = JCheckpointManager(d)
        jtr = jtl.Trainer(jmod, jcfg, jt, jparams, ckpt=jck)
        _run_reference(jtr, jcfg, 0, 2)
        jtr.save(blocking=True)
        other = pPM.materialize(mod.init_specs(cfg), 99, device="cpu")
        tr = ptl.Trainer(mod, cfg, pt, other, ckpt=CheckpointManager(d))
        tr.restore()
        assert tr.step == jtr.step == 2
        for got, want in ((tr.params, jtr.params),
                          (tr.opt_state.m, jtr.opt_state.m),
                          (tr.opt_state.v, jtr.opt_state.v)):
            assert all(np.array_equal(a, b)
                       for a, b in zip(leaves(got), jleaves(want)))
        assert tr.opt_state.count.dtype == torch.int32
        restored = leaves(tr.params)
        jhist = _run_reference(jtr, jcfg, 2, 3)
        hist = tr.run(ppipe.batches(cfg, B, T, start_step=2), 3)
        for key in ("loss", "grad_norm"):
            assert rel(hist[key], jhist[key]) <= STEP_TOL
        for got, want, b0 in zip(leaves(tr.params), jleaves(jtr.params),
                                 restored):
            assert rel(got - b0, want - b0) <= CHANGE_TOL
        tr.save(blocking=True)
        jtr2 = jtl.Trainer(jmod, jcfg, jt, jPM.materialize(
            jmod.init_specs(jcfg), jax.random.PRNGKey(99)), ckpt=jck)
        jtr2.restore()
        assert jtr2.step == tr.step == 5
        assert all(np.array_equal(a, b) for a, b in
                   zip(jleaves(jtr2.params), leaves(tr.params)))
        assert all(np.array_equal(a, b) for a, b in
                   zip(jleaves(jtr2.opt_state.v), leaves(tr.opt_state.v)))


def test_trainer_loss_decreases_and_resumes():
    """The port's twin of the reference's test of that name."""
    cfg = get_arch(ARCH).reduced()
    mod = model_module(cfg)
    prm = pPM.materialize(mod.init_specs(cfg), 0, device="cpu")
    tcfg = TrainConfig(lr=2e-3, warmup_steps=5, total_steps=100, microbatch=2)
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d)
        tr = ptl.Trainer(mod, cfg, tcfg, prm, ckpt=ck, ckpt_every=10)
        hist = tr.run(ppipe.batches(cfg, 4, 32), 30)
        assert min(hist["loss"][-5:]) < hist["loss"][0]
        assert all(np.isfinite(hist["grad_norm"]))
        assert len(hist["step_time"]) == 30 and ck.all_steps()[-1] == 30
        tr.save(blocking=True)
        prm2 = pPM.materialize(mod.init_specs(cfg), 99, device="cpu")
        tr2 = ptl.Trainer(mod, cfg, tcfg, prm2, ckpt=ck)
        tr2.restore()
        assert tr2.step == tr.step
        assert all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(pPM.tree_paths(tr.params), pPM.tree_paths(tr2.params)))


def test_trainer_without_donation_keeps_the_callers_tensors():
    """``donate=False`` steps on copies: the tensors handed in stay as they
    were, and the trained parameters equal a donating Trainer's."""
    cfg = get_arch(ARCH).reduced()
    mod = model_module(cfg)
    prm = pPM.materialize(mod.init_specs(cfg), 0, device="cpu")
    keep = {p: t.clone() for p, t in pPM.tree_paths(prm)}
    tcfg = TrainConfig(lr=2e-3, warmup_steps=1, total_steps=10)
    tr = ptl.Trainer(mod, cfg, tcfg, prm, donate=False)
    tr.run(ppipe.batches(cfg, 2, 8), 2)
    assert all(torch.equal(t, keep[p]) for p, t in pPM.tree_paths(prm))
    tr2 = ptl.Trainer(mod, cfg, tcfg, pPM.materialize(mod.init_specs(cfg), 0,
                                                      device="cpu"))
    tr2.run(ppipe.batches(cfg, 2, 8), 2)
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(pPM.tree_paths(tr.params), pPM.tree_paths(tr2.params)))
