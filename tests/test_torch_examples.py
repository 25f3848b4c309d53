"""The port's example scripts run end to end on the CPU when asked to
(``--torch-device cpu``): the quickstart's Table-1 grid, the solver
example's asserts on a 2 x 4 mesh, the LP example's, the portfolio
example's and the reliability example's asserts, the LM serving
example, digital and analog, and the LM training example (three steps, a
checkpoint and a resume); without a GPU and
without that flag each exits non-zero
with a message instead of falling back to the CPU."""
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = ["quickstart_torch.py", "meliso_solver_torch.py",
            "meliso_portfolio_torch.py", "meliso_lp_torch.py",
            "meliso_reliability_torch.py", "serve_lm_torch.py",
            "train_lm_torch.py"]


def run(script, *args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, str(REPO / "examples" / script),
                           *args], env=env, text=True, capture_output=True,
                          timeout=300)


def test_quickstart_grid_on_cpu():
    """The grid's three rows; TaOx-HfOx + EC at EpiRAM-class error (the
    paper's bound, 1.5x) and under a fifth of the raw device's, at > 300x
    less programming energy."""
    out = run("quickstart_torch.py", "--torch-device", "cpu")
    assert out.returncode == 0, out.stderr
    rows = {}
    for line in out.stdout.splitlines():
        parts = line.split()
        if len(parts) == 5 and parts[1] in ("True", "False"):
            rows[(parts[0], parts[1])] = [float(v) for v in parts[2:]]
    assert set(rows) == {("epiram", "False"), ("taox-hfox", "False"),
                         ("taox-hfox", "True")}
    epi, raw, ec = (rows[k] for k in (("epiram", "False"),
                                      ("taox-hfox", "False"),
                                      ("taox-hfox", "True")))
    assert ec[0] < 1.5 * epi[0] and ec[0] < 0.2 * raw[0]
    assert epi[1] / ec[1] > 300


def test_meliso_solver_on_cpu():
    """The solver example's own asserts (auto-omega and CG in fewer
    iterations than the fixed-omega baseline, x error <= tol) at n = 1,024
    on the default 2 x 4 mesh, one 512 x 256 capacity block a rank."""
    out = run("meliso_solver_torch.py", "--torch-device", "cpu", "--n",
              "1024")
    assert out.returncode == 0, out.stderr
    names = [line.split()[0] for line in out.stdout.splitlines()
             if line.startswith(("richardson", "cg "))]
    assert names == ["richardson", "richardson", "cg"]
    assert "placement=distributed mesh=2x4 producer=False" in out.stdout


def test_meliso_lp_on_cpu():
    """The LP example's own asserts (both PDHG solves converge, the analog
    objective within 1e-3 of the digital one, the analog x feasible) on a
    2 x 4 mesh programmed from a producer, one 64^2 block a rank."""
    out = run("meliso_lp_torch.py", "--torch-device", "cpu", "--mesh", "2,4",
              "--producer", "--m", "128", "--n", "256")
    assert out.returncode == 0, out.stderr
    rows = {" ".join(line.split()[:2]): line.split()[2:]
            for line in out.stdout.splitlines()
            if line.startswith("pdhg ")}
    assert set(rows) == {"pdhg digital", "pdhg analog"}
    assert float(rows["pdhg digital"][-1]) == 0.0
    assert float(rows["pdhg analog"][-1]) > 0.0
    assert "mesh=2,4, producer=True, placement=distributed" in out.stdout


def test_meliso_portfolio_on_cpu():
    """The portfolio example's own asserts (both ADMM solves converge, the
    analog objective within 1e-3 of the digital one, the split copy in the
    box) and its table: a digital and an analog row, the analog one billing
    iteration energy, the digital one none."""
    out = run("meliso_portfolio_torch.py", "--torch-device", "cpu")
    assert out.returncode == 0, out.stderr
    rows = {" ".join(line.split()[:2]): line.split()[2:]
            for line in out.stdout.splitlines()
            if line.startswith("admm ")}
    assert set(rows) == {"admm digital", "admm analog"}
    assert float(rows["admm digital"][-1]) == 0.0
    assert float(rows["admm analog"][-1]) > 0.0
    assert "torch_device=cpu" in out.stdout
    assert "of the digital oracle" in out.stdout


def test_meliso_reliability_on_cpu():
    """The reliability example's own asserts: the aged solve worse than the
    fresh one, a selective refresh (fewer tiles than the image has, less
    energy than a full reprogram) restoring it within 2x, and the
    fault-tolerant CG over the default 2 x 4 mesh converging after at least
    one restore."""
    out = run("meliso_reliability_torch.py", "--torch-device", "cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    refreshed = [ln for ln in lines if ln.startswith("[lifetime] refreshed")]
    assert len(refreshed) == 1
    done, total = refreshed[0].split()[2].split("/")
    assert 0 < int(done) < int(total) == 16
    assert any("column 5 latched" in ln for ln in lines)
    assert any(ln.startswith("[fault]    detected") for ln in lines)
    assert "converged=True" in lines[-1] and "2 x 4 mesh" in lines[-1]


@pytest.mark.parametrize("rram", [False, True])
def test_serve_lm_on_cpu(rram):
    """The LM serving example on the reduced qwen3-1.7b: a digital and an
    analog run (one-time write billed), each generating batch x tokens
    tokens; the same prompt and seed give the same sequence twice."""
    args = ["--torch-device", "cpu", "--tokens", "4", "--batch", "2",
            "--prompt-len", "8"] + (["--rram"] if rram else [])
    out = run("serve_lm_torch.py", *args)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("analog programming: E=") == rram
    assert f"backend={'rram' if rram else 'digital'} batch=2 full=False " \
        "torch_device=cpu" in out.stdout
    assert any(ln.startswith("generated 8 tokens") for ln in lines)
    first = [ln for ln in lines if ln.startswith("first sequence:")]
    assert len(first) == 1 and len(first[0].split(",")) == 4
    assert run("serve_lm_torch.py", *args).stdout.splitlines()[-1] == \
        first[0]


@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-11b"])
def test_serve_lm_takes_frames_and_patches_on_cpu(arch):
    """The LM serving example on the reduced whisper-tiny (frame
    embeddings, one a prompt token) and llama-3.2-vision-11b (patch
    embeddings), digital and analog: batch x tokens generated, the same
    sequence for the same seed."""
    for rram in (False, True):
        args = ["--torch-device", "cpu", "--arch", arch, "--tokens", "3",
                "--batch", "2", "--prompt-len", "6"] + \
            (["--rram"] if rram else [])
        out = run("serve_lm_torch.py", *args)
        assert out.returncode == 0, out.stderr
        lines = out.stdout.splitlines()
        assert lines[0].startswith("analog programming: E=") == rram
        assert f"arch={arch} backend={'rram' if rram else 'digital'} " \
            "batch=2" in out.stdout
        assert any(ln.startswith("generated 6 tokens") for ln in lines)
        first = [ln for ln in lines if ln.startswith("first sequence:")]
        assert len(first) == 1 and len(first[0].split(",")) == 3
        assert run("serve_lm_torch.py", *args).stdout.splitlines()[-1] == \
            first[0]


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b"])
def test_serve_lm_runs_the_recurrent_families_on_cpu(arch):
    """The LM serving example on the reduced rwkv6-1.6b and zamba2-1.2b,
    digital and analog: a 32-token prompt (one chunk of the recurrence),
    batch x tokens generated, the same sequence for the same seed."""
    for rram in (False, True):
        args = ["--torch-device", "cpu", "--arch", arch, "--tokens", "3",
                "--batch", "2", "--prompt-len", "32"] + \
            (["--rram"] if rram else [])
        out = run("serve_lm_torch.py", *args)
        assert out.returncode == 0, out.stderr
        lines = out.stdout.splitlines()
        assert lines[0].startswith("analog programming: E=") == rram
        assert f"arch={arch} backend={'rram' if rram else 'digital'} " \
            "batch=2" in out.stdout
        assert any(ln.startswith("generated 6 tokens") for ln in lines)
        first = [ln for ln in lines if ln.startswith("first sequence:")]
        assert len(first) == 1 and len(first[0].split(",")) == 3
        assert run("serve_lm_torch.py", *args).stdout.splitlines()[-1] == \
            first[0]


def test_train_lm_on_cpu(tmp_path):
    """The smoke preset (4 layers, d_model 128) for 3 steps: a finite loss
    a step, a checkpoint at step 3, then ``--resume`` goes on from it."""
    ck = str(tmp_path / "ckpt")
    args = ["--preset", "smoke", "--steps", "3", "--torch-device", "cpu",
            "--ckpt-dir", ck]
    out = run("train_lm_torch.py", *args)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "arch=qwen3-1.7b preset=smoke params=1.0M"
    steps = [line.split() for line in lines if line.startswith("step ")]
    assert [int(s[1]) for s in steps] == [1, 2, 3]
    assert all(math.isfinite(float(s[3])) for s in steps)
    assert lines[-1] == f"checkpointed at step 3 -> {ck}"
    more = run("train_lm_torch.py", *args[:2], "--steps", "2", *args[4:],
               "--resume")
    assert more.returncode == 0, more.stderr
    assert "resumed from step 3" in more.stdout
    assert more.stdout.splitlines()[-1] == f"checkpointed at step 5 -> {ck}"


@pytest.mark.parametrize("script", EXAMPLES)
def test_examples_do_not_fall_back_to_the_cpu(script):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    out = run(script)
    assert out.returncode != 0
    assert "--torch-device cpu" in out.stderr and out.stdout == ""


@pytest.mark.parametrize("flag", [["--mesh", "1,1"], ["--producer"]])
def test_solver_example_has_no_distributed_flags(flag):
    """The solver example takes the JAX example's distributed flags:
    ``--mesh 1,1`` (one rank) and ``--producer`` (each rank of the default
    2 x 4 mesh programs its window from a producer) pass its own asserts at
    n = 1,024; a malformed mesh exits with a message."""
    out = run("meliso_solver_torch.py", "--torch-device", "cpu", "--n",
              "1024", *flag)
    assert out.returncode == 0, out.stderr
    want = "mesh=1x1 producer=False" if flag[0] == "--mesh" \
        else "mesh=2x4 producer=True"
    assert f"placement=distributed {want}" in out.stdout
    names = [line.split()[0] for line in out.stdout.splitlines()
             if line.startswith(("richardson", "cg "))]
    assert names == ["richardson", "richardson", "cg"]
    bad = run("meliso_solver_torch.py", "--torch-device", "cpu", "--mesh",
              "2x4")
    assert bad.returncode != 0 and "R,C" in bad.stderr
