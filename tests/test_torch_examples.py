"""The port's example scripts run end to end on the CPU when asked to
(``--torch-device cpu``): the quickstart's Table-1 grid, the solver
example's asserts and the portfolio example's asserts; without a GPU and
without that flag each exits non-zero with a message instead of falling
back to the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = ["quickstart_torch.py", "meliso_solver_torch.py",
            "meliso_portfolio_torch.py"]


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
    iterations than the fixed-omega baseline, x error <= tol) at n = 1,024,
    one 1,024^2 capacity block."""
    out = run("meliso_solver_torch.py", "--torch-device", "cpu", "--n",
              "1024")
    assert out.returncode == 0, out.stderr
    names = [line.split()[0] for line in out.stdout.splitlines()
             if line.startswith(("richardson", "cg "))]
    assert names == ["richardson", "richardson", "cg"]
    assert "placement=local" in out.stdout


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


@pytest.mark.parametrize("script", EXAMPLES)
def test_examples_do_not_fall_back_to_the_cpu(script):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    out = run(script)
    assert out.returncode != 0
    assert "--torch-device cpu" in out.stderr and out.stdout == ""


@pytest.mark.parametrize("flag", [["--mesh", "1,1"], ["--producer"]])
def test_solver_example_has_no_distributed_flags(flag):
    """Distributed placement waits for ROADMAP A11: argparse refuses
    ``--mesh``.  ``--producer`` programs through the streamed engine and
    passes the example's own asserts at n = 1,024."""
    if flag == ["--producer"]:
        out = run("meliso_solver_torch.py", "--torch-device", "cpu", "--n",
                  "1024", *flag)
        assert out.returncode == 0, out.stderr
        assert "placement=streamed" in out.stdout
        names = [line.split()[0] for line in out.stdout.splitlines()
                 if line.startswith(("richardson", "cg "))]
        assert names == ["richardson", "richardson", "cg"]
        return
    out = run("meliso_solver_torch.py", "--torch-device", "cpu", *flag)
    assert out.returncode == 2 and "unrecognized arguments" in out.stderr
