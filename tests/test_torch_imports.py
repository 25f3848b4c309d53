"""The port stands alone: no file under src/repro_torch/, and none of
chip_smoke.py, encode_probe.py and mvm_probe.py, imports ``jax`` or anything
of ``repro``; and the package imports in a fresh interpreter without them being
importable."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py", REPO / "encode_probe.py", REPO / "mvm_probe.py"]


def imported_roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_file_list_covers_the_transposed_slice():
    """The import scan reaches every module of the port, the transposed and
    least-squares/LP slice included."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for rel in ("src/repro_torch/solvers/lstsq.py",
                "src/repro_torch/solvers/pdhg.py",
                "src/repro_torch/kernels/tridiag.py",
                "src/repro_torch/kernels/rram_mvm.py",
                "src/repro_torch/engine.py", "chip_smoke.py"):
        assert rel in names, rel


def test_port_file_list_covers_the_group_slice():
    """The import scan reaches the grouped-execution and encode modules."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for rel in ("src/repro_torch/kernels/encode.py",
                "src/repro_torch/core/crossbar.py",
                "src/repro_torch/interop.py"):
        assert rel in names, rel


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_neither_jax_nor_repro(path):
    assert path.exists(), path
    bad = imported_roots(path) & {"jax", "jaxlib", "repro", "flax", "optax"}
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_package_imports_with_jax_and_repro_blocked():
    """Import every port module with ``jax`` and ``repro`` made unimportable:
    nothing reaches them, directly or through a chain."""
    code = (
        "import sys, importlib, pkgutil\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch.solvers import lsqr, lsmr, pdhg, random_feasible_lp\n"
        "from repro_torch.kernels import ec_rmatmul, thomas_solve\n"
        "from repro_torch.engine import TransposedAnalogMatrix\n"
        "from repro_torch.core import programmed_block_rmvm\n"
        "from repro_torch.kernels import (ec_group_matmul, ec_group_rmatmul,\n"
        "    encode_matmul, encode_matmul_rng, rram_encode_matmul)\n"
        "from repro_torch.engine import AnalogMatrixGroup, CHAIN_ACTIVATIONS\n"
        "from repro_torch.core import group_program_blocks, grouped_block_mvm\n"
        "from repro_torch.interop import group_from_numpy\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_forward_layout_query_imports_alone():
    """The forward launcher's layout query and its record are exported
    beside the transposed ones and import with ``jax`` and ``repro``
    blocked; the records differ in their last field."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from repro_torch.kernels import matmul_layout, rmatmul_layout\n"
        "from repro_torch.kernels.rram_mvm import (MatmulLayout,\n"
        "    RmatmulLayout)\n"
        "print(len(MatmulLayout._fields), MatmulLayout._fields[-1],\n"
        "      RmatmulLayout._fields[-1])\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["9", "pieces", "partials_per_block"]
