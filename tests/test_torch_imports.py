"""The port stands alone: no file under src/repro_torch/, and none of
chip_smoke.py, the five probes and the port's examples, imports
``jax`` or anything of ``repro``; and the package imports in a fresh
interpreter without them being importable."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py", REPO / "encode_probe.py", REPO / "mvm_probe.py",
     REPO / "lp_probe.py", REPO / "reliability_probe.py",
     REPO / "lm_probe.py",
     REPO / "examples" / "quickstart_torch.py",
     REPO / "examples" / "meliso_solver_torch.py",
     REPO / "examples" / "meliso_portfolio_torch.py",
     REPO / "examples" / "meliso_lp_torch.py",
     REPO / "examples" / "meliso_reliability_torch.py",
     REPO / "examples" / "serve_lm_torch.py",
     REPO / "examples" / "train_lm_torch.py",
     REPO / "tools" / "check_invariants_torch.py"]


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


def test_port_file_list_covers_the_main_path_slice():
    """The import scan reaches the refinement solver and the examples."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for rel in ("src/repro_torch/solvers/refinement.py",
                "src/repro_torch/solvers/krylov.py",
                "examples/quickstart_torch.py",
                "examples/meliso_solver_torch.py"):
        assert rel in names, rel


def test_port_file_list_covers_the_distributed_slice():
    """The import scan reaches the mesh, the distributed placement and the
    LP example."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for rel in ("src/repro_torch/launch/mesh.py",
                "src/repro_torch/core/distributed.py",
                "examples/meliso_lp_torch.py"):
        assert rel in names, rel


def test_port_file_list_covers_the_solver_registry_slice():
    """The import scan reaches ADMM, the registry and the portfolio
    example."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for rel in ("src/repro_torch/solvers/admm.py",
                "src/repro_torch/solvers/registry.py",
                "examples/meliso_portfolio_torch.py"):
        assert rel in names, rel


def test_port_file_list_covers_the_reliability_slice():
    """The import scan reaches the reliability package, the checkpoint
    manager and the reliability example."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for rel in ("src/repro_torch/reliability/__init__.py",
                "src/repro_torch/reliability/aging.py",
                "src/repro_torch/reliability/probes.py",
                "src/repro_torch/reliability/refresh.py",
                "src/repro_torch/reliability/ft_solve.py",
                "src/repro_torch/distributed/__init__.py",
                "src/repro_torch/distributed/fault_tolerance.py",
                "examples/meliso_reliability_torch.py",
                "reliability_probe.py"):
        assert rel in names, rel


def test_port_file_list_covers_the_group_slice():
    """The import scan reaches the grouped-execution and encode modules."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for rel in ("src/repro_torch/kernels/encode.py",
                "src/repro_torch/core/crossbar.py",
                "src/repro_torch/interop.py"):
        assert rel in names, rel


def test_port_file_list_covers_the_lm_serving_slice():
    """The import scan reaches the configs, the models, the server and the
    LM serving example."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for rel in ("src/repro_torch/configs/base.py",
                "src/repro_torch/configs/registry.py",
                "src/repro_torch/configs/qwen3_1p7b.py",
                "src/repro_torch/models/params.py",
                "src/repro_torch/models/common.py",
                "src/repro_torch/models/flash.py",
                "src/repro_torch/models/rram.py",
                "src/repro_torch/models/transformer.py",
                "src/repro_torch/train/serve.py",
                "examples/serve_lm_torch.py", "lm_probe.py"):
        assert rel in names, rel


def test_lm_serving_imports_with_jax_and_repro_blocked():
    """The configs (the port's own copies), every arch file, the models and
    the server import with ``jax`` and ``repro`` made unimportable, and
    ``model_module`` hands out the port's transformer."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from repro_torch.configs import ARCHS, get_arch, model_module\n"
        "from repro_torch.models import transformer\n"
        "from repro_torch.train.serve import Server, greedy_generate\n"
        "from repro_torch.interop import params_from_numpy\n"
        "archs = [get_arch(a) for a in ARCHS + ('meliso-mvm',)]\n"
        "assert model_module(get_arch('qwen3-1.7b').model) is transformer\n"
        "print(len(archs))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["11"]


def test_port_file_list_covers_the_attention_families_slice():
    """The import scan reaches the MoE, whisper and llama-vision modules."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for rel in ("src/repro_torch/models/moe.py",
                "src/repro_torch/models/whisper.py",
                "src/repro_torch/models/llama_vision.py"):
        assert rel in names, rel


def test_attention_families_import_with_jax_and_repro_blocked():
    """The three families import with ``jax`` and ``repro`` made
    unimportable, and ``model_module`` hands each arch its module."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from repro_torch.configs import get_arch, model_module\n"
        "from repro_torch.models import llama_vision, moe, whisper\n"
        "for arch, mod in (('mixtral-8x7b', moe),\n"
        "                  ('phi3.5-moe-42b-a6.6b', moe),\n"
        "                  ('whisper-tiny', whisper),\n"
        "                  ('llama-3.2-vision-11b', llama_vision)):\n"
        "    assert model_module(get_arch(arch).model) is mod, arch\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_port_file_list_covers_the_recurrent_families_slice():
    """The import scan reaches the linear-attention recurrences and the
    RWKV-6, Mamba-2 and Zamba2 modules."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for rel in ("src/repro_torch/models/linear_attention.py",
                "src/repro_torch/models/rwkv6.py",
                "src/repro_torch/models/mamba2.py",
                "src/repro_torch/models/zamba2.py"):
        assert rel in names, rel


def test_recurrent_families_import_with_jax_and_repro_blocked():
    """The recurrent families import with ``jax`` and ``repro`` made
    unimportable, ``model_module`` hands each arch its module, and a
    family without one raises ``KeyError``."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from repro_torch.configs import get_arch, model_module\n"
        "from repro_torch.models import (linear_attention, mamba2, rwkv6,\n"
        "                                zamba2)\n"
        "assert model_module(get_arch('rwkv6-1.6b').model) is rwkv6\n"
        "assert model_module(get_arch('zamba2-1.2b').model) is zamba2\n"
        "try:\n"
        "    model_module(get_arch('meliso-mvm').model)\n"
        "except KeyError:\n"
        "    print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_port_file_list_covers_the_training_slice():
    """The import scan reaches the optimizer, the train loop, the data
    pipeline and the training example."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for rel in ("src/repro_torch/train/optimizer.py",
                "src/repro_torch/train/train_loop.py",
                "src/repro_torch/train/__init__.py",
                "src/repro_torch/data/__init__.py",
                "src/repro_torch/data/pipeline.py",
                "examples/train_lm_torch.py"):
        assert rel in names, rel


def test_training_imports_with_jax_and_repro_blocked():
    """The training modules import with ``jax`` and ``repro`` made
    unimportable, and export the reference's names."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from repro_torch.train import (OptState, Server, Trainer,\n"
        "    adamw_init, adamw_update, greedy_generate, lr_schedule,\n"
        "    make_train_step)\n"
        "from repro_torch.train.optimizer import global_norm\n"
        "from repro_torch.data import Prefetcher, batches, synthetic_batch\n"
        "from repro_torch.models.common import AnalogProduct, layer_body\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_port_file_list_covers_the_serving_slice():
    """The import scan reaches every module of the serving simulator."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for rel in ("__init__", "traffic", "batching", "cache", "metrics",
                "simulator"):
        assert f"src/repro_torch/serving/{rel}.py" in names, rel


def test_serving_imports_with_jax_and_repro_blocked():
    """The serving simulator imports with ``jax`` and ``repro`` made
    unimportable, and exports the reference's names."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from repro_torch.serving import (Batch, BatchingConfig,\n"
        "    CacheOverBudgetError, ImageCache, MetricsAccumulator,\n"
        "    RequestQueue, ServingConfig, generate_trace, simulate)\n"
        "from repro_torch.train.serve import Server\n"
        "assert Server.dispatches_per_batch\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_port_file_list_covers_the_analysis_slice():
    """The import scan reaches the analysis package and the rehearsal of
    its chip phase."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for rel in ("src/repro_torch/analysis/__init__.py",
                "src/repro_torch/analysis/memory.py",
                "src/repro_torch/analysis/model_flops.py", "lm_probe.py"):
        assert rel in names, rel


def test_analysis_imports_with_jax_and_repro_blocked():
    """The analysis package and the solver cores import with ``jax`` and
    ``repro`` made unimportable, and count qwen3-1.7b's parameters over
    shapes alone."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from repro_torch.analysis import (max_aval_elements, model_flops,\n"
        "    peak_bytes)\n"
        "from repro_torch.configs import get_arch\n"
        "from repro_torch.solvers import (cg_pipeline, lsmr_pipeline,\n"
        "    lsqr_pipeline, pdhg_pipeline)\n"
        "print(model_flops.param_count(get_arch('qwen3-1.7b')))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["2032264192"]


def test_port_file_list_covers_the_invariant_slice():
    """The import scan reaches the audits, the registry and the gate."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for rel in ("src/repro_torch/analysis/verify.py",
                "src/repro_torch/analysis/pipelines.py",
                "src/repro_torch/core/prng.py",
                "src/repro_torch/launch/mesh.py",
                "tools/check_invariants_torch.py"):
        assert rel in names, rel


def test_invariants_import_with_jax_and_repro_blocked():
    """The audits and the registry import with ``jax`` and ``repro`` made
    unimportable, the registry names its 29 pipelines without building
    one, and the package exports the reference's names less
    ``jaxpr_max_elements`` and ``trace``, plus ``peak_bytes`` and
    ``model_flops``, and the cost model's and roofline's."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from repro_torch import analysis\n"
        "from repro_torch.analysis import pipelines, verify\n"
        "specs = pipelines.registered_pipelines(device='cpu', scale='cpu')\n"
        "print(len(specs), ' '.join(sorted(analysis.__all__)))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [
        "29", "CallCounter", "HW", "Report", "RunCost", "Site", "Violation",
        "analyze_run", "aval_bound", "collective_audit", "collective_wire",
        "collective_wire_bytes", "count_op", "dispatch_count", "format_row",
        "key_reuse", "max_aval_elements", "measure_cost", "model_flops",
        "peak_bytes", "precision_lint", "roofline_terms", "run_all"]


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
        "from repro_torch.solvers import bicgstab, gmres, refine\n"
        "from repro_torch.core import (corrected_mvm, corrected_matmul,\n"
        "    corrected_matvecmul)\n"
        "from repro_torch.solvers import (admm, admm_pipeline,\n"
        "    random_box_qp, SolverSpec, registry)\n"
        "assert len(registry()) == 12\n"
        "from repro_torch.launch import make_mesh, psum\n"
        "from repro_torch.core import (distributed_corrected_mvm,\n"
        "    make_distributed_streamed_mvm, shard_matrix)\n"
        "from repro_torch.reliability import (AgeLedger, ft_cg, ft_pdhg,\n"
        "    probe_tile_scores, refresh_tiles)\n"
        "from repro_torch.distributed import CheckpointManager, Watchdog\n"
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


def test_port_file_list_covers_the_roofline_slice():
    """The import scan reaches the declared kernel costs, the cost model,
    the wire count and the roofline."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for rel in ("src/repro_torch/kernels/cost.py",
                "src/repro_torch/analysis/cost.py",
                "src/repro_torch/analysis/wire.py",
                "src/repro_torch/analysis/roofline.py"):
        assert rel in names, rel


def test_roofline_slice_imports_with_jax_and_repro_blocked():
    """The kernel costs, the cost model, the wire count and the roofline
    import, and count a CPU call, with ``jax`` and ``repro`` made
    unimportable."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import torch\n"
        "from repro_torch.kernels import cost, stencil_denoise\n"
        "from repro_torch.analysis import analyze_run, measure_cost\n"
        "from repro_torch.analysis import roofline, wire\n"
        "c = measure_cost(stencil_denoise, torch.ones(16, 2), 1e-2)\n"
        "assert (c.flops, c.bytes) == tuple(cost.stencil_denoise(16, 2))\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
