"""The port's invariant registry (``repro_torch.analysis.pipelines``) at
``scale="cpu"``: each of the reference's 29 pipelines (``pallas`` read as
``cuda``) run once under the five audits, with no violation, equal field
for field to the ``cpu`` section of ``INVARIANTS_torch.json``; and held to
the reference's checked-in ``INVARIANTS.json``, read as data (nothing is
traced):

* ``max_elements`` equals the reference's where the shapes are the
  reference's (the aged entry excepted: the reference draws its fault
  uniforms over the whole padded image, 2 x the image; the port a block at
  a time, so its largest tensor is the image);
* the virtual entries hold exactly one capacity block, as the reference's
  4,194,304 is one 2,048^2 block;
* the decode's distinct keys are 8 steps x the reference's 10.

The fields a run and a trace count differently are held to the port's
formula: producer calls (one a block an MVM, where the trace inlines the
producer once), the key census (one draw a block an MVM on the
``reference`` backend, where the reference draws a block grid at once),
psums and joins (one each a distributed MVM)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from _torch_port import few_threads  # noqa: F401
from repro_torch.analysis import pipelines as P

REPO = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((REPO / "INVARIANTS_torch.json").read_text())
REFERENCE = json.loads((REPO / "INVARIANTS.json").read_text())
SPECS = {s.name: s for s in P.registered_pipelines(device="cpu",
                                                   scale="cpu")}
CAP = 64                      # the small configuration's capacity block
VIRTUAL_BLOCKS = (P.CPU_VIRTUAL_N // CAP) ** 2      # 64

# (DAC draws an MVM, draws of the producer's content and of programming an
# MVM): the reference backend draws the DAC once a block (fold 1 of its
# block key), the cuda backend once a member over the whole vector; the
# banded producer draws its texture on the 10 (4 x 4 grid) or 22 (8 x 8)
# blocks within three bandwidths of the diagonal; resident=False programs
# each of the 64 blocks again inside every MVM.  Lanczos and ADMM draw one
# start vector more (the power iteration's).
START_DRAWS = {"solve-lanczos-streamed-reference": 1,
               "solve-admm-streamed-reference": 1}
DRAWS = {
    "local-forward-reference": (4, 0), "local-rmatvec-reference": (4, 0),
    "local-forward-cuda": (1, 0), "local-rmatvec-cuda": (1, 0),
    "streamed-forward-reference": (16, 10),
    "streamed-rmatvec-reference": (16, 10),
    "streamed-forward-cuda": (16, 10), "streamed-rmatvec-cuda": (16, 10),
    "group-forward-reference": (32, 0), "group-rmatvec-reference": (32, 0),
    "group-forward-cuda": (8, 0), "group-rmatvec-cuda": (8, 0),
    "group-chain-wholemodel-reference": (32, 0),
    "group-chain-wholemodel-cuda": (32, 0),
    "group-moe-experts-reference": (16, 0),
    "local-aged-forward-reference": (4, 4),     # + a fault draw a block
    "distributed-forward-reference": (4, 0),
    "distributed-rmatvec-reference": (4, 0),
    "solve-cg-streamed-reference": (16, 10),
    "solve-lsqr-streamed-reference": (16, 10),
    "solve-lanczos-streamed-reference": (16, 10),
    "solve-admm-streamed-reference": (16, 10),
}
for _name in SPECS:
    if "virtual65536" in _name:
        DRAWS[_name] = (VIRTUAL_BLOCKS, 22 + VIRTUAL_BLOCKS)


def test_registry_has_the_references_names():
    """The reference's 29 names, ``pallas`` read as ``cuda``, and both
    manifest sections name the same 29."""
    assert len(SPECS) == 29
    assert set(SPECS) == {n.replace("pallas", "cuda") for n in REFERENCE}
    assert set(MANIFEST["cpu"]) == set(SPECS)
    assert {s.backend for s in SPECS.values()} == {"reference", "cuda"}
    with pytest.raises(ValueError, match="scale"):
        P.registered_pipelines(device="cpu", scale="small")


@pytest.mark.parametrize("name", sorted(SPECS))
def test_pipeline_matches_manifest_and_reference(name):
    spec = SPECS[name]
    reports = P.verify_pipeline(spec)
    row = P.manifest_record(spec, reports)
    assert row["violations"] == [], row["violations"]
    assert row == MANIFEST["cpu"][name]

    ref = REFERENCE[name.replace("cuda", "pallas")]
    assert row["min_devices"] == ref["min_devices"]
    virtual = "virtual65536" in name
    # the largest tensor
    if virtual:
        assert ref["max_elements"] == P.VIRTUAL_CAP ** 2
        assert row["max_elements"] == CAP * CAP
        assert row["aval_budget"] == 16 * CAP * CAP
    elif name == "local-aged-forward-reference":
        assert row["max_elements"] == 128 * 128 == ref["max_elements"] // 2
    else:
        assert row["max_elements"] == ref["max_elements"]
        assert row["aval_budget"] == ref["aval_budget"]
    assert row["max_elements"] <= row["aval_budget"]
    # producer calls: one a block an MVM (the reference: 1-2 inlinings)
    mvms = row["mvms"]
    if spec.producer_per_mvm is None:
        assert row["producer_calls"] is None is ref["producer_calls"]
    else:
        assert ref["producer_calls"] in (1, 2)
        assert row["producer_calls"] == mvms * spec.producer_per_mvm
    # the key census
    if name == "serving-decode-fused-rwkv6":
        assert mvms is None
        assert row["distinct_keys"] == 8 * ref["distinct_keys"] == 80
        # 19 analog denses a step, the 2 layers' share their 9 keys
        assert (row["key_consumptions"], row["key_repeats"]) == \
            (8 * 19, 8 * 9)
    else:
        dac, baked = DRAWS[name]
        start = START_DRAWS.get(name, 0)
        assert row["key_consumptions"] == mvms * (dac + baked) + start
        assert row["distinct_keys"] == mvms * dac + baked + start
        assert row["key_repeats"] == (mvms - 1) * baked
    # psums and joins: one each a distributed MVM (the reference: psums of
    # its trace, no gather)
    assert ref["gathers"] == 0
    if spec.placement == "distributed":
        assert row["psums"] == row["gathers"] == mvms
    else:
        assert row["psums"] == row["gathers"] == 0 == ref["psums"]
    # MVMs: one a call; the virtual solves at ANALYSIS_MAXITER
    if spec.direction in ("forward", "rmatvec"):
        assert mvms == 1
    if virtual and spec.direction == "solve":
        assert row["maxiter"] == P.ANALYSIS_MAXITER
        assert mvms == 2 * (1 + P.ANALYSIS_MAXITER)


@pytest.mark.parametrize("name", sorted(n for n, s in SPECS.items()
                                        if s.direction == "solve"))
def test_solve_runs_the_maxiter_it_records(name):
    """A solve's record states the ``maxiter`` its core was built with."""
    spec = SPECS[name]
    assert spec.build().fn.keywords["maxiter"] == spec.maxiter
    assert spec.maxiter == MANIFEST["cpu"][name]["maxiter"]


def test_check_section_reports_each_difference(monkeypatch):
    """``check_section`` runs each entry at its device's scale and returns
    its record with each field that differs from the device's section as
    (measured, manifest), then each manifest entry the registry lacks."""
    name = "local-forward-reference"
    seen = []

    def one_entry(*, device, scale):
        seen.append((device, scale))
        return [SPECS[name]]

    monkeypatch.setattr(P, "registered_pipelines", one_entry)
    manifest = {"cpu": {name: dict(MANIFEST["cpu"][name], psums=3),
                        "gone": {}},
                "cuda": {}}
    first, last = P.check_section("cpu", manifest)
    assert seen == [(torch.device("cpu"), "cpu")]
    assert first.name == name and first.row == MANIFEST["cpu"][name]
    assert first.diff == {"psums": (0, 3)}
    assert "launches" not in first.row and first.seconds > 0
    assert (last.name, last.row, last.diff) == ("gone", None,
                                                {"name": (None, "gone")})
    [clean] = P.check_section("cpu", {"cpu": {name: MANIFEST["cpu"][name]}})
    assert clean.diff == {} and clean.row == MANIFEST["cpu"][name]


def test_gate_tool_passes_on_the_cpu():
    """``tools/check_invariants_torch.py --device cpu`` exits 0 against the
    committed manifest."""
    out = subprocess.run(
        [sys.executable, str(REPO / "tools" / "check_invariants_torch.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                 OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1].startswith("invariants OK "
                                                          "(29 pipelines")


def test_gate_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = subprocess.run(
        [sys.executable, str(REPO / "tools" / "check_invariants_torch.py")],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert out.returncode != 0 and "--device cpu" in out.stderr
