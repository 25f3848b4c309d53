#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU, full size.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc`` (``$CUDA_HOME/bin`` or ``PATH``); exits
non-zero, printing no result, without them or without the repository's
``src/repro_torch`` beside it.  Phases, each of which raises on failure:

  1. build the ten CUDA kernels from ``src/repro_torch/kernels/csrc`` and
     print what ``ptxas -v`` reports for each compiled kernel;
  2. program a 32,768 x 32,768 matrix (taox-hfox, EC on, default 8 x 8 MCAs
     of 512 x 512) and hold each kernel to its plain PyTorch version at the
     main path's shapes, timing kernel, plain version and library call; both
     EC products also bit for bit run to run, and the layout each launcher
     chose printed: a persistent one-wave grid over units of the image
     (forward: 16 rows x a 4,096-column piece of K, the pieces added in
     piece order by a second pass; transposed: 16 rows x 512 columns, the
     blocks' partials added in block order), fed by a TMA ring -- the
     staged kernel, which both must take here, in phase 5 and in phase 6;
     thomas_solve held and timed at lam 1e-2 (the Thomas engines'), also
     timed at 1e-12 and 1e3, held at lam 10 to its plain version and at lam
     1e3 to a float64 solve (within twice the plain version's error), bit
     for bit run to run, with each CUDA kernel's share of a call (the
     transposes of a panel wider than one column); the launch floor (500
     back-to-back plain launches of the one-thread floor probe,
     launch_floor_probe) with the 1 x 1 richardson_update, stencil_denoise
     and cg_update beside it (all three launched with programmatic
     dependent launch), recorded beside the four small kernels; the EC +
     stencil pair of a corrected MVM at batch 1 and 8; and stencil_denoise
     (lam 1e-12 and 1e-2), cg_update and richardson_update at the main
     path's other panels (TIER2_STENCIL_SHAPES, TIER2_CG_SHAPES), each
     against its plain version and bit for bit run to run, beside its byte
     bound and share;
  3. serve 8 single-vector requests and one batch of 8 through
     ``backend="cuda"``, against the digital ``a @ x``, the ``reference``
     backend on the same image, and -- with the input DAC off, where both
     are deterministic -- the reference pipeline to 1e-5;
  3t. the same for ``A.T @ y`` on the same image, and, DAC off, an engine
     with the exact Thomas tier-2 (lam = 1e-2) in both directions against
     the reference pipeline to 1e-5;
  4. solve an SPD system (epiram, EC on) through ``backend="cuda"`` with CG,
     Richardson, BiCGSTAB and GMRES(20) to x error <= 1e-3, and with
     iterative refinement (inner CG) to a digital relative residual <=
     1e-5, below the printed one-MVM noise floor; each cold and warm, with
     one ec_matmul and one stencil_denoise launch an MVM; a warm CG
     solve's and a warm Richardson solve's (at the estimated omega) device
     ms an iteration (torch.profiler);
  4e. on the same image: Lanczos (tol 1e-3), LOBPCG (k = 2, largest and
     smallest), spectral_bounds / estimate_omega(method="lanczos") and
     Richardson at that omega; each pair's digital Ritz residual against
     the registry's honesty bound, the eigenvalues within 2 x the noise
     floor of the same solver on the digital operator with the same key
     and steps (the digital solve to tol 1e-6 printed beside), and one
     ec_matmul + one stencil launch per MVM call (Lanczos: 8 seed steps +
     one a step; LOBPCG: one at entry + one 6-column call an iteration);
  4r. the 12 solvers of the port's registry, each on its seed-0 problem at
     n = 12 programmed on a cuda engine (epiram, EC on, one 32^2 MCA) under
     the reference contract suite's budgets: the ledger's energy is the
     write plus the billed MVMs, one EC launch per billed MVM in its
     direction; and on the dense problem on the card, the recorded residual
     honest against the digital recompute and the converged flag with it;
  5. solve a consistent 32,768 x 16,384 least-squares problem with LSQR and
     LSMR to normal-equations residual <= 1e-3 and a 16,384 x 32,768 random
     feasible LP with PDHG to KKT residual <= 1e-3 (epiram, EC on); each of
     the two images first holds ec_matmul, ec_rmatmul (batch 1) and
     stencil_denoise (on its 16,384-row panel) to their plain versions, and,
     DAC off, A.T @ y on the cuda path to the reference pipeline to 1e-5
     (Neumann, and Thomas at lam = 1e-2);
  5e. operator_norm (Lanczos on [[0, A], [A', 0]]) on the least-squares
     image, near the Marchenko-Pastur edge 1 + sqrt(1/2), within 2 x that
     image's noise floor of the digital operator's with the same key and
     steps; one ec_matmul and one ec_rmatmul launch a Lanczos step, seed
     steps included;
  5q. linearized ADMM on the same image: a box QP built on its matrix with
     a known optimum (random_box_qp's construction), solved cold and warm
     to KKT <= 1e-3 with the default step (16 power steps); the split copy
     in the box, the objective within 1e-3 of the digital operator's run
     with the same key, one ec_matmul + one ec_rmatmul launch per billed
     MVM pair;
  6. program the 8 experts' w1 of one Mixtral-8x7B MoE layer (14,336 x
     4,096 each, A ~ N(0, 1/4,096), taox-hfox, EC on) as one group, hold the
     grouped EC kernels to their plain versions, and run group_mvm /
     group_rmvm at batch 1 and 8 on both backends (a group of one equal to
     the solo kernel bit for bit, both directions): one grouped EC launch and
     one tier-2 launch per call, each member equal to its solo execute, the
     DAC-off cuda path equal to the reference pipeline (Neumann and Thomas
     at lam = 1e-2) to 1e-5;
  6c. chain 32 square 4,096^2 layers (Mixtral's d_model and depth, He
     init, relu) through chain_mvm on both backends: 32 ec_matmul launches
     per chain, DAC off cuda equal to reference to 1e-4 after 32 layers;
  7. x (256, 4,096) @ encode(W (4,096, 14,336)) in 512^2 MCA tiles through
     rram_encode_matmul and encode_matmul_rng (taox-hfox levels and
     effective sigma): each held to its plain version, the rng kernel at
     sigma = 0 equal to encode_matmul with zero eps, bit for bit run to
     run, and its draws' moments read back through the product; for both
     product kernels the ptxas report (registers, stack frame, spills), the
     SM clock and power sampled while they run, the rate reached and each
     CUDA kernel's share of a call, and for the rng kernel a second bound
     that counts its generator;
  8. the paper's Table 1 on the card (benchmarks/table1_ec.py's full mode):
     bcsstk02 and Iperturb (66^2, one 66 x 66 MCA) on every device, raw and
     with EC, programmed once a cell on the cuda backend and run 100 times;
     the paper's claims asserted at tests/test_paper_claims.py's bounds,
     DAC off cuda equal to reference in every cell, ec_matmul held to its
     plain version on that image (a 264-byte row stride: the register-load
     layout), the one-shot corrected_mvm equal to the reference engine bit
     for bit, and corrected_matmul at one Mixtral expert's width (fused
     against faithful, EC against raw; the two forms timed in turn, with
     the SM clock sampled while they run);
  9. streamed execution (a ``block_fn(i, j)`` producer, only A_tilde kept,
     dA derived again per block): [9a] phase 2's matrix sliced into 4,096^2
     blocks, its streamed image equal to the local one bit for bit, one EC
     launch per block and one tier-2 launch per call in both directions,
     DAC off cuda equal to reference to 1e-5 (Neumann, Thomas at lam
     1e-2), and the EC kernels on one block of the stack against their
     plain versions; [9b] the paper's dubcova2 (65,025^2, the implicit
     banded producer on 8 x 8 MCAs of 1,024^2, taox-hfox, k = 5, EC on):
     3 A @ x and 1 A.T @ y against the producer's ground truth, the peak at
     or under the image + 12 capacity blocks, where a call's time goes, the
     8,192^2 block's EC kernels, and the one-shot streamed_corrected_mvm
     under 12 blocks with no image; [9c] CG (tol 1e-3, at most 12
     iterations) on an epiram image of the same producer to x error <=
     1e-3, one cg_update an iteration;
 10. distributed placement over a 2 x 4 mesh of ranks, all on this card
     (one process drives them in rank order; partials summed over the
     contraction axis in rank order, tier-2 on each output segment, one
     global output): [10a] phase 3's cell (32,768^2, taox-hfox, EC on, 8 x
     8 MCAs of 512^2; rank windows 16,384 x 8,192) at batch 1 and 8 each
     way, one EC launch per capacity block (64) and one tier-2 launch per
     segment (2 forward, 4 transposed), DAC off cuda = reference on the
     same handle (Neumann, Thomas at lam 1e-2); [10b] [9b]'s dubcova2
     producer on a 1 x 1 mesh equal to [9b]'s streamed calls bit for bit
     in both directions, and over 2 x 4 at its padded 65,536^2 within 1e-5
     of 1 x 1, DAC off cuda = reference, the peak over the image; [10c]
     ``resident=False`` at 65,536^2 (the reference's scale test: banded
     SPD producer, epiram, 8 x 8 MCAs of 1,024^2): CG to the residual
     2e-2 (digital residual too), the producer once a block an MVM, the
     peak over the start under 12 capacity blocks; [10d] phase 6's
     Mixtral w1 group over 2 x 4: members 0 and 7 equal to their solo
     distributed programs bit for bit, one ec_group_matmul launch per
     rank's window, DAC off cuda = reference (Neumann, Thomas);
 11. device-lifetime reliability (``reliability_phase``): [11a] phase 4's
     kind of matrix (R + R^T + 2I, 32,768^2, epiram, 8 x 8 MCAs of 512^2)
     on the ``reference`` backend, the one that ages: CG fresh, aged to
     about 64 latched cells (the count printed), CG aged (digital residual
     over 1e-2 and the fresh one), one batch-8 probe call, a refresh of the
     tiles whose score rose over 3 x their fresh score (fewer than all 64,
     less energy than a full reprogram), CG again within 2 x the fresh
     residual; a solve leaves the ledger as it was, a host A @ x adds one;
     the aging transform's ms a call and its peak over the image; [11b]
     ``ft_cg`` over a 2 x 4 mesh (``backend="cuda"``) with one bitline of
     every MCA (column 5 of every 512-wide strip of the rank windows)
     latched at the G_on rail at segment 1 and repaired:
     converged at tol 1e-4 after at least one restore, one ec_matmul a
     block an MVM; [11c] ``ft_pdhg`` on phase 5's LP with a NaN written into
     block (0, 0) before segment 0 and repaired: converged after exactly one
     restore; [11d] phase 6's Mixtral w1 group aged (50 MVMs, 3,600 s) on
     the reference backend: members 0 and 7 equal to solo handles aged from
     their own keys bit for bit, one group_mvm adds one to every member's
     ledger, ``backend="cuda"`` refuses the aged group;
 12. the transformer LM served on the programmed image (``lm_phase``):
     qwen3-1.7b at its published widths and depth (28 layers, d_model
     2,048, 16 / 8 heads of 128, d_ff 6,144, vocab 151,936 padded to
     152,064) in float32, random weights from seed 0, every linear kernel
     programmed once (taox-hfox, k = 5, EC, 512^2 cells, dw float32); the
     analog dense (one ec_rmatmul launch per 8 rows + one stencil_denoise)
     against its plain twin at the five kernel shapes and 1 / 4 / 8 / 64
     rows, bit for bit run to run; 4 prompts of 64 tokens -> 32 new and 1
     prompt of 1,024 tokens -> 16 new (its prefill through the chunked
     flash attention) served with the DAC on, every launch counted (197
     ec_rmatmul + 197 stencil_denoise a decode step at 4 rows); DAC off,
     prefill's logits within 1e-4 of the digital model; DAC on, two
     generate calls under one key equal; program, prefill and decode times,
     device busy against wall over the decode loop, a decode step's EC
     kernels against their byte bound, and the stencil's device ms summed
     over the 1 x 1,024 prefill's launches against their byte bound;
 13. the attention-based families served (``families_phase``, float32,
     weights from seed 0, the [12] backend, each model freed before the
     next): [13a] Mixtral-8x7B at its published widths, 8 of its 32
     layers, one request of 4 x 64 -> 32 tokens: its experts' 4-D stacks
     stay digital (the reference's rule), every attention dense and the
     head analog (33 ec_rmatmul + 33 stencil_denoise a decode step); [13b]
     layer 0's MoE tree programmed on its own, whose (8, 4,096, 14,336)
     stacks take the expert EC: expert_mm against its plain twin at lam
     1e-2 and 1e-12, moe_apply on 4 and 256 tokens (one ec_group_rmatmul
     per 8 capacity slots a stack, one stencil_denoise a stack), DAC off
     against the digital experts; [13c] whisper-tiny whole, 1,500 frames
     and a 16-token prompt -> 16 (the decoder's cross-attention projects
     the 1,500 frames again every step: 1,537 ec_rmatmul a decode step);
     [13d] Llama-3.2-Vision-11B at its published widths, one super layer
     (4 self + 1 cross of 40), 4,096 patches, 32 -> 8 tokens, the cross
     gate set to 1.0 (zero at init); for [13a], [13c] and [13d] the dense
     twin at the family's kernel shapes, every launch counted against the
     families' analog denses, DAC-off logits within 1e-4 of the digital
     model, two generate calls under one key equal, times, the idle share
     and a decode step's bytes against HBM's rate;
 14. the recurrent families served (``recurrent_phase``, after [13], the
     same backend and checks): [14a] rwkv6-1.6b whole (24 layers, d_model
     2,048, 32 heads of 64, d_ff 7,168, vocab 65,536): nine analog denses
     a layer (w_lora_b is read digitally), 217 ec_rmatmul + 217
     stencil_denoise a decode step at 4 rows; 4 x 64 -> 32 and 1 x 1,024
     -> 16 (32 chunks of the inter-chunk scan; the decode step's time
     against the short prompt's); [14b] zamba2-1.2b whole (38 layers = 6
     groups of 6 digital mamba blocks, a shared attention block after each
     group, an analog tail of 2; d_inner 4,096, 64 SSM heads, vocab
     32,000): 49 + 49 a decode step, 4 x 64 -> 32; for each the dense twin
     at its five kernel shapes, and the chunked WKV / SSD alone over 1,024
     tokens against its single-token recurrence, device ms;
 15. training on one card (``train_phase``, after [14], float32, TF32
     off): [15a] qwen3-1.7b at its published widths and depth (2.03 G
     parameters) trained 10 steps by ``Trainer.run`` from seed-0 weights,
     AdamW (lr 3e-4, warmup 2 of 10 steps), microbatches of 2 in a batch
     of 4 x 256 tokens, block remat, batches from the synthetic pipeline
     through the prefetching thread: finite losses and grad norms, the last
     three losses' least under the first; the step's median ms (steps 3 to
     10), tokens/s, model TFLOP/s against the fp32 peak, device busy share
     against wall over 3 profiled steps and the peak memory against its
     prediction; a blocking save and a restore into a Trainer built from
     seed-99 weights, parameters, m, v and count equal bit for bit; [15b]
     2 of its layers at full width on 1 x 64 tokens: the loss and every
     leaf's gradient on the card against the same port code on the host's
     CPU (loss 1e-5, each leaf rel-L2 1e-4); [15c] the analog dense's
     gradient ([12]'s backend at lam 1e-2): x, w_tilde and dw through
     ``dense`` (its autograd function over the kernels) against
     ``dense_plain`` (plain autograd) at the five kernel shapes and 8 / 64
     rows, 1e-5 and bit for bit run to run, one ec_rmatmul per 8 rows + one
     stencil_denoise forward and one stencil_denoise backward; then the
     2-layer model programmed on [12]'s backend, its loss's backward
     counted (the main path) with a finite gradient on every leaf it
     reaches;
 16. the serving simulator (``serving_phase``, after [15]): [16a] the
     reference benchmark's mixed trace (4 tenants of reduced rwkv6-1.6b
     and qwen3-1.7b, 24 requests) through ``repro_torch.serving.simulate``
     on the card with the model run, on epiram and on the digital
     baseline, each equal (records, summary, cache stats) to the same
     trace without the model on the CPU, its launches one ec_rmatmul per 8
     rows and one stencil_denoise per analog dense of each batch (the
     digital run none), and the skewed trace (36 requests) under lru and
     write_cost, write_cost's write energy the lower; [16b] three tenants
     of qwen3-1.7b at its published widths and depth (float32, [12]'s
     backend) sharing one weight set, an ImageCache under write_cost with
     room for two images (27.5 GB), a generate_trace of 8 requests served
     batch by batch: each miss programs a Server (held to the bytes it
     adds less those its evictions free, within 1 % of an image), a hit
     programs nothing, each generate counted against the padded shape's
     analog denses, the peak within the weights + 3 images + activations,
     and the memory back to the start at the end;
 17. the reference analysis registry's two paper-scale cores
     (``analysis_phase``, after [16]): a 65,536^2 banded producer
     (``ImplicitBandedMatrix``, seed 2) programmed ``resident=False``
     (taox-hfox, k = 5, EC on, 4 x 4 MCAs of 512^2: 1,024 capacity blocks
     of 2,048^2 an MVM); [17a] on a 1 x 1 mesh ``mvm_fn`` both ways and
     ``pdhg_pipeline`` (tau = sigma = 0.1, 2 iterations), [17b] on the 2 x
     4 mesh ``lsqr_pipeline`` (2 iterations): each call's largest tensor
     (``analysis.max_aval_elements``) <= n^2 / 8 and <= 4 capacity blocks,
     its allocator peak over the start (``analysis.peak_bytes``) <= 12
     capacity blocks, one producer call and one EC launch a block an MVM
     (none at programming), one stencil a segment, every iterate finite,
     and an MVM's wall and device-busy ms;
 18. the invariant registry on the card (``invariants_phase``, after
     [17]): each of the 29 pipelines of ``repro_torch.analysis.pipelines``
     at ``scale="paper"`` (the six virtual entries at 65,536^2, 1,024
     blocks of 2,048^2, ``resident=False``; the virtual solves at 2
     iterations) run once under the five audits of
     ``repro_torch.analysis.verify``; its record printed as one JSON line,
     no violation, the record equal field for field to the ``cuda``
     section of ``INVARIANTS_torch.json`` (launches per kernel included),
     and on the six virtual entries the allocator's peak over the start
     (``analysis.peak_bytes``, the audited run) <= 12 capacity blocks;
 19. the roofline of the main path (``roofline_phase``, after [18]):
     ``repro_torch.analysis.analyze_run`` counts each call's flops and
     bytes in one run (each kernel function by its declared cost,
     ``repro_torch.kernels.cost``), and on the card reads its device time
     (``torch.profiler``) against the bound: [19k] the ten kernel functions
     at PERF.md section 6's shapes (their device ms a call beside that
     table's, launches one a call); [19a] the 32,768^2 local corrected MVM
     both ways at batch 1 and 8; [19b] a warm CG solve on an epiram SPD
     32,768^2 image (flops and bytes an MVM, cg_update's share); [19c]
     [17]'s 65,536^2 ``resident=False`` MVM with model_flops 4 n^2; [19d]
     qwen3-1.7b whole (float32): a decode step at 4 rows (its EC bytes
     equal to ``ec_bytes``, the idle share) and a 1 x 1,024 prefill (the
     EC function bound beside the per-8-row launch traffic).  No achieved
     over 1.05, and every count equal to the CPU's of the same calls
     (``ROOFLINE_CPU_COUNTS``, from ``lm_probe.py rehearse-roofline
     --full``);
 20. sharded execution on a one-card mesh (``sharded_phase``, after [19]):
     every rank of a 1 x 1, 1 x 4 or 2 x 4 ("data", "model") mesh on the
     card; [20a] one Mixtral-8x7B MoE layer's tree programmed on its own
     ([12]'s backend) through ``moe_apply``'s tensor-parallel path on 1 x 4
     and 2 x 128 tokens: 1 x 1 = the local path bit for bit with its
     launches, each rank's expert_mm on views of its d_ff block within
     EC_TOL of its plain twin, 3 ceil(cap / 8) ec_group_rmatmul + 3
     stencil_denoise a rank and nothing else, DAC off within 1e-4 of the
     digital TP path, the peak under the local call's + one rank's share
     of one stack, device and per-call ms against the byte bound; [20b]
     one layer of Mixtral at its published widths trained one step as
     ``build_cell``'s train branch builds it, on each mesh against the
     step without one (1e-5), and on 2 x 64 tokens (drops, peak, ms);
     [20c] ``compressed_psum`` over 8 ranks of a 151,936 x 2,048 gradient
     and ``ring_collective_matmul`` over 4 at 256 x 4,096 @ 4,096 x
     14,336, their wire bytes at the ring formulas.

Beside the calls they wrap, [3] / [3t] hold ``engine.mvm_fn`` both ways,
[6] ``group_mvm_fn`` and [6c] ``chain_fn`` to them bit for bit under one
key with the same launches; [4] and [5] run ``cg_pipeline``,
``lsqr_pipeline``, ``lsmr_pipeline`` and ``pdhg_pipeline`` at their public
solves' settings, bit for bit in x, history, iterations and MVMs, their
launches by formula; [12] holds ``Server.decode_fn(8)`` after a prefill to
``decode_tokens`` after a second, fresh prefill (8 x (197 + 197)
launches); [15a] holds ``analysis.model_flops.param_count`` to the
materialized count and prints its train_4k FLOPs a token beside the hand
count, their difference in closed form.

Launch counts are zeroed just before each solve of phases 4, 4e, 4r, 5,
5e and 5q, and before phases 3, 3t, 6, 6c, 7, 8, 9, 10, 11, 12, 13, 14
and 15's main calls, before [16a]'s served runs and [16b]'s batches and
before each of [17]'s counted calls and [20a]'s tensor-parallel calls,
and [19] reads the change over each of its counted runs: every kernel
must have run on the path that uses it.  The last three lines of output are
the kernel table as JSON, the card's name and power limit, and the result
line.  Every bound is ``repro_torch.analysis.roofline.bound_ms`` of a
declared cost from ``repro_torch.kernels.cost``, over the rates in
``roofline.HW``: the published H100 SXM figures (3.35 TB/s of HBM,
67 TFLOP/s float32 outside the tensor cores).
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

N = 32768
SEED = 0
STENCIL_CHECK_LAM = 1e-2  # large enough that the stencil term shows in fp32
EC_TOL = 1e-5          # ec_(r)matmul vs its plain version (fp32 sums, other order)
ELEMENTWISE_TOL = 1e-6  # the one-pass kernels, and thomas_solve (a contraction)
SOLVE_TOL = 1e-3
REFINE_TOL = 1e-5      # refine's digital residual: below the one-MVM noise floor
GMRES_RESTART = 20
LSTSQ_SHAPE = (N, N // 2)   # rows, columns of the least-squares matrix
LP_SHAPE = (N // 2, N)      # constraints, variables of the LP
PDHG_MAXITER = 5000
EIGEN_TOL = 1e-3        # [4e] / [5e] solves (relative Ritz residual)
EIGEN_DIGITAL_TOL = 1e-6  # the digital runs they are printed beside
LOBPCG_K = 2            # a 6-column [X | R | P] panel: one ec_matmul launch
# The reference registry's honesty contract for the eigen family:
# recompute <= max(slack * recorded, floor) (solvers/registry.py).
RITZ_SLACK = 3.0
RITZ_FLOOR = {"lanczos": 5e-3, "lobpcg": 5e-4}
ADMM_ACTIVE_FRAC = 0.3   # [5q]: share of x* on a bound (random_box_qp's)
ADMM_MAXITER = 2000
# [5q]: rel-L2 bound on x against the digital run's and against x*; at
# tol 1e-3 each run lands ~4.4e-3 from x* (NVIDIA H100 80GB HBM3, 700 W),
# so the two lie within ~8.9e-3 of each other at the most.
ADMM_X_TOL = 1e-2
REGISTRY_N = 12         # [4r]: each registry solver's problem size
# Mixtral-8x7B (src/repro/configs/mixtral_8x7b.py): one MoE layer's experts.
D_MODEL, D_FF, N_EXPERTS, N_LAYERS = 4096, 14336, 8, 32
CHAIN_TOL = 1e-4        # cuda vs reference after N_LAYERS chained layers
HOOK_KEY = 13           # [3], [3t], [6], [6c]: a hook and its call's key
ENCODE_ROWS = 256       # rows of x in phase 7
ENCODE_SEED = 2024
# Thomas, a block scan (csrc/tridiag.cu): in each of its two passes a thread
# composes and replays its 64 rows (2 x 64 dependent FMAs, 4 cycles each)
# around an 11-level shuffle scan (5 over lanes, 5 over warp totals, 1 shift;
# about 30 cycles a level with its barriers), at the 1.98 GHz boost clock.
THOMAS_ROWS_PER_THREAD = 64
THOMAS_SCAN_LEVELS = 11
THOMAS_CHECK_LAMS = (10.0, 1e3)  # |c'| ~ 0.92 and ~ 0.97: long carries
SM_CLOCK_HZ = 1.98e9
LAUNCH_FLOOR_ITERS = 500
# [2] tier-2 and CG-update panels of the main path: the solvers' columns
# (n = 32,768, 16,384; dubcova2's 65,025) and batch 8, qwen3-1.7b's (d_out,
# rows) panels (2,048 / 6,144 / the 151,936-row vocabulary at 4 and 1,024
# rows), and [13b]'s MoE (F, E * C) panel at 256 tokens (E * C = 640).
TIER2_STENCIL_SHAPES = ((32768, 1), (32768, 8), (16384, 1), (65025, 1),
                        (2048, 4), (6144, 4), (151936, 4), (6144, 1024),
                        (151936, 1024), (D_FF, 640))
TIER2_CG_SHAPES = ((32768, 1), (32768, 8), (65025, 1))
# qwen3-1.7b's tier-2 panels in a 1 x 1,024 prefill, (d_out, rows, launches):
# 28 layers of q, o, down (2,048), k, v (1,024) and gate, up (6,144) on 1,024
# rows, and the head's (152,064, 1) on the last token: 197 launches.
TIER2_PREFILL_PANELS = ((2048, 1024, 84), (1024, 1024, 56),
                        (6144, 1024, 56), (152064, 1, 1))
TIER2_SEED = SEED + 2   # [2]'s tier-2 panels: a generator of their own
SLEEP_CYCLES = 100_000_000  # ~50 ms at the H100's clock: longer than queueing a run
# Instructions a draw of encode_matmul_rng's generator issues at the least,
# counted from the source (philox_normal in csrc/encode_matmul.cu):
# Philox4x32-10, 10 rounds of 2 wide multiplies and 2 three-way XORs (40; the
# key schedule is shared by a thread's draws); the two 24-bit uniforms and
# the clamp (7); logf's branch-free fast path as CUDA 12.9 compiles it (28);
# sqrt_fast (5); cos_small (20).
GEN_INSTRUCTIONS_PER_DRAW = 100
# Paper Table 1 (benchmarks/table1_ec.py, full mode): its devices in order
# (the index keys a cell) and MVMs a cell.
TABLE1_DEVICES = ("epiram", "ag-si", "alox-hfo2", "taox-hfox")
TABLE1_REPS = 100
LIFETIME_MAXITER = 30   # [11a]: CG's cap (kappa ~ 1.016: a few iterations)
AGED_TOL = 1e-2         # [11a]: the aged solve's digital residual must exceed
                        # it (benchmarks/reliability.py's AGED_TOL)
REFRESH_RATIO = 3.0     # [11a]: refresh a tile whose probe score rose over
                        # this multiple of its fresh score
FT_PDHG_TOL = 5e-3      # [11c]: ft_pdhg's digital KKT tolerance (the
                        # digital KKT of the analog iterate stalls near 1e-3:
                        # 1.07e-3 on a 4,096 x 8,192 LP, 512^2 MCAs, CPU)
LM_ARCH = "qwen3-1.7b"  # [12]: its published widths and depth, float32
LM_SEED = 0
LM_DAC_KEY = 9          # [12]: the runtime key of the served model's DAC
LM_CHECK_KEY = 11       # [12]: the key of the dense-vs-plain checks
# [12]: (batch, prompt tokens, new tokens, max_len): four 64-token prompts,
# and one 1,024-token prompt whose prefill (t * s over the flash
# threshold) takes the chunked attention.
LM_REQUESTS = ((4, 64, 32, 128), (1, 1024, 16, 1040))
LM_RT_KW = {"q_chunk": 512, "kv_chunk": 520}   # chunks that divide 1,024
                                                # and 1,040
LM_DENSE_ROWS = (1, 4, 8, 64)  # [12]: decode panels checked, beside each
                               # request's prefill panel (b * t rows)
LM_DIGITAL_TOL = 1e-4   # [12]: DAC-off logits against the digital model
LM_DECODE_FN_TOKENS = 8  # [12]: Server.decode_fn's steps after a prefill
LM_TIMING_REPS = 3
LM_PROFILE_STEPS = 8
# [13]: the attention-based families, float32, weights from LM_SEED.
MOE_ARCH = "mixtral-8x7b"
MOE_LAYERS = 8          # [13a]: of 32; 8 layers and their images are ~51 GB
MOE_REQUEST = (4, 64, 32, 128)
MOE_EXPERT_TOKENS = (4, 256)   # [13b]: moe_apply's decode / prefill inputs
WHISPER_ARCH = "whisper-tiny"
WHISPER_FRAMES = 1500   # [13c]: Whisper's 30 s window at 50 frames a second
WHISPER_REQUEST = (1, 16, 16, 32)
WHISPER_RT_KW = {"q_chunk": 500, "kv_chunk": 500}   # divide 1,500
VISION_ARCH = "llama-3.2-vision-11b"
VISION_LAYERS = 5       # [13d]: one super layer (4 self + 1 cross) of 40
VISION_REQUEST = (1, 32, 8, 48)
VISION_GATE = 1.0       # [13d]: every cross layer's gate after materialize
FAMILY_DENSE_ROWS = (1, 4, 8)  # [13]: decode panels of the dense twin check
FAMILY_PROFILE_STEPS = 4
# [14]: the recurrent families at their published widths and depth, float32,
# weights from LM_SEED.  (batch, prompt tokens, new tokens, max_len): a
# prompt over 32 tokens must be a multiple of the recurrence's 32-token
# chunk; rwkv6's second prompt is 32 chunks of the inter-chunk scan.
RWKV_ARCH = "rwkv6-1.6b"
RWKV_REQUESTS = ((4, 64, 32, 128), (1, 1024, 16, 1040))
ZAMBA_ARCH = "zamba2-1.2b"
ZAMBA_REQUEST = (4, 64, 32, 128)
RECURRENT_SCAN_TOKENS = 1024   # [14]: the chunked WKV / SSD timed alone
# [15]: training on one card.  qwen3-1.7b at its published widths and
# depth, float32, weights from LM_SEED; (batch, tokens) a step.
TRAIN_ARCH = "qwen3-1.7b"
TRAIN_BATCH = (4, 256)
TRAIN_STEPS = 10
TRAIN_TCFG = {"lr": 3e-4, "warmup_steps": 2, "total_steps": 10,
              "microbatch": 2, "remat": "block"}
TRAIN_PROFILE_STEPS = 3
TRAIN_GRAD_LAYERS = 2           # [15b] / [15c]: layers at full width
TRAIN_GRAD_TOKENS = 64          # [15b] / [15c]: 1 x 64 tokens
TRAIN_LOSS_TOL = 1e-5           # [15b]: card vs CPU, the loss, relative
TRAIN_GRAD_TOL = 1e-4           # [15b]: card vs CPU, each leaf's rel-L2
TRAIN_DENSE_ROWS = (8, 64)      # [15c]: rows of the dense gradient checks
TRAIN_RESTORE_SEED = 99
# [15a]: the peak predicted before the first run (GiB): parameters,
# gradients, m, v and the microbatch accumulators (5 x 8.13 GB), the
# stacked layers' per-layer gradients before they are stacked (5.65 GB)
# and the activations of one microbatch (~1.5 GB).
TRAIN_PEAK_PREDICTED_GIB = (44.0, 48.0)

# [16]: the serving simulator.  [16a] runs the reference benchmark's
# configurations (benchmarks/serving.py's _mixed_cfg and _skew_cfg, copied
# here: that module imports the JAX package) on the reduced models the
# simulator serves.
SERVING_MIXED_REQUESTS = 24     # the benchmark's quick run
SERVING_SKEW_REQUESTS = 36
SERVING_SKEW_CAPACITY = 1_100_000   # the hot rwkv6 image + one zamba2 image
SERVING_BATCHING = {"max_batch": 4, "prompt_buckets": (8, 16),
                    "decode_buckets": (4, 8), "batch_buckets": (1, 2, 4)}
# [16b] the image cache at qwen3-1.7b's published widths and depth, float32,
# [12]'s backend: three tenants of one weight set, room for two images.
CACHE_ARCH = "qwen3-1.7b"
CACHE_TENANTS = 3
CACHE_IMAGES = 2
CACHE_REQUESTS = 8
CACHE_TRAFFIC = {"rate_rps": 1.0, "zipf_s": 0.5, "prompt_lens": (12, 24),
                 "prompt_mix": (0.5, 0.5), "decode_lens": (4, 7),
                 "decode_mix": (0.5, 0.5), "seed": 0}
CACHE_BATCHING = {"max_batch": 4, "prompt_buckets": (16, 32),
                  "decode_buckets": (4, 8), "batch_buckets": (1, 2, 4)}
CACHE_MAX_LEN = 64
CACHE_MEM_TOL = 0.01    # of one image: the bytes an eviction frees, the end
# [17]: the reference registry's paper-scale entries
# (src/repro/analysis/pipelines.py: VIRTUAL_N, _virtual_cfg, _banded, _key).
ANALYSIS_N = 65_536
ANALYSIS_GEOM = (4, 4, 512, 512)   # capacity 2,048^2: 1,024 blocks an MVM
ANALYSIS_SEED = 2                  # the banded producer's seed
ANALYSIS_KEY = 7
# Of the registry's 100 (PDHG) and 50 (LSQR) iterations: at 4, [17] took
# 102 s on an H100 (each call runs twice, once under the dispatch mode).
ANALYSIS_MAXITER = 2
# [18]: the manifest the registry's records are held to (its cuda section).
INVARIANTS = Path(__file__).resolve().parent / "INVARIANTS_torch.json"
INVARIANTS_PEAK_BLOCKS = 12
# [19]: the roofline.  Each kernel function at PERF.md section 6's shape
# (the arguments of its kernels.cost function), called ROOFLINE_REPS times
# a counted run, and that table's device ms a launch beside it.
ROOFLINE_KERNEL_SHAPES = {
    "ec_matmul": (N, N, 1), "ec_rmatmul": (N, N, 1),
    "ec_group_matmul": (N_EXPERTS, D_FF, D_MODEL, 1),
    "ec_group_rmatmul": (N_EXPERTS, D_FF, D_MODEL, 1),
    "stencil_denoise": (N, 1), "thomas_solve": (N, 1), "cg_update": (N, 1),
    "richardson_update": (N, 1),
    "encode_matmul": (ENCODE_ROWS, D_MODEL, D_FF),
    "encode_matmul_rng": (ENCODE_ROWS, D_MODEL, D_FF)}
ROOFLINE_REPS = {"ec_matmul": 3, "ec_rmatmul": 3, "ec_group_matmul": 3,
                 "ec_group_rmatmul": 3, "stencil_denoise": 50,
                 "thomas_solve": 50, "cg_update": 50,
                 "richardson_update": 50, "encode_matmul": 3,
                 "encode_matmul_rng": 3}
ROOFLINE_SECTION6_MS = {"ec_matmul": 2.692, "ec_rmatmul": 2.677,
                        "ec_group_matmul": 1.183, "ec_group_rmatmul": 1.185,
                        "stencil_denoise": 0.00117, "thomas_solve": 0.0152,
                        "cg_update": 0.00159, "richardson_update": 0.00130,
                        "encode_matmul": 0.880, "encode_matmul_rng": 1.195}
ROOFLINE_SEED = SEED + 19
ROOFLINE_MAX_ACHIEVED = 1.05     # over it a count is wrong
# [19d]: (batch, prompt tokens, max_len) of the decode step's prefill and
# of the long prefill.
ROOFLINE_LM_REQUESTS = ((4, 64, 128), (1, 1024, 1040))
ROOFLINE_TIMEOUT_S = 300   # [19]'s own process
# [19]: the CPU's flops and bytes of the same calls at the same shapes,
# "tag what": [flops, bytes], as ``python3 lm_probe.py rehearse-roofline
# --full`` printed them on the host of an NVIDIA H100 80GB HBM3 (700.00 W)
# machine; the card's counts must equal them.
ROOFLINE_CPU_COUNTS = {
    "[19k] ec_matmul 32768x32768x1 x 3":
        [12884901888, 25770983424],
    "[19k] ec_rmatmul 32768x32768x1 x 3":
        [12884901888, 25770983424],
    "[19k] ec_group_matmul 8x14336x4096x1 x 3":
        [5637144576, 11276451840],
    "[19k] ec_group_rmatmul 8x14336x4096x1 x 3":
        [5637144576, 11277434880],
    "[19k] stencil_denoise 32768x1 x 50":
        [9830400, 13107200],
    "[19k] thomas_solve 32768x1 x 50":
        [8192000, 13108000],
    "[19k] cg_update 32768x1 x 50":
        [6553600, 39321800],
    "[19k] richardson_update 32768x1 x 50":
        [4915200, 32768200],
    "[19k] encode_matmul 256x4096x14336 x 3":
        [90194313216, 1465909248],
    "[19k] encode_matmul_rng 256x4096x14336 x 3":
        [90194313216, 761266176],
    "[19a] 32768^2 A @ x batch 1":
        [4295557126, 8593604686],
    "[19a] 32768^2 A.T @ y batch 1":
        [4295557126, 8593604686],
    "[19a] 32768^2 A @ x batch 8":
        [34364456966, 8619294798],
    "[19a] 32768^2 A.T @ y batch 8":
        [34364456966, 8619294798],
    "[19b] warm CG on the 32768^2 epiram SPD image":
        [12887523427, 25787499222],
    "[19c] resident=False 65536^2 A @ x (1024 blocks of 2048^2)":
        [77377750016, 497208416256],
    "[19d] qwen3-1.7b decode step at 4 rows":
        [27745448882, 15819504936],
    "[19d] qwen3-1.7b 1 x 1024 prefill":
        [6030665616668, 102085239420]
}


# [20]: sharded execution on a one-card mesh (every rank on the card).
SHARDED_MESHES = ((1, 1), (1, 4), (2, 4))       # (data, model)
SHARDED_MOE_INPUTS = ((1, 4), (2, 128))   # (batch, tokens): replicated, split
SHARDED_TRAIN_LAYERS = 1      # of Mixtral-8x7B's 32, at its published widths
SHARDED_TRAIN_SMALL = (2, 4)  # capacity 8 >= every path's tokens: no drop
SHARDED_TRAIN_BIG = (2, 64)
SHARDED_TRAIN_MICRO = 2       # build_cell's max(B // 16, dsz) at 2 x 4
SHARDED_TRAIN_TOL = 1e-5
SHARDED_PSUM_SHAPE = (151_936, 2_048)   # qwen3-1.7b's embedding, a rank
SHARDED_PSUM_RANKS = 8
SHARDED_PSUM_TOL = 0.02       # the reference's int8 bound
SHARDED_RING = (256, 4_096, 14_336)     # x (m, k) @ w (k, n)
SHARDED_RING_RANKS = 4
SHARDED_SEED = SEED + 20


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((got - want).double())
                 / torch.linalg.vector_norm(want.double()))


def device_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call of ``fn``: a sleep kernel holds the
    stream while the host queues all ``iters`` calls, so the CUDA events
    around them see the device's time and not the host's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def call_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of one call of ``fn`` as a caller looping on it sees it:
    host clock around back-to-back calls, host overhead included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def alternating_ms(fns, rounds: int, warmup: int = 2):
    """Device time of one call of each of ``fns``, called in turn for
    ``rounds`` rounds, each call between its own CUDA events, so that a
    change of clock falls on every form alike: (median, min, max) a form."""
    for _ in range(warmup):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    events = [[(torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True)) for _ in range(rounds)]
              for _ in fns]
    for r in range(rounds):
        for fn, ev in zip(fns, events):
            ev[r][0].record()
            fn()
            ev[r][1].record()
    torch.cuda.synchronize()
    times = [[s.elapsed_time(e) for s, e in ev] for ev in events]
    return [(statistics.median(t), min(t), max(t)) for t in times]


def clock_under_load(fn, seconds: float = 1.5):
    """Median SM clock (MHz) and power draw (W) that ``nvidia-smi`` samples
    every 50 ms while ``fn`` runs back to back for about ``seconds``, and the
    number of samples (``(None, None, 0)`` if none came while it ran)."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    samples = []
    reader = threading.Thread(target=lambda: samples.extend(
        (time.perf_counter(), line) for line in proc.stdout), daemon=True)
    reader.start()
    try:
        wait = time.perf_counter()
        while not samples and time.perf_counter() - wait < 10:
            time.sleep(0.01)
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(8):
                fn()
            torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        reader.join(timeout=10)
    under = []
    for t, line in samples:
        parts = [p.strip() for p in line.split(",")]
        if t0 + 0.1 <= t <= t1 and len(parts) == 2:
            try:
                under.append((float(parts[0]), float(parts[1])))
            except ValueError:
                continue
    if not under:
        return None, None, 0
    return (statistics.median(u[0] for u in under),
            statistics.median(u[1] for u in under), len(under))


def kernel_split(fn, iters: int = 5):
    """Mean device ms per call of each CUDA kernel (and memset) ``fn``
    launches, from ``torch.profiler``; empty if the trace has no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {}
    for evt in prof.key_averages():
        total = getattr(evt, "device_time_total", None)
        if total is None:
            total = getattr(evt, "cuda_time_total", 0)
        if total:
            split[evt.key] = total / 1e3 / iters
    return split


def short_kernel_name(key: str) -> str:
    """``void (anonymous namespace)::encode_matmul_kernel<false>(float ...)``
    -> ``encode_matmul_kernel<false>``: a profiler key without namespace,
    return type and parameters."""
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return (key.split("(")[0] or key).strip()


def layout_line(name: str, lay) -> str:
    """What the forward or transposed launcher chose
    (``kernels.matmul_layout`` / ``rmatmul_layout``)."""
    waves = lay.blocks / (lay.blocks_per_sm * lay.sms)
    kind = "staged (TMA)" if lay.staged else "register loads"
    last = (f"{lay.pieces} pieces of K" if hasattr(lay, "pieces") else
            f"<= {lay.partials_per_block} partials a block")
    return (f"    {name} layout: {kind}, {lay.blocks} blocks on "
            f"{lay.blocks_per_sm} x {lay.sms} resident slots ({waves:.3f} "
            f"waves), {lay.units} units of {lay.rows_per_unit} x "
            f"{lay.cols_per_unit}, {last}, workspace "
            f"{lay.workspace_floats} floats")


def compare(name, kernel_fn, plain_fn, tol, cost, iters,
            library_fn=None, plain_iters=None, plain_warmup=2):
    """Kernel vs plain version on the same inputs: error, times, and the
    bound of the call's declared ``cost`` (``kernels.cost``).
    ``plain_iters`` / ``plain_warmup`` time a slow plain version with fewer
    calls than the kernel."""
    from repro_torch.analysis.roofline import bound_ms
    got, want = kernel_fn(), plain_fn()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(rel_l2(g, w) for g, w in zip(got, want))
    max_abs = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"{name}: non-finite output")
    check(err <= tol, f"{name}: rel-L2 {err:.3e} against its plain version "
                      f"exceeds {tol:.0e}")
    b_ms, b_by = bound_ms(cost.flops, cost.bytes)
    row = {"rel_l2": err, "max_abs_err": max_abs,
           "ms": device_time_ms(kernel_fn, iters),
           "call_ms": call_time_ms(kernel_fn, iters),
           "plain_ms": device_time_ms(plain_fn, plain_iters or iters,
                                      plain_warmup),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": (device_time_ms(library_fn, iters)
                          if library_fn is not None else None)}
    lib = "-" if library_fn is None else f"{row['library_ms']:.4f} ms"
    print(f"  {name:34s} rel-L2 {err:.2e} max|err| {max_abs:.2e}  kernel "
          f"{row['ms']:.4f} ms (per call {row['call_ms']:.4f})  plain "
          f"{row['plain_ms']:.4f} ms  library {lib}  bound {b_ms:.4f} ms "
          f"({b_by})", flush=True)
    return row


def ritz_rel(a, y, theta) -> float:
    """Worst pair's digital relative Ritz residual ``||a y - theta y|| /
    |theta|``, with the dense matrix ``a``."""
    y = y if y.ndim == 2 else y[:, None]
    resid = torch.linalg.vector_norm(a @ y - y * theta[None, :], dim=0)
    return float(torch.max(resid / theta.abs()))


def eig_gap(got, want) -> float:
    """Worst relative difference of two eigenvalue estimates."""
    return float(torch.max((got.double() - want.double()).abs()
                           / want.double().abs()))


def timed_solves(name, solve, counts, mvm_ms, calls):
    """[4e]'s ``solve``, cold then warm: launches (added to ``counts``), wall
    ms, ms an iteration, and ms an iteration outside the MVMs, which are
    ``calls(res)``, a list of (engine calls, panel width), at the call
    times ``mvm_ms[width]``.  Returns the warm result and launches."""
    from repro_torch import kernels
    for run in ("cold", "warm"):
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        used = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
        for k, v in used.items():
            counts[k] += v
        it = max(res.iterations, 1)
        mvm_wall = sum(c * mvm_ms[w] for c, w in calls(res))
        n_calls = sum(c for c, _ in calls(res))
        ev = ", ".join(f"{float(t):.7f}" for t in res.eigenvalues)
        print(f"[4e] {name} ({run}): {res.iterations} iterations, "
              f"{n_calls} MVM calls (ledger {res.ledger.mvms} + "
              f"{res.ledger.mvms_single} batch-1), converged="
              f"{res.converged}, eigenvalues [{ev}], Ritz residual "
              f"{res.final_residual:.3e}, {wall:.1f} ms = {wall / it:.3f} "
              f"ms/iteration, {(wall - mvm_wall) / it:.3f} ms/iteration "
              f"outside the MVMs ({mvm_wall:.1f} ms of MVMs at the "
              f"measured call times); launches "
              f"{ {k: v for k, v in used.items() if v} }", flush=True)
        check(res.converged, f"{name} did not converge to {EIGEN_TOL}")
    return res, used


def nonzero(counts) -> dict:
    return {k: v for k, v in counts.items() if v}


def hook_check(tag, what, hook, call, want):
    """An engine hook's closure (``mvm_fn``, ``group_mvm_fn``,
    ``chain_fn``) against the engine call it wraps, under the same key: bit
    for bit, each launching ``want``.  Returns the hook's launches."""
    from repro_torch import kernels
    runs = []
    for fn in (call, hook):
        before = dict(kernels.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        runs.append((out, nonzero({k: v - before[k]
                                   for k, v in kernels.LAUNCHES.items()})))
    (want_out, call_counts), (got, hook_counts) = runs
    equal = torch.equal(got, want_out)
    print(f"{tag} {what}: bit for bit {equal}; launches {hook_counts} (the "
          f"call's {call_counts})", flush=True)
    check(equal and hook_counts == call_counts == want,
          f"{tag} {what}: not the call bit for bit, or launches other than "
          f"{want}")
    return hook_counts


def core_check(tag, what, core, args, res, want):
    """A solver core (``cg_pipeline`` and the others) at its public call's
    settings against that call's result ``res``: x, the history, the
    iterations and the MVMs bit for bit, and its launches ``want(k, mvms)``.
    Returns the core's outputs and launches."""
    from repro_torch import kernels
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    out = core(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    used = nonzero({k: v - before[k] for k, v in kernels.LAUNCHES.items()})
    x, (hist, k, mvms) = out[0], out[1:4] if len(out) == 5 else out[2:5]
    equal = (torch.equal(x[:, 0], res.x) and k == res.iterations
             and mvms == res.ledger.mvms
             and torch.equal(hist[:k, 0], res.residuals[:k])
             and bool(torch.isnan(hist[k:]).all()))
    print(f"{tag} {what}: {k} iterations, {mvms} MVMs in {wall * 1e3:.1f} "
          f"ms, the public call's x, history, iterations and MVMs bit for "
          f"bit {equal}; launches {used}", flush=True)
    check(equal, f"{tag} {what} differs from its public solver")
    check(used == want(k, mvms),
          f"{tag} {what}: launches {used}, expected {want(k, mvms)}")
    return out, used


def launch_floor(dev, kernels, lam, h):
    """Device ms a launch of four one-element kernels of the ``kernels``
    module, each LAUNCH_FLOOR_ITERS times back to back: the floor probe
    ``launch_floor_probe`` (one thread writes one float, a plain launch: the
    floor) and the three kernels launched with programmatic dependent
    launch, ``richardson_update``, ``stencil_denoise`` and ``cg_update``.
    A tree without the probe gives None for it."""
    one = torch.ones(1, 1, device=dev)
    alpha, omega = torch.ones(1, device=dev), torch.ones((), device=dev)
    probe = getattr(kernels, "launch_floor_probe", None)
    out = torch.empty(1, device=dev)
    ms = {"launch_floor_probe": None if probe is None else device_time_ms(
              lambda: probe(out), LAUNCH_FLOOR_ITERS),
          "richardson_update": device_time_ms(
              lambda: kernels.richardson_update(one, one, one, omega),
              LAUNCH_FLOOR_ITERS),
          "stencil_denoise": device_time_ms(
              lambda: kernels.stencil_denoise(one, lam, h),
              LAUNCH_FLOOR_ITERS),
          "cg_update": device_time_ms(
              lambda: kernels.cg_update(one, one, one, one, alpha),
              LAUNCH_FLOOR_ITERS)}
    floor = ("not in this tree" if probe is None else
             f"{ms['launch_floor_probe'] * 1e3:.3f} us a launch")
    print(f"[2] launch floor: {floor} (launch_floor_probe, one thread "
          f"writing one float, a plain launch, {LAUNCH_FLOOR_ITERS} back to "
          f"back, CUDA events); 1 x 1 with PDL: richardson_update "
          f"{ms['richardson_update'] * 1e3:.3f} us, stencil_denoise "
          f"{ms['stencil_denoise'] * 1e3:.3f} us, cg_update "
          f"{ms['cg_update'] * 1e3:.3f} us", flush=True)
    return ms


def tier2_phase(dev, kernels, lam, h):
    """[2] ``stencil_denoise``, ``cg_update`` and ``richardson_update`` of
    the ``kernels`` module at the main path's shapes, each against its plain
    version (rel-L2 <= ELEMENTWISE_TOL, bit for bit run to run, one launch a
    call; ``richardson_update``'s omega a device tensor, as the solver's
    is): the stencil held at STENCIL_CHECK_LAM and timed there and at the
    engine's ``lam``;
    each beside its byte bound (each panel read once, each output written
    once) and its share of it; and the stencil's TIER2_PREFILL_PANELS
    launched as a prefill launches them.  Returns ``{name: row}`` entries
    for the kernel table's shapes."""
    from repro_torch.analysis.roofline import bound_ms
    gen = torch.Generator(device=dev).manual_seed(TIER2_SEED)
    rows = []

    def launches(fn, name):
        kernels.reset_launches()
        out = fn()
        check(kernels.LAUNCHES[name] == 1, f"{name}: not one launch a call")
        return out

    def share(row):
        return (f"{row['bound_ms'] / row['ms']:.1%} of the bound"
                if row.get("ms") else "share not measured")

    print(f"[2] tier-2 and CG-update panels (lam {lam:g} and "
          f"{STENCIL_CHECK_LAM:g})", flush=True)
    for n, batch in TIER2_STENCIL_SHAPES:
        p = torch.randn(n, batch, generator=gen, device=dev)
        iters = 500 if n * batch <= 1 << 20 else 50
        got = launches(lambda: kernels.stencil_denoise(p, lam, h),
                       "stencil_denoise")
        err = rel_l2(got, kernels.stencil_denoise_plain(p, lam, h))
        check(err <= ELEMENTWISE_TOL and torch.equal(
                  got, kernels.stencil_denoise(p, lam, h)),
              f"stencil_denoise {n}x{batch} lam {lam:g}: rel-L2 {err:.3e}, "
              f"or not the same run to run")
        row = compare(f"stencil_denoise {n}x{batch} lam "
                      f"{STENCIL_CHECK_LAM:g}",
                      lambda: kernels.stencil_denoise(p, STENCIL_CHECK_LAM,
                                                      h),
                      lambda: kernels.stencil_denoise_plain(
                          p, STENCIL_CHECK_LAM, h),
                      ELEMENTWISE_TOL,
                      cost=kernels.cost.stencil_denoise(n, batch),
                      iters=iters)
        check(torch.equal(kernels.stencil_denoise(p, STENCIL_CHECK_LAM, h),
                          kernels.stencil_denoise(p, STENCIL_CHECK_LAM, h)),
              f"stencil_denoise {n}x{batch} is not the same run to run")
        row.update(shape=f"{n}x{batch}", batch=batch,
                   err_lam=STENCIL_CHECK_LAM, ms_lam=STENCIL_CHECK_LAM,
                   lam_ms={f"{lam:g}": device_time_ms(
                       lambda: kernels.stencil_denoise(p, lam, h), iters)})
        print(f"    stencil_denoise {n}x{batch}: {share(row)}; at lam "
              f"{lam:g} {row['lam_ms'][f'{lam:g}']:.5f} ms", flush=True)
        rows.append({"stencil_denoise": row})
        del p, got
    for n, batch in TIER2_CG_SHAPES:
        v = [torch.randn(n, batch, generator=gen, device=dev)
             for _ in range(4)]
        alpha = torch.rand(batch, generator=gen, device=dev)
        launches(lambda: kernels.cg_update(*v, alpha), "cg_update")
        row = compare(f"cg_update {n}x{batch}",
                      lambda: kernels.cg_update(*v, alpha),
                      lambda: kernels.cg_update_plain(*v, alpha),
                      ELEMENTWISE_TOL, cost=kernels.cost.cg_update(n, batch),
                      iters=500)
        check(all(torch.equal(a, b) for a, b in zip(
                  kernels.cg_update(*v, alpha), kernels.cg_update(*v, alpha))),
              f"cg_update {n}x{batch} is not the same run to run")
        row.update(shape=f"{n}x{batch}", batch=batch)
        print(f"    cg_update {n}x{batch}: {share(row)}", flush=True)
        rows.append({"cg_update": row})
        del v
    rich = torch.Generator(device=dev).manual_seed(TIER2_SEED + 1)
    for n, batch in TIER2_CG_SHAPES:
        v = [torch.randn(n, batch, generator=rich, device=dev)
             for _ in range(3)]
        omega = torch.rand((), generator=rich, device=dev)
        launches(lambda: kernels.richardson_update(*v, omega),
                 "richardson_update")
        row = compare(f"richardson_update {n}x{batch}",
                      lambda: kernels.richardson_update(*v, omega),
                      lambda: kernels.richardson_update_plain(*v, omega),
                      ELEMENTWISE_TOL,
                      cost=kernels.cost.richardson_update(n, batch),
                      iters=500)
        check(all(torch.equal(a, b) for a, b in zip(
                  kernels.richardson_update(*v, omega),
                  kernels.richardson_update(*v, omega))),
              f"richardson_update {n}x{batch} is not the same run to run")
        row.update(shape=f"{n}x{batch}", batch=batch)
        print(f"    richardson_update {n}x{batch}: {share(row)}", flush=True)
        rows.append({"richardson_update": row})
        del v
    panels = [(torch.randn(d_out, n, generator=gen, device=dev), count)
              for d_out, n, count in TIER2_PREFILL_PANELS]

    def prefill():
        for p, count in panels:
            for _ in range(count):
                kernels.stencil_denoise(p, lam, h)

    count = sum(c for _, c in panels)
    kernels.reset_launches()
    prefill()
    check(kernels.LAUNCHES["stencil_denoise"] == count,
          f"stencil_denoise: not {count} launches for the prefill's panels")
    row = {"shape": f"qwen3-1.7b 1x1024 prefill's {count} panels",
           "launches": count, "ms": device_time_ms(prefill, 5),
           "bound_ms": bound_ms(0, sum(
               kernels.cost.stencil_denoise(*p.shape).bytes * c
               for p, c in panels))[0],
           "bound_by": "bytes"}
    print(f"    stencil_denoise over a qwen3-1.7b 1 x 1,024 prefill's "
          f"{count} panels, back to back: {row['ms']:.4f} ms, "
          f"{share(row)} {row['bound_ms']:.4f} ms", flush=True)
    rows.append({"stencil_denoise": row})
    return rows


def ec_stencil_pair_ms(kernels, at, da, x, x_t, lam, h):
    """Device ms of the pair a corrected MVM launches: the EC product of the
    ``kernels`` module, then tier-2 on its output (the stencil's launch may
    overlap the product's tail)."""
    return device_time_ms(lambda: kernels.stencil_denoise(
        kernels.ec_matmul(at, da, x, x_t), lam, h), 10)


def cg_step(solvers, A, b):
    """A CG step's device time with the ``solvers`` module on the image
    ``A``: a warm solve under the profiler, its kernels' device ms over its
    MVMs (the iterations and the entry residual's).  Returns the MVMs, ms a
    step and the ms of ``stencil_denoise`` + ``cg_update`` in it."""
    def solve():
        return solvers.cg(A, b, tol=SOLVE_TOL, maxiter=50, backend="cuda")

    mvms = solve().iterations + 1
    split = kernel_split(solve, iters=1)
    return (mvms, sum(split.values()) / mvms,
            sum(v for k_, v in split.items()
                if "stencil_" in k_ or "cg_update" in k_) / mvms)


def richardson_step(solvers, A, b):
    """A Richardson step's device time with the ``solvers`` module on the
    image ``A``: a warm solve at the omega its auto mode takes
    (``estimate_omega``, found once before), under the profiler, its
    kernels' device ms over its MVMs (one an iteration).  Returns the MVMs,
    ms a step and the ms of ``stencil_denoise`` + ``richardson_update`` in
    it."""
    omega = solvers.estimate_omega(A)

    def solve():
        return solvers.richardson(A, b, omega=omega, tol=SOLVE_TOL,
                                  maxiter=50, backend="cuda")

    mvms = solve().iterations
    split = kernel_split(solve, iters=1)
    return (mvms, sum(split.values()) / mvms,
            sum(v for k_, v in split.items()
                if "stencil_" in k_ or "richardson_update" in k_) / mvms)


def eigen_phase(dev, A, a, b, x_true, noise_floor):
    """[4e] the eigen solvers on phase [4]'s SPD image ``A`` (dense ``a``):
    Lanczos, LOBPCG (k = 2, largest and smallest), the Lanczos
    ``spectral_bounds`` / ``estimate_omega`` and Richardson at that omega.
    Each converged solve's pairs pass the registry's digital Ritz-residual
    honesty bound; its eigenvalues are within 2 x the one-MVM noise floor
    of the same solver on the digital operator (``torch.matmul``) with the
    same key, start and number of steps, and are printed beside the
    digital solve to tol 1e-6; Lanczos launches ``ec_matmul`` and the
    stencil once per MVM (8 seed steps + one a step), LOBPCG once at entry
    and once per 6-column iteration.  Returns the launches of the main
    runs."""
    from repro_torch import kernels, solvers
    counts = dict.fromkeys(kernels.LAUNCHES, 0)
    n = a.shape[0]
    # A generator of its own: the later phases' draws stay as they were.
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    panels = {w: torch.randn(n, w, generator=gen, device=dev)
              for w in (1, LOBPCG_K, 3 * LOBPCG_K)}
    mvm_ms = {w: call_time_ms(lambda p=p: A @ p, 10)
              for w, p in panels.items()}
    print("[4e] one corrected MVM a call: " + ", ".join(
        f"batch {w} {ms:.3f} ms" for w, ms in mvm_ms.items()), flush=True)

    def hold(name, res, used, launches, same, fine, kind):
        """``res`` against the dense matrix: its pairs' Ritz residuals, its
        eigenvalues against ``same`` (the digital run with its key, start
        and steps) and ``fine`` (the digital run to tol 1e-6)."""
        rec = ritz_rel(a, res.x, res.eigenvalues)
        gap = eig_gap(res.eigenvalues, same.eigenvalues)
        gap_fine = eig_gap(res.eigenvalues, fine.eigenvalues)
        fine_ev = ", ".join(f"{float(t):.7f}" for t in fine.eigenvalues)
        print(f"    {name}: digital Ritz residual {rec:.3e} (recorded "
              f"{res.final_residual:.3e}, bound max({RITZ_SLACK:g} x "
              f"recorded, {RITZ_FLOOR[kind]:g})); eigenvalues against the "
              f"digital operator, same key and {res.iterations} steps: "
              f"{gap:.3e} (bound 2 x noise floor {2 * noise_floor:.3e}); "
              f"against the digital solve to tol {EIGEN_DIGITAL_TOL:g} "
              f"({fine.iterations} iterations, converged={fine.converged}, "
              f"eigenvalues [{fine_ev}]): "
              f"{gap_fine:.3e}", flush=True)
        check(rec <= max(RITZ_SLACK * res.final_residual, RITZ_FLOOR[kind]),
              f"{name}: digital Ritz residual {rec:.3e} against recorded "
              f"{res.final_residual:.3e}")
        check(gap <= 2 * noise_floor,
              f"{name}: eigenvalues {gap:.3e} from the digital operator's, "
              f"over 2 x the noise floor {noise_floor:.3e}")
        check(used["ec_matmul"] == launches and
              used["stencil_denoise"] == launches,
              f"{name}: expected {launches} ec_matmul and stencil_denoise "
              f"launches, got {used}")

    res, used = timed_solves(
        "lanczos", lambda: solvers.lanczos(A, tol=EIGEN_TOL), counts,
        mvm_ms, lambda r: [(r.ledger.mvms_single, 1)])
    hold("lanczos", res, used, 8 + res.iterations,
         solvers.lanczos(a, tol=0.0, maxiter=res.iterations),
         solvers.lanczos(a, tol=EIGEN_DIGITAL_TOL), "lanczos")
    for which in ("largest", "smallest"):
        res, used = timed_solves(
            f"lobpcg k={LOBPCG_K} {which}",
            lambda: solvers.lobpcg(A, LOBPCG_K, which=which, tol=EIGEN_TOL,
                                   maxiter=100), counts, mvm_ms,
            lambda r: [(1, LOBPCG_K), (r.iterations, 3 * LOBPCG_K)])
        hold(f"lobpcg {which}", res, used, 1 + res.iterations,
             solvers.lobpcg(a, LOBPCG_K, which=which, tol=0.0,
                            maxiter=res.iterations),
             solvers.lobpcg(a, LOBPCG_K, which=which,
                            tol=EIGEN_DIGITAL_TOL, maxiter=100), "lobpcg")

    # Step sizing from a Lanczos sweep, then Richardson at that omega.
    before = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lmin, lmax = solvers.spectral_bounds(A, method="lanczos")
    omega = solvers.estimate_omega(A, method="lanczos")
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    used = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
    sweep = solvers.lanczos(a, tol=0.0, maxiter=16)
    gap = eig_gap(torch.tensor([lmin, lmax]), sweep.eigenvalues.cpu())
    print(f"[4e] spectral_bounds(method='lanczos') [{lmin:.7f}, {lmax:.7f}] "
          f"(digital, same sweep: {gap:.3e} apart), estimate_omega "
          f"{omega:.7f}, both in {wall:.1f} ms; launches "
          f"{ {k: v for k, v in used.items() if v} }", flush=True)
    check(used["ec_matmul"] == 2 * (8 + 16) and
          used["stencil_denoise"] == 2 * (8 + 16),
          f"the two Lanczos sweeps did not launch 2 x 24 MVMs: {used}")
    check(gap <= 2 * noise_floor, "Lanczos bounds off the digital sweep's")
    check(abs(omega - 2.0 / (1.05 * lmax + max(lmin, 0.0))) <= 1e-6 * omega,
          "estimate_omega is not the formula on spectral_bounds")
    for k_, v_ in used.items():
        counts[k_] += v_
    before = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solvers.richardson(A, b, omega=omega, tol=SOLVE_TOL, maxiter=50,
                             backend="cuda")
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    used = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
    for k_, v_ in used.items():
        counts[k_] += v_
    err = rel_l2(res.x, x_true)
    print(f"[4e] richardson at the Lanczos omega: {res.iterations} "
          f"iterations, converged={res.converged}, x err {err:.3e}, "
          f"{wall:.1f} ms; launches "
          f"{ {k: v for k, v in used.items() if v} }", flush=True)
    check(res.converged and err <= SOLVE_TOL,
          f"richardson at the Lanczos omega: x err {err:.3e}")
    check(used["richardson_update"] == res.iterations and
          used["ec_matmul"] == res.iterations,
          f"richardson did not launch richardson_update and ec_matmul once "
          f"an iteration: {used}")
    return counts


def operator_norm_phase(dev, A, a, b, x_true):
    """[5e] ``operator_norm`` on phase [5]'s least-squares image ``A``
    (dense ``a``, m x n Gaussian / sqrt(m): ||A||_2 near 1 + sqrt(n/m)):
    its value within 2 x this image's one-MVM noise floor of the same
    function on the digital operator with the same key and steps (printed
    beside the digital run to tol 1e-6), one ec_matmul and one ec_rmatmul
    launch per Lanczos step, seed steps included, and the top Ritz pair of
    ``[[0, A], [A', 0]]`` honest against the dense matrix.  The spectrum's
    soft edge keeps the Ritz residual above tol 1e-3 within the default 32
    steps (about 6.5e-3 at 2,048 x 1,024 on the CPU), so the sweep is not
    required to converge: operator_norm returns the estimate either way.
    Returns the launches of the main runs."""
    from repro_torch import kernels, solvers
    from repro_torch.solvers.eigen import _augmented
    counts = dict.fromkeys(kernels.LAUNCHES, 0)
    m, n = a.shape
    noise_floor = rel_l2(A @ x_true, b)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    u = torch.randn(n, generator=gen, device=dev)
    v = torch.randn(m, generator=gen, device=dev)
    fwd_ms = call_time_ms(lambda: A @ u, 10)
    t_ms = call_time_ms(lambda: A.T @ v, 10)
    mp_edge = 1 + (n / m) ** 0.5
    print(f"[5e] {m}x{n} image: one-MVM noise floor {noise_floor:.3e}; "
          f"a call A @ u {fwd_ms:.3f} ms, A.T @ v {t_ms:.3f} ms; "
          f"Marchenko-Pastur edge 1 + sqrt(n/m) = {mp_edge:.4f}", flush=True)
    for run in ("cold", "warm"):
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sigma = solvers.operator_norm(A, tol=EIGEN_TOL)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        used = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
        for k_, v_ in used.items():
            counts[k_] += v_
        # The same sweep, for its steps and its top Ritz pair.
        sweep = solvers.lanczos(_augmented(solvers.as_operator(A)),
                                tol=EIGEN_TOL, maxiter=32)
        steps = sweep.iterations
        mvm_wall = sweep.ledger.mvms_single * (fwd_ms + t_ms)
        print(f"[5e] operator_norm ({run}): {sigma:.7f} in {steps} Lanczos "
              f"steps + 8 seed steps, converged={sweep.converged}, Ritz "
              f"residual {sweep.final_residual:.3e}, {wall:.1f} ms = "
              f"{wall / steps:.3f} ms/step, {(wall - mvm_wall) / steps:.3f} "
              f"ms/step outside the MVMs ({mvm_wall:.1f} ms of MVMs); "
              f"launches { {k: v for k, v in used.items() if v} }",
              flush=True)
        check(abs(float(sweep.eigenvalues[1]) - sigma) <= 1e-6 * sigma,
              "operator_norm is not its Lanczos sweep")
        check(used["ec_matmul"] == 8 + steps and
              used["ec_rmatmul"] == 8 + steps and
              used["stencil_denoise"] == 2 * (8 + steps),
              f"operator_norm: expected {8 + steps} ec_matmul and "
              f"ec_rmatmul launches, got {used}")
    y = sweep.x[:, 1]
    h_y = torch.cat([a @ y[m:], a.T @ y[:m]])
    rec = float(torch.linalg.vector_norm(h_y - sweep.eigenvalues[1] * y)
                / sweep.eigenvalues[1].abs())
    same = solvers.operator_norm(a, tol=0.0, maxiter=steps)
    fine = solvers.operator_norm(a, tol=EIGEN_DIGITAL_TOL)
    gap, gap_fine = abs(sigma - same) / same, abs(sigma - fine) / fine
    print(f"    operator_norm: digital Ritz residual {rec:.3e} (recorded "
          f"{sweep.final_residual:.3e}); digital operator, same key and "
          f"{steps} steps: {same:.7f}, {gap:.3e} apart (bound 2 x noise "
          f"floor {2 * noise_floor:.3e}); digital to tol "
          f"{EIGEN_DIGITAL_TOL:g}: {fine:.7f}, {gap_fine:.3e} apart",
          flush=True)
    check(rec <= max(RITZ_SLACK * sweep.final_residual,
                     RITZ_FLOOR["lanczos"]),
          f"operator_norm: digital Ritz residual {rec:.3e}")
    check(gap <= 2 * noise_floor,
          f"operator_norm {sigma:.7f} off the digital {same:.7f} by "
          f"{gap:.3e}, over 2 x the noise floor")
    return counts


def admm_phase(dev, A, a):
    """[5q] linearized ADMM on phase [5]'s least-squares image ``A`` (dense
    ``a``, m x n), with no second program: a box QP with a known optimum
    built on ``a`` by ``random_box_qp``'s construction (``_box_qp_on``: x*
    uniform in [-0.9, 0.9] but ~30 % of it on a bound of [-1, 1], KKT
    multipliers ``|N(0, 1)|`` signed by the bound, a Gaussian b and ``q = g
    - a'(a x* - b)``), drawn from a generator of its own.  ``admm`` runs
    cold and warm to KKT <= tol, then on the digital operator with the same
    key and power steps.  Checks: converged and finite; ``res.dual`` in the
    box; the objective within 1e-3 of the digital run's; the digital KKT of
    the returned (x, z) within the registry's qp slack / floor of the
    recorded one; x within ``ADMM_X_TOL`` of the digital run's and of x*;
    one ``ec_matmul`` launch per billed forward MVM and one ``ec_rmatmul``
    per billed transposed one.  Returns the launches of the main runs."""
    from repro_torch import kernels, solvers
    from repro_torch.solvers.admm import _box_qp_on
    counts = dict.fromkeys(kernels.LAUNCHES, 0)
    m, n = a.shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    b, q, lo, hi, x_star = (t.squeeze(-1) for t in _box_qp_on(
        a, gen, 1, ADMM_ACTIVE_FRAC))
    qp = {s.name: s for s in solvers.registry()}["admm"]

    def objective(x):
        r = (a @ x - b).double()
        return float(0.5 * torch.dot(r, r) + torch.dot(q.double(),
                                                      x.double()))

    def kkt(x, z):
        grad = a.T @ (a @ x - b) + q
        stat = torch.linalg.vector_norm(x - torch.clamp(x - grad, lo, hi))
        return float((stat + torch.linalg.vector_norm(x - z))
                     / (1.0 + torch.linalg.vector_norm(x)))

    u = torch.randn(n, generator=gen, device=dev)
    v = torch.randn(m, generator=gen, device=dev)
    fwd_ms = call_time_ms(lambda: A @ u, 10)
    t_ms = call_time_ms(lambda: A.T @ v, 10)
    print(f"[5q] {m}x{n} image, box [-1, 1]: x* on a bound "
          f"{float((x_star.abs() == 1).float().mean()):.4f}, its digital KKT "
          f"{kkt(x_star, x_star):.3e}; a call A @ u {fwd_ms:.3f} ms, A.T @ v "
          f"{t_ms:.3f} ms", flush=True)
    for run in ("cold", "warm"):
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solvers.admm(A, b, q, lo=-1.0, hi=1.0, tol=SOLVE_TOL,
                           maxiter=ADMM_MAXITER)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        used = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
        for k_, v_ in used.items():
            counts[k_] += v_
        led = res.ledger
        fwd, tr = led.mvms + led.mvms_single, led.mvms_t + led.mvms_single_t
        it = max(res.iterations, 1)
        mvm_wall = fwd * fwd_ms + tr * t_ms
        print(f"[5q] admm ({run}): {res.iterations} iterations, {led.mvms} "
              f"+ {led.mvms_t} transposed MVMs (+ {led.mvms_single} + "
              f"{led.mvms_single_t} power-iteration), KKT "
              f"{res.final_residual:.3e}, converged={res.converged}, "
              f"{wall:.1f} ms = {wall / it:.3f} ms/iteration, "
              f"{(wall - mvm_wall) / it:.3f} ms/iteration outside the two "
              f"MVM calls ({mvm_wall:.1f} ms of MVMs at the measured call "
              f"times); launches { {k: v for k, v in used.items() if v} }",
              flush=True)
        check(res.converged and bool(torch.isfinite(res.x).all()),
              f"admm did not reach KKT <= {SOLVE_TOL} in {ADMM_MAXITER} "
              f"iterations")
        check(float(res.dual.min()) >= -1.0 and float(res.dual.max()) <= 1.0,
              "admm: the split copy left the box")
        check(used["ec_matmul"] == fwd and used["ec_rmatmul"] == tr and
              used["stencil_denoise"] == fwd + tr,
              f"admm: expected {fwd} ec_matmul and {tr} ec_rmatmul "
              f"launches, one stencil each, got {used}")
    digital = solvers.admm(a, b, q, lo=-1.0, hi=1.0, tol=SOLVE_TOL,
                           maxiter=ADMM_MAXITER)
    obj, obj_d, obj_star = objective(res.x), objective(digital.x), \
        objective(x_star)
    gap = abs(obj - obj_d) / (1.0 + abs(obj_d))
    recomputed = kkt(res.x, res.dual)
    off_digital, off_star = rel_l2(res.x, digital.x), rel_l2(res.x, x_star)
    print(f"    admm: objective {obj:.7f}, digital operator (same key and "
          f"power steps, {digital.iterations} iterations, converged="
          f"{digital.converged}) {obj_d:.7f}, gap {gap:.3e} (bound 1e-3); "
          f"f(x*) {obj_star:.7f}; rel-L2(x, x*) {off_star:.3e}, digital "
          f"{rel_l2(digital.x, x_star):.3e}, rel-L2(x, digital x) "
          f"{off_digital:.3e} (bound {ADMM_X_TOL}); digital KKT of the "
          f"analog (x, z) {recomputed:.3e} (bound "
          f"{max(qp.slack * res.final_residual, qp.floor):.3e})", flush=True)
    check(digital.converged, "admm on the digital operator did not converge")
    check(gap <= 1e-3, f"admm: objective gap {gap:.3e} to the digital run")
    check(recomputed <= max(qp.slack * res.final_residual, qp.floor),
          f"admm: digital KKT {recomputed:.3e} of the returned (x, z) "
          f"against the recorded {res.final_residual:.3e}")
    check(off_digital <= ADMM_X_TOL and off_star <= ADMM_X_TOL,
          f"admm: x off the digital run's by {off_digital:.3e} and off x* "
          f"by {off_star:.3e}, over {ADMM_X_TOL}")
    return counts


def registry_phase(dev):
    """[4r] every solver of the port's registry on the card: its seed-0
    problem at n = 12 (batch 1) programmed on a ``cuda`` local engine
    (epiram, EC on, one 32^2 MCA), run under the reference contract suite's
    budgets.  Checks: the ledger's total energy is the write plus the four
    (count x rate) terms; every billed MVM is one EC launch in its direction
    (LOBPCG: one launch for each 3k-column panel, billed as three) with one
    tier-2 launch; on the dense problem on the card, the recorded residual
    within the spec's slack / floor of the digital recompute, both ways
    unless the history is lagged, and ``converged`` iff it is <= tol.
    Returns the launches of the analog runs."""
    from repro_torch import kernels, solvers
    from repro_torch.engine import AnalogEngine
    from repro_torch.solvers.registry import RUN, contract_config
    counts = dict.fromkeys(kernels.LAUNCHES, 0)
    for spec in solvers.registry():
        p = spec.make_problem(0, REGISTRY_N, 1, device=dev)
        A = AnalogEngine(contract_config(p["a"].shape[0]), backend="cuda",
                         device=dev).program(p["a"], 0)
        run = RUN[spec.family]
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = spec.solve(A, p, key=0, **run)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        used = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
        for k_, v_ in used.items():
            counts[k_] += v_
        led = res.ledger
        billed = led.write_energy_j + sum(
            float(rate.energy_j) * c for rate, c in (
                (led.input_stats, led.mvms),
                (led.input_stats_single, led.mvms_single),
                (led.input_stats_t, led.mvms_t),
                (led.input_stats_single_t, led.mvms_single_t)))
        fwd = 1 + res.iterations if spec.name == "lobpcg" else \
            led.mvms + led.mvms_single
        tr = led.mvms_t + led.mvms_single_t
        calls = fwd + tr
        digital = spec.solve(p["a"], p, key=0, **run)
        recorded = float(digital.final_residual)
        rec = spec.recompute(p, digital)
        print(f"[4r] {spec.name:10s} {res.iterations:5d} iterations, MVMs "
              f"{led.mvms} + {led.mvms_single} single, {led.mvms_t} + "
              f"{led.mvms_single_t} transposed, converged={res.converged}, "
              f"residual {res.final_residual:.3e}, {wall:.1f} ms "
              f"({wall / max(calls, 1):.3f} ms an MVM call); launches "
              f"{ {k: v for k, v in used.items() if v} }; digital "
              f"{digital.iterations} iterations, recorded {recorded:.3e}, "
              f"recomputed {rec:.3e}", flush=True)
        check(led.write_energy_j > 0 and
              abs(led.total_energy_j - billed) <= 1e-12 * billed,
              f"{spec.name}: total energy {led.total_energy_j!r} is not the "
              f"write plus the billed MVMs {billed!r}")
        check(used["ec_matmul"] == fwd and used["ec_rmatmul"] == tr and
              used["stencil_denoise"] == calls,
              f"{spec.name}: expected {fwd} ec_matmul and {tr} ec_rmatmul "
              f"launches, one stencil each, got {used}")
        check(not spec.needs_rmatvec or tr >= 1,
              f"{spec.name}: no transposed MVM billed")
        check(rec <= max(spec.slack * recorded, spec.floor) and
              (spec.lagged_history or
               recorded <= max(spec.slack * rec, spec.floor)),
              f"{spec.name}: recorded {recorded:.3e} against the digital "
              f"recompute {rec:.3e}")
        check(digital.converged == (recorded <= run["tol"]),
              f"{spec.name}: converged={digital.converged} at {recorded:.3e}")
        check(digital.ledger.total_energy_j == 0.0,
              f"{spec.name}: the digital operator billed energy")
    return counts


def streamed_phase(dev, gen, cfg, engine, more_shapes, n, n_dub, dub_geom):
    """Phase 9, streamed execution: a ``block_fn(i, j)`` producer programs
    the image, which is kept as one contiguous block stack, and every
    execute derives ``dA = block_fn(i, j) - A_tilde[i, j]`` again per block
    (one ec_matmul / ec_rmatmul launch a capacity block on the cuda backend,
    one tier-2 launch a call).  [9a] the n^2 matrix of phase 2 (``cfg``,
    ``engine``, key 1) through a slicing producer, against the local image;
    [9b] the paper's dubcova2 (``n_dub``^2, ``dub_geom``) from the implicit
    banded producer: MVMs, peak memory, the one-shot form; [9c] CG on it.
    Appends the EC kernels' rows at both block shapes to ``more_shapes``;
    returns the launches of the phase's main runs."""
    from repro_torch.analysis.roofline import HW
    from repro_torch import kernels, solvers
    from repro_torch.core import (CrossbarConfig, ImplicitBandedMatrix,
                                  get_device, streamed_corrected_mvm)
    from repro_torch.core import crossbar
    from repro_torch.core.prng import fold_in, generator
    from repro_torch.engine import AnalogEngine, AnalogMatrix
    gib = 2.0 ** 30
    # A block_fn(i, j) producer programs the image, which is kept as one
    # contiguous block stack; every execute derives dA = block_fn(i, j) -
    # A_tilde[i, j] again per block: one ec_matmul / ec_rmatmul launch per
    # capacity block on the cuda backend, one tier-2 launch per call.
    streamed_counts = dict.fromkeys(kernels.LAUNCHES, 0)

    def tally(counts):
        for k_, v_ in counts.items():
            streamed_counts[k_] += v_

    def streamed_view(S, c, be):
        """A streamed handle's image under another engine (no copy)."""
        return AnalogMatrix(
            engine=AnalogEngine(c, execution="streamed", backend=be,
                                device=dev),
            shape=S.shape, base_key=S.base_key, write_stats=S.write_stats,
            at_stack=S.at_stack, block_fn=S.block_fn)

    def block_rows(tag, c, at_blk, da_blk, seed):
        """ec_matmul / ec_rmatmul at batch 1 on one capacity block of a
        streamed image and its derived dA (row stride cap_n, as the engine
        passes them), against their plain versions and cuBLAS."""
        cm, cn = at_blk.shape
        u = torch.randn(cn, 1, generator=gen, device=dev)
        u_t = crossbar._encode_vec(u, c, gen=generator(seed, dev))
        v = torch.randn(cm, 1, generator=gen, device=dev)
        v_t = crossbar._encode_vec(v, c, gen=generator(seed + 1, dev))
        res = {
            "ec_matmul": compare(
                f"ec_matmul {cm}x{cn} block ({tag}) batch 1",
                lambda: kernels.ec_matmul(at_blk, da_blk, u, u_t),
                lambda: kernels.ec_matmul_plain(at_blk, da_blk, u, u_t),
                EC_TOL, cost=kernels.cost.ec_matmul(cm, cn, 1), iters=20,
                library_fn=lambda: torch.matmul(at_blk, u)
                + torch.matmul(da_blk, u_t)),
            "ec_rmatmul": compare(
                f"ec_rmatmul {cm}x{cn} block ({tag}) batch 1",
                lambda: kernels.ec_rmatmul(at_blk, da_blk, v, v_t),
                lambda: kernels.ec_rmatmul_plain(at_blk, da_blk, v, v_t),
                EC_TOL, cost=kernels.cost.ec_rmatmul(cm, cn, 1), iters=20,
                library_fn=lambda: torch.matmul(at_blk.T, v)
                + torch.matmul(da_blk.T, v_t))}
        for name, row in res.items():
            row.update(shape=f"{cm}x{cn} streamed block ({tag})", batch=1,
                       layout=(kernels.rmatmul_layout if name == "ec_rmatmul"
                               else kernels.matmul_layout)(
                                   at_blk, da_blk, 1)._asdict())
        return res

    # 9a. Streamed equals local at n^2: phase [2]'s matrix (the first draw
    # of a generator seeded SEED) and key, sliced into 4,096^2 blocks.
    cap = cfg.geom.capacity[0]
    a = torch.randn(n, n, generator=torch.Generator(device=dev)
                    .manual_seed(SEED), device=dev)

    def slicer(src, c_m, c_n):
        def block_fn(i, j):
            blk = src[i * c_m:(i + 1) * c_m, j * c_n:(j + 1) * c_n]
            if tuple(blk.shape) != (c_m, c_n):   # the zero-padded edge
                blk = torch.nn.functional.pad(
                    blk, (0, c_n - blk.shape[1], 0, c_m - blk.shape[0]))
            return blk
        return block_fn

    producer = slicer(a, cap, cap)
    A = engine.program(a, 1)
    t0 = time.perf_counter()
    S = AnalogEngine(cfg, execution="streamed", backend="cuda",
                     device=dev).program(producer, 1, shape=(n, n))
    torch.cuda.synchronize()
    prog_s = time.perf_counter() - t0
    same_image = torch.equal(S.at_blocks, A.at_blocks)
    grid9a = S.at_stack.shape[:2]
    print(f"[9a] streamed program of {n}^2 from a slicing producer "
          f"({grid9a[0]} x {grid9a[1]} blocks of {cap}^2) in {prog_s:.2f} "
          f"s; image {S.image_nbytes / gib:.0f} GiB (local: "
          f"{A.image_nbytes / gib:.0f}); equal to the local image bit for "
          f"bit: {same_image}", flush=True)
    check(same_image, "the streamed image differs from the local one")
    del A
    torch.cuda.empty_cache()
    n_blocks = grid9a[0] * grid9a[1]
    x1 = torch.randn(n, 1, generator=gen, device=dev)
    y1 = torch.randn(n, 1, generator=gen, device=dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    fwd = S @ x1
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    fwd_counts = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    t0 = time.perf_counter()
    bwd = S.T @ y1
    torch.cuda.synchronize()
    bwd_ms = (time.perf_counter() - t0) * 1e3
    bwd_counts = dict(kernels.LAUNCHES)
    tally(fwd_counts)
    tally(bwd_counts)
    print(f"[9a] streamed A @ x: {fwd_ms:.1f} ms, rel-L2 vs digital "
          f"{rel_l2(fwd, torch.matmul(a, x1)):.4e}, launches {fwd_counts}; "
          f"A.T @ y: {bwd_ms:.1f} ms, rel-L2 "
          f"{rel_l2(bwd, torch.matmul(a.T, y1)):.4e}, launches "
          f"{bwd_counts}", flush=True)
    check(fwd_counts["ec_matmul"] == n_blocks
          and fwd_counts["stencil_denoise"] == 1
          and bwd_counts["ec_rmatmul"] == n_blocks
          and bwd_counts["stencil_denoise"] == 1,
          f"not one EC launch per block ({n_blocks}) and one tier-2 launch "
          f"per streamed MVM: {fwd_counts} / {bwd_counts}")
    check(bool(torch.isfinite(fwd).all() & torch.isfinite(bwd).all()),
          "non-finite streamed MVM output")
    det9 = {}
    for method, lam in (("neumann", cfg.lam), ("thomas", STENCIL_CHECK_LAM)):
        c = dataclasses.replace(cfg, encode_inputs=False,
                                denoise_method=method, lam=lam)
        kernels.reset_launches()
        got = (streamed_view(S, c, "cuda") @ x1,
               streamed_view(S, c, "cuda").T @ y1)
        torch.cuda.synchronize()
        tally(kernels.LAUNCHES)
        want = (streamed_view(S, c, "reference") @ x1,
                streamed_view(S, c, "reference").T @ y1)
        det9[method] = [rel_l2(g_, w_) for g_, w_ in zip(got, want)]
    print(f"[9a] DAC off, streamed cuda vs streamed reference rel-L2 "
          f"(A @ x, A.T @ y): Neumann {det9['neumann'][0]:.3e} / "
          f"{det9['neumann'][1]:.3e}; Thomas at lam {STENCIL_CHECK_LAM:g} "
          f"{det9['thomas'][0]:.3e} / {det9['thomas'][1]:.3e}", flush=True)
    check(max(max(v) for v in det9.values()) <= 1e-5,
          "the streamed cuda path disagrees with the streamed reference")
    at_blk = S.at_blocks[0, 0]
    da_blk = torch.sub(producer(0, 0), at_blk)
    more_shapes.append(block_rows("9a", cfg, at_blk, da_blk, 90))
    del S, a, producer, at_blk, da_blk, fwd, bwd, got, want
    torch.cuda.empty_cache()

    # 9b. The paper's dubcova2 (65,025^2): the implicit banded producer on
    # 8 x 8 MCAs of 1,024^2 (benchmarks/strong_scaling.py's streamed row),
    # taox-hfox, k = 5, EC on.  The matrix never exists on the card.
    dcfg = CrossbarConfig(device=get_device("taox-hfox"), geom=dub_geom,
                          k_iters=5, ec=True)
    dcap = dcfg.geom.capacity[0]
    block_bytes = dcap * dcap * 4
    imp = ImplicitBandedMatrix(n=n_dub, cap_m=dcap, cap_n=dcap, seed=n_dub,
                               device=dev)
    xd = torch.randn(n_dub, generator=gen, device=dev)
    yd = torch.randn(n_dub, generator=gen, device=dev)
    bd, bdt = imp.matvec(xd), imp.rmatvec(yd)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    deng = AnalogEngine(dcfg, execution="streamed", backend="cuda",
                        device=dev)
    t0 = time.perf_counter()
    D = deng.program(imp.block, fold_in(11, 3 * n_dub), shape=(n_dub, n_dub))
    torch.cuda.synchronize()
    dprog_s = time.perf_counter() - t0
    dgrid = D.at_stack.shape[0] * D.at_stack.shape[1]
    kernels.reset_launches()
    dms, dys = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        dys.append(D @ xd)
        torch.cuda.synchronize()
        dms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    dz = D.T @ yd
    torch.cuda.synchronize()
    dms_t = (time.perf_counter() - t0) * 1e3
    dub_counts = dict(kernels.LAUNCHES)
    tally(dub_counts)
    peak = torch.cuda.max_memory_allocated() - base
    limit = D.image_nbytes + 12 * block_bytes
    eps = [rel_l2(y_, bd) for y_ in dys]
    eps_t = rel_l2(dz, bdt)
    print(f"[9b] dubcova2 {n_dub}^2 ({dgrid} blocks of {dcap}^2, "
          f"{dcfg.device.name}, k = {dcfg.k_iters}, EC on): programmed in "
          f"{dprog_s:.2f} s, image {D.image_nbytes / 1e9:.2f} GB; 3 A @ x: "
          f"{', '.join(f'{v:.1f}' for v in dms)} ms, eps_l2 vs "
          f"imp.matvec {', '.join(f'{v:.4e}' for v in eps)}; A.T @ y "
          f"{dms_t:.1f} ms, eps_l2 vs imp.rmatvec {eps_t:.4e}; launches "
          f"{dub_counts}", flush=True)
    print(f"[9b] peak over program + 4 MVMs: "
          f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB allocated, "
          f"{peak / gib:.2f} GiB over the start (image "
          f"{D.image_nbytes / gib:.2f} GiB + "
          f"{(peak - D.image_nbytes) / block_bytes:.2f} capacity "
          f"blocks; limit image + 12 blocks = {limit / gib:.2f} GiB; a dense "
          f"program would hold A, A_tilde and dA: "
          f"{3 * n_dub * n_dub * 4 / 1e9:.1f} GB)", flush=True)
    check(dub_counts["ec_matmul"] == 3 * dgrid
          and dub_counts["ec_rmatmul"] == dgrid
          and dub_counts["stencil_denoise"] == 4,
          f"dubcova2: not {dgrid} EC launches per streamed MVM: {dub_counts}")
    check(peak <= limit, f"dubcova2: peak {peak / gib:.2f} GiB over the "
                         f"image plus 12 capacity blocks")
    check(all(bool(torch.isfinite(y_).all()) for y_ in dys + [dz])
          and max(eps + [eps_t]) < 0.1,
          "dubcova2: non-finite output or error above 0.1")
    # DAC off, the cuda path against the reference pipeline at this size.
    dexact = dataclasses.replace(dcfg, encode_inputs=False)
    det_dub = rel_l2(streamed_view(D, dexact, "cuda") @ xd,
                     streamed_view(D, dexact, "reference") @ xd)
    print(f"[9b] DAC off, cuda vs reference pipeline, A @ x: rel-L2 "
          f"{det_dub:.3e}", flush=True)
    check(det_dub <= 1e-5, "dubcova2: cuda path disagrees with reference")
    # Where a streamed MVM's time goes: the producer's sweep, dA's
    # derivation, the EC kernel and the DAC pass, each timed alone for one
    # block (x blocks) or one sweep; the device's busy time in one call
    # (torch.profiler) against its wall time.
    dat, dda = D.at_blocks[3, 3], torch.sub(imp.block(3, 3), D.at_blocks[3, 3])
    dblock = block_rows("9b dubcova2", dcfg, dat, dda, 91)
    more_shapes.append(dblock)

    def sweep():
        for i_ in range(D.at_stack.shape[0]):
            for j_ in range(D.at_stack.shape[1]):
                imp.block(i_, j_)

    xb_blk = xd[:dcap, None].contiguous()
    split = {
        "producer sweep": device_time_ms(sweep, 2, warmup=1),
        "derive dA (x blocks)": dgrid * device_time_ms(
            lambda: torch.sub(dat, dda), 10),
        "ec_matmul (x blocks)": dgrid * dblock["ec_matmul"]["ms"],
        "DAC pass (x blocks)": dgrid * device_time_ms(
            lambda: crossbar._encode_vec(
                xb_blk, dcfg, gen=generator(5, dev)), 20),
        "tier-2 stencil": device_time_ms(
            lambda: kernels.stencil_denoise(bd[:, None].contiguous(),
                                            dcfg.lam, dcfg.h), 20)}
    busy = sum(kernel_split(lambda: D @ xd, iters=2).values())
    wall = statistics.median(dms)
    bound9 = 3 * D.image_nbytes / HW['hbm_bw'] * 1e3
    print("[9b] a streamed A @ x, device ms: " + ", ".join(
        f"{k_} {v_:.3f}" for k_, v_ in split.items())
        + f"; wall {wall:.1f}, device busy {busy:.1f} (idle share "
        f"{1 - busy / wall:.3f}); byte bound {bound9:.2f} ms (image read + "
        f"each producer block written and read once), wall / bound "
        f"{wall / bound9:.2f}", flush=True)
    # What phase [10] holds its 1 x 1 mesh to: [9b]'s calls 0 and 3.
    dub = {"x": xd, "y": yd, "fwd": dys[0], "bwd": dz, "n": n_dub,
           "cfg": dcfg, "key": fold_in(11, 3 * n_dub)}
    del D, dys, dz, dat, dda
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    y_once, _ = streamed_corrected_mvm(imp.block, xd, n_dub, n_dub,
                                       fold_in(11, 3 * n_dub), dcfg)
    torch.cuda.synchronize()
    once_s = time.perf_counter() - t0
    peak_once = torch.cuda.max_memory_allocated() - base
    print(f"[9b] one-shot streamed_corrected_mvm (plain PyTorch, no image): "
          f"{once_s * 1e3:.1f} ms, eps_l2 {rel_l2(y_once, bd):.4e}, peak "
          f"{peak_once / gib:.2f} GiB over the start = "
          f"{peak_once / block_bytes:.2f} capacity blocks (limit 12)",
          flush=True)
    check(peak_once < 12 * block_bytes,
          "one-shot streamed MVM above 12 capacity blocks")
    check(rel_l2(y_once, bd) < 0.1, "one-shot streamed MVM error above 0.1")
    del y_once
    torch.cuda.empty_cache()

    # 9c. A solve at that size: CG on an epiram image of the same producer.
    ecfg = dataclasses.replace(dcfg, device=get_device("epiram"))
    E = AnalogEngine(ecfg, execution="streamed", backend="cuda",
                     device=dev).program(imp.block, fold_in(11, 4 * n_dub),
                                         shape=(n_dub, n_dub))
    x_true = torch.randn(n_dub, generator=gen, device=dev)
    b_true = imp.matvec(x_true)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solvers.cg(E, b_true, tol=SOLVE_TOL, maxiter=12, backend="cuda")
    torch.cuda.synchronize()
    cg_s = time.perf_counter() - t0
    cg_counts = dict(kernels.LAUNCHES)
    tally(cg_counts)
    led = res.ledger
    mvms = led.mvms + led.mvms_single
    err = rel_l2(res.x, x_true)
    print(f"[9c] CG on the {n_dub}^2 epiram image: {res.iterations} "
          f"iterations, {mvms} MVMs, converged={res.converged}, x err "
          f"{err:.3e}, residual {res.final_residual:.3e}; {cg_s * 1e3:.1f} "
          f"ms = {cg_s * 1e3 / max(res.iterations, 1):.1f} ms/iteration; "
          f"energy: write {led.write_energy_j:.4e} J, per MVM "
          f"{E.input_write_stats(1).energy_j:.4e} J, iterations "
          f"{led.iteration_energy_j:.4e} J; launches {cg_counts}",
          flush=True)
    check(res.converged and err <= SOLVE_TOL and res.iterations <= 12,
          f"dubcova2 CG did not reach x error <= {SOLVE_TOL} in 12 "
          f"iterations")
    check(cg_counts["cg_update"] == res.iterations
          and cg_counts["ec_matmul"] == dgrid * mvms
          and cg_counts["stencil_denoise"] == mvms,
          f"dubcova2 CG: not one cg_update an iteration and {dgrid} "
          f"ec_matmul + 1 stencil an MVM: {cg_counts}")
    print(f"[9] streamed launches {streamed_counts}", flush=True)
    del E, res, imp
    torch.cuda.empty_cache()
    return streamed_counts, dub


def banded_spd(n, cap, dev):
    """The reference's 65,536^2 scale test producer
    (tests/test_distributed.py, ``test_distributed_scale_65536``): 1 / (1 +
    |i - j|) within 8 of the diagonal, plus 16 on it; RNG-free.  Blocks
    beyond the band are zeros, made without the index arithmetic."""
    r = torch.arange(cap, dtype=torch.int32, device=dev)

    def block(i, j):
        if abs(i - j) * cap > cap + 8:
            return torch.zeros(cap, cap, device=dev)
        d = (r[:, None] + (i - j) * cap - r[None, :]).abs_()
        blk = d.float().add_(1.0).reciprocal_().masked_fill_(d > 8, 0.0)
        del d
        if i == j:
            blk.diagonal().add_(16.0)
        return blk
    return block


def distributed_phase(dev, gen, dub, *, n=N, d_ff=D_FF, d_model=D_MODEL,
                      experts=N_EXPERTS, geom=None, band_n=65536,
                      band_geom=None, mesh_shape=(2, 4)):
    """Phase 10, the distributed placement over an R x C mesh of ranks, all
    on this card (one process drives them in rank order; partials summed
    over the contraction axis in rank order, tier-2 on each output segment,
    one global output).  [10a] a dense n^2 matrix (the [3] cell) over the
    mesh: A @ x and A.T @ y at batch 1 and 8, one ec_matmul (ec_rmatmul)
    launch per capacity block and one tier-2 launch per segment, DAC off
    cuda = reference (Neumann, Thomas).  [10b] [9b]'s dubcova2 producer
    (``dub``): a 1 x 1 mesh equal to [9b]'s streamed outputs bit for bit, the
    mesh at the padded size equal to it within 1e-5, cuda = reference, the
    peak over the image.  [10c] ``resident=False`` at ``band_n`` (the
    reference's 65,536^2 scale test producer, epiram): CG to the residual
    2e-2, the peak over the start.  [10d] the [6] Mixtral group over the
    mesh: members = solo distributed programs bit for bit, one
    ec_group_matmul per rank's window, cuda = reference.  Returns the
    launches of the phase's main runs.  ``geom`` ([10a], [10d]; default 8
    x 8 MCAs of 512^2) and ``band_geom`` ([10c]; 8 x 8 of 1,024^2) and the
    sizes are arguments, so the phase can be rehearsed small on the CPU."""
    from repro_torch import analysis, kernels, solvers
    from repro_torch.core import (CrossbarConfig, ImplicitBandedMatrix,
                                  MCAGeometry, get_device)
    from repro_torch.core.prng import fold_in
    from repro_torch.engine import (AnalogEngine, AnalogMatrix,
                                    AnalogMatrixGroup)
    from repro_torch.launch import make_mesh
    gib = 2.0 ** 30
    R, C = mesh_shape
    mesh = make_mesh(mesh_shape, ("data", "model"), device=dev)
    one = make_mesh((1, 1), ("data", "model"), device=dev)
    counts = dict.fromkeys(kernels.LAUNCHES, 0)

    def tally(c):
        for k_, v_ in c.items():
            counts[k_] += v_

    def launches(fn):
        """``fn()``'s result, its launches (tallied) and its wall ms."""
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        used = dict(kernels.LAUNCHES)
        tally(used)
        return out, used, ms

    def used_only(c):
        return {k_: v_ for k_, v_ in c.items() if v_}

    def view(A, c, be, on=mesh):
        """A distributed handle's operands under another engine."""
        return AnalogMatrix(
            engine=AnalogEngine(c, execution="distributed", backend=be,
                                mesh=on),
            shape=A.shape, base_key=A.base_key, write_stats=A.write_stats,
            mesh_sharded=True, at_ranks=A.at_ranks, da_ranks=A.da_ranks,
            block_fn=A.block_fn, resident=A.resident)

    # 10a. Dense placement: the [3] matrix cell over the mesh.
    cfg = CrossbarConfig(device=get_device("taox-hfox"),
                         geom=geom or MCAGeometry())
    cap = cfg.geom.capacity[0]
    eng = AnalogEngine(cfg, execution="distributed", backend="cuda",
                       mesh=mesh)
    a = torch.randn(n, n, generator=gen, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    A = eng.program(a, 21)
    torch.cuda.synchronize()
    prog_s = time.perf_counter() - t0
    blocks_per_rank = (n // R // cap) * (n // C // cap)
    n_blocks = blocks_per_rank * R * C
    print(f"[10a] dense {n}^2 over a {R} x {C} mesh (rank windows "
          f"{n // R} x {n // C}, {blocks_per_rank} blocks of {cap}^2 a rank) "
          f"programmed in {prog_s:.2f} s; image {A.image_nbytes / gib:.1f} "
          f"GiB", flush=True)
    check(len(A.at_ranks) == R * C
          and tuple(A.at_ranks[0].shape) == (n // R, n // C),
          "unexpected rank windows")
    ms10a, xs, ys = {}, {}, {}
    for b in (1, 8):
        x = xs[b] = torch.randn(n, b, generator=gen, device=dev)
        y = ys[b] = torch.randn(n, b, generator=gen, device=dev)
        fwd, fc, ms10a[("fwd", b)] = launches(lambda: A @ x)
        bwd, bc, ms10a[("bwd", b)] = launches(lambda: A.T @ y)
        err = (rel_l2(fwd, torch.matmul(a, x)),
               rel_l2(bwd, torch.matmul(a.T, y)))
        print(f"[10a] batch {b}: A @ x {ms10a[('fwd', b)]:.1f} ms, rel-L2 "
              f"vs digital {err[0]:.4e}, launches {used_only(fc)}; A.T @ y "
              f"{ms10a[('bwd', b)]:.1f} ms, rel-L2 {err[1]:.4e}, launches "
              f"{used_only(bc)}", flush=True)
        check(fc["ec_matmul"] == n_blocks and fc["stencil_denoise"] == R
              and bc["ec_rmatmul"] == n_blocks and bc["stencil_denoise"] == C
              and sum(fc.values()) == n_blocks + R
              and sum(bc.values()) == n_blocks + C,
              f"[10a] not one EC launch per capacity block ({n_blocks}) and "
              f"one tier-2 launch per segment: {fc} / {bc}")
        check(tuple(fwd.shape) == (n, b) and tuple(bwd.shape) == (n, b)
              and bool(torch.isfinite(fwd).all() & torch.isfinite(bwd).all())
              and max(err) < 0.1, "[10a] wrong shape, non-finite or error "
                                  "above 0.1")
    x1 = x[:, :1].contiguous()
    call_ms = {be: call_time_ms(lambda: view(A, cfg, be) @ x1, 3)
               for be in ("cuda", "reference")}
    split = kernel_split(lambda: A @ x1, iters=2)
    busy = sum(split.values())
    top = sorted(split.items(), key=lambda kv: -kv[1])[:4]
    print(f"[10a] A @ x at batch 1 a call: cuda {call_ms['cuda']:.2f} ms, "
          f"reference {call_ms['reference']:.2f} ms; device busy "
          f"{busy:.2f} ms a cuda call (idle share "
          f"{1 - busy / call_ms['cuda']:.3f}), the largest: "
          + ", ".join(f"{short_kernel_name(k_)} {v_:.3f}" for k_, v_ in top),
          flush=True)
    det10a = {}
    for method, lam in (("neumann", cfg.lam), ("thomas", STENCIL_CHECK_LAM)):
        c = dataclasses.replace(cfg, encode_inputs=False,
                                denoise_method=method, lam=lam)
        for b in (1, 8):
            got, _, _ = launches(lambda: (view(A, c, "cuda") @ xs[b],
                                          view(A, c, "cuda").T @ ys[b]))
            want = (view(A, c, "reference") @ xs[b],
                    view(A, c, "reference").T @ ys[b])
            det10a[method, b] = [rel_l2(g_, w_) for g_, w_ in zip(got, want)]
    print("[10a] DAC off, cuda vs reference on the same handle (A @ x / "
          "A.T @ y): " + "; ".join(
              f"{m_} batch {b_} {v_[0]:.3e} / {v_[1]:.3e}"
              for (m_, b_), v_ in det10a.items())
          + f" (Thomas at lam {STENCIL_CHECK_LAM:g})", flush=True)
    check(max(max(v) for v in det10a.values()) <= 1e-5,
          "[10a] the distributed cuda path disagrees with the reference")
    del A, a, x, y, xs, ys, x1, fwd, bwd, got, want
    torch.cuda.empty_cache()

    # 10b. Producer placement: [9b]'s dubcova2, on a 1 x 1 mesh at its own
    # size (equal to [9b]'s streamed calls 0 and 3 bit for bit) and over the
    # mesh at the padded size (every split axis whole capacity blocks).
    dcfg = dub["cfg"]
    dcap = dcfg.geom.capacity[0]
    block_bytes = dcap * dcap * 4
    imp = ImplicitBandedMatrix(n=dub["n"], cap_m=dcap, cap_n=dcap,
                               seed=dub["n"], device=dev)
    n_pad = -(-dub["n"] // dcap) * dcap
    outs, peaks, progs = {}, {}, {}
    for label, on, size in (("1x1", one, dub["n"]),
                            (f"{R}x{C}", mesh, n_pad)):
        xd = torch.zeros(size, device=dev)
        yd = torch.zeros(size, device=dev)
        xd[:dub["n"]], yd[:dub["n"]] = dub["x"], dub["y"]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        deng = AnalogEngine(dcfg, execution="distributed", backend="cuda",
                            mesh=on)
        t0 = time.perf_counter()
        D = deng.program(imp.block, dub["key"], shape=(size, size))
        torch.cuda.synchronize()
        progs[label] = time.perf_counter() - t0
        fwd, fc, f_ms = launches(lambda: D @ xd)
        bwd, bc, b_ms = launches(lambda: deng.rmvm(
            D, yd, key=fold_in(dub["key"], 3)))
        peaks[label] = (torch.cuda.max_memory_allocated() - base
                        - D.image_nbytes)
        outs[label] = (fwd[:dub["n"]], bwd[:dub["n"]])
        nb = (n_pad // dcap) ** 2
        segs = (1, 1) if on is one else (R, C)
        print(f"[10b] dubcova2 over {label} ({size}^2 declared): programmed "
              f"in {progs[label]:.2f} s, image {D.image_nbytes / gib:.2f} "
              f"GiB; A @ x {f_ms:.1f} ms, launches {used_only(fc)}; A.T @ y "
              f"{b_ms:.1f} ms, launches {used_only(bc)}; peak over the image "
              f"{peaks[label] / gib:.3f} GiB = {peaks[label] / block_bytes:.2f}"
              f" capacity blocks", flush=True)
        check(fc["ec_matmul"] == nb and fc["stencil_denoise"] == segs[0]
              and bc["ec_rmatmul"] == nb and bc["stencil_denoise"] == segs[1],
              f"[10b] {label}: not {nb} EC launches and one tier-2 launch a "
              f"segment: {fc} / {bc}")
        check(peaks[label] <= 12 * block_bytes,
              f"[10b] {label}: peak above the image + 12 capacity blocks")
        if on is mesh:
            exact = dataclasses.replace(dcfg, encode_inputs=False)
            cu, pl = view(D, exact, "cuda"), view(D, exact, "reference")
            det = [rel_l2(cu @ xd, pl @ xd), rel_l2(cu.T @ yd, pl.T @ yd)]
            print(f"[10b] DAC off, {label}, cuda vs reference (A @ x, A.T @ "
                  f"y): rel-L2 {det[0]:.3e} / {det[1]:.3e}", flush=True)
            check(max(det) <= 1e-5, "[10b] cuda disagrees with the reference")
            del cu, pl
        del D, fwd, bwd, xd, yd
        torch.cuda.empty_cache()
    same = [torch.equal(outs["1x1"][k_], dub[w_])
            for k_, w_ in ((0, "fwd"), (1, "bwd"))]
    apart = [rel_l2(outs[f"{R}x{C}"][k_], outs["1x1"][k_]) for k_ in (0, 1)]
    print(f"[10b] 1 x 1 = [9b] streamed bit for bit (A @ x, A.T @ y): "
          f"{same[0]} / {same[1]}; {R} x {C} vs 1 x 1 rel-L2 {apart[0]:.3e} / "
          f"{apart[1]:.3e}", flush=True)
    check(all(same), "[10b] the 1 x 1 mesh differs from the streamed engine")
    check(max(apart) <= 1e-5, f"[10b] the {R} x {C} mesh differs from 1 x 1")
    del outs, imp
    torch.cuda.empty_cache()

    # 10c. resident=False: no image anywhere, CG over the mesh.
    bgeom = band_geom or MCAGeometry(8, 8, 1024, 1024)
    bcfg = CrossbarConfig(device=get_device("epiram"), geom=bgeom, k_iters=5,
                          ec=True)
    bcap = bcfg.geom.capacity[0]
    calls = [0]
    block = banded_spd(band_n, bcap, dev)

    def producer(i, j):
        calls[0] += 1
        return block(i, j)

    b_vec = torch.ones(band_n, device=dev)
    torch.cuda.empty_cache()
    beng = AnalogEngine(bcfg, execution="distributed", backend="cuda",
                        mesh=mesh)
    solved = {}

    def program_and_solve(rhs):
        solved["B"] = B_ = beng.program(producer, 0, shape=(band_n, band_n),
                                        resident=False)
        solved["after_program"] = calls[0]
        solved["run"] = launches(lambda: solvers.cg(
            B_, rhs, tol=2e-2, maxiter=4, key=0, backend="cuda"))

    peak_c = analysis.peak_bytes(program_and_solve, b_vec)
    B, after_program = solved["B"], solved["after_program"]
    res, cg_counts, cg_ms = solved.pop("run")
    bblock = bcap * bcap * 4
    mvms = res.ledger.mvms + res.ledger.mvms_single
    nbb = (band_n // bcap) ** 2
    # The digital residual of the solve, one producer sweep.
    resid = torch.zeros(band_n, device=dev)
    for i_ in range(band_n // bcap):
        for j_ in range(band_n // bcap):
            resid[i_ * bcap:(i_ + 1) * bcap] += torch.mv(
                block(i_, j_), res.x[j_ * bcap:(j_ + 1) * bcap])
    resid = rel_l2(resid, b_vec)
    print(f"[10c] resident=False {band_n}^2 (epiram, {nbb} blocks of "
          f"{bcap}^2, {R} x {C}): image {B.image_nbytes} B; CG "
          f"{res.iterations} iterations, {mvms} MVMs, converged="
          f"{res.converged}, residual {res.final_residual:.3e} (digital "
          f"{resid:.3e}); {cg_ms:.1f} ms = {cg_ms / max(mvms, 1):.1f} ms an "
          f"MVM; producer calls {after_program} to program, "
          f"{calls[0] - after_program} in the solve ({nbb} an MVM); peak "
          f"over the start {peak_c / gib:.3f} GiB = {peak_c / bblock:.2f} "
          f"capacity blocks; launches {used_only(cg_counts)}", flush=True)
    check(res.converged and res.final_residual <= 2e-2 and resid <= 2e-2,
          "[10c] CG did not reach the residual 2e-2")
    check(after_program == 0 and calls[0] == nbb * mvms,
          "[10c] the producer ran other than once a block an MVM")
    check(cg_counts["ec_matmul"] == nbb * mvms
          and cg_counts["cg_update"] == res.iterations
          and cg_counts["stencil_denoise"] == R * mvms,
          f"[10c] not {nbb} ec_matmul + {R} stencils an MVM and one "
          f"cg_update an iteration: {cg_counts}")
    check(peak_c <= 12 * bblock, "[10c] peak above 12 capacity blocks")
    del B, res, b_vec, solved
    torch.cuda.empty_cache()

    # 10d. Grouped placement: the [6] Mixtral w1 group over the mesh.
    geng = AnalogEngine(cfg, execution="distributed", backend="cuda",
                        mesh=mesh)
    w1 = torch.randn(experts, d_ff, d_model, generator=gen,
                     device=dev).div_(d_model ** 0.5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    G = geng.program_group(w1, 5)
    torch.cuda.synchronize()
    gprog = time.perf_counter() - t0
    same_solo = True
    for g_ in (0, experts - 1):
        solo = geng.program(w1[g_], fold_in(5, g_))
        same_solo &= all(torch.equal(p_, q_) for p_, q_ in zip(
            G.member(g_).at_ranks + G.member(g_).da_ranks,
            solo.at_ranks + solo.da_ranks))
        del solo
    print(f"[10d] {experts} experts' w1 ({d_ff} x {d_model}) over {R} x {C} "
          f"programmed in {gprog:.2f} s, stacks per rank "
          f"{tuple(G.at_ranks[0].shape)} ({G.image_nbytes / gib:.1f} GiB, "
          f"each window padded on its own); members 0 and {experts - 1} = "
          f"solo distributed programs bit for bit: {same_solo}", flush=True)
    check(same_solo, "[10d] a member differs from its solo program")
    gms = {}
    for b in (1, 8):
        gx = torch.randn(experts, d_model, b, generator=gen, device=dev)
        gy = torch.randn(experts, d_ff, b, generator=gen, device=dev)
        fwd, fc, gms[("fwd", b)] = launches(lambda: G @ gx)
        bwd, bc, gms[("bwd", b)] = launches(lambda: geng.group_rmvm(G, gy))
        err = (rel_l2(fwd, torch.bmm(w1, gx)),
               rel_l2(bwd, torch.bmm(w1.transpose(1, 2), gy)))
        print(f"[10d] batch {b}: G @ x {gms[('fwd', b)]:.1f} ms, rel-L2 vs "
              f"digital {err[0]:.4e}, launches {used_only(fc)}; G.T @ y "
              f"{gms[('bwd', b)]:.1f} ms, rel-L2 {err[1]:.4e}, launches "
              f"{used_only(bc)}", flush=True)
        cols = -(-(d_model // C) // cap)
        check(fc["ec_group_matmul"] == R * C and fc["stencil_denoise"] == R
              and sum(fc.values()) == R * C + R
              and bc["ec_group_rmatmul"] == R * C * cols
              and bc["stencil_denoise"] == C,
              f"[10d] not one ec_group_matmul per rank window and one "
              f"tier-2 launch per segment: {fc} / {bc}")
        check(max(err) < 0.1 and bool(torch.isfinite(fwd).all()
                                      & torch.isfinite(bwd).all()),
              "[10d] non-finite or error above 0.1")
    det10d = {}
    for method, lam in (("neumann", cfg.lam), ("thomas", STENCIL_CHECK_LAM)):
        c = dataclasses.replace(cfg, encode_inputs=False,
                                denoise_method=method, lam=lam)
        views = [AnalogMatrixGroup(
            engine=AnalogEngine(c, execution="distributed", backend=be,
                                mesh=mesh),
            size=G.size, shape=G.shape, base_key=G.base_key,
            member_keys=G.member_keys, write_stats=G.write_stats,
            mesh_sharded=True, at_ranks=G.at_ranks, da_ranks=G.da_ranks)
            for be in ("cuda", "reference")]
        got, want = [(h.engine.group_mvm(h, gx), h.engine.group_rmvm(h, gy))
                     for h in views]
        det10d[method] = [rel_l2(g_, w_) for g_, w_ in zip(got, want)]
    print(f"[10d] DAC off, batch 8, cuda vs reference (G @ x, G.T @ y): "
          f"Neumann {det10d['neumann'][0]:.3e} / {det10d['neumann'][1]:.3e}; "
          f"Thomas at lam {STENCIL_CHECK_LAM:g} {det10d['thomas'][0]:.3e} / "
          f"{det10d['thomas'][1]:.3e}", flush=True)
    check(max(max(v) for v in det10d.values()) <= 1e-5,
          "[10d] the grouped distributed cuda path disagrees with reference")
    print(f"[10] distributed launches {used_only(counts)}", flush=True)
    del G, w1, gx, gy, fwd, bwd, got, want, views
    torch.cuda.empty_cache()
    return counts


def reliability_phase(dev, gen, *, n=N, geom=None, target_faults=64,
                      lp_shape=LP_SHAPE, d_ff=D_FF, d_model=D_MODEL,
                      experts=N_EXPERTS, mesh_shape=(2, 4)):
    """Phase 11, device-lifetime reliability.  [11a] the [4] matrix (``R +
    R^T + 2I``, n^2, epiram, ``backend="reference"``, the only backend that
    ages): a fresh solve, the age that latches about ``target_faults``
    cells, the aged solve (digital residual above AGED_TOL and the fresh
    one), one probe call, a refresh of the tiles whose score rose over
    REFRESH_RATIO x their fresh score, and the solve again (within 2 x the
    fresh residual at less write energy than a full reprogram); a solve
    leaves the ledger as it was, a host ``A @ x`` adds one; the aging
    transform's time and peak.  [11b] ``ft_cg`` over an R x C mesh
    (``backend="cuda"``) with column 5 of every MCA-wide strip of the rank
    windows latched at the G_on rail at segment 1 and repaired: converged
    at tol 1e-4 after at least one restore.  [11c] ``ft_pdhg`` on the [5]
    LP with a NaN written into block (0, 0) before segment 0 and repaired:
    converged after one restore.  [11d] the [6] Mixtral w1 group aged
    (``advanced(50)``, ``elapsed(3600)``): members 0 and the last equal to
    solo handles aged from their own keys bit for bit, one ``group_mvm``
    adds one to every member, ``backend="cuda"`` refuses it.  Sizes are
    arguments, so the phase can be rehearsed small on the CPU
    (``reliability_probe.py rehearse``).  Returns the launches of the
    phase's main runs."""
    from repro_torch import kernels, solvers
    from repro_torch.core import CrossbarConfig, MCAGeometry, get_device
    from repro_torch.core.prng import fold_in
    from repro_torch.distributed import CheckpointManager
    from repro_torch.engine import AnalogEngine, AnalogMatrixGroup
    from repro_torch.launch import make_mesh
    from repro_torch.reliability import (RefreshPolicy, aged_blocks,
                                         attach_age, ft_cg, ft_pdhg,
                                         probe_tile_scores, refresh_tiles)
    from repro_torch.reliability.aging import attach_group_age
    gib = 2.0 ** 30
    counts = dict.fromkeys(kernels.LAUNCHES, 0)
    ckpt = tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_")

    def launches(fn):
        """``fn()``'s result, its launches (tallied) and its wall ms."""
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        used = {k_: v_ for k_, v_ in kernels.LAUNCHES.items() if v_}
        for k_, v_ in used.items():
            counts[k_] += v_
        return out, used, ms

    # 11a. One image's lifetime.
    cfg = CrossbarConfig(device=get_device("epiram"),
                         geom=geom or MCAGeometry())
    cap = cfg.geom.capacity[0]
    a = torch.randn(n, n, generator=gen, device=dev).div_(n)
    a = a + a.T
    a.diagonal().add_(2.0)
    x_true = torch.randn(n, generator=gen, device=dev)
    b = torch.matmul(a, x_true)
    engine = AnalogEngine(cfg, backend="reference", device=dev)
    A = engine.program(a, 2)
    mb = A._grid()[0]

    def solve(salt):
        res, used, ms = launches(lambda: solvers.cg(
            A, b, tol=1e-6, maxiter=LIFETIME_MAXITER, key=fold_in(0, salt),
            backend="cuda"))
        return res, rel_l2(torch.matmul(a, res.x), b), used, ms

    res, fresh, used, ms = solve(11)
    print(f"[11a] {n}^2 SPD image (epiram, {mb} x {mb} blocks of {cap}^2, "
          f"reference backend): fresh CG {res.iterations} iterations in "
          f"{ms:.1f} ms, digital residual {fresh:.3e}; launches {used}",
          flush=True)
    check(used.get("cg_update", 0) == res.iterations,
          "[11a] not one cg_update an iteration")
    floor = probe_tile_scores(A, key=fold_in(0, 10)).scores
    mvms = max(1, round(target_faults
                        / (cfg.device.fault_rate * n * n)))
    led = attach_age(A).advanced(mvms)
    A.age = led
    at = A.at_blocks
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    aged = aged_blocks(at, led, cfg.device)
    peak = torch.cuda.max_memory_allocated() - base
    moved = aged != at
    latched = int(moved.sum())
    diag = sum(int(moved[i, i].sum()) for i in range(mb))
    rail = int((moved & (aged != 0)).sum())
    del aged, moved
    age_ms = call_time_ms(lambda: aged_blocks(at, led, cfg.device), 5)
    split = kernel_split(lambda: aged_blocks(at, led, cfg.device), iters=2)
    busy = sum(split.values())
    top = sorted(split.items(), key=lambda kv: -kv[1])[:4]
    block_bytes = cap * cap * 4
    print(f"[11a] aged to {mvms} MVMs (p = {mvms * cfg.device.fault_rate:.2e}"
          f" a cell): {latched} cells changed by a latch ({rail} at the G_on "
          f"rail, {diag} in diagonal blocks); the aging transform "
          f"{age_ms:.2f} ms a call, peak over the image "
          f"{peak / gib:.3f} GiB = {peak / A.at_pad.nbytes:.3f} images + "
          f"{(peak - A.at_pad.nbytes) / block_bytes:.2f} capacity blocks; "
          f"device busy {busy:.2f} ms of it, the largest: "
          + ", ".join(f"{short_kernel_name(k_)} {v_:.3f}" for k_, v_ in top),
          flush=True)
    check(latched > 0 and diag > 0, "[11a] the age latched no cell of a "
                                    "diagonal block")
    check(peak <= A.at_pad.nbytes + 4 * block_bytes,
          "[11a] the aging transform's peak is over the aged copy + 4 blocks")
    x1 = x_true[:, None]
    fresh_call = call_time_ms(
        lambda: engine.mvm(dataclasses.replace(A, age=None), x1), 3)
    before = A.age.mvms.clone()
    res, aged_rel, used, ms = solve(12)
    check(torch.equal(A.age.mvms, before), "[11a] a solve moved the ledger")
    print(f"[11a] aged CG {res.iterations} iterations in {ms:.1f} ms "
          f"({ms / (res.iterations + 1):.1f} ms an MVM against a fresh "
          f"reference call's {fresh_call:.1f}), digital residual "
          f"{aged_rel:.3e} (fresh {fresh:.3e}); the ledger unchanged "
          f"({float(before[0, 0]):.0f} MVMs)", flush=True)
    check(aged_rel > max(AGED_TOL, fresh),
          f"[11a] the aged solve's residual {aged_rel:.3e} is not above "
          f"{AGED_TOL} and the fresh {fresh:.3e}")
    report, _, probe_ms = launches(lambda: probe_tile_scores(
        A, key=fold_in(0, 13)))
    ratio = report.scores / floor
    print(f"[11a] probe: one batch-{report.n_probes} call in {probe_ms:.1f} "
          f"ms; fresh scores {float(floor.min()):.2e}.."
          f"{float(floor.max()):.2e}, aged "
          f"{float(report.scores.min()):.2e}..{report.worst:.2e}; the "
          f"ledger at {float(A.age.mvms[0, 0]):.0f} MVMs", flush=True)
    check(float(A.age.mvms.min()) == mvms + report.n_probes,
          "[11a] the probe did not age the image by nb read disturbs")
    rr = refresh_tiles(A, ratio, RefreshPolicy(threshold=REFRESH_RATIO),
                       key=fold_in(0, 14))
    res, restored, used, ms = solve(15)
    print(f"[11a] refreshed {len(rr.tiles)} of {mb * mb} tiles (score over "
          f"{REFRESH_RATIO:g} x fresh; {sum(i == j for i, j in rr.tiles)} "
          f"diagonal): write {rr.write_stats.energy_j:.4e} J against a full "
          f"reprogram's {rr.full_rewrite_stats.energy_j:.4e} J "
          f"({rr.energy_saving:.1%} saved); CG again {res.iterations} "
          f"iterations, digital residual {restored:.3e} (fresh {fresh:.3e})",
          flush=True)
    check(0 < len(rr.tiles) < mb * mb
          and rr.write_stats.energy_j < rr.full_rewrite_stats.energy_j,
          "[11a] the refresh was not selective")
    check(restored <= 2.0 * fresh,
          f"[11a] the refreshed solve {restored:.3e} is over 2 x fresh")
    n0 = float(A.age.mvms.max())
    A @ x_true
    check(float(A.age.mvms.max()) == n0 + 1,
          "[11a] a host A @ x did not add one read disturb")
    del A, engine, at, floor, ratio, report, rr, res
    torch.cuda.empty_cache()

    # 11b. ft_cg over the mesh: a column latched mid-solve.
    R, C = mesh_shape
    mesh = make_mesh(mesh_shape, ("data", "model"), device=dev)
    deng = AnalogEngine(cfg, execution="distributed", backend="cuda",
                        mesh=mesh)
    D = deng.program(a, 3)
    del a
    torch.cuda.empty_cache()
    state = {}
    cell = cfg.geom.cell_cols

    def inject(seg, h):
        # One bitline of every MCA stuck at the G_on rail of its cells'
        # differential pairs (sign(w) * G_on, as aging latches a cell):
        # column 5 of every MCA-wide strip of every rank window.  A single
        # stuck column spoils a refinement step by about |r_5| / rms(r) of
        # its residual, so it trips the detector only part of the time.
        if seg == 1 and not state:
            state["saved"] = [w[:, 5::cell].clone() for w in h.at_ranks]
            g_on = max(float(w.abs().max()) for w in h.at_ranks)
            for w in h.at_ranks:
                cols = w[:, 5::cell]
                cols.copy_(torch.sign(cols).mul_(g_on))

    def repair(event, h):
        for w, s in zip(h.at_ranks, state.pop("saved")):
            w[:, 5::cell] = s
        state["event"] = event

    res, used, ms = launches(lambda: ft_cg(
        D, b, tol=1e-4, maxiter=400, segment=25, key=9, segment_hook=inject,
        on_fault=repair, backend="cuda",
        manager=CheckpointManager(f"{ckpt.name}/ft_cg")))
    err = rel_l2(res.x, x_true)
    ev = state.get("event")
    faults = ", ".join(f"{e.kind} at segment {e.segment}, digital "
                       f"residual {e.residual:.3e}, restored to step "
                       f"{e.restored_step}" for e in res.fault_events)
    print(f"[11b] ft_cg over {R} x {C} ({n}^2, rank windows {n // R} x "
          f"{n // C}; column 5 of every {cell}-wide MCA strip latched at "
          f"segment 1): {res.iterations} accepted segments, "
          f"{len(res.fault_events)} fault(s) ({faults}; repaired: "
          f"{ev is not None}), "
          f"{res.restores} restore(s), {res.ledger.mvms} MVMs, converged="
          f"{res.converged}, digital residual {res.final_residual:.3e}, x err "
          f"{err:.3e}, {ms / 1e3:.2f} s; launches {used}", flush=True)
    blocks = (n // cap) ** 2
    check(res.converged and res.restores >= 1,
          "[11b] ft_cg did not converge after a restore")
    check(used.get("ec_matmul", 0) == blocks * res.ledger.mvms
          and used.get("cg_update", 0) > 0,
          "[11b] not one ec_matmul a block an MVM, or no cg_update")
    del D, deng, b, x_true, res
    torch.cuda.empty_cache()

    # 11c. ft_pdhg on the [5] LP: a NaN written into block (0, 0).
    m_lp, n_lp = lp_shape
    la, lb, lc, x_star, _ = solvers.random_feasible_lp(SEED, m_lp, n_lp,
                                                       device=dev)
    L = AnalogEngine(cfg, backend="cuda", device=dev).program(la, 4)
    del la
    torch.cuda.empty_cache()
    lp_state = {}

    def nan_hook(seg, h):
        if not lp_state:
            lp_state["saved"] = float(h.at_pad[0, 0])
            h.at_pad[0, 0] = float("nan")

    def nan_repair(event, h):
        h.at_pad[0, 0] = lp_state["saved"]

    res, used, ms = launches(lambda: ft_pdhg(
        L, lb, lc, tol=FT_PDHG_TOL, maxiter=PDHG_MAXITER, segment=200,
        key=12, segment_hook=nan_hook, on_fault=nan_repair,
        manager=CheckpointManager(f"{ckpt.name}/ft_pdhg")))
    obj = float(torch.dot(lc, x_star))
    gap = abs(float(torch.dot(lc, res.x)) - obj) / (1 + abs(obj))
    led = res.ledger
    print(f"[11c] ft_pdhg {m_lp}x{n_lp}: {res.iterations} accepted segments, "
          f"faults {[(e.kind, e.segment) for e in res.fault_events]}, "
          f"{res.restores} restore(s), {led.mvms} + {led.mvms_t} transposed "
          f"MVMs (+ {led.mvms_single} + {led.mvms_single_t} power steps), "
          f"converged={res.converged}, digital KKT {res.final_residual:.3e}, "
          f"objective gap {gap:.3e}, {ms / 1e3:.2f} s; launches {used}",
          flush=True)
    check(res.converged and res.restores == 1,
          "[11c] ft_pdhg did not converge after exactly one restore")
    check(used.get("ec_rmatmul", 0) == led.mvms_t + led.mvms_single_t,
          "[11c] not every A.T @ y through ec_rmatmul")
    del L, lb, lc, x_star, res
    torch.cuda.empty_cache()

    # 11d. The [6] Mixtral w1 group, aged.
    gcfg = CrossbarConfig(device=get_device("taox-hfox"),
                          geom=geom or MCAGeometry())
    geng = AnalogEngine(gcfg, backend="reference", device=dev)
    w1 = torch.randn(experts, d_ff, d_model, generator=gen,
                     device=dev).div_(d_model ** 0.5)
    G = geng.program_group(w1, 5)
    del w1
    torch.cuda.empty_cache()
    G.ages = attach_group_age(G).advanced(50).elapsed(3600.0)
    gx = torch.randn(d_model, 1, generator=gen, device=dev)
    out, _, g_ms = launches(lambda: geng.group_mvm(G, gx))
    moved = float(G.ages.mvms.min()) == float(G.ages.mvms.max()) == 51.0
    same = []
    for g_ in (0, experts - 1):
        solo = G.member(g_)
        solo.age = attach_age(solo).advanced(50).elapsed(3600.0)
        same.append(torch.equal(out[g_], geng.mvm(solo, gx)))
    try:
        AnalogMatrixGroup(
            engine=AnalogEngine(gcfg, backend="cuda", device=dev),
            size=G.size, shape=G.shape, base_key=G.base_key,
            member_keys=G.member_keys, write_stats=G.write_stats,
            at_pad=G.at_pad, da_pad=G.da_pad, ages=G.ages) @ gx
        refused = False
    except ValueError:
        refused = True
    print(f"[11d] {experts} experts' w1 ({d_ff} x {d_model}, taox-hfox) aged "
          f"50 MVMs + 3,600 s: a group call {g_ms:.1f} ms; members 0 and "
          f"{experts - 1} = solo aged handles bit for bit: {same}; every "
          f"ledger at 51 after the call: {moved}; backend='cuda' refuses: "
          f"{refused}", flush=True)
    check(all(same) and moved and refused,
          "[11d] the aged group differs from its solo members, its ledgers "
          "did not advance together, or cuda took it")
    del G, out, gx
    torch.cuda.empty_cache()
    ckpt.cleanup()
    return counts


def dense_twin_check(tag, views, rram, gen, dev) -> None:
    """The analog dense's kernel path (``models.common.dense``: ec_rmatmul
    + stencil_denoise) against its plain twin (``dense_plain``: the same
    DAC draw, layout and casts) on every view at each of its row counts,
    each also bit for bit run to run.  At a served lam of 1e-12 the stencil
    term is far below fp32's resolution, so the check runs at
    STENCIL_CHECK_LAM, where it shows.  ``views``: (name, programmed kernel
    dict, row counts) triples."""
    from repro_torch.models.common import Runtime, dense, dense_plain
    rram_chk = dataclasses.replace(rram, lam=STENCIL_CHECK_LAM)
    parts = []
    for name, p, rows_list in views:
        d_in, d_out = p["w"].shape
        errs = []
        for rows in rows_list:
            x = torch.randn(rows, d_in, generator=gen, device=dev)
            got = dense(p, x, Runtime(rram=rram_chk, key=LM_CHECK_KEY))
            again = dense(p, x, Runtime(rram=rram_chk, key=LM_CHECK_KEY))
            want = dense_plain(p, x, Runtime(rram=rram_chk, key=LM_CHECK_KEY))
            err = rel_l2(got, want)
            check(err <= EC_TOL and torch.equal(got, again),
                  f"{tag} dense {d_in}->{d_out} at {rows} rows: rel-L2 "
                  f"{err:.2e} against its plain twin, or not the same run "
                  f"to run")
            errs.append(f"{err:.1e}")
        parts.append(f"{name} {d_in}x{d_out} " + " / ".join(errs) + " at "
                     + " / ".join(map(str, rows_list)) + " rows")
    print(f"{tag} analog dense (ec_rmatmul + stencil_denoise, lam "
          f"{STENCIL_CHECK_LAM:g}) vs its plain twin, rel-L2: "
          + "; ".join(parts) + "; each bit for bit run to run", flush=True)


def lm_phase(dev, more_shapes, *, cfg=None, rram=None, requests=LM_REQUESTS,
             dense_rows=LM_DENSE_ROWS, rt_kw=None,
             profile_steps=LM_PROFILE_STEPS):
    """[12] the transformer LM served on the programmed image: by default
    qwen3-1.7b at its published widths and depth in float32, weights from
    seed LM_SEED, taox-hfox (k = 5, EC, 512^2 cells, lam 1e-12, dw in
    float32).  Holds the analog ``dense`` to its plain twin at every kernel
    shape of the model, serves ``requests`` ((batch, prompt tokens, new
    tokens, max_len) each) with the DAC on and counts the EC launches,
    holds the DAC-off model to the digital one and the DAC-on model to
    itself run to run, and times program, prefill and decode.  Returns the
    main path's launch counts.  A function with size arguments, so that it
    can be rehearsed on the CPU at a reduced config."""
    import gc
    from repro_torch.analysis.roofline import HW
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RRAMBackendConfig
    from repro_torch.core.prng import fold_in
    from repro_torch.models import flash
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import Runtime
    from repro_torch.models.rram import (analog_image_bytes,
                                         programmed_kernel_shapes,
                                         strip_rram)
    from repro_torch.train.serve import Server

    if cfg is None:
        cfg = dataclasses.replace(get_arch(LM_ARCH).model,
                                  param_dtype="float32",
                                  compute_dtype="float32")
    rram = rram or RRAMBackendConfig(enabled=True, dw_dtype="float32")
    rt_kw = dict(LM_RT_KW if rt_kw is None else rt_kw)
    gib = 2.0 ** 30
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    start_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = PM.materialize(tf.init_specs(cfg), LM_SEED,
                            dtype=PM.torch_dtype(cfg.param_dtype), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    srv = Server(tf, cfg, params, rt=Runtime(rram=rram, key=LM_DAC_KEY,
                                             **rt_kw),
                 max_len=requests[0][3])
    torch.cuda.synchronize()
    program_s = time.perf_counter() - t0
    prog = srv.params
    shapes = programmed_kernel_shapes(prog)
    per_pass = sum(l_ for l_, _, _ in shapes)     # analog denses a pass
    elems = sum(l_ * m * n for l_, m, n in shapes)
    w_bytes = sum(int(t.nbytes) for _, t in PM.tree_paths(params))
    img_bytes = analog_image_bytes(prog)
    peak = torch.cuda.max_memory_allocated()
    ws = srv.write_stats
    print(f"[12] {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads} / {cfg.n_kv_heads} of {cfg.d_head}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab} (padded {cfg.vocab_pad}), "
          f"{cfg.param_dtype}; materialized in {init_s:.2f} s; programmed "
          f"{per_pass} kernels in {len(shapes)} tensors ({elems / 1e9:.4f} G "
          f"elements, "
          f"{srv.program_dispatches} shape buckets; {rram.device}, k = "
          f"{rram.k_iters}, {rram.cell_rows}^2 cells, dw {rram.dw_dtype}) in "
          f"{program_s:.2f} s; w {w_bytes / 1e9:.3f} GB + w_tilde + dw "
          f"{img_bytes / 1e9:.3f} GB; held at the start "
          f"{start_bytes / gib:.2f} GiB, peak {peak / gib:.2f} GiB "
          f"({(peak - start_bytes) / gib:.2f} over the start); write "
          f"{ws.energy_j:.4e} J, {ws.latency_s:.4e} s", flush=True)
    check(rram.dw_dtype != "float32" or img_bytes == 8 * elems,
          "[12] the analog image's bytes do not match its kernels")

    # The analog dense against its plain twin at every kernel shape of the
    # model (layer 0's views and the head), on the decode panels and each
    # request's prefill panel.
    layer = PM.tree_map(lambda t: t[0], prog["layers"])
    views = {"wq": layer["attn"]["wq"], "wk": layer["attn"]["wk"],
             "wu": layer["mlp"]["wu"], "wd": layer["mlp"]["wd"]}
    if not cfg.tie_embeddings:
        views["lm_head"] = prog["lm_head"]
    rows_checked = sorted(set(dense_rows) | {b * t for b, t, _, _ in requests})
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 1)
    dense_twin_check("[12]", [(name, p, rows_checked)
                              for name, p in views.items()], rram, gen, dev)
    # The EC kernel on the decode panel, timed at an MLP kernel's and the
    # head's shape beside its plain version and cuBLAS.
    b0 = requests[0][0]
    for name in ("wu", "lm_head"):
        if name not in views:
            continue
        at, da = views[name]["w_tilde"], views[name]["dw"]
        m, k = at.shape
        y = torch.randn(m, b0, generator=gen, device=dev)
        y_t = torch.randn(m, b0, generator=gen, device=dev)
        row = compare(f"ec_rmatmul {m}x{k} batch {b0}",
                      lambda: kernels.ec_rmatmul(at, da, y, y_t),
                      lambda: kernels.ec_rmatmul_plain(at, da, y, y_t),
                      EC_TOL, cost=kernels.cost.ec_rmatmul(m, k, b0), iters=20,
                      library_fn=lambda: torch.matmul(at.T, y)
                      + torch.matmul(da.T, y_t))
        row.update(shape=f"{m}x{k} (LM {name})", batch=b0)
        more_shapes.append({"ec_rmatmul": row})

    # The main path: every request served with the DAC on, counted.
    batches = []
    for i, (b, t, _, _) in enumerate(requests):
        toks = torch.randint(0, cfg.vocab, (b, t), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(LM_SEED + 10 + i))
        batches.append({"tokens": toks})
    servers = [srv] + [Server(tf, cfg, prog, rt=srv.rt, max_len=ml)
                       for _, _, _, ml in requests[1:]]
    check(all(s.program_dispatches == 0 for s in servers[1:]),
          "[12] a server programmed an already programmed image again")
    flash_calls = [0]
    real_flash = flash.flash_attention

    def counting_flash(*a, **kw):
        flash_calls[0] += 1
        return real_flash(*a, **kw)

    flash.flash_attention = counting_flash
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        outs = [s.generate(bt, n) for s, bt, (_, _, n, _) in
                zip(servers, batches, requests)]
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
    finally:
        flash.flash_attention = real_flash
    for out, (b, t, n, _) in zip(outs, requests):
        check(tuple(out.shape) == (b, n) and bool((out >= 0).all())
              and bool((out < cfg.vocab).all()),
              f"[12] generate returned {tuple(out.shape)} or a token out of "
              f"the vocabulary")
    n_head = per_pass - cfg.n_layers * (per_pass // cfg.n_layers)
    # Prefill: the layers on b x t rows, the head on the last token's b;
    # each decode step: every dense on b rows.  One launch per 8 rows.
    want_ec = sum((per_pass - n_head) * -(-b * t // 8) + n_head * -(-b // 8)
                  + (n - 1) * per_pass * -(-b // 8)
                  for b, t, n, _ in requests)
    want_flash = sum(cfg.n_layers for _, t, _, ml in requests
                     if t > 1 and t * ml > srv.rt.flash_threshold)
    print(f"[12] served " + ", ".join(
        f"{b} x {t} prompt -> {n} new (max_len {ml})"
        for b, t, n, ml in requests)
        + f" with the DAC on: launches {counts} (ec_rmatmul expected "
        f"{want_ec}); flash attention {flash_calls[0]} calls (expected "
        f"{want_flash}: prefill where t x s > {srv.rt.flash_threshold})",
        flush=True)
    check(counts["ec_rmatmul"] == want_ec
          and counts["stencil_denoise"] == per_pass * sum(
              n for _, _, n, _ in requests),
          "[12] not one ec_rmatmul launch per 8 rows and one "
          "stencil_denoise launch per analog dense")
    check(all(v == 0 for k_, v in counts.items()
              if k_ not in ("ec_rmatmul", "stencil_denoise")),
          f"[12] another kernel ran on the LM path: {counts}")
    check(flash_calls[0] == want_flash, "[12] flash attention did not run "
          "exactly where t x s is over the threshold")

    # One prefill and one decode step of the first request, counted.
    b, t, n, ml = requests[0]
    torch.cuda.synchronize()
    kernels.reset_launches()
    tok, caches = srv.prefill(batches[0])
    torch.cuda.synchronize()
    pre_counts = {k_: v for k_, v in kernels.LAUNCHES.items() if v}
    kernels.reset_launches()
    srv.decode_tokens(tok, caches, 1)
    torch.cuda.synchronize()
    step_counts = {k_: v for k_, v in kernels.LAUNCHES.items() if v}
    want_pre = (per_pass - n_head) * -(-b * t // 8) + n_head * -(-b // 8)
    print(f"[12] prefill of {b} x {t}: launches {pre_counts} (ec_rmatmul "
          f"expected {want_pre}); one decode step at {b} rows: {step_counts}"
          f" ({cfg.n_layers} layers x {(per_pass - n_head) // cfg.n_layers}"
          f" + {n_head} head)", flush=True)
    check(pre_counts.get("ec_rmatmul") == want_pre,
          "[12] prefill's ec_rmatmul launches")
    check(b > 8 or step_counts == {"ec_rmatmul": per_pass,
                                   "stencil_denoise": per_pass},
          f"[12] a decode step's launches are not {per_pass} + {per_pass}")
    # Server.decode_fn after a prefill, against decode_tokens after a
    # second, fresh prefill (the KV caches are written in place: the two
    # share none).  Checked here; the tally above is the served requests'.
    steps = min(n - 1, LM_DECODE_FN_TOKENS)
    tok, caches = srv.prefill(batches[0])
    torch.cuda.synchronize()
    kernels.reset_launches()
    got, _ = srv.decode_fn(steps)(tok, caches)
    torch.cuda.synchronize()
    fn_counts = nonzero(kernels.LAUNCHES)
    tok2, caches2 = srv.prefill(batches[0])
    want, _ = srv.decode_tokens(tok2, caches2, steps)
    per_step = per_pass * -(-b // 8)
    print(f"[12] decode_fn({steps}) after a prefill: tokens "
          f"{tuple(got.shape)} equal to decode_tokens after a fresh prefill "
          f"{torch.equal(got, want)}; launches {fn_counts} ({steps} x "
          f"{per_step} + {steps} x {per_pass} expected)", flush=True)
    check(torch.equal(tok, tok2) and torch.equal(got, want),
          "[12] decode_fn's tokens differ from decode_tokens'")
    check(fn_counts == {"ec_rmatmul": steps * per_step,
                        "stencil_denoise": steps * per_pass},
          f"[12] decode_fn's launches are not {steps} x ({per_step} + "
          f"{per_pass})")
    del tok2, caches2, got, want

    # Times: host clock around synchronised work (every path warmed above).
    for s, bt, (b, t, n, ml) in zip(servers, batches, requests):
        pre = []
        for _ in range(LM_TIMING_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, caches = s.prefill(bt)
            torch.cuda.synchronize()
            pre.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        s.decode_tokens(tok, caches, n - 1)
        torch.cuda.synchronize()
        dec = (time.perf_counter() - t0) * 1e3 / max(n - 1, 1)
        print(f"[12] request {b} x {t} -> {n}: prefill "
              f"{statistics.median(pre):.2f} ms (min {min(pre):.2f}), "
              f"decode {dec:.3f} ms a token = {b * 1e3 / dec:.1f} tokens/s "
              f"at batch {b}", flush=True)

    # Where a decode step's time goes: device busy (torch.profiler over
    # ``steps`` steps) against the unprofiled wall, and the EC kernels'
    # device ms against their byte bound (each image read once, the panels
    # read and written once).
    b, t, n, ml = requests[0]
    steps = max(1, min(profile_steps, (ml - t) // 3))   # 3 runs, one cache
    tok, caches = srv.prefill(batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.decode_tokens(tok, caches, steps)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    split = {k_: v / steps for k_, v in kernel_split(
        lambda: srv.decode_tokens(tok, caches, steps), iters=1).items()}
    ec_keys = ("ec_rmatmul", "partial_sum_kernel", "stencil_")
    ec_ms = sum(v for k_, v in split.items()
                if any(e in k_ for e in ec_keys))
    busy = sum(split.values())
    ec_bytes = sum(l_ * (kernels.cost.ec_rmatmul(m, n_, b).bytes
                         + kernels.cost.stencil_denoise(n_, b).bytes)
                   for l_, m, n_ in shapes)
    ec_bound = ec_bytes / HW['hbm_bw'] * 1e3
    top = sorted(split.items(), key=lambda kv: -kv[1])[:6]
    print(f"[12] a decode step at {b} rows ({steps} steps): wall "
          f"{wall:.3f} ms, device busy {busy:.3f} ms (idle share "
          f"{1 - busy / wall:.3f}); EC kernels {ec_ms:.3f} ms against "
          f"their byte bound {ec_bound:.3f} ms ({ec_bytes / 1e9:.3f} GB a "
          f"step at {HW['hbm_bw'] / 1e12:.2f} TB/s: "
          f"{ec_bound / ec_ms if ec_ms else 0.0:.3f} of the bound); the "
          f"largest: " + ", ".join(f"{short_kernel_name(k_)} {v:.3f}"
                                   for k_, v in top), flush=True)

    # The tier-2 stencil's share of the longest prompt's prefill: its device
    # ms summed over the prefill's launches (one a dense: the layers'
    # (d_out, b t) panels, the head's on the last token) against their
    # byte bound (each panel read and written once).
    b, t, _, _ = requests[-1]
    pre_split = kernel_split(lambda: servers[-1].prefill(batches[-1]),
                             iters=1)
    st_ms = sum(v for k_, v in pre_split.items() if "stencil_" in k_)
    # The layers' stacked kernels see b t rows, the head b.
    st_bound = sum(l_ * kernels.cost.stencil_denoise(
        n_, b * t if l_ == cfg.n_layers else b).bytes
        for l_, _, n_ in shapes) / HW['hbm_bw'] * 1e3
    pre_busy = sum(pre_split.values())
    print(f"[12] a {b} x {t} prefill: stencil_denoise {st_ms:.4f} ms device "
          f"over its {per_pass} launches, byte bound {st_bound:.4f} "
          f"ms ({st_bound / st_ms if st_ms else 0.0:.3f} of it), "
          f"{st_ms / pre_busy if pre_busy else 0.0:.4f} of the prefill's "
          f"{pre_busy:.3f} ms device busy", flush=True)

    # DAC off: the analog model against the digital one on the same w.
    digital = strip_rram(prog)
    dig_rt = Runtime(**rt_kw)
    off_rt = Runtime(rram=dataclasses.replace(rram, encode_inputs=False),
                     **rt_kw)
    b, t, n, ml = requests[0]
    # The vocabulary's live columns (the padded ones are -1e30 on both).
    live = slice(0, cfg.vocab)
    logits_dig, _ = tf.prefill(digital, batches[0], cfg, dig_rt, ml)
    logits_off, _ = tf.prefill(prog, batches[0], cfg, off_rt, ml)
    off_err = rel_l2(logits_off[:, -1, live], logits_dig[:, -1, live])
    tok_dig = Server(tf, cfg, digital, rt=dig_rt, max_len=ml) \
        .generate(batches[0], n)
    tok_off = Server(tf, cfg, prog, rt=off_rt, max_len=ml) \
        .generate(batches[0], n)
    agree_off = float((tok_off == tok_dig).float().mean())
    # DAC on: the same key twice, and the deviation from the digital model.
    again = srv.generate(batches[0], n)
    logits_on, _ = tf.prefill(prog, batches[0], cfg,
                              srv._rt_for(fold_in(LM_DAC_KEY, 0)), ml)
    on_err = rel_l2(logits_on[:, -1, live], logits_dig[:, -1, live])
    agree_on = float((outs[0] == tok_dig).float().mean())
    print(f"[12] DAC off: prefill's last-token logits vs the digital model "
          f"rel-L2 {off_err:.3e} (tf32 off), greedy tokens agree on "
          f"{agree_off:.4f} of {tok_dig.numel()}; DAC on: logits vs digital "
          f"{on_err:.3e}, tokens agree on {agree_on:.4f}; two generate "
          f"calls under one key equal bit for bit: "
          f"{torch.equal(again, outs[0])}", flush=True)
    check(bool(torch.isfinite(logits_on).all())
          and bool(torch.isfinite(logits_off).all())
          and bool((logits_on[..., cfg.vocab:] == -1e30).all()),
          "[12] non-finite logits, or a padded column not masked")
    check(off_err <= LM_DIGITAL_TOL, f"[12] DAC-off logits {off_err:.3e} "
          f"from the digital model's")
    check(torch.equal(again, outs[0]), "[12] two generate calls under one "
          "key differ")
    return counts


def analog_calls(cfg, b, t, ctx=0, prefill=True):
    """(d_in, d_out, rows) of every analog dense call of one pass at batch
    ``b`` over ``t`` tokens a sequence (a decode step: t = 1), by the
    reference's programming rule: 2-D and 3-D kernels named "w" are
    programmed, so the MoE experts' (L, E, D, F) stacks and llama-vision's
    (n_super, per, D, F) self layers and zamba2's (groups, per, D, F)
    mamba blocks stay digital (and the images of the MoE router and of
    rwkv6's w_lora_b are never read).  ``ctx``: whisper's encoder frames
    (its encoder runs in prefill only) or llama-vision's patches, which
    every pass projects through the cross layers' wk / wv again."""
    d, f = cfg.d_model, cfg.d_ff
    q, kv = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head

    def attn(rows_q, rows_kv):
        return [(d, q, rows_q), (d, kv, rows_kv), (d, kv, rows_kv),
                (q, d, rows_q)]

    def mlp(rows):
        gate = [(d, f, rows)] if cfg.act == "silu_gated" else []
        return gate + [(d, f, rows), (f, d, rows)]

    n = b * t
    if cfg.family == "transformer":
        calls = (attn(n, n) + mlp(n)) * cfg.n_layers
    elif cfg.family == "moe":
        calls = attn(n, n) * cfg.n_layers
    elif cfg.family == "rwkv6":
        # time mix wr, wk, wv, wg, w_lora_a, wo; channel mix wk, wr, wv
        calls = ([(d, d, n)] * 4 + [(d, 64, n), (d, d, n), (d, f, n),
                                    (d, d, n), (f, d, n)]) * cfg.n_layers
    elif cfg.family == "zamba2":
        groups, tail = divmod(cfg.n_layers, cfg.attn_every)
        di, st, h = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
        shared = [(2 * d, d, n)] + attn(n, n) + [(d, d, n)]
        mamba = [(d, di, n), (d, di, n), (d, st, n), (d, st, n), (d, h, n),
                 (di, d, n)]
        calls = shared * groups + mamba * tail
    elif cfg.family == "whisper":
        enc = (attn(b * ctx, b * ctx) + mlp(b * ctx)) * cfg.n_enc_layers
        calls = (enc if prefill else []) + (
            attn(n, n) + attn(n, b * ctx) + mlp(n)) * cfg.n_layers
    else:
        calls = (attn(n, b * ctx) + mlp(n)) * (cfg.n_layers
                                                // cfg.cross_attn_every)
    return calls + [(d, cfg.vocab_pad, b)]      # the head: the last token


def ec_launches(calls) -> int:
    """One ec_rmatmul launch per 8 rows of every analog dense."""
    return sum(-(-rows // 8) for _, _, rows in calls)


def ec_bytes(calls) -> int:
    """Bytes the EC launches of ``calls`` move: each launch reads both fp32
    images (w_tilde, dw), every call its two input panels and its output
    (``kernels.cost.ec_launch_bytes``)."""
    from repro_torch.kernels import cost
    return sum(cost.ec_launch_bytes(m, n, r, transpose=True)
               for m, n, r in calls)


def digital_weight_bytes(params) -> int:
    """Bytes of every kernel named "w" that carries no image (read whole by
    each pass's digital product); the embedding table is gathered, not
    read, and the programmed w of the MoE router (d x E) and of rwkv6's
    w_lora_b (64 x d a layer) are read digitally (left out)."""
    if not isinstance(params, dict):
        return 0
    own = int(params["w"].nbytes) if isinstance(params.get("w"),
                                                torch.Tensor) \
        and "w_tilde" not in params else 0
    return own + sum(digital_weight_bytes(v) for k, v in params.items()
                     if isinstance(v, dict))


def free_cuda() -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def counted_request(what, srv, cfg, batch, n, ctx=0):
    """``srv.generate(batch, n)`` with the launch counts zeroed just before
    and read just after, held to :func:`analog_calls` (one ec_rmatmul per
    8 rows and one stencil_denoise per analog dense, nothing else) and the
    tokens to the vocabulary.  Returns (tokens, counts, the prefill's
    calls, a decode step's calls)."""
    from repro_torch import kernels
    b, t = batch["tokens"].shape
    pre_calls = analog_calls(cfg, b, t, ctx, prefill=True)
    step_calls = analog_calls(cfg, b, 1, ctx, prefill=False)
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = srv.generate(batch, n)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    want_ec = ec_launches(pre_calls) + (n - 1) * ec_launches(step_calls)
    want_st = len(pre_calls) + (n - 1) * len(step_calls)
    print(f"{what} with the DAC on: launches "
          f"{ {k_: v for k_, v in counts.items() if v} } (expected "
          f"ec_rmatmul {want_ec}, stencil_denoise {want_st})", flush=True)
    check(tuple(out.shape) == (b, n) and bool((out >= 0).all())
          and bool((out < cfg.vocab).all()),
          f"{what}: generate returned {tuple(out.shape)} or a token out of "
          f"the vocabulary")
    check(counts["ec_rmatmul"] == want_ec
          and counts["stencil_denoise"] == want_st
          and all(v == 0 for k_, v in counts.items()
                  if k_ not in ("ec_rmatmul", "stencil_denoise")),
          f"{what}: launches {counts} are not one ec_rmatmul per 8 rows and "
          f"one stencil_denoise per analog dense")
    return out, counts, pre_calls, step_calls


def serve_times(srv, batch, n):
    """Host clock around synchronised work (the path warmed before):
    LM_TIMING_REPS prefills (ms each) and ``n - 1`` decode steps after the
    last (ms a step)."""
    pre = []
    for _ in range(LM_TIMING_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, caches = srv.prefill(batch)
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    srv.decode_tokens(tok, caches, n - 1)
    torch.cuda.synchronize()
    return pre, (time.perf_counter() - t0) * 1e3 / max(n - 1, 1)


def serve_family(tag, dev, mod, cfg, params, rram, request, extra, *,
                 rt_kw, views, ctx, profile_steps):
    """Serve one request ((batch, prompt tokens, new tokens, max_len) and
    ``extra`` -- frames or patches) of a family's model with the DAC on,
    programmed once by its Server, and hold it to the phase's checks:
    the dense twin at ``views``, every EC launch counted against
    :func:`analog_calls` (prefill, one decode step, the request), nothing
    else launched, DAC-off logits within LM_DIGITAL_TOL of the digital
    model, two generate calls under one key equal; times and a decode
    step's idle share against its byte bound.  Returns (launch counts of
    the request, the server)."""
    from repro_torch.analysis.roofline import HW
    from repro_torch import kernels
    from repro_torch.core.prng import fold_in
    from repro_torch.models import params as PM
    from repro_torch.models.common import Runtime
    from repro_torch.models.rram import (analog_image_bytes,
                                         programmed_kernel_shapes,
                                         strip_rram)
    from repro_torch.train.serve import Server

    gib = 2.0 ** 30
    b, t, n, ml = request
    t0 = time.perf_counter()
    srv = Server(mod, cfg, params, rt=Runtime(rram=rram, key=LM_DAC_KEY,
                                              **rt_kw), max_len=ml)
    torch.cuda.synchronize()
    program_s = time.perf_counter() - t0
    prog = srv.params
    shapes = programmed_kernel_shapes(prog)
    elems = sum(l_ * m * k for l_, m, k in shapes)
    w_bytes = sum(int(a.nbytes) for _, a in PM.tree_paths(params))
    img_bytes = analog_image_bytes(prog)
    print(f"{tag} programmed {sum(l_ for l_, _, _ in shapes)} kernels in "
          f"{len(shapes)} tensors ({elems / 1e9:.4f} G elements) in "
          f"{program_s:.2f} s; w {w_bytes / 1e9:.3f} GB + w_tilde + dw "
          f"{img_bytes / 1e9:.3f} GB; digital kernels "
          f"{digital_weight_bytes(prog) / 1e9:.3f} GB; peak "
          f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB; write "
          f"{srv.write_stats.energy_j:.4e} J, "
          f"{srv.write_stats.latency_s:.4e} s", flush=True)
    check(rram.dw_dtype != "float32" or img_bytes == 8 * elems,
          f"{tag} the analog image's bytes do not match its kernels")
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 1)
    dense_twin_check(tag, views(prog), rram, gen, dev)

    toks = torch.randint(0, cfg.vocab, (b, t), device=dev,
                         generator=torch.Generator(device=dev)
                         .manual_seed(LM_SEED + 10))
    batch = {"tokens": toks, **extra}
    # The main path: the request served with the DAC on, counted.
    out, counts, pre_calls, step_calls = counted_request(
        f"{tag} served {b} x {t} prompt -> {n} new (max_len {ml})", srv,
        cfg, batch, n, ctx)
    torch.cuda.synchronize()
    kernels.reset_launches()
    tok, caches = srv.prefill(batch)
    torch.cuda.synchronize()
    pre_counts = {k_: v for k_, v in kernels.LAUNCHES.items() if v}
    kernels.reset_launches()
    srv.decode_tokens(tok, caches, 1)
    torch.cuda.synchronize()
    step_counts = {k_: v for k_, v in kernels.LAUNCHES.items() if v}
    print(f"{tag} prefill: {pre_counts} (expected ec_rmatmul "
          f"{ec_launches(pre_calls)}); a decode step: {step_counts} "
          f"(expected {ec_launches(step_calls)} + {len(step_calls)})",
          flush=True)
    check(pre_counts == {"ec_rmatmul": ec_launches(pre_calls),
                         "stencil_denoise": len(pre_calls)}
          and step_counts == {"ec_rmatmul": ec_launches(step_calls),
                              "stencil_denoise": len(step_calls)},
          f"{tag} a pass's launches differ from the expected")

    pre, dec = serve_times(srv, batch, n)
    # A decode step: device busy (torch.profiler) against the unprofiled
    # wall, and its bytes (the EC launches' images and panels, the digital
    # kernels read whole) against HBM's rate.
    steps = max(1, min(profile_steps, (ml - t) // 3))   # 3 runs, one cache
    tok, caches = srv.prefill(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.decode_tokens(tok, caches, steps)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    split = {k_: v / steps for k_, v in kernel_split(
        lambda: srv.decode_tokens(tok, caches, steps), iters=1).items()}
    busy = sum(split.values())
    ec_ms = sum(v for k_, v in split.items() if any(
        e in k_ for e in ("ec_rmatmul", "partial_sum_kernel",
                          "stencil_")))
    step_bytes = ec_bytes(step_calls) + digital_weight_bytes(prog)
    bound = step_bytes / HW['hbm_bw'] * 1e3
    top = sorted(split.items(), key=lambda kv: -kv[1])[:5]
    print(f"{tag} prefill {statistics.median(pre):.2f} ms (min "
          f"{min(pre):.2f}), decode {dec:.3f} ms a token = "
          f"{b * 1e3 / dec:.1f} tokens/s at batch {b}; a decode step "
          f"({steps} steps): wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"(idle share {1 - busy / wall:.3f}), EC kernels {ec_ms:.3f} ms; "
          f"bytes {step_bytes / 1e9:.3f} GB (EC "
          f"{ec_bytes(step_calls) / 1e9:.3f}), bound {bound:.3f} ms at "
          f"{HW['hbm_bw'] / 1e12:.2f} TB/s; the largest: "
          + ", ".join(f"{short_kernel_name(k_)} {v:.3f}" for k_, v in top),
          flush=True)

    # DAC off: the analog model against the digital one on the same w.
    digital = strip_rram(prog)
    dig_rt = Runtime(**rt_kw)
    off_rt = Runtime(rram=dataclasses.replace(rram, encode_inputs=False),
                     **rt_kw)
    live = slice(0, cfg.vocab)
    logits_dig, _ = mod.prefill(digital, batch, cfg, dig_rt, ml)
    logits_off, _ = mod.prefill(prog, batch, cfg, off_rt, ml)
    off_err = rel_l2(logits_off[:, -1, live], logits_dig[:, -1, live])
    tok_dig = Server(mod, cfg, digital, rt=dig_rt, max_len=ml) \
        .generate(batch, n)
    tok_off = Server(mod, cfg, prog, rt=off_rt, max_len=ml) \
        .generate(batch, n)
    again = srv.generate(batch, n)
    logits_on, _ = mod.prefill(prog, batch, cfg,
                               srv._rt_for(fold_in(LM_DAC_KEY, 0)), ml)
    on_err = rel_l2(logits_on[:, -1, live], logits_dig[:, -1, live])
    print(f"{tag} DAC off: prefill's last-token logits vs the digital "
          f"model rel-L2 {off_err:.3e}, greedy tokens agree on "
          f"{float((tok_off == tok_dig).float().mean()):.4f} of "
          f"{tok_dig.numel()}; DAC on: logits vs digital {on_err:.3e}, "
          f"tokens agree on {float((out == tok_dig).float().mean()):.4f}; "
          f"two generate calls under one key equal: "
          f"{torch.equal(again, out)}; peak "
          f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB", flush=True)
    check(bool(torch.isfinite(logits_on).all())
          and bool(torch.isfinite(logits_off).all())
          and bool((logits_on[..., cfg.vocab:] == -1e30).all()),
          f"{tag} non-finite logits, or a padded column not masked")
    check(off_err <= LM_DIGITAL_TOL, f"{tag} DAC-off logits {off_err:.3e} "
          f"from the digital model's")
    check(torch.equal(again, out), f"{tag} two generate calls under one "
          f"key differ")
    return counts, srv


def experts_phase(dev, more_shapes, cfg, tree, rram, tokens):
    """[13b] one MoE layer's tree (router and the (E, D, F) / (E, F, D)
    stacks) programmed on its own -- its stacks are 3-D, so each expert is
    programmed and ``moe_apply`` takes the EC branch: ``expert_mm`` against
    its plain twin on the dispatch buffers' shapes (lam STENCIL_CHECK_LAM
    and the served lam), ``moe_apply`` on ``tokens`` tokens each with the
    DAC on and counted (3 ec_group_rmatmul launches per 8 capacity slots,
    3 stencil_denoise), DAC off against the digital experts, timed against
    its byte bound.  Returns the launch counts."""
    from repro_torch.analysis.roofline import HW
    from repro_torch import kernels
    from repro_torch.models import moe
    from repro_torch.models.common import Runtime
    from repro_torch.models.rram import program_rram, strip_rram

    gib = 2.0 ** 30
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    t0 = time.perf_counter()
    prog, ws = program_rram(tree, rram, 7)
    torch.cuda.synchronize()
    print(f"[13b] layer 0's MoE tree programmed on its own in "
          f"{time.perf_counter() - t0:.2f} s: router {tuple(tree['router']['w'].shape)}"
          f", wg / wu {(e, d, f)}, wd {(e, f, d)}, each expert its image "
          f"({3 * e * d * f * 8 / 1e9:.3f} GB of w_tilde + dw); write "
          f"{ws.energy_j:.4e} J; peak "
          f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB", flush=True)
    check(all("w_tilde" in prog[k] for k in ("router", "wg", "wu", "wd")),
          "[13b] a kernel of the single-layer tree was not programmed")
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 2)
    caps = [moe._capacity(n, cfg) for n in tokens]
    errs = []
    for cap in caps:
        xin = torch.randn(e, cap, d, generator=gen, device=dev)
        h = torch.randn(e, cap, f, generator=gen, device=dev)
        for name, x in (("wg", xin), ("wu", xin), ("wd", h)):
            for lam in (STENCIL_CHECK_LAM, rram.lam):
                r = dataclasses.replace(rram, lam=lam)
                got = moe.expert_mm(prog[name], x,
                                    Runtime(rram=r, key=LM_CHECK_KEY))
                again = moe.expert_mm(prog[name], x,
                                      Runtime(rram=r, key=LM_CHECK_KEY))
                want = moe.expert_mm_plain(prog[name], x,
                                           Runtime(rram=r, key=LM_CHECK_KEY))
                err = rel_l2(got, want)
                errs.append(err)
                check(err <= EC_TOL and torch.equal(got, again),
                      f"[13b] expert_mm {name} at capacity {cap}, lam "
                      f"{lam:g}: rel-L2 {err:.2e} against its plain twin, "
                      f"or not the same run to run")
    print(f"[13b] expert_mm (ec_group_rmatmul + stencil_denoise) vs its "
          f"plain twin at capacities {caps} x wg / wu / wd x lam "
          f"{STENCIL_CHECK_LAM:g} / {rram.lam:g}: rel-L2 {min(errs):.1e}-"
          f"{max(errs):.1e}, each bit for bit run to run", flush=True)
    # The grouped kernel alone at the decode buffer's panels.
    at, da = prog["wg"]["w_tilde"], prog["wg"]["dw"]
    cols = e * caps[0]
    y = torch.randn(d, cols, generator=gen, device=dev)
    y_t = torch.randn(d, cols, generator=gen, device=dev)
    row = compare(f"ec_group_rmatmul {e}x{d}x{f} batch {caps[0]}",
                  lambda: kernels.ec_group_rmatmul(at, da, y, y_t),
                  lambda: kernels.ec_group_rmatmul_plain(at, da, y, y_t),
                  EC_TOL, cost=kernels.cost.ec_group_rmatmul(e, d, f,
                                                             caps[0]),
                  iters=20,
                  library_fn=lambda: torch.bmm(
                      at.transpose(1, 2), y.view(d, e, -1).transpose(0, 1))
                  + torch.bmm(da.transpose(1, 2),
                              y_t.view(d, e, -1).transpose(0, 1)))
    row.update(shape=f"{e}x{d}x{f} (MoE wg)", batch=caps[0])
    more_shapes.append({"ec_group_rmatmul": row})

    counts = dict.fromkeys(kernels.LAUNCHES, 0)
    digital = strip_rram(prog)
    off = dataclasses.replace(rram, encode_inputs=False)
    for n_tok, cap in zip(tokens, caps):
        x = torch.randn(1, n_tok, d, generator=gen, device=dev)
        torch.cuda.synchronize()
        kernels.reset_launches()
        out, aux = moe.moe_apply(prog, x, cfg,
                                 Runtime(rram=rram, key=LM_DAC_KEY))
        torch.cuda.synchronize()
        got = dict(kernels.LAUNCHES)
        for k_, v in got.items():
            counts[k_] += v
        again, _ = moe.moe_apply(prog, x, cfg,
                                 Runtime(rram=rram, key=LM_DAC_KEY))
        want = 3 * -(-cap // 8)
        dig, _ = moe.moe_apply(digital, x, cfg, None)
        off_out, _ = moe.moe_apply(prog, x, cfg, Runtime(rram=off))
        off_err, on_err = rel_l2(off_out, dig), rel_l2(out, dig)
        call = lambda: moe.moe_apply(prog, x, cfg,   # noqa: E731
                                     Runtime(rram=rram, key=LM_DAC_KEY))
        dev_ms, call_ms = device_time_ms(call, 5), call_time_ms(call, 5)
        nbytes = 3 * kernels.cost.ec_launch_bytes(d, f, cap, transpose=True,
                                                  g=e)
        print(f"[13b] moe_apply on {n_tok} tokens (capacity {cap}): "
              f"launches {({k_: v for k_, v in got.items() if v})} "
              f"(expected ec_group_rmatmul {want}, stencil_denoise 3); "
              f"DAC off vs the digital experts rel-L2 {off_err:.3e}, DAC "
              f"on {on_err:.3e}, run to run equal {torch.equal(out, again)}"
              f"; device {dev_ms:.3f} ms, per call {call_ms:.3f} ms, byte "
              f"bound {nbytes / HW['hbm_bw'] * 1e3:.3f} ms "
              f"({nbytes / 1e9:.3f} GB); aux {float(aux):.4f}", flush=True)
        check(got["ec_group_rmatmul"] == want
              and got["stencil_denoise"] == 3
              and all(v == 0 for k_, v in got.items()
                      if k_ not in ("ec_group_rmatmul", "stencil_denoise")),
              f"[13b] launches {got}: not {want} ec_group_rmatmul + 3 "
              f"stencil_denoise")
        check(bool(torch.isfinite(out).all()) and torch.equal(out, again)
              and off_err <= LM_DIGITAL_TOL,
              f"[13b] moe_apply: non-finite, not the same run to run, or "
              f"DAC off {off_err:.3e} from the digital experts")
    return counts


def families_phase(dev, more_shapes, *, cfgs=None, rram=None,
                   moe_request=MOE_REQUEST, expert_tokens=MOE_EXPERT_TOKENS,
                   whisper_request=WHISPER_REQUEST, frames=WHISPER_FRAMES,
                   whisper_rt_kw=None, vision_request=VISION_REQUEST,
                   profile_steps=FAMILY_PROFILE_STEPS):
    """[13] the attention-based families served on the programmed image,
    float32, random weights from LM_SEED, taox-hfox (k = 5, EC, 512^2
    cells, lam 1e-12, dw float32), each model freed before the next:
    [13a] Mixtral-8x7B at its published widths, MOE_LAYERS of 32 layers;
    [13b] its layer 0's MoE tree programmed on its own (the expert EC);
    [13c] whisper-tiny whole, 1,500 frames; [13d] Llama-3.2-Vision-11B at
    its published widths, one super layer (4 self + 1 cross of 40), every
    cross layer's tanh gate set to VISION_GATE after materialize on the
    analog and the digital side alike (the reference initialises it to
    zero, and tanh(0) = 0 would hide the cross path from the logits).
    ``cfgs`` ({"moe", "whisper", "vision"} -> ModelConfig) replaces the
    models, so that the phase can be rehearsed on the CPU.  Returns the
    main path's launch counts."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RRAMBackendConfig
    from repro_torch.models import llama_vision, moe, whisper
    from repro_torch.models import params as PM

    def full(arch, **kw):
        return dataclasses.replace(get_arch(arch).model,
                                   param_dtype="float32",
                                   compute_dtype="float32", **kw)

    cfgs = cfgs or {"moe": full(MOE_ARCH, n_layers=MOE_LAYERS),
                    "whisper": full(WHISPER_ARCH),
                    "vision": full(VISION_ARCH, n_layers=VISION_LAYERS)}
    rram = rram or RRAMBackendConfig(enabled=True, dw_dtype="float32")
    total = {}

    def add(counts):
        for k_, v in counts.items():
            total[k_] = total.get(k_, 0) + v

    def layer0(tree):
        return PM.tree_map(lambda a: a[0], tree)

    # [13a] Mixtral-8x7B served.
    t0 = time.perf_counter()
    cfg = cfgs["moe"]
    free_cuda()
    params = PM.materialize(moe.init_specs(cfg), LM_SEED, device=dev)
    b, t, _, _ = moe_request
    print(f"[13a] {cfg.n_layers} layers (depth cut), d_model {cfg.d_model}, "
          f"heads {cfg.n_heads} / {cfg.n_kv_heads} of {cfg.d_head}, d_ff "
          f"{cfg.d_ff}, {cfg.n_experts} experts top-"
          f"{cfg.experts_per_token}, SWA {cfg.swa_window}, vocab "
          f"{cfg.vocab} (padded {cfg.vocab_pad}), {cfg.param_dtype}",
          flush=True)
    rows = sorted(set(FAMILY_DENSE_ROWS) | {b * t})
    counts, srv = serve_family(
        "[13a]", dev, moe, cfg, params, rram, moe_request, {},
        rt_kw={}, ctx=0, profile_steps=profile_steps,
        views=lambda prog: [
            (name, layer0(prog["layers"])["attn"][name], rows)
            for name in ("wq", "wk", "wo")] + [
            ("lm_head", prog["lm_head"], FAMILY_DENSE_ROWS)])
    add(counts)
    # Layer 0's MoE tree, digital, kept for [13b]; the model freed.
    tree = PM.tree_map(lambda a: a[0].clone(),
                       {k_: {"w": v["w"]} for k_, v in
                        srv.params["layers"]["moe"].items()})
    del params, srv
    print(f"[13a] phase wall time {time.perf_counter() - t0:.2f} s",
          flush=True)

    # [13b] the expert EC on that tree.
    t0 = time.perf_counter()
    free_cuda()
    add(experts_phase(dev, more_shapes, cfg, tree, rram, expert_tokens))
    del tree
    print(f"[13b] phase wall time {time.perf_counter() - t0:.2f} s",
          flush=True)

    # [13c] whisper-tiny, whole.
    t0 = time.perf_counter()
    cfg = cfgs["whisper"]
    free_cuda()
    params = PM.materialize(whisper.init_specs(cfg), LM_SEED, device=dev)
    b, t, _, _ = whisper_request
    fr = torch.randn(b, frames, cfg.d_model, device=dev,
                     generator=torch.Generator(device=dev)
                     .manual_seed(LM_SEED + 20))
    print(f"[13c] {cfg.n_enc_layers} + {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.d_head}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab} (padded {cfg.vocab_pad}); "
          f"{frames} frames", flush=True)
    rows = sorted(set(FAMILY_DENSE_ROWS) | {b * t, b * frames})
    counts, srv = serve_family(
        "[13c]", dev, whisper, cfg, params, rram, whisper_request,
        {"frames": fr}, rt_kw=dict(whisper_rt_kw or WHISPER_RT_KW),
        ctx=frames, profile_steps=profile_steps,
        views=lambda prog: [
            ("enc wq", layer0(prog["enc_layers"])["attn"]["wq"], rows),
            ("enc wu", layer0(prog["enc_layers"])["mlp"]["wu"], rows),
            ("enc wd", layer0(prog["enc_layers"])["mlp"]["wd"], rows),
            ("cross wk", layer0(prog["dec_layers"])["cross_attn"]["wk"],
             rows),
            ("lm_head", prog["lm_head"], FAMILY_DENSE_ROWS)])
    add(counts)
    del params, srv, fr
    print(f"[13c] phase wall time {time.perf_counter() - t0:.2f} s",
          flush=True)

    # [13d] Llama-3.2-Vision-11B, one super layer, gates at VISION_GATE.
    t0 = time.perf_counter()
    cfg = cfgs["vision"]
    free_cuda()
    params = PM.materialize(llama_vision.init_specs(cfg), LM_SEED,
                            device=dev)
    params["super"]["cross"]["attn"]["gate"].fill_(VISION_GATE)
    b, t, _, _ = vision_request
    patches = torch.randn(b, cfg.n_patches, cfg.d_model, device=dev,
                          generator=torch.Generator(device=dev)
                          .manual_seed(LM_SEED + 30))
    n_super = cfg.n_layers // cfg.cross_attn_every
    print(f"[13d] {n_super} super layer(s) of {cfg.cross_attn_every - 1} "
          f"self + 1 cross ({cfg.n_layers} layers, depth cut), d_model "
          f"{cfg.d_model}, heads {cfg.n_heads} / {cfg.n_kv_heads} of "
          f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.n_patches} patches; cross gate {VISION_GATE}", flush=True)
    rows = sorted(set(FAMILY_DENSE_ROWS) | {b * t})
    counts, srv = serve_family(
        "[13d]", dev, llama_vision, cfg, params, rram, vision_request,
        {"patches": patches}, rt_kw={}, ctx=cfg.n_patches,
        profile_steps=profile_steps,
        views=lambda prog: [
            ("cross wq", layer0(prog["super"]["cross"])["attn"]["wq"], rows),
            ("cross wk", layer0(prog["super"]["cross"])["attn"]["wk"],
             sorted(set(rows) | {b * cfg.n_patches})),
            ("cross wu", layer0(prog["super"]["cross"])["mlp"]["wu"], rows),
            ("cross wd", layer0(prog["super"]["cross"])["mlp"]["wd"], rows),
            ("lm_head", prog["lm_head"], FAMILY_DENSE_ROWS)])
    add(counts)
    del params, srv, patches
    free_cuda()
    print(f"[13d] phase wall time {time.perf_counter() - t0:.2f} s",
          flush=True)
    return total


def long_context(tag, dev, mod, cfg, srv, request):
    """A second request on ``srv``'s programmed model (no programming):
    served with the DAC on and counted; prefill and decode timed, and the
    decode step after the full prompt against one after its first 32
    tokens at the same batch (a recurrent step carries a fixed-size state,
    so its time should not grow with the context).  Returns the request's
    launch counts."""
    from repro_torch.train.serve import Server

    b, t, n, ml = request
    s = Server(mod, cfg, srv.params, rt=srv.rt, max_len=ml)
    toks = torch.randint(0, cfg.vocab, (b, t), device=dev,
                         generator=torch.Generator(device=dev)
                         .manual_seed(LM_SEED + 11))
    batch = {"tokens": toks}
    out, counts, pre_calls, step_calls = counted_request(
        f"{tag} served {b} x {t} prompt -> {n} new", s, cfg, batch, n)
    pre, dec = serve_times(s, batch, n)
    _, short = serve_times(s, {"tokens": toks[:, :32]}, n)
    again = s.generate(batch, n)
    print(f"{tag} {b} x {t}: {ec_launches(pre_calls)} + {len(pre_calls)} "
          f"launches a prefill, {ec_launches(step_calls)} + "
          f"{len(step_calls)} a decode step; prefill "
          f"{statistics.median(pre):.2f} ms (min {min(pre):.2f}), decode "
          f"{dec:.3f} ms a token after {t} tokens of context, {short:.3f} "
          f"after 32; two generate calls under one key equal: "
          f"{torch.equal(again, out)}", flush=True)
    check(torch.equal(again, out), f"{tag} {b} x {t}: two generate calls "
          f"under one key differ")
    return counts


def recurrence_ms(tag, dev, cfg, t):
    """The chunked WKV (rwkv6) or SSD (zamba2) alone at batch 1 over ``t``
    tokens with the model's heads: device ms (``torch.profiler``'s kernel
    sum; "not measured" when the trace holds no kernel) and host-clock ms
    a call, its single-token step's host-clock ms a call (the profiler
    misses some of a step's few short kernels, so the step gets no
    device reading), and the chunked form's agreement with ``t`` steps
    run in order (the same recurrence; every log-decay inside both
    clamps)."""
    from repro_torch.models import linear_attention as la

    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 40)
    if cfg.family == "rwkv6":
        dk = dv = cfg.ssm_head_dim
        h = cfg.d_model // dk
        lshape = (1, t, h, dk)
    else:
        h, dk, dv = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
        lshape = (1, t, h)
    q = torch.randn(1, t, h, dk, generator=gen, device=dev)
    k = torch.randn(1, t, h, dk, generator=gen, device=dev) / dk ** 0.5
    v = torch.randn(1, t, h, dv, generator=gen, device=dev)
    logd = -torch.exp(torch.randn(lshape, generator=gen, device=dev)
                      - 1.0).clamp(1e-6, 1.5)
    u = torch.randn(h, dk, generator=gen, device=dev) * 0.1
    s0 = torch.zeros(1, h, dk, dv, device=dev)
    if cfg.family == "rwkv6":
        name = "chunked_wkv"
        chunked = lambda: la.chunked_wkv(q, k, v, logd, u, s0)   # noqa: E731
        step = lambda: la.wkv_decode_step(                       # noqa: E731
            q[:, 0], k[:, 0], v[:, 0], logd[:, 0], u, s0)
    else:
        name = "chunked_ssd"
        chunked = lambda: la.chunked_ssd(q, k, v, logd, s0)      # noqa: E731
        step = lambda: la.ssd_decode_step(                       # noqa: E731
            q[:, 0], k[:, 0], v[:, 0], logd[:, 0], s0)
    out, s_fin = chunked()
    s_seq = s0
    outs = []
    for i in range(t):
        args = (q[:, i], k[:, i], v[:, i], logd[:, i])
        o, s_seq = la.wkv_decode_step(*args, u, s_seq) \
            if cfg.family == "rwkv6" else la.ssd_decode_step(*args, s_seq)
        outs.append(o)
    err = max(rel_l2(out, torch.stack(outs, dim=1)), rel_l2(s_fin, s_seq))
    split = kernel_split(chunked, iters=3)
    dev_ms = f"{sum(split.values()):.3f} ms" if split else "not measured"
    wall = call_time_ms(chunked, 3)
    step_wall = call_time_ms(step, 20)
    print(f"{tag} {name} alone, batch 1 x {t} tokens, {h} heads of {dk} x "
          f"{dv}, {t // 32} chunks of 32: device {dev_ms}, a call "
          f"{wall:.3f} ms; its single-token step: a call {step_wall:.4f} "
          f"ms; chunked vs {t} steps in order rel-L2 {err:.2e}", flush=True)
    check(err <= 1e-4 and bool(torch.isfinite(out).all()),
          f"{tag} {name} differs from its token recurrence ({err:.2e})")


def recurrent_phase(dev, more_shapes, *, cfgs=None, rram=None,
                    rwkv_requests=RWKV_REQUESTS, zamba_request=ZAMBA_REQUEST,
                    scan_tokens=RECURRENT_SCAN_TOKENS,
                    profile_steps=FAMILY_PROFILE_STEPS):
    """[14] the recurrent families served on the programmed image at their
    published widths and depth, float32, random weights from LM_SEED, the
    [12] backend (taox-hfox, k = 5, EC, 512^2 cells, lam 1e-12, dw fp32),
    each model freed before the next: [14a] rwkv6-1.6b (24 layers; nine
    analog denses a layer, w_lora_b digital) on 4 x 64 -> 32 and 1 x 1,024
    -> 16; [14b] zamba2-1.2b (38 layers: 6 groups of 6 digital mamba blocks
    with a shared attention block after each, and an analog tail of 2) on
    4 x 64 -> 32.  Each through :func:`serve_family`'s checks, and the
    chunked WKV / SSD timed alone over ``scan_tokens`` tokens.  ``cfgs``
    ({"rwkv6", "zamba2"} -> ModelConfig) replaces the models, so that the
    phase can be rehearsed on the CPU.  Returns the main path's launch
    counts."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RRAMBackendConfig
    from repro_torch.models import params as PM
    from repro_torch.models import rwkv6, zamba2

    def full(arch):
        return dataclasses.replace(get_arch(arch).model,
                                   param_dtype="float32",
                                   compute_dtype="float32")

    cfgs = cfgs or {"rwkv6": full(RWKV_ARCH), "zamba2": full(ZAMBA_ARCH)}
    rram = rram or RRAMBackendConfig(enabled=True, dw_dtype="float32")
    total = {}

    def add(counts):
        for k_, v in counts.items():
            total[k_] = total.get(k_, 0) + v

    def layer0(tree):
        return PM.tree_map(lambda a: a[0], tree)

    # [14a] rwkv6-1.6b, whole.
    t0 = time.perf_counter()
    cfg = cfgs["rwkv6"]
    free_cuda()
    params = PM.materialize(rwkv6.init_specs(cfg), LM_SEED, device=dev)
    b, t, _, _ = rwkv_requests[0]
    print(f"[14a] {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.d_model // cfg.ssm_head_dim} heads of {cfg.ssm_head_dim}, "
          f"d_ff {cfg.d_ff}, LoRA rank {rwkv6.LORA_R}, vocab {cfg.vocab} "
          f"(padded {cfg.vocab_pad}), {cfg.param_dtype}", flush=True)
    rows = sorted(set(FAMILY_DENSE_ROWS) | {b * t})
    counts, srv = serve_family(
        "[14a]", dev, rwkv6, cfg, params, rram, rwkv_requests[0], {},
        rt_kw={}, ctx=0, profile_steps=profile_steps,
        views=lambda prog: [
            ("tm wr", layer0(prog["layers"])["tm"]["wr"], rows),
            ("tm w_lora_a", layer0(prog["layers"])["tm"]["w_lora_a"], rows),
            ("cm wk", layer0(prog["layers"])["cm"]["wk"], rows),
            ("cm wv", layer0(prog["layers"])["cm"]["wv"], rows),
            ("lm_head", prog["lm_head"], FAMILY_DENSE_ROWS)])
    add(counts)
    add(long_context("[14a]", dev, rwkv6, cfg, srv, rwkv_requests[1]))
    del params, srv
    free_cuda()
    recurrence_ms("[14a]", dev, cfg, scan_tokens)
    print(f"[14a] phase wall time {time.perf_counter() - t0:.2f} s",
          flush=True)

    # [14b] zamba2-1.2b, whole.
    t0 = time.perf_counter()
    cfg = cfgs["zamba2"]
    free_cuda()
    params = PM.materialize(zamba2.init_specs(cfg), LM_SEED, device=dev)
    groups, tail = divmod(cfg.n_layers, cfg.attn_every)
    b, t, _, _ = zamba_request
    print(f"[14b] {cfg.n_layers} layers = {groups} groups of "
          f"{cfg.attn_every} digital mamba blocks (4-D stacks) + a shared "
          f"attention block after each + an analog tail of {tail}; d_model "
          f"{cfg.d_model}, d_inner {cfg.d_inner}, N {cfg.ssm_state}, "
          f"{cfg.n_ssm_heads} SSM heads of {cfg.ssm_head_dim}, "
          f"{cfg.n_heads} attention heads of {cfg.d_head}, vocab "
          f"{cfg.vocab} (padded {cfg.vocab_pad}), {cfg.param_dtype}",
          flush=True)
    rows = sorted(set(FAMILY_DENSE_ROWS) | {b * t})
    tail_views = (lambda prog: [
        ("tail wz", layer0(prog["tail"])["wz"], rows),
        ("tail wB", layer0(prog["tail"])["wB"], rows)]) if tail else \
        (lambda prog: [])
    counts, srv = serve_family(
        "[14b]", dev, zamba2, cfg, params, rram, zamba_request, {},
        rt_kw={}, ctx=0, profile_steps=profile_steps,
        views=lambda prog: [
            ("adapter in", layer0(prog["adapters_in"]), rows),
            ("attn wq", prog["shared_attn"]["attn"]["wq"], rows)]
        + tail_views(prog) + [
            ("lm_head", prog["lm_head"], FAMILY_DENSE_ROWS)])
    add(counts)
    check(all("w_tilde" not in layer0(layer0(srv.params["groups"]))[k_]
              for k_ in ("wz", "wx", "wB", "wC", "wdt", "out")),
          "[14b] a grouped mamba kernel was programmed (4-D stacks stay "
          "digital)")
    del params, srv
    free_cuda()
    recurrence_ms("[14b]", dev, cfg, scan_tokens)
    print(f"[14b] phase wall time {time.perf_counter() - t0:.2f} s",
          flush=True)
    return total


def leaf_grads(mod, params, batch, cfg, rt):
    """(loss, {path: gradient}) of ``mod.loss`` over every leaf of
    ``params`` (a leaf the loss does not reach: None)."""
    from repro_torch.models import params as PM
    from repro_torch.train.train_loop import loss_and_grads
    loss, grads = loss_and_grads(mod, params, batch, cfg, rt)
    return loss, dict(zip((p for p, _ in PM.tree_paths(params)), grads))


def train_phase(dev, *, cfg=None, batch=TRAIN_BATCH, tcfg_kw=None,
                grad_tokens=TRAIN_GRAD_TOKENS, dense_rows=TRAIN_DENSE_ROWS,
                rram=None, profile_steps=TRAIN_PROFILE_STEPS):
    """[15] training on one card: [15a] qwen3-1.7b at its published widths
    and depth trained by ``Trainer.run`` (float32, TF32 off), its step
    time, rate, busy share and peak memory, a save and a bit-for-bit
    restore into a Trainer built from other weights; [15b] the gradient of
    ``TRAIN_GRAD_LAYERS`` of its layers on the card against the host's
    CPU; [15c] the analog dense's gradient through the kernels against
    plain autograd, and the programmed ``TRAIN_GRAD_LAYERS``-layer model's
    backward, counted.  ``cfg`` replaces the model and the sizes shrink,
    so that the phase can be rehearsed on the CPU.  Returns the main path's
    launch counts ([15c]'s backward through the programmed model)."""
    import gc
    import tempfile
    from repro_torch.analysis.roofline import HW
    from repro_torch import kernels
    from repro_torch.analysis import model_flops
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import (SHAPES, RRAMBackendConfig,
                                          TrainConfig)
    from repro_torch.data import Prefetcher, batches, synthetic_batch
    from repro_torch.distributed import CheckpointManager
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import Runtime, dense, dense_plain
    from repro_torch.models.rram import program_rram
    from repro_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if cfg is None:
        cfg = dataclasses.replace(get_arch(TRAIN_ARCH).model,
                                  param_dtype="float32",
                                  compute_dtype="float32")
    tcfg = TrainConfig(**(TRAIN_TCFG if tcfg_kw is None else tcfg_kw))
    rram = rram or RRAMBackendConfig(enabled=True, dw_dtype="float32")
    gib = 2.0 ** 30
    b, t = batch
    tokens = b * t
    free_cuda()

    # ---- [15a] the full model trained on one card
    t0 = time.perf_counter()
    params = PM.materialize(tf.init_specs(cfg), LM_SEED,
                            dtype=PM.torch_dtype(cfg.param_dtype), device=dev)
    n_all = sum(p.numel() for _, p in PM.tree_paths(params))
    n_embed = params["embed"].numel()
    n_layers = sum(p.numel() for _, p in PM.tree_paths(params["layers"]))
    n_ne = n_all - n_embed
    p_bytes = sum(p.numel() * p.element_size()
                  for _, p in PM.tree_paths(params))
    tmp = tempfile.TemporaryDirectory(prefix="train_phase_")
    trainer = Trainer(tf, cfg, tcfg, params, rt=Runtime(),
                      ckpt=CheckpointManager(tmp.name, keep_n=1),
                      ckpt_every=10 ** 9)
    data = Prefetcher(batches(cfg, b, t), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    init_s = time.perf_counter() - t0
    hist = trainer.run(data, TRAIN_STEPS)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    losses, norms = hist["loss"], hist["grad_norm"]
    print(f"[15a] {cfg.n_layers} layers, d_model {cfg.d_model}, {n_all / 1e9:.4f} "
          f"G parameters ({n_ne / 1e9:.4f} G outside the embedding, "
          f"{p_bytes / 1e9:.3f} GB), {cfg.param_dtype}, TF32 off; "
          f"materialized + AdamW state in {init_s:.2f} s; {TRAIN_STEPS} steps "
          f"of {b} x {t} tokens, microbatch {tcfg.microbatch}, remat "
          f"{tcfg.remat}, lr {tcfg.lr:g} (warmup {tcfg.warmup_steps} of "
          f"{tcfg.total_steps}); losses "
          + " ".join(f"{v:.4f}" for v in losses) + "; grad norms "
          + " ".join(f"{v:.3f}" for v in norms), flush=True)
    check(all(math.isfinite(v) for v in losses + norms),
          "[15a] a loss or grad norm is not finite")
    check(min(losses[-3:]) < losses[0],
          f"[15a] the last three losses {losses[-3:]} are not under the "
          f"first {losses[0]:.4f}")
    step_s = statistics.median(hist["step_time"][2:])
    flops = 6 * n_ne * tokens + 2 * n_layers * tokens
    tflops = flops / step_s / 1e12
    print(f"[15a] a step (median of steps 3-{TRAIN_STEPS}): "
          f"{step_s * 1e3:.1f} ms (first {hist['step_time'][0] * 1e3:.1f}, "
          f"min {min(hist['step_time'][2:]) * 1e3:.1f}, max "
          f"{max(hist['step_time'][2:]) * 1e3:.1f}); {tokens / step_s:.1f} "
          f"tokens/s; model {tflops:.2f} TFLOP/s ({flops / 1e12:.3f} TFLOP "
          f"a step: 6 x {n_ne / 1e9:.4f} G x {tokens} + the remat forward "
          f"2 x {n_layers / 1e9:.4f} G x {tokens}, attention's score "
          f"products left out) = {tflops * 1e12 / HW['peak_flops']:.3f} of "
          f"the {HW['peak_flops'] / 1e12:.0f} TFLOP/s fp32 peak", flush=True)
    # The analysis package's count over shapes alone, and its train_4k FLOPs
    # a token beside the hand count: they differ by the embedding's
    # 6 n_embed (gathered, left out above), the attention term 3 x 4 L H Dh
    # (S / 2) (left out above) and less the remat forward 2 n_layers (not
    # in model_flops).
    arch = dataclasses.replace(get_arch(TRAIN_ARCH), model=cfg)
    mf = model_flops.model_flops(arch, "train_4k")
    per_tok, hand = mf["model_flops"] / mf["tokens"], flops / tokens
    s_kv = min(SHAPES["train_4k"].seq_len, cfg.swa_window
               or SHAPES["train_4k"].seq_len) / 2
    attn = 12.0 * (cfg.n_layers + cfg.n_enc_layers) * cfg.n_heads \
        * cfg.d_head * s_kv
    gap = 6 * n_embed + attn - 2 * n_layers
    print(f"[15a] analysis.model_flops: param_count {mf['params']} (the "
          f"materialized model {n_all}); train_4k {per_tok / 1e9:.4f} GFLOP "
          f"a token against the hand count's {hand / 1e9:.4f}: the "
          f"difference {(per_tok - hand) / 1e9:.4f} G = 6 n_embed "
          f"{6 * n_embed / 1e9:.4f} + attention {attn / 1e9:.4f} (S_kv "
          f"{s_kv:g}) - the remat forward {2 * n_layers / 1e9:.4f}",
          flush=True)
    check(model_flops.param_count(arch) == mf["params"] == n_all,
          "[15a] analysis.model_flops.param_count is not the model's count")
    check(abs(per_tok - hand - gap) <= 1e-12 * per_tok,
          "[15a] model_flops and the hand count differ by other than the "
          "embedding, the attention term and the remat forward")
    print(f"[15a] peak memory {peak / gib:.2f} GiB (held at the start "
          f"{start_bytes / gib:.2f}; predicted "
          f"{TRAIN_PEAK_PREDICTED_GIB[0]:.0f}-{TRAIN_PEAK_PREDICTED_GIB[1]:.0f}"
          f": parameters, gradients, m, v and accumulators 5 x "
          f"{p_bytes / 1e9:.2f} GB + the layers' unstacked gradients "
          f"{n_layers * 4 / 1e9:.2f} GB + activations)", flush=True)

    # Device busy against wall: the profiler over ``profile_steps`` steps
    # (one warm-up step first) against the unprofiled median.
    split = kernel_split(lambda: trainer.run(data, 1), iters=profile_steps)
    busy = sum(split.values())
    top = sorted(split.items(), key=lambda kv: -kv[1])[:6]
    print(f"[15a] a step's device busy {busy:.1f} ms against {step_s * 1e3:.1f}"
          f" wall: busy share {busy / (step_s * 1e3):.3f} ({profile_steps} "
          f"profiled steps); the largest: " + ", ".join(
              f"{short_kernel_name(k)} {v:.1f}" for k, v in top), flush=True)

    # Save, then restore into a Trainer built from other weights.
    t0 = time.perf_counter()
    trainer.save(blocking=True)
    save_s = time.perf_counter() - t0
    data.stop()
    other = PM.materialize(tf.init_specs(cfg), TRAIN_RESTORE_SEED,
                           dtype=PM.torch_dtype(cfg.param_dtype), device=dev)
    fresh = Trainer(tf, cfg, tcfg, other, rt=Runtime(),
                    ckpt=CheckpointManager(tmp.name, keep_n=1))
    del other
    t0 = time.perf_counter()
    fresh.restore()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    pairs = [(a, c) for tree in ("params", "m", "v")
             for (_, a), (_, c) in zip(
                 PM.tree_paths(trainer.params if tree == "params"
                               else getattr(trainer.opt_state, tree)),
                 PM.tree_paths(fresh.params if tree == "params"
                               else getattr(fresh.opt_state, tree)))]
    same = all(torch.equal(a, c) for a, c in pairs) and torch.equal(
        trainer.opt_state.count, fresh.opt_state.count)
    print(f"[15a] save (blocking) {save_s:.2f} s, restore {restore_s:.2f} s "
          f"({3 * p_bytes / 1e9:.2f} GB); step {fresh.step} restored into a "
          f"Trainer from seed-{TRAIN_RESTORE_SEED} weights: parameters, m, v "
          f"and count equal bit for bit: {same}", flush=True)
    check(same and fresh.step == trainer.step,
          "[15a] the restored state differs from the saved one")
    del trainer, fresh, pairs, data, params
    tmp.cleanup()
    gc.collect()
    free_cuda()

    # ---- [15b] the gradient on the card against the host's CPU
    small = dataclasses.replace(cfg, n_layers=TRAIN_GRAD_LAYERS)
    params = PM.materialize(tf.init_specs(small), LM_SEED,
                            dtype=PM.torch_dtype(small.param_dtype),
                            device=dev)
    host = PM.tree_map(lambda a: a.detach().cpu(), params)
    sb = synthetic_batch(small, 1, grad_tokens, step=0)
    t0 = time.perf_counter()
    loss, grads = leaf_grads(tf, params, {k: torch.from_numpy(v).to(dev)
                                          for k, v in sb.items()}, small,
                             Runtime(remat="block"))
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_h, grads_h = leaf_grads(tf, host, {k: torch.from_numpy(v)
                                            for k, v in sb.items()}, small,
                                 Runtime(remat="block"))
    host_s = time.perf_counter() - t0
    loss_err = abs(float(loss) - float(loss_h)) / abs(float(loss_h))
    errs = {p: rel_l2(g.cpu(), grads_h[p]) for p, g in grads.items()}
    worst = max(errs.items(), key=lambda kv: kv[1])
    print(f"[15b] {TRAIN_GRAD_LAYERS} layers at full width on 1 x "
          f"{grad_tokens} tokens: loss {float(loss):.6f} on the card, "
          f"{float(loss_h):.6f} on the CPU (rel {loss_err:.2e}); "
          f"{len(errs)} gradient leaves, the worst rel-L2 {worst[1]:.2e} "
          f"({worst[0]}); loss + gradient {dev_s * 1e3:.1f} ms on the card, "
          f"{host_s * 1e3:.1f} ms on the CPU", flush=True)
    check(loss_err <= TRAIN_LOSS_TOL and worst[1] <= TRAIN_GRAD_TOL,
          f"[15b] the card's loss ({loss_err:.2e}) or gradient ({worst}) is "
          f"off the CPU's")
    del host, grads_h

    # ---- [15c] the analog dense's gradient on the card
    rram_chk = dataclasses.replace(rram, lam=STENCIL_CHECK_LAM)
    prog, _ = program_rram(params, rram, LM_SEED + 3)
    layer = PM.tree_map(lambda a: a[0], prog["layers"])
    views = {"wq": layer["attn"]["wq"], "wk": layer["attn"]["wk"],
             "wu": layer["mlp"]["wu"], "wd": layer["mlp"]["wd"]}
    if not cfg.tie_embeddings:
        views["lm_head"] = prog["lm_head"]
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 4)

    def dense_grads(fn, p, x, cot):
        live = [x.clone().requires_grad_(),
                p["w_tilde"].detach().clone().requires_grad_(),
                p["dw"].detach().clone().requires_grad_()]
        out = fn({"w": p["w"], "w_tilde": live[1], "dw": live[2]}, live[0],
                 Runtime(rram=rram_chk, key=LM_CHECK_KEY))
        return torch.autograd.grad(out, live, cot)

    parts = []
    for name, p in views.items():
        d_in, d_out = p["w"].shape
        errs = []
        for rows in dense_rows:
            x = torch.randn(rows, d_in, generator=gen, device=dev)
            cot = torch.randn(rows, d_out, generator=gen, device=dev)
            torch.cuda.synchronize()
            kernels.reset_launches()
            got = dense_grads(dense, p, x, cot)
            torch.cuda.synchronize()
            launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
            again = dense_grads(dense, p, x, cot)
            want = dense_grads(dense_plain, p, x, cot)
            err = max(rel_l2(a, c) for a, c in zip(got, want))
            check(err <= EC_TOL and all(torch.equal(a, c)
                                        for a, c in zip(got, again)),
                  f"[15c] the dense {d_in}->{d_out} gradient at {rows} rows: "
                  f"rel-L2 {err:.2e} against plain autograd, or not the "
                  f"same run to run")
            check(launched == {"ec_rmatmul": -(-rows // 8),
                               "stencil_denoise": 2},
                  f"[15c] the dense {d_in}->{d_out} forward + backward at "
                  f"{rows} rows launched {launched}")
            errs.append(f"{err:.1e}")
        parts.append(f"{name} {d_in}x{d_out} " + " / ".join(errs))
    print(f"[15c] the analog dense's gradients (x, w_tilde, dw; lam "
          f"{STENCIL_CHECK_LAM:g}) through AnalogProduct vs plain autograd, "
          f"worst rel-L2 at " + " / ".join(map(str, dense_rows)) + " rows: "
          + "; ".join(parts) + "; each bit for bit run to run, one "
          "ec_rmatmul per 8 rows + one stencil_denoise forward and one "
          "backward", flush=True)

    # The main path: the programmed model's loss and gradient, counted.
    pb = {k: torch.from_numpy(v).to(dev) for k, v in sb.items()}
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    loss_a, grads = leaf_grads(tf, prog, pb, small, Runtime(
        rram=rram, key=LM_DAC_KEY, remat="block"))
    torch.cuda.synchronize()
    back_s = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    reached = {p: g for p, g in grads.items() if g is not None}
    images = {p: t for p, t in PM.tree_paths(prog)
              if p.endswith("['w_tilde']")}
    n_dense = len(images)
    per_pass = sum(t.shape[0] if t.ndim == 3 else 1 for t in images.values())
    # The layers' denses run again in remat's recompute; the head's not.
    n_body = per_pass - sum(1 for t in images.values() if t.ndim == 2)
    want_ec = (per_pass + n_body) * -(-grad_tokens // 8)
    want_stencil = 2 * per_pass + n_body
    print(f"[15c] the {TRAIN_GRAD_LAYERS}-layer model programmed ([12]'s "
          f"backend, DAC on, remat block): loss {float(loss_a):.4f}, "
          f"forward + backward launches {counts} (expected {want_ec} + "
          f"{want_stencil}: {per_pass} analog denses a pass in {n_dense} "
          f"images, the {n_body} in the layers recomputed by remat; one "
          f"ec_rmatmul per 8 of {grad_tokens} rows and one stencil_denoise "
          f"a forward, one stencil_denoise a backward); {len(reached)} of "
          f"{len(grads)} leaves reached, all finite: "
          f"{all(bool(torch.isfinite(g).all()) for g in reached.values())};"
          f" forward + backward {back_s * 1e3:.1f} ms", flush=True)
    check(all(bool(torch.isfinite(g).all()) for g in reached.values()),
          "[15c] a non-finite gradient through the programmed model")
    check(all(p in reached and p.replace("['w_tilde']", "['dw']") in reached
              for p in images),
          "[15c] an image the loss reads got no gradient")
    check(counts["ec_rmatmul"] == want_ec
          and counts["stencil_denoise"] == want_stencil
          and all(v == 0 for k, v in counts.items()
                  if k not in ("ec_rmatmul", "stencil_denoise")),
          f"[15c] the launches {counts}: not one ec_rmatmul per 8 rows and "
          f"one stencil_denoise a forward (and recompute), one "
          f"stencil_denoise a backward, of each analog dense")
    del prog, params, grads, reached
    gc.collect()
    free_cuda()
    return counts


def serving_mixed_cfg(rram):
    """benchmarks/serving.py's service-quality trace: two zoo models, four
    tenants, Zipf skew (the port's types)."""
    from repro_torch.serving import (BatchingConfig, ServingConfig,
                                     TenantSpec, TrafficConfig)
    tenants = (TenantSpec("acme", "rwkv6-1.6b"),
               TenantSpec("globex", "qwen3-1.7b"),
               TenantSpec("initech", "rwkv6-1.6b"),
               TenantSpec("umbrella", "qwen3-1.7b"))
    traffic = TrafficConfig(n_requests=SERVING_MIXED_REQUESTS, rate_rps=6.0,
                            zipf_s=1.0, prompt_lens=(6, 12),
                            prompt_mix=(0.6, 0.4), decode_lens=(4, 8),
                            decode_mix=(0.6, 0.4), seed=0)
    return ServingConfig(tenants=tenants, traffic=traffic,
                         batching=BatchingConfig(**SERVING_BATCHING),
                         rram=rram, cache_capacity_bytes=1 << 23,
                         policy="write_cost", seed=0, max_len=32)


def serving_skew_cfg(policy):
    """benchmarks/serving.py's cache-pressure trace: a hot expensive tenant
    and four cold cheap ones, ``run_model=False``."""
    from repro_torch.configs.base import RRAMBackendConfig
    from repro_torch.serving import (BatchingConfig, ServingConfig,
                                     TenantSpec, TrafficConfig)
    tenants = (TenantSpec("hot", "rwkv6-1.6b"),
               TenantSpec("cold-a", "zamba2-1.2b"),
               TenantSpec("cold-b", "zamba2-1.2b"),
               TenantSpec("cold-c", "zamba2-1.2b"),
               TenantSpec("cold-d", "zamba2-1.2b"))
    traffic = TrafficConfig(n_requests=SERVING_SKEW_REQUESTS, rate_rps=2.0,
                            zipf_s=1.0, prompt_lens=(6, 12),
                            prompt_mix=(0.6, 0.4), decode_lens=(4, 8),
                            decode_mix=(0.6, 0.4), seed=0)
    return ServingConfig(tenants=tenants, traffic=traffic,
                         batching=BatchingConfig(**dict(SERVING_BATCHING,
                                                        max_batch=2)),
                         rram=RRAMBackendConfig(enabled=True),
                         cache_capacity_bytes=SERVING_SKEW_CAPACITY,
                         policy=policy, seed=0, max_len=32,
                         run_model=False)


def simulated_batches(res, batching):
    """(arch, padded batch, prompt bucket, decode bucket) of every batch a
    simulate run served, read off its records: a batch's members share
    their start on the simulated clock, and no two batches start together
    (each moves the clock on)."""
    from repro_torch.serving import bucket_for
    groups = {}
    for r in res.records:
        groups.setdefault(r.start_s, []).append(r)
    return [(g[0].arch, bucket_for(len(g), batching.batch_buckets),
             bucket_for(max(r.prompt_len for r in g), batching.prompt_buckets),
             bucket_for(max(r.decode_len for r in g), batching.decode_buckets))
            for _, g in sorted(groups.items())]


def serving_line(tag, res, wall_s) -> str:
    s = res.summary
    cache = res.cache_stats or {}
    return (f"{tag}: {s['n_requests']} requests in {s['n_batches']} batches, "
            f"{s['tokens_per_s']:.4f} tokens/s on the simulated clock, p50 "
            f"{s['p50_latency_s']:.4f} s, p99 {s['p99_latency_s']:.4f} s, "
            f"{s['joules_per_token']:.6e} J/token (exec "
            f"{s['exec_energy_j']:.6e} J, write {s['write_energy_j']:.6e} "
            f"J), padding overhead {s['padding_overhead']:.4f}, hits "
            f"{cache.get('hits', '-')}, misses {cache.get('misses', '-')}, "
            f"evictions {cache.get('evictions', '-')}, reprograms "
            f"{cache.get('reprograms', '-')}; exec dispatches "
            f"{s['exec_dispatches']}, program dispatches "
            f"{s['program_dispatches']}; wall {wall_s:.3f} s")


def simulator_phase(dev):
    """[16a] the ported simulator on ``dev`` as the reference benchmark
    defines it: the mixed trace served with the model run (every batch
    through ``Server.generate``) on the analog backend (epiram) and on the
    digital baseline, each held equal, records, summary and cache stats,
    to the same trace run without the model on the CPU; the analog run's
    launches held to its batches' analog denses (one ec_rmatmul per 8 rows
    and one stencil_denoise a dense, nothing else), the digital run's to
    none; then the skewed trace under lru and write_cost, whose write energy
    must be the lower (the benchmark's own contract).  The equality covers
    the simulator's bookkeeping only: its metrics are host arithmetic on
    shapes and hold whatever tokens the card computes.  The kernels the
    served batches launch are held to their plain versions in [2] and [12].
    Returns the analog run's launch counts."""
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RRAMBackendConfig
    from repro_torch.serving import simulate

    epiram = RRAMBackendConfig(enabled=True, device="epiram")
    runs = {}
    for name, rram in (("analog epiram", epiram), ("digital", None)):
        cfg = serving_mixed_cfg(rram)
        free_cuda()
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = simulate(cfg, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        host = simulate(dataclasses.replace(cfg, run_model=False),
                        device="cpu")
        host_wall = time.perf_counter() - t0
        print(serving_line(f"[16a] mixed trace, {name}, run_model=True on "
                           f"{dev}", res, wall), flush=True)
        print(f"[16a] the same on the CPU, run_model=False: wall "
              f"{host_wall:.3f} s; records equal {res.records == host.records}"
              f", summary equal {res.summary == host.summary}, cache stats "
              f"equal {res.cache_stats == host.cache_stats}", flush=True)
        check(res.records == host.records and res.summary == host.summary
              and res.cache_stats == host.cache_stats,
              f"[16a] {name}: the served run's metrics differ from the "
              f"CPU's run without the model")
        want = {"ec_rmatmul": 0, "stencil_denoise": 0}
        if rram is not None:
            for arch, b, t, n in simulated_batches(res, cfg.batching):
                mcfg = get_arch(arch).reduced()
                pre = analog_calls(mcfg, b, t)
                step = analog_calls(mcfg, b, 1, prefill=False)
                want["ec_rmatmul"] += ec_launches(pre) \
                    + (n - 1) * ec_launches(step)
                want["stencil_denoise"] += len(pre) + (n - 1) * len(step)
        print(f"[16a] {name}: launches "
              f"{ {k_: v for k_, v in counts.items() if v} } (expected "
              f"{ {k_: v for k_, v in want.items() if v} })", flush=True)
        check(all(counts[k_] == want.get(k_, 0) for k_ in counts),
              f"[16a] {name}: launches {counts}, expected {want}")
        runs[name] = (res, counts)
    check(runs["analog epiram"][1]["ec_rmatmul"] > 0,
          "[16a] the analog run launched no EC kernel")

    evict = {}
    for policy in ("lru", "write_cost"):
        t0 = time.perf_counter()
        res = simulate(serving_skew_cfg(policy), device=dev)
        torch.cuda.synchronize()
        print(serving_line(f"[16a] skewed trace, {policy}, run_model=False",
                           res, time.perf_counter() - t0), flush=True)
        evict[policy] = res.cache_stats["write_energy_j"]
    check(evict["write_cost"] < evict["lru"],
          f"[16a] write_cost's write energy {evict['write_cost']:.6e} J is "
          f"not below lru's {evict['lru']:.6e} J")
    free_cuda()
    return runs["analog epiram"][1]


def request_inputs(batch, vocab, dev):
    """A batch's padded prompt as the simulator builds it: each member's
    tokens drawn from its ``token_seed`` (PCG64), pad rows repeating the
    last member, int32 on ``dev``."""
    import numpy as np
    rows = [np.random.Generator(np.random.PCG64(r.token_seed))
            .integers(0, vocab, size=batch.prompt_bucket)
            for r in batch.requests]
    rows += [rows[-1]] * (batch.batch_pad - len(rows))
    return {"tokens": torch.as_tensor(np.stack(rows).astype(np.int32),
                                      device=dev)}


def cache_model():
    """[16b]'s model and backend: CACHE_ARCH at its published widths and
    depth in float32, [12]'s backend with dw in float32."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RRAMBackendConfig
    cfg = dataclasses.replace(get_arch(CACHE_ARCH).model,
                              param_dtype="float32", compute_dtype="float32")
    return cfg, RRAMBackendConfig(enabled=True, dw_dtype="float32")


def programmed_meta(cfg, rram):
    """``cfg``'s programmed tree under ``rram`` as meta tensors: the shapes,
    dtypes and bytes of its weights and image, nothing allocated."""
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as tf
    from repro_torch.models.rram import program_specs
    return PM.tree_map(
        lambda s: torch.empty(s.shape, device="meta", dtype=PM.torch_dtype(
            s.dtype or cfg.param_dtype)),
        program_specs(tf.init_specs(cfg), rram))


def cache_schedule(prog, rram, cache, build, traffic_kw):
    """[16b]'s schedule on the simulated clock, as ``simulate`` keeps it: the
    ``generate_trace`` of CACHE_REQUESTS requests over CACHE_TENANTS tenants
    of CACHE_ARCH, batched by CACHE_BATCHING, each batch's image taken
    through ``cache.get``.  ``build(tenant index, n)`` makes a tenant's n-th
    image, (server, bytes, write stats); a miss stalls the clock for its
    write latency.  Yields (batch, server, outcome, clock); once the caller
    is done with a batch, its service at the padded shapes
    (``forward_input_stats`` of ``prog``, any tree with the programmed
    shapes) moves the clock on."""
    from repro_torch.models.rram import forward_input_stats
    from repro_torch.serving import (BatchingConfig, RequestQueue,
                                     TenantSpec, TrafficConfig,
                                     generate_trace)

    tenants = tuple(TenantSpec(f"tenant-{i}", CACHE_ARCH)
                    for i in range(CACHE_TENANTS))
    index = {t_.name: i for i, t_ in enumerate(tenants)}
    queue = RequestQueue(BatchingConfig(**CACHE_BATCHING))
    for r in generate_trace(tenants, TrafficConfig(n_requests=CACHE_REQUESTS,
                                                   **traffic_kw)):
        queue.add(r)
    builds = {}

    def build_for(tenant):
        def make():
            n = builds.get(tenant, 0)
            builds[tenant] = n + 1
            return build(index[tenant], n)
        return make

    now = 0.0
    while len(queue):
        batch = queue.form_batch(now)
        if batch is None:
            now = queue.next_arrival(now)
            continue
        server, outcome = cache.get(batch.tenant, build_for(batch.tenant),
                                    now)
        now += float(outcome.write_stats.latency_s)    # 0 on a hit
        yield batch, server, outcome, now
        pre = forward_input_stats(prog, rram, batch=batch.padded_prompt_tokens)
        step = forward_input_stats(prog, rram, batch=batch.batch_pad)
        now += pre.latency_s + step.latency_s * batch.decode_bucket


def dry_cache_schedule(cfg, rram, traffic_kw):
    """:func:`cache_schedule` on shapes alone (meta tensors; nothing built
    or served): the cache's stats the card's run must give."""
    from repro_torch.models.rram import (analog_image_bytes, crossbar_cfg,
                                         programming_write_stats)
    from repro_torch.serving import ImageCache
    prog = programmed_meta(cfg, rram)
    img = analog_image_bytes(prog)
    stats = programming_write_stats(prog, crossbar_cfg(rram))
    cache = ImageCache(CACHE_IMAGES * img, "write_cost")
    for _ in cache_schedule(prog, rram, cache,
                            lambda i, n: (None, img, stats), traffic_kw):
        pass
    return cache.stats()


def image_cache_phase(dev, *, cfg=None, rram=None, traffic_kw=CACHE_TRAFFIC,
                      allocated=None, peak=None):
    """[16b] the image cache at full width: ``CACHE_TENANTS`` tenants of one
    model (by default :func:`cache_model`), one digital weight set shared by
    all, an ImageCache under write_cost with room for ``CACHE_IMAGES``
    images, :func:`cache_schedule` served batch by batch: a miss builds a
    Server under ``fold_in(fold_in(SEED, tenant), build)``, then
    ``Server.generate`` runs at the padded shape, counted against
    :func:`analog_calls`.  The cache's stats are held to
    :func:`dry_cache_schedule`'s (which must evict and reprogram), a hit to
    no programming and no bytes, each miss to the bytes of the image it
    built less those of the images it evicted (within CACHE_MEM_TOL of one
    image), the peak to the weights + CACHE_IMAGES + 1 images + the largest
    generate's activations, and the end, everything freed, to the start.
    ``allocated`` / ``peak`` default to ``torch.cuda``'s allocator counts.
    Returns the launch counts of the batches."""
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as tf
    from repro_torch.models.rram import analog_image_bytes

    allocated = allocated or torch.cuda.memory_allocated
    peak = peak or torch.cuda.max_memory_allocated
    if cfg is None:
        cfg, rram = cache_model()
    want = dry_cache_schedule(cfg, rram, traffic_kw)
    print(f"[16b] the schedule on shapes alone: {want['misses']} programs "
          f"({want['reprograms']} reprograms), {want['hits']} hits, "
          f"{want['evictions']} evictions", flush=True)
    check(want["evictions"] >= 1 and want["reprograms"] >= 1,
          "[16b] the trace neither evicts nor reprograms")
    free_cuda()
    start = allocated()
    t0 = time.perf_counter()
    params = PM.materialize(tf.init_specs(cfg), LM_SEED,
                            dtype=PM.torch_dtype(cfg.param_dtype), device=dev)
    torch.cuda.synchronize()
    w_bytes = sum(int(t_.nbytes) for _, t_ in PM.tree_paths(params))
    prog = programmed_meta(cfg, rram)
    img_bytes = analog_image_bytes(prog)
    gb = 1e9
    print(f"[16b] {CACHE_TENANTS} tenants of {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.param_dtype}: one weight set of "
          f"{w_bytes / gb:.3f} GB materialized in "
          f"{time.perf_counter() - t0:.2f} s, shared; an image (w_tilde + dw "
          f"{rram.dw_dtype}) {img_bytes / gb:.3f} GB; cache capacity "
          f"{CACHE_IMAGES} images ({CACHE_IMAGES * img_bytes / gb:.3f} GB), "
          f"write_cost; {rram.device}, k = {rram.k_iters}, {rram.cell_rows}^2 "
          f"cells, lam {rram.lam}", flush=True)
    counts, marks, stats = cache_trace_run(
        dev, cfg, rram, params, prog, img_bytes, traffic_kw, start=start,
        allocated=allocated, peak=peak)
    check(stats == want, f"[16b] the cache's stats {stats} are not the "
          f"schedule's on shapes {want}")
    bound = w_bytes + (CACHE_IMAGES + 1) * img_bytes + marks["activations"]
    print(f"[16b] peak {marks['peak'] / gb:.3f} GB over the start (builds "
          f"{marks['build_peak'] / gb:.3f}, generates "
          f"{marks['serve_peak'] / gb:.3f}) against weights + "
          f"{CACHE_IMAGES + 1} images + the largest generate's activations "
          f"({marks['activations'] / gb:.3f} GB) = {bound / gb:.3f} GB",
          flush=True)
    check(marks["peak"] <= bound, "[16b] the peak exceeds the weights + "
          f"{CACHE_IMAGES + 1} images + activations")
    del params
    free_cuda()
    end = allocated()
    print(f"[16b] everything freed: allocated {end / gb:.4f} GB against "
          f"{start / gb:.4f} GB at the start", flush=True)
    check(abs(end - start) <= CACHE_MEM_TOL * img_bytes,
          "[16b] freeing the weights, the cache and its servers did not "
          "bring the allocated bytes back to the start")
    return counts


def cache_trace_run(dev, cfg, rram, params, prog, img_bytes, traffic_kw, *,
                    start, allocated, peak):
    """[16b]'s loop (see :func:`image_cache_phase`); every tensor it makes
    is its own local, gone when it returns.  Returns (launch counts, peak
    marks, the cache's stats)."""
    import gc
    from repro_torch.core.prng import fold_in
    from repro_torch.core.write_verify import WriteStats
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import Runtime
    from repro_torch.models.rram import analog_image_bytes, strip_rram
    from repro_torch.serving import ImageCache
    from repro_torch.train.serve import Server

    cache = ImageCache(CACHE_IMAGES * img_bytes, "write_cost")
    program_s, generate_ms, total = [], [], {}
    marks = {"build_peak": 0, "serve_peak": 0, "activations": 0}
    gb = 1e9

    def build(tenant, n):
        t0 = time.perf_counter()
        srv = Server(tf, cfg, strip_rram(params), rt=Runtime(rram=rram),
                     max_len=CACHE_MAX_LEN,
                     key=fold_in(fold_in(SEED, tenant), n))
        torch.cuda.synchronize()
        program_s.append(time.perf_counter() - t0)
        return srv, analog_image_bytes(srv.params), srv.write_stats

    def mark():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return allocated()

    # ``before`` is taken as the last batch ends: nothing between then and
    # the next ``cache.get`` touches the card.  The previous batch's server
    # is dropped once the next one is taken, as in ``simulate``.
    before, programs = mark(), 0
    for i, (batch, server, outcome, now) in enumerate(
            cache_schedule(prog, rram, cache, build, traffic_kw), 1):
        gc.collect()
        torch.cuda.synchronize()
        after = allocated()
        marks["build_peak"] = max(marks["build_peak"], peak() - start)
        if outcome.hit:
            what = "hit"
            check(len(program_s) == programs
                  and outcome.write_stats == WriteStats.zero()
                  and abs(after - before) <= CACHE_MEM_TOL * img_bytes,
                  f"[16b] batch {i}: a hit programmed, or moved "
                  f"{after - before} bytes")
        else:
            new = analog_image_bytes(server.params)
            freed = before + new - after
            want = len(outcome.evicted) * img_bytes
            what = (f"{'reprogram' if outcome.reprogrammed else 'miss'}: "
                    f"programmed in {program_s[-1]:.2f} s "
                    f"({server.program_dispatches} shape buckets, write "
                    f"{outcome.write_stats.energy_j:.4e} J, "
                    f"{outcome.write_stats.latency_s:.4e} s simulated), "
                    f"evicted {list(outcome.evicted)}, allocated "
                    f"{before / gb:.3f} -> {after / gb:.3f} GB: "
                    f"{freed / gb:.4f} GB freed against {want / gb:.4f}")
            check(new == img_bytes and abs(freed - want)
                  <= CACHE_MEM_TOL * img_bytes,
                  f"[16b] batch {i}: built {new} bytes, freed {freed} "
                  f"bytes for {len(outcome.evicted)} evicted images")
        inputs = request_inputs(batch, cfg.vocab, dev)
        held = mark()
        t0 = time.perf_counter()
        out, counts, _, _ = counted_request(
            f"[16b] batch {i} ({batch.tenant}, {batch.size} requests at "
            f"{batch.batch_pad} x {batch.prompt_bucket} -> "
            f"{batch.decode_bucket})", server, cfg, inputs,
            batch.decode_bucket)
        generate_ms.append((time.perf_counter() - t0) * 1e3)
        marks["serve_peak"] = max(marks["serve_peak"], peak() - start)
        marks["activations"] = max(marks["activations"], peak() - held)
        del out
        for k_, v in counts.items():
            total[k_] = total.get(k_, 0) + v
        print(f"[16b] batch {i}: {batch.tenant}, requests "
              f"{[r.rid for r in batch.requests]}, {what}; generate "
              f"{generate_ms[-1]:.1f} ms; starts at {now:.4f} s simulated",
              flush=True)
        before, programs = mark(), len(program_s)
    marks["peak"] = max(marks["build_peak"], marks["serve_peak"])
    stats = cache.stats()
    print(f"[16b] {CACHE_REQUESTS} requests in {i} batches: "
          f"{stats['misses']} programs ({stats['reprograms']} reprograms), "
          f"{stats['hits']} hits, {stats['evictions']} evictions; program s "
          f"{[round(x, 3) for x in program_s]}, generate ms "
          f"{[round(x, 1) for x in generate_ms]}", flush=True)
    check(stats["used_bytes"] == img_bytes * len(cache.entries),
          "[16b] the cache's bytes")
    # The last batch again: its wall against the device busy time of its
    # kernels (torch.profiler), the idle share of a generate.
    n = batch.decode_bucket
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server.generate(inputs, n)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    busy = sum(kernel_split(lambda: server.generate(inputs, n),
                            iters=1).values())
    print(f"[16b] the last batch's generate again: wall {wall:.1f} ms, "
          f"device busy {busy:.1f} ms, idle share {1 - busy / wall:.3f}",
          flush=True)
    return total, marks, stats


def serving_phase(dev):
    """[16] the serving simulator on the card: [16a] then [16b].  Returns
    the launch counts of both main paths, added."""
    counts = {}
    for tag, phase in (("[16a]", simulator_phase),
                       ("[16b]", image_cache_phase)):
        t0 = time.perf_counter()
        for k_, v in phase(dev).items():
            counts[k_] = counts.get(k_, 0) + v
        print(f"{tag} wall time {time.perf_counter() - t0:.2f} s",
              flush=True)
    return counts


def analysis_phase(dev, *, n=ANALYSIS_N, geom=None):
    """[17] the reference registry's two paper-scale entries on the card
    (src/repro/analysis/pipelines.py, ``_build_virtual``, ``_build_pdhg``,
    ``_build_lstsq_virtual``): an n^2 ``resident=False`` operator from the
    banded producer (taox-hfox, k = 5, EC on, ``geom``, default 4 x 4 MCAs
    of 512^2: 1,024 capacity blocks of 2,048^2 an MVM at 65,536^2),
    programmed with nothing resident.  [17a] on a 1 x 1 mesh: ``mvm_fn`` both
    ways and ``pdhg_pipeline`` (tau = sigma = 0.1, tol 1e-4,
    ``ANALYSIS_MAXITER``); [17b] on the 2 x 4 mesh: ``lsqr_pipeline`` (tol
    1e-4, ``ANALYSIS_MAXITER``).
    Each call runs once under ``analysis.peak_bytes`` (its launches and
    producer calls counted, its wall timed) and once under
    ``analysis.max_aval_elements``; an MVM's device-busy ms comes from the
    profiler.  Checks: max elements <= n^2 / 8 and <= 4 capacity blocks,
    peak <= 12 capacity blocks, one producer call and one EC launch a block
    an MVM (none at programming), one stencil a segment, every iterate
    finite.  Returns the launches of the counted runs.  A function with
    size arguments, so that it can be rehearsed on the CPU."""
    from repro_torch import analysis, kernels, solvers
    from repro_torch.core import (CrossbarConfig, ImplicitBandedMatrix,
                                  MCAGeometry, get_device)
    from repro_torch.engine import AnalogEngine
    from repro_torch.launch import make_mesh
    geom = geom or MCAGeometry(*ANALYSIS_GEOM)
    maxiter = ANALYSIS_MAXITER
    cfg = CrossbarConfig(device=get_device("taox-hfox"), geom=geom,
                         k_iters=5, ec=True)
    cap = cfg.geom.capacity[0]
    blocks = (n // cap) ** 2
    block_elems = cap * cap
    gib = 2.0 ** 30
    imp = ImplicitBandedMatrix(n=n, cap_m=cap, cap_n=cap, seed=ANALYSIS_SEED,
                               device=dev)
    calls = [0]

    def producer(i, j):
        calls[0] += 1
        return imp.block(i, j)

    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    counts = dict.fromkeys(kernels.LAUNCHES, 0)

    def measured(tag, what, fn, args, mvms, segments, transposed):
        """``fn(*args)`` counted under ``peak_bytes``, then its largest
        tensor in a second run; the checks above, ``mvms`` forward and
        ``transposed`` transposed MVMs, ``segments`` its stencils."""
        out = []
        kernels.reset_launches()
        before = calls[0]
        t0 = time.perf_counter()
        peak = analysis.peak_bytes(lambda *a: out.append(fn(*a)), *args)
        wall = (time.perf_counter() - t0) * 1e3
        used = nonzero(kernels.LAUNCHES)
        for k_, v_ in used.items():
            counts[k_] += v_
        made = calls[0] - before
        t0 = time.perf_counter()
        elems = analysis.max_aval_elements(fn, *args)
        mode_ms = (time.perf_counter() - t0) * 1e3
        total = mvms + transposed
        want = nonzero({"ec_matmul": blocks * mvms,
                        "ec_rmatmul": blocks * transposed,
                        "stencil_denoise": segments})
        print(f"{tag} {what}: {total} MVMs ({mvms} + {transposed} "
              f"transposed) in {wall:.1f} ms = {wall / total:.1f} ms an MVM; "
              f"max elements {elems} = {elems / block_elems:.3f} capacity "
              f"blocks (n^2/8 = {n * n // 8}; its run under the dispatch "
              f"mode {mode_ms:.1f} ms); peak over the start "
              f"{peak / gib:.4f} GiB = {peak / (4 * block_elems):.2f} "
              f"capacity blocks; producer calls {made} ({blocks} an MVM); "
              f"launches {used}", flush=True)
        check(elems <= n * n // 8 and elems <= 4 * block_elems,
              f"{tag} {what}: a tensor of {elems} elements, over n^2/8 or 4 "
              f"capacity blocks")
        check(peak <= 12 * 4 * block_elems,
              f"{tag} {what}: peak above 12 capacity blocks")
        check(made == blocks * total,
              f"{tag} {what}: the producer ran other than once a block an "
              f"MVM")
        check(used == want, f"{tag} {what}: launches {used}, expected {want}")
        return out[0], wall / total

    def mvm_busy(tag, what, fn, args, wall):
        split = kernel_split(lambda: fn(*args), iters=1)
        dev_ms = sum(split.values())
        print(f"{tag} {what}, one MVM: wall {wall:.1f} ms, device busy "
              f"{dev_ms:.1f} ms (idle share {1 - dev_ms / wall:.3f})",
              flush=True)

    for tag, shape in (("[17a]", (1, 1)), ("[17b]", (2, 4))):
        R, C = shape
        mesh = make_mesh(shape, ("data", "model"), device=dev)
        eng = AnalogEngine(cfg, execution="distributed", backend="cuda",
                           mesh=mesh)
        t0 = time.perf_counter()
        A = eng.program(producer, ANALYSIS_KEY, shape=(n, n), resident=False)
        print(f"{tag} resident=False {n}^2 over {R} x {C} ({cfg.device.name}, "
              f"k = {cfg.k_iters}, {blocks} blocks of {cap}^2): programmed "
              f"in {(time.perf_counter() - t0) * 1e3:.1f} ms, image "
              f"{A.image_nbytes} B, producer calls {calls[0]}", flush=True)
        check(calls[0] == 0, f"{tag} programming called the producer")
        op = solvers.as_operator(A)
        b = torch.randn(n, 1, generator=gen, device=dev)
        zeros = torch.zeros(n, 1, device=dev)
        if shape == (1, 1):
            x = torch.randn(n, generator=gen, device=dev)
            for what, transpose in (("A @ x", False), ("A.T @ y", True)):
                fn = eng.mvm_fn(A, transpose=transpose)
                y, ms = measured(tag, what, fn, (x, ANALYSIS_KEY),
                                 0 if transpose else 1, 1, int(transpose))
                check(tuple(y.shape) == (n,) and bool(torch.isfinite(y).all()),
                      f"{tag} {what}: wrong shape or non-finite")
                mvm_busy(tag, what, fn, (x, ANALYSIS_KEY), ms)
            c = torch.rand(n, 1, generator=gen, device=dev)
            core = solvers.pdhg_pipeline(op, tau=0.1, sigma=0.1, tol=1e-4,
                                         maxiter=maxiter)
            # The steps are given: no power iteration, one MVM each way at
            # entry and one each way an iteration.
            out, _ = measured(tag, f"pdhg (maxiter {maxiter})", core,
                              (b, c, zeros, zeros, ANALYSIS_KEY),
                              1 + maxiter, 2 * (1 + maxiter), 1 + maxiter)
            x_, y_, hist, k, mvms, pi_mvms, _ = out
            check(k == maxiter and mvms == 1 + k and pi_mvms == 0,
                  f"{tag} pdhg: {k} iterations, {mvms} MVMs")
            iterates = (x_, y_, hist[:k])
        else:
            core = solvers.lsqr_pipeline(op, tol=1e-4, maxiter=maxiter)
            out, _ = measured(tag, f"lsqr (maxiter {maxiter})", core,
                              (b, zeros, ANALYSIS_KEY), 1 + maxiter,
                              (R + C) * (1 + maxiter), 1 + maxiter)
            x_, hist, k, mvms, _ = out
            check(k == maxiter and mvms == 1 + k,
                  f"{tag} lsqr: {k} iterations, {mvms} MVMs")
            iterates = (x_, hist[:k])
        print(f"{tag} the core's residuals "
              + " ".join(f"{float(v):.4e}" for v in hist[:k, 0]), flush=True)
        check(all(bool(torch.isfinite(t).all()) for t in iterates),
              f"{tag} a non-finite iterate")
        del A, op, out, iterates
        calls[0] = 0
    return counts


def invariants_phase(dev):
    """[18] every pipeline of ``repro_torch.analysis.pipelines`` at the
    scale of ``dev``'s type, once under the five audits
    (``pipelines.check_section``; on the card each virtual entry under
    ``peak_bytes`` too): each record printed as a JSON line, no violation,
    the record equal to ``INVARIANTS_torch.json``'s section for ``dev``
    (launches included on the card), and each virtual entry's peak over
    the start <= 12 capacity blocks.  Returns the launches of the audited
    runs.  Rehearsed on the CPU at the reduced scale."""
    from repro_torch import kernels
    from repro_torch.analysis import pipelines as P
    counts = dict.fromkeys(kernels.LAUNCHES, 0)
    block = 4 * P.VIRTUAL_CAP ** 2                  # bytes of one block
    for c in P.check_section(dev, json.loads(INVARIANTS.read_text()),
                             peak=dev.type == "cuda"):
        check(c.row is not None,
              f"[18] {c.name}: in the manifest, not in the registry")
        for k_, v_ in c.reports["DispatchCount"].summary["launches"].items():
            counts[k_] += v_
        print("[18] " + json.dumps(c.row, sort_keys=True), flush=True)
        ab = c.reports["AvalBound"].summary
        peak = ab.get("peak_bytes")
        print(f"[18] {c.name}: {c.seconds:.2f} s, largest {ab['max_aval']} "
              f"at {ab['at']}"
              + ("" if peak is None else f", peak over the start {peak} B "
                 f"({peak / block:.2f} capacity blocks)"), flush=True)
        check(not c.row["violations"],
              f"[18] {c.name}: violations {c.row['violations']}")
        check(not c.diff, f"[18] {c.name}: (measured, manifest) differ: "
              f"{c.diff}")
        if peak is not None:
            check(peak <= INVARIANTS_PEAK_BLOCKS * block,
                  f"[18] {c.name}: peak {peak} B over "
                  f"{INVARIANTS_PEAK_BLOCKS} capacity blocks")
    return counts


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def roofline_line(tag, what, rec, smi, extra=""):
    """One record of ``analysis.analyze_run`` as a line: its counts, terms
    and, from the card, device time, achieved and each kernel function's
    row; the card's name and power limit beside it."""
    line = (f"{tag} {what}: flops {rec['flops_per_device']:.0f}, bytes "
            f"{rec['bytes_per_device']:.0f}; bound {rec['dominant_time_s'] * 1e3:.4f} "
            f"ms ({rec['dominant']})")
    if "device_ms" in rec:
        line += (f"; device {rec['device_ms']:.4f} ms, achieved "
                 f"{rec['achieved']:.4f}; " + "; ".join(
                     f"{k} {r['calls']} calls / {r['launches']} launches "
                     f"{r['device_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
                     f"({r['bound_by']}), achieved "
                     f"{(r['achieved'] or 0.0):.4f}"
                     for k, r in rec["by_kernel"].items()))
    print(line + extra + f" | {smi}", flush=True)


def roofline_phase(dev, *, kernel_shapes=None, n=N, analysis_n=ANALYSIS_N,
                   geom=None, lm_cfg=None, rram=None, lm_requests=None,
                   lm_rt_kw=None, cpu_counts=None):
    """[19] the roofline of the main path (``analysis.analyze_run``): each
    call's flops and bytes counted in one run (each kernel function by its
    declared cost, ``kernels.cost``), its bound, and on the card its device
    time, how close it came (``achieved``) and each kernel function's
    calls, launches, device ms and bound.
      [19k] each of the ten kernel functions at its PERF.md section 6
        shape (``kernel_shapes``), repeated ``ROOFLINE_REPS`` times a run;
      [19a] phase 3's local corrected MVM (n^2, taox-hfox, DAC on), both
        directions, batch 1 and 8;
      [19b] a warm CG solve on phase 4's kind of matrix (epiram SPD n^2);
      [19c] phase 17's ``resident=False`` MVM on a 1 x 1 mesh
        (``analysis_n``^2, 1,024 blocks of 2,048^2), ``model_flops`` 4 n^2;
      [19d] phase 12's model (qwen3-1.7b at full width and depth, float32):
        a decode step at 4 rows and a 1 x 1,024 prefill, their EC bytes
        against ``ec_bytes(analog_calls(...))``.
    Checks: no ``achieved`` over 1.05; each kernel function's launches one
    a call (``[19k]``) and its declared cost that of its shapes; [19d]'s
    decode EC bytes equal to ``ec_bytes``; and, given ``cpu_counts`` (the
    CPU's counts of the same calls, ``lm_probe.py rehearse-roofline
    --full``), every flops and bytes count equal to the CPU's.  Returns the
    launches of the counted runs and the counts.  A function with size
    arguments, so that it can be rehearsed on the CPU."""
    import gc
    from repro_torch import analysis, kernels, solvers
    from repro_torch.analysis import roofline
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RRAMBackendConfig
    from repro_torch.core import (CrossbarConfig, ImplicitBandedMatrix,
                                  MCAGeometry, get_device)
    from repro_torch.core.devices import effective_sigma_py
    from repro_torch.engine import AnalogEngine
    from repro_torch.launch import make_mesh
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import Runtime
    from repro_torch.train.serve import Server

    card = dev.type == "cuda"
    kc = kernels.cost
    smi = card_line() if card else "CPU run: no device numbers"

    def sync():
        if card:
            torch.cuda.synchronize()

    def free():
        gc.collect()
        if card:
            torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(ROOFLINE_SEED)
    counts = dict.fromkeys(kernels.LAUNCHES, 0)
    got = {}

    def measure(tag, what, fn, *args, model_flops=None, extra=None):
        w0 = time.perf_counter()
        rec = analysis.analyze_run(fn, *args, model_flops=model_flops)
        wall = f"; analyze_run {time.perf_counter() - w0:.2f} s"
        got[f"{tag} {what}"] = [rec["flops_per_device"],
                                rec["bytes_per_device"]]
        roofline_line(tag, what, rec, smi,
                      (extra(rec) if extra else "") + wall)
        if card:
            check(rec["achieved"] <= ROOFLINE_MAX_ACHIEVED,
                  f"{tag} {what}: achieved {rec['achieved']:.3f}, over "
                  f"{ROOFLINE_MAX_ACHIEVED}: a count is wrong")
            for k_, r in rec["by_kernel"].items():
                counts[k_] += r["launches"]
                check(r["achieved"] is not None
                      and r["achieved"] <= ROOFLINE_MAX_ACHIEVED,
                      f"{tag} {what}: {k_} achieved {r['achieved']}")
        return rec

    # ------------------------------------------ [19k] the kernel functions
    shapes = kernel_shapes or ROOFLINE_KERNEL_SHAPES
    taox = get_device("taox-hfox")
    h = CrossbarConfig(device=taox).h
    enc = dict(sigma=effective_sigma_py(taox, 5), levels=taox.levels,
               block_k=512, block_n=512)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def operands(name, s):
        if name in ("ec_matmul", "ec_rmatmul"):
            m, k, b = s
            rows = k if name == "ec_matmul" else m
            return (rand(m, k), rand(m, k), rand(rows, b), rand(rows, b)), {}
        if name.startswith("ec_group"):
            g, m, k, b = s
            rows = k if name == "ec_group_matmul" else m
            return ((rand(g, m, k), rand(g, m, k), rand(rows, g * b),
                     rand(rows, g * b)), {})
        if name in ("stencil_denoise", "thomas_solve"):
            return (rand(*s),), {"lam": STENCIL_CHECK_LAM, "h": h}
        if name == "cg_update":
            return (*(rand(*s) for _ in range(4)),
                    torch.rand(s[1], generator=gen, device=dev)), {}
        if name == "richardson_update":
            return (*(rand(*s) for _ in range(3)),
                    torch.rand((), generator=gen, device=dev)), {}
        m, k, n_ = s
        if name == "encode_matmul":
            return (rand(m, k), rand(k, n_), rand(k, n_)), enc
        return (rand(m, k), rand(k, n_)), enc

    t0 = time.perf_counter()
    for name, s in shapes.items():
        args, kw = operands(name, s)
        reps = ROOFLINE_REPS[name]
        run = getattr(kernels, name)
        if name == "encode_matmul_rng":
            call = lambda *a: [run(ENCODE_SEED, *a, **kw)   # noqa: E731
                               for _ in range(reps)][-1]
        else:
            call = lambda *a: [run(*a, **kw)                # noqa: E731
                               for _ in range(reps)][-1]
        one = (kc.thomas_solve(*s, STENCIL_CHECK_LAM, h)
               if name == "thomas_solve" else getattr(kc, name)(*s))
        rec = measure("[19k]", f"{name} {'x'.join(map(str, s))} x {reps}",
                      call, *args)
        check(rec["flops_per_device"] == reps * one.flops
              and rec["bytes_per_device"] == reps * one.bytes,
              f"[19k] {name}: counts other than {reps} x its declared cost")
        if card:
            row = rec["by_kernel"][name]
            per = row["device_ms"] / reps
            ref = ROOFLINE_SECTION6_MS[name]
            print(f"    {name}: {per:.5f} ms a call against PERF.md section "
                  f"6's {ref:.5f} ({per / ref - 1:+.1%}: "
                  f"{'within' if abs(per / ref - 1) <= 0.1 else 'outside'} "
                  f"10 %); launches {row['launches']} for {row['calls']} "
                  f"calls | {smi}", flush=True)
            check(row["calls"] == row["launches"] == reps,
                  f"[19k] {name}: launches other than one a call")
        del args, rec
        free()
    print(f"[19k] wall {time.perf_counter() - t0:.2f} s", flush=True)

    # ------------------------------------------ [19a] the local corrected MVM
    t0 = time.perf_counter()
    cfg = CrossbarConfig(device=taox)
    A = AnalogEngine(cfg, backend="cuda", device=dev).program(rand(n, n), 1)
    for b in (1, 8):
        for what, op in (("A @ x", A), ("A.T @ y", A.T)):
            v = rand(n, b)
            name = "ec_rmatmul" if "T" in what else "ec_matmul"
            rec = measure("[19a]", f"{n}^2 {what} batch {b}",
                          lambda u, op=op: op @ u, v)
            if "by_kernel" in rec:
                want = getattr(kc, name)(n, n, b)
                row = rec["by_kernel"][name]
                check((row["flops"], row["bytes"]) == tuple(want),
                      f"[19a] {what}: {name}'s counts are not its declared "
                      f"cost")
    del A
    free()
    print(f"[19a] wall {time.perf_counter() - t0:.2f} s", flush=True)

    # ------------------------------------------------------ [19b] warm CG
    t0 = time.perf_counter()
    a = rand(n, n).div_(n)
    a = a + a.T
    a.diagonal().add_(2.0)
    b_ = torch.matmul(a, rand(n))
    A = AnalogEngine(CrossbarConfig(device=get_device("epiram")),
                     backend="cuda", device=dev).program(a, 2)
    del a
    free()
    its = []

    def solve(rhs):
        res = solvers.cg(A, rhs, tol=SOLVE_TOL, maxiter=50, backend="cuda")
        its.append(res.iterations)
        return res.x

    def cg_extra(rec):
        k_ = its[-1]
        mvms = k_ + 1
        out = (f"; {k_} iterations ({mvms} MVMs): {rec['flops_per_device'] / mvms:.0f}"
               f" flops, {rec['bytes_per_device'] / mvms:.0f} bytes an MVM")
        if "by_kernel" in rec:
            cgu = rec["by_kernel"].get("cg_update", {}).get("device_ms", 0.0)
            out += (f"; {rec['device_ms'] / mvms:.4f} ms an MVM, cg_update's "
                    f"share {cgu / rec['device_ms']:.5f}")
        return out

    measure("[19b]", f"warm CG on the {n}^2 epiram SPD image", solve, b_,
            extra=cg_extra)
    del A, b_
    free()
    print(f"[19b] wall {time.perf_counter() - t0:.2f} s", flush=True)

    # --------------------------- [19c] the 65,536^2 resident=False MVM
    t0 = time.perf_counter()
    geom = geom or MCAGeometry(*ANALYSIS_GEOM)
    vcfg = CrossbarConfig(device=taox, geom=geom, k_iters=5, ec=True)
    cap = vcfg.geom.capacity[0]
    imp = ImplicitBandedMatrix(n=analysis_n, cap_m=cap, cap_n=cap,
                               seed=ANALYSIS_SEED, device=dev)
    eng = AnalogEngine(vcfg, execution="distributed", backend="cuda",
                       mesh=make_mesh((1, 1), ("data", "model"), device=dev))
    V = eng.program(imp.block, ANALYSIS_KEY, shape=(analysis_n, analysis_n),
                    resident=False)
    fn = eng.mvm_fn(V)
    measure("[19c]", f"resident=False {analysis_n}^2 A @ x ({(analysis_n // cap) ** 2} "
            f"blocks of {cap}^2)", lambda x: fn(x, ANALYSIS_KEY),
            rand(analysis_n), model_flops=4 * analysis_n ** 2,
            extra=lambda r: (f"; useful ratio {r['useful_ratio']:.4f}, "
                             f"roofline fraction "
                             f"{r['roofline_fraction']:.4f}"))
    del V, fn, eng, imp
    free()
    print(f"[19c] wall {time.perf_counter() - t0:.2f} s", flush=True)

    # ------------------------------------------------- [19d] the LM, served
    t0 = time.perf_counter()
    if lm_cfg is None:
        lm_cfg = dataclasses.replace(get_arch(LM_ARCH).model,
                                     param_dtype="float32",
                                     compute_dtype="float32")
    rram = rram or RRAMBackendConfig(enabled=True, dw_dtype="float32")
    rt_kw = dict(LM_RT_KW if lm_rt_kw is None else lm_rt_kw)
    (b0, t0_, ml0), (b1, t1, ml1) = lm_requests or ROOFLINE_LM_REQUESTS
    params = PM.materialize(tf.init_specs(lm_cfg), LM_SEED,
                            dtype=PM.torch_dtype(lm_cfg.param_dtype),
                            device=dev)
    srv = Server(tf, lm_cfg, params, rt=Runtime(rram=rram, key=LM_DAC_KEY,
                                                 **rt_kw), max_len=ml0)
    del params
    long_srv = Server(tf, lm_cfg, srv.params, rt=srv.rt, max_len=ml1)

    def tokens(b, t, i):
        return torch.randint(0, lm_cfg.vocab, (b, t), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(LM_SEED + 10 + i))

    tok, caches = srv.prefill({"tokens": tokens(b0, t0_, 0)})
    length = caches["len"]

    def step(t):
        # Each run starts at the prefill's length: the caches' k / v are
        # written in place at the same position, their lengths anew.
        fresh = {**caches, "len": (length.clone() if torch.is_tensor(length)
                                   else list(length))}
        return srv.decode_tokens(t, fresh, 1)[0]

    sync()
    walls = []
    for _ in range(3):
        w0 = time.perf_counter()
        step(tok)
        sync()
        walls.append((time.perf_counter() - w0) * 1e3)
    wall = statistics.median(walls)
    print(f"[19d] decode step walls (unprofiled) "
          + ", ".join(f"{w:.3f}" for w in walls) + " ms", flush=True)
    dec_calls = analog_calls(lm_cfg, b0, 1, prefill=False)
    ec_b = ec_bytes(dec_calls)
    st_b = sum(kc.stencil_denoise(n_, r).bytes for _, n_, r in dec_calls)

    def dec_extra(rec):
        out = (f"; EC declared bytes {ec_b} (ec_bytes(analog_calls(cfg, "
               f"{b0}, 1, prefill=False)) = {ec_b / 1e9:.3f} GB, bound "
               f"{ec_b / roofline.HW['hbm_bw'] * 1e3:.3f} ms; with the stencils' "
               f"{st_b}: {(ec_b + st_b) / 1e9:.3f} GB, "
               f"{(ec_b + st_b) / roofline.HW['hbm_bw'] * 1e3:.3f} ms)")
        if "device_ms" in rec:
            out += (f"; step wall {wall:.3f} ms unprofiled, idle share "
                    f"{1 - rec['device_ms'] / wall:.3f}")
        return out

    rec = measure("[19d]", f"{LM_ARCH} decode step at {b0} rows", step, tok,
                  extra=dec_extra)
    if "by_kernel" in rec:
        check(rec["by_kernel"]["ec_rmatmul"]["bytes"] == ec_b,
              f"[19d] the decode step's EC bytes "
              f"{rec['by_kernel']['ec_rmatmul']['bytes']} are not {ec_b}")
    pre_calls = analog_calls(lm_cfg, b1, t1)
    pre_declared = [sum(c) for c in zip(*(kc.ec_rmatmul(m, n_, r)
                                          for m, n_, r in pre_calls))]
    pre_bound, pre_by = roofline.bound_ms(*pre_declared)
    pre_launch = ec_bytes(pre_calls)
    launch_ms = pre_launch / roofline.HW['hbm_bw'] * 1e3

    def pre_extra(rec):
        out = (f"; EC declared {pre_declared[0]} flops, {pre_declared[1]} "
               f"bytes: function bound {pre_bound:.3f} ms ({pre_by}; bytes "
               f"{pre_declared[1] / roofline.HW['hbm_bw'] * 1e3:.3f} ms), as "
               f"launched {pre_launch} bytes ({launch_ms:.3f} ms: "
               f"{pre_launch / pre_declared[1]:.2f} x, the images once per "
               f"8 rows)")
        if "by_kernel" in rec:
            ec = rec["by_kernel"]["ec_rmatmul"]
            out += (f"; EC {ec['device_ms']:.3f} ms: {ec['achieved']:.4f} of "
                    f"the function bound, {launch_ms / ec['device_ms']:.4f}"
                    f" of the launch traffic's")
        return out

    rec = measure("[19d]", f"{LM_ARCH} {b1} x {t1} prefill",
                  lambda t: long_srv.prefill({"tokens": t})[0],
                  tokens(b1, t1, 1), extra=pre_extra)
    if "by_kernel" in rec:
        check(rec["by_kernel"]["ec_rmatmul"]["bytes"] == pre_declared[1],
              "[19d] the prefill's EC bytes are not their declared cost")
    del srv, long_srv, caches, tok, rec
    free()
    print(f"[19d] wall {time.perf_counter() - t0:.2f} s", flush=True)

    print("[19] counts " + json.dumps(got), flush=True)
    if cpu_counts is not None:
        diff = {k: (got.get(k), v) for k, v in cpu_counts.items()
                if got.get(k) != v}
        check(not diff and set(got) == set(cpu_counts),
              f"[19] counts differ from the CPU's: {diff}")
        print(f"[19] all {len(got)} flops and bytes counts equal to the "
              f"CPU's of the same calls", flush=True)
    return counts


def sharded_phase(dev, *, cfg=None, rram=None, meshes=SHARDED_MESHES,
                  moe_inputs=SHARDED_MOE_INPUTS, train_cfg=None,
                  train_small=SHARDED_TRAIN_SMALL,
                  train_big=SHARDED_TRAIN_BIG, psum_shape=SHARDED_PSUM_SHAPE,
                  ring=SHARDED_RING):
    """[20] sharded execution on a mesh whose ranks all share the card
    (``make_mesh(shape, ("data", "model"), "cuda")``): [20a] a Mixtral-8x7B
    MoE layer's tree (seed LM_SEED) at its published widths programmed on
    its own ([13b]'s backend), ``moe_apply`` through the tensor-parallel
    path on each of ``meshes`` and ``moe_inputs``: 1 x 1 equal to the local
    path bit for bit with its launches, each rank's ``expert_mm`` (on views of
    its d_ff block) within EC_TOL of its plain twin, the launches exactly
    3 ceil(cap_rank / 8) ec_group_rmatmul + 3 stencil_denoise a rank, DAC
    off within LM_DIGITAL_TOL of the digital TP path, the allocator's peak
    under the local call's + one rank's share of one stack (no block
    copied), device and per-call ms against the byte bound; [20b] the
    model at SHARDED_TRAIN_LAYERS layers, digital, one train step as
    ``build_cell``'s train branch builds it (``make_runtime``,
    ``grad_shardings`` under fsdp_tp, microbatch SHARDED_TRAIN_MICRO,
    block remat) on ``train_small`` tokens without a mesh and on each
    mesh: 1 x 1 and 1 x 4 within SHARDED_TRAIN_TOL of the step without a
    mesh (loss, grad_norm, parameters), 2 x 4 -- whose MoE capacity and
    aux are per data rank -- of the step without a mesh at microbatch
    B / 2; then on ``train_big`` tokens on 2 x 4 and without a mesh, the
    dropped assignments, peak and step ms, all finite; [20c]
    ``compressed_psum`` over SHARDED_PSUM_RANKS data ranks of a
    ``psum_shape`` gradient a rank and ``ring_collective_matmul`` over
    SHARDED_RING_RANKS model ranks at ``ring``, each collective's wire
    bytes at the ring formulas.  ``cfg`` / ``rram`` / ``train_cfg`` replace
    the models, so the phase can be rehearsed on the CPU.  Returns the
    launch counts of [20a]'s counted TP calls."""
    from repro_torch import kernels
    from repro_torch.analysis import wire
    from repro_torch.analysis.roofline import bound_ms
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.configs.base import RRAMBackendConfig
    from repro_torch.distributed import compressed_psum, ring_collective_matmul
    from repro_torch.distributed.sharding import (NamedSharding, P,
                                                  param_shardings, shard)
    from repro_torch.launch import make_mesh, make_runtime
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import moe
    from repro_torch.models import params as PM
    from repro_torch.models.common import Runtime
    from repro_torch.models.rram import program_rram, strip_rram
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_loop import make_train_step

    gib = 2.0 ** 30
    smi = card_line()
    full = dataclasses.replace(get_arch(MOE_ARCH).model,
                               param_dtype="float32", compute_dtype="float32")
    cfg = cfg or full
    rram = rram or RRAMBackendConfig(enabled=True, dw_dtype="float32")
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    grids = {m: make_mesh(m, ("data", "model"), dev) for m in meshes}
    counts = dict.fromkeys(kernels.LAUNCHES, 0)

    # [20a] the MoE's tensor-parallel path.
    t0 = time.perf_counter()
    free_cuda()
    tree = PM.materialize(moe.moe_specs(cfg), LM_SEED, device=dev)
    prog, _ = program_rram(tree, rram, 7)
    digital = strip_rram(prog)
    del tree
    torch.cuda.synchronize()
    print(f"[20a] {smi}; one MoE layer's tree of {MOE_ARCH} "
          f"({e} x {d} x {f}, float32) programmed on its own in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SHARDED_SEED)
    off = dataclasses.replace(rram, encode_inputs=False)

    def rt_of(r, grid):
        return Runtime(rram=r, key=LM_DAC_KEY, mesh=grid)

    def peak_over(call):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = call()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    for b, t in moe_inputs:
        x = torch.randn(b, t, d, generator=gen, device=dev)
        kernels.reset_launches()
        (local, local_aux), local_peak = peak_over(
            lambda: moe.moe_apply(prog, x, cfg, rt_of(rram, None)))
        local_launches = dict(kernels.LAUNCHES)
        for shape, grid in grids.items():
            dsz, msz = shape
            split = b % dsz == 0
            ranks = dsz * msz
            cap = moe._capacity((b // dsz if split else b) * t, cfg)
            torch.cuda.synchronize()
            kernels.reset_launches()
            (out, aux), peak = peak_over(
                lambda: moe.moe_apply(prog, x, cfg, rt_of(rram, grid)))
            got = dict(kernels.LAUNCHES)
            for k_, v in got.items():
                counts[k_] += v
            want = {"ec_group_rmatmul": ranks * 3 * -(-cap // 8),
                    "stencil_denoise": 3 * ranks}
            check(got == {k_: want.get(k_, 0) for k_ in got},
                  f"[20a] {shape} {b} x {t}: launches {nonzero(got)}, not "
                  f"{want}")
            if shape == (1, 1):
                check(torch.equal(out, local) and torch.equal(aux, local_aux)
                      and got == local_launches,
                      f"[20a] 1 x 1 {b} x {t}: not the local path bit for "
                      f"bit, or launches {nonzero(got)} against "
                      f"{nonzero(local_launches)}")
            # Each rank's expert_mm against its plain twin on its inputs.
            seen = []
            real = moe.expert_mm

            def spy(pd, xx, rt, _real=real):
                salt = rt._salt
                y = _real(pd, xx, rt)
                seen.append((pd, xx, salt, y))
                return y

            moe.expert_mm = spy
            try:
                moe.moe_apply(prog, x, cfg, rt_of(rram, grid))
            finally:
                moe.expert_mm = real
            errs = []
            for pd, xx, salt, y in seen:
                want_y = moe.expert_mm_plain(pd, xx, Runtime(
                    rram=rram, key=LM_DAC_KEY, _salt=salt))
                errs.append(rel_l2(y, want_y))
            views = all(pd["w_tilde"].untyped_storage().data_ptr() ==
                        prog[name]["w_tilde"].untyped_storage().data_ptr()
                        for (pd, _, _, _), name in zip(
                            seen, ["wg", "wu", "wd"] * ranks))
            del seen
            check(len(errs) == 3 * ranks and max(errs) <= EC_TOL and views,
                  f"[20a] {shape} {b} x {t}: {len(errs)} expert_mm calls, "
                  f"max rel-L2 {max(errs):.2e} against the plain twin, "
                  f"views of the images {views}")
            off_out, _ = moe.moe_apply(prog, x, cfg, rt_of(off, grid))
            dig, _ = moe.moe_apply(digital, x, cfg, rt_of(None, grid))
            off_err = rel_l2(off_out, dig)
            share = e * d * (f // msz) * 4
            check(off_err <= LM_DIGITAL_TOL and bool(torch.isfinite(out).all())
                  and peak <= local_peak + share,
                  f"[20a] {shape} {b} x {t}: DAC off {off_err:.3e} from the "
                  f"digital TP path, or peak {peak / gib:.3f} GiB over the "
                  f"local call's {local_peak / gib:.3f} + one rank's share "
                  f"{share / gib:.3f} GiB")
            call = lambda: moe.moe_apply(   # noqa: E731
                prog, x, cfg, rt_of(rram, grid))
            dev_ms, call_ms = device_time_ms(call, 5), call_time_ms(call, 5)
            # moe_apply syncs with the host (bincount), so the events' time
            # is near the wall: the profiler's kernel time is the device's.
            ksplit = kernel_split(call, iters=3)
            busy = sum(ksplit.values())
            top = sorted(ksplit.items(), key=lambda kv: -kv[1])[:3]
            view = shard(prog["wg"]["w_tilde"], NamedSharding(
                grid, P(None, None, "model")))[0]
            lay = kernels.rmatmul_layout(view, view, min(cap, 8)) \
                if view.is_cuda else None
            # Each rank reads its d_ff block of the three stacks once per 8
            # capacity slots, so each data rank reads the images once.
            fm = f // msz
            nbytes = ranks * sum(
                kernels.cost.ec_launch_bytes(m_, k_, cap, transpose=True,
                                             g=e)
                for m_, k_ in ((d, fm), (d, fm), (fm, d)))
            b_ms, _ = bound_ms(0, nbytes)
            print(f"[20a] {shape[0]} x {shape[1]}, x {b} x {t} "
                  f"({'split' if split and dsz > 1 else 'whole'} batch, "
                  f"capacity {cap} a rank): launches {nonzero(got)}; "
                  f"expert_mm vs plain {min(errs):.1e}-{max(errs):.1e}; DAC "
                  f"off vs digital TP {off_err:.3e}; peak {peak / gib:.3f} "
                  f"GiB (local {local_peak / gib:.3f}); events "
                  f"{dev_ms:.3f} ms, per call {call_ms:.3f} ms, kernels "
                  f"busy {busy:.3f} ms (idle share "
                  f"{1 - busy / call_ms if call_ms else 0:.3f}; "
                  + ", ".join(f"{short_kernel_name(k_)} {v_:.3f}"
                              for k_, v_ in top)
                  + f"), byte bound {b_ms:.3f} ms ({nbytes / 1e9:.3f} GB); "
                  f"aux {float(aux):.6f}", flush=True)
            if lay is not None:
                print(layout_line(f"rank 0's wg block {tuple(view.shape)} "
                                  f"(strides {view.stride()})", lay),
                      flush=True)
            if lay is not None and msz > 1 and (b, t) == moe_inputs[0]:
                # One launch on rank 0's wg block as a view and as a
                # contiguous copy, in turns.
                dview = shard(prog["wg"]["dw"], NamedSharding(
                    grid, P(None, None, "model")))[0]
                vc, dc = view.contiguous(), dview.contiguous()
                y = torch.randn(d, e * 8, generator=gen, device=dev)
                (v_ms, _, _), (c_ms, _, _) = alternating_ms(
                    [lambda: kernels.ec_group_rmatmul(view, dview, y, y),
                     lambda: kernels.ec_group_rmatmul(vc, dc, y, y)], 10)
                print(f"[20a] ec_group_rmatmul at 8 columns a member on "
                      f"rank 0's {tuple(view.shape)} wg block: as a view "
                      f"{v_ms:.4f} ms, as a contiguous copy {c_ms:.4f} ms "
                      f"(median of 10 turns); "
                      + layout_line("contiguous copy",
                                    kernels.rmatmul_layout(vc, dc, 8))
                      .strip(), flush=True)
                del vc, dc
    del prog, digital
    print(f"[20a] phase wall time {time.perf_counter() - t0:.2f} s",
          flush=True)

    # [20b] a sharded train step, as build_cell's train branch builds it.
    t0 = time.perf_counter()
    free_cuda()
    tcfg_m = train_cfg or dataclasses.replace(full,
                                              n_layers=SHARDED_TRAIN_LAYERS)
    specs = moe.init_specs(tcfg_m)

    def params0():
        """The seed-LM_SEED parameters, materialized anew for each step
        (no pristine copy kept)."""
        return PM.materialize(specs, LM_SEED, device=dev)

    n_params = sum(math.prod(s_.shape) for _, s_ in PM.tree_paths(specs))
    tok_gen = torch.Generator(device=dev).manual_seed(SHARDED_SEED + 1)

    def batch_of(b, t):
        tok = torch.randint(0, tcfg_m.vocab, (b, t), generator=tok_gen,
                            device=dev, dtype=torch.int32)
        return {"tokens": tok, "labels": tok}

    def runtime(grid):
        if grid is not None:
            return make_runtime(grid, causal_skip=True)
        return Runtime(q_chunk=512, kv_chunk=512, causal_skip=True)

    def train_step(grid, micro, batch):
        """One step from ``params0()``: (params, metrics, ms, peak
        bytes)."""
        params = params0()
        fn = make_train_step(
            moe, tcfg_m, TrainConfig(microbatch=micro, remat="block"),
            runtime(grid), grad_shardings=None if grid is None else
            param_shardings(specs, grid, "fsdp_tp"))
        opt = adamw_init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t_ = time.perf_counter()
        params, opt, met = fn(params, opt, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t_) * 1e3
        del opt
        return params, met, ms, torch.cuda.max_memory_allocated()

    def drops(grid, batch):
        """Dropped (token, expert) assignments of one forward: each token
        group's expert counts over its capacity."""
        seen = []
        real = moe._moe_ffn_chunk

        def counting(p_, x2, c_, rt, _real=real):
            top = torch.topk((x2 @ p_["router"]["w"]).float(),
                             c_.experts_per_token, dim=-1)[1]
            n_e = torch.bincount(top.reshape(-1), minlength=c_.n_experts)
            seen.append(int((n_e - moe._capacity(x2.shape[0], c_))
                            .clamp(min=0).sum()))
            return _real(p_, x2, c_, rt)

        moe._moe_ffn_chunk = counting
        try:
            with torch.no_grad():
                moe.loss(params0(), batch, tcfg_m, runtime(grid))
        finally:
            moe._moe_ffn_chunk = real
        return sum(seen)

    def worst(params, want) -> float:
        return max(rel_l2(a, b) for (_, a), (_, b) in
                   zip(PM.tree_paths(params), PM.tree_paths(want)))

    def close(got, want) -> float:
        return max(abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
                   for k in ("loss", "grad_norm"))

    small = batch_of(*train_small)
    mb = SHARDED_TRAIN_MICRO
    train_step(None, mb, small)       # warm-up: the first step's set-up
    ref_p, ref_m, ref_ms, ref_peak = train_step(None, mb, small)
    print(f"[20b] {tcfg_m.n_layers} of {full.n_layers} layers of "
          f"{MOE_ARCH} at its published widths, digital float32, "
          f"{n_params:,} parameters; {train_small[0]} x {train_small[1]} "
          f"tokens, microbatch {mb}, block remat; no mesh: loss "
          f"{float(ref_m['loss']):.6f}, grad_norm "
          f"{float(ref_m['grad_norm']):.6f}, step {ref_ms:.1f} ms, peak "
          f"{ref_peak / gib:.2f} GiB", flush=True)
    for shape, grid in grids.items():
        if shape[0] == 1:
            want_p, want_m, what = ref_p, ref_m, f"no mesh, microbatch {mb}"
        else:
            # Capacity and aux per data rank: the step without a mesh whose
            # microbatches are the data ranks' token groups.
            want_p, want_m, _, _ = train_step(None, mb // shape[0], small)
            what = f"no mesh, microbatch {mb // shape[0]}"
        params, met, ms, peak = train_step(grid, mb, small)
        err, p_err = close(met, want_m), worst(params, want_p)
        print(f"[20b] {shape[0]} x {shape[1]}: loss {float(met['loss']):.6f}"
              f", grad_norm {float(met['grad_norm']):.6f}; against {what}: "
              f"loss / grad_norm {err:.2e}, parameters {p_err:.2e} (against"
              f" no mesh, microbatch {mb}: {close(met, ref_m):.2e}); step "
              f"{ms:.1f} ms, peak {peak / gib:.2f} GiB", flush=True)
        check(err <= SHARDED_TRAIN_TOL and p_err <= SHARDED_TRAIN_TOL,
              f"[20b] {shape}: {err:.2e} / {p_err:.2e} from {what}")
        del params, want_p
    del ref_p
    big = batch_of(*train_big)
    for shape in ((2, 4), None):
        grid = grids.get(shape) if shape else None
        if shape and grid is None:
            continue
        n_drop = drops(grid, big)
        params, met, ms, peak = train_step(grid, mb, big)
        finite = all(bool(torch.isfinite(p_).all())
                     for _, p_ in PM.tree_paths(params)) and \
            all(bool(torch.isfinite(v).all()) for v in met.values())
        del params
        print(f"[20b] {train_big[0]} x {train_big[1]} tokens, "
              f"{'2 x 4' if shape else 'no mesh'}: loss "
              f"{float(met['loss']):.6f}, grad_norm "
              f"{float(met['grad_norm']):.6f}, dropped assignments "
              f"{n_drop}, peak {peak / gib:.2f} GiB, step {ms:.1f} ms",
              flush=True)
        check(finite, f"[20b] {train_big} on {shape}: a non-finite output")
    print(f"[20b] phase wall time {time.perf_counter() - t0:.2f} s",
          flush=True)

    # [20c] the collectives at size, and their wire bytes.
    t0 = time.perf_counter()
    free_cuda()
    records = []

    def on_wire(kind, axes, tensors, grid):
        records.append(wire.collective_record(kind, axes, tensors, grid))

    n_r = SHARDED_PSUM_RANKS
    grid8 = make_mesh((n_r,), ("data",), dev)
    g = torch.randn((n_r,) + tuple(psum_shape), generator=gen, device=dev)
    xs = list(g.unbind(0))
    exact = g.sum(0)
    mesh_mod.OBSERVERS.append(on_wire)
    try:
        outs, res = compressed_psum(grid8, xs, "data")
        torch.cuda.synchronize()
        out1 = outs[0]
        del outs
        err = float((out1 - exact).abs().max() / exact.abs().max())
        scale = torch.stack([x_.abs().max() for x_ in xs]).max() / 127.0
        for r in range(n_r):
            q = torch.clamp(torch.round(xs[r] / scale), -127, 127).to(
                torch.int8)
            check(torch.equal(res[r], xs[r] - q.to(torch.float32) * scale),
                  f"[20c] rank {r}'s residual is not its input less the "
                  f"dequantised value")
            del q
        outs2, _ = compressed_psum(grid8, xs, "data", res)
        out2 = outs2[0]
        del outs2, res
        ef_err = rel_l2(out1 + out2, 2 * exact)
        plain_err = rel_l2(2 * out1, 2 * exact)
        psum_records = list(records)
        records.clear()
        del out1, out2, g, xs, exact
        free_cuda()
        m_, k_, n_ = ring
        grid4 = make_mesh((SHARDED_RING_RANKS,), ("model",), dev)
        xr = torch.randn(m_, k_, generator=gen, device=dev)
        wr = torch.randn(k_, n_, generator=gen, device=dev) / k_ ** 0.5
        ws = shard(wr, NamedSharding(grid4, P("model", None)))
        ys = ring_collective_matmul(grid4, [xr] * grid4.size, ws, "model")
        torch.cuda.synchronize()
    finally:
        mesh_mod.OBSERVERS.remove(on_wire)
    ring_records = records
    want_y = xr @ wr
    ring_err = max(rel_l2(y, want_y) for y in ys)
    ring_ms = device_time_ms(lambda: ring_collective_matmul(
        grid4, [xr] * grid4.size, ws, "model"), 5)
    mm_ms = device_time_ms(lambda: xr @ wr, 5)
    g_bytes = math.prod(psum_shape) * 4
    shard_bytes = (k_ // SHARDED_RING_RANKS) * n_ * 4
    want_psum = [("all-reduce", 4, n_r, wire.collective_wire(
                      "all-reduce", 4, n_r)),
                 ("all-reduce", g_bytes, n_r, wire.collective_wire(
                     "all-reduce", g_bytes, n_r))] * 2
    want_ring = [("collective-permute", shard_bytes, SHARDED_RING_RANKS,
                  shard_bytes)] * SHARDED_RING_RANKS
    as_rows = [(r_["op"], r_["bytes"], r_["group"], r_["wire"])
               for r_ in psum_records + ring_records]
    print(f"[20c] compressed_psum over {n_r} data ranks of "
          f"{psum_shape[0]:,} x {psum_shape[1]:,} fp32 "
          f"({g_bytes / 1e9:.3f} GB a rank): max error / max |sum| "
          f"{err:.3e} (< {SHARDED_PSUM_TOL}); two steps rel-L2 with error "
          f"feedback {ef_err:.3e}, without {plain_err:.3e}; ring "
          f"{m_} x {k_} @ {k_} x {n_} over {SHARDED_RING_RANKS} model ranks: "
          f"rel-L2 {ring_err:.2e} against x @ w, device {ring_ms:.3f} ms "
          f"(one x @ w {mm_ms:.3f} ms); wire records {as_rows}; phase "
          f"wall {time.perf_counter() - t0:.2f} s", flush=True)
    check(err < SHARDED_PSUM_TOL and ef_err < plain_err
          and ring_err <= SHARDED_TRAIN_TOL
          and as_rows == want_psum + want_ring,
          f"[20c] int8 error {err:.3e}, EF {ef_err:.3e} against "
          f"{plain_err:.3e}, ring {ring_err:.2e}, or wire records {as_rows} "
          f"against {want_psum + want_ring}")
    del ys, ws, xr, wr, want_y
    free_cuda()
    return counts


def roofline_in_own_process() -> dict:
    """[19] (``roofline_phase`` at its defaults, held to
    ``ROOFLINE_CPU_COUNTS``) in a Python process of its own, its output
    passed on line by line; returns its launches.  The earlier phases take
    many device-only profiles (``kernel_split``), after which a profile in
    the same process was seen to hold device records of earlier work and
    to miss its own (torch 2.11, NVIDIA H100 80GB HBM3): ``analyze_run``'s
    profiles need a process whose profiles are all its own."""
    root = Path(__file__).resolve().parent
    code = ("import json, sys, torch\n"
            f"sys.path[:0] = [{str(root / 'src')!r}, {str(root)!r}]\n"
            "import chip_smoke\n"
            "counts = chip_smoke.roofline_phase(\n"
            "    torch.device('cuda'),\n"
            "    cpu_counts=chip_smoke.ROOFLINE_CPU_COUNTS)\n"
            "print('[19] launches ' + json.dumps(counts), flush=True)\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=root,
                            stdout=subprocess.PIPE, text=True)
    launches = []

    def relay():
        for line in proc.stdout:
            print(line, end="", flush=True)
            if line.startswith("[19] launches "):
                launches.append(json.loads(line[len("[19] launches "):]))

    # The deadline holds while the output is read: a child that hangs with
    # its output open is killed at ROOFLINE_TIMEOUT_S all the same.
    reader = threading.Thread(target=relay, daemon=True)
    reader.start()
    try:
        rc = proc.wait(timeout=ROOFLINE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        rc = f"nothing: killed after {ROOFLINE_TIMEOUT_S} s"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=30)
    check(rc == 0 and len(launches) == 1,
          f"[19] its process exited with {rc}")
    return launches[0]


def kernel_phases():
    """Phases [1]-[11]; returns what the report needs: the nvidia-smi line,
    the kernel rows of [2], the other shapes' rows and the main paths'
    launch counts."""
    import numpy as np
    from repro_torch import kernels, solvers
    from repro_torch.analysis.roofline import HW, bound_ms
    from repro_torch.core import (CrossbarConfig, MCAGeometry,
                                  corrected_matmul, corrected_mvm, encode,
                                  get_device, rel_linf)
    from repro_torch.core import crossbar
    from repro_torch.core.matrices import (PAPER_MATRICES, make_iperturb,
                                           paper_matrix)
    from repro_torch.core.devices import effective_sigma_py
    from repro_torch.core.prng import fold_in, generator
    from repro_torch.engine import (AnalogEngine, AnalogMatrix,
                                    AnalogMatrixGroup)
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | tf32 off",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # ---------------------------------------------------------- 1. build
    t0 = time.perf_counter()
    build.library()
    print(f"[1] build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{build.build_seconds:.1f} s)", flush=True)
    ptxas = build.ptxas_report()
    for name, rep in ptxas.items():
        print(f"    {rep['source']:18s} {name:34s} {rep['registers']:3d} "
              f"registers, {rep['stack']} B stack frame, "
              f"{rep['spill_stores']} / {rep['spill_loads']} B spill stores "
              f"/ loads, {rep['smem']} B static shared memory")

    # -------------------------------------------- 2. program, kernels vs plain
    cfg = CrossbarConfig(device=get_device("taox-hfox"))
    engine = AnalogEngine(cfg, backend="cuda", device=dev)
    a = torch.randn(N, N, generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    A = engine.program(a, 1)
    torch.cuda.synchronize()
    gib = 2.0 ** 30
    print(f"[2] programmed {N} x {N} ({cfg.device.name}, "
          f"{cfg.geom.capacity[0]}^2 capacity blocks) in "
          f"{time.perf_counter() - t0:.2f} s; peak "
          f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB (A "
          f"{a.nbytes / gib:.0f} + image {A.image_nbytes / gib:.0f} GiB)",
          flush=True)
    check(A.at_pad.shape == (N, N), "unexpected padded image shape")

    # The least a separate launch takes, and the PDL kernels' 1 x 1 beside it.
    floor = launch_floor(dev, kernels, cfg.lam, cfg.h)
    floor_ms = floor["launch_floor_probe"]

    rows = {}
    for batch in (1, 8):
        x = torch.randn(N, batch, generator=gen, device=dev)
        x_t = crossbar._encode_vec(x, cfg, gen=generator(batch, dev))
        at, da = A.at_pad, A.da_pad
        m, k = at.shape
        res = {"ec_matmul": compare(
            f"ec_matmul {m}x{k} batch {batch}",
            lambda: kernels.ec_matmul(at, da, x, x_t),
            lambda: kernels.ec_matmul_plain(at, da, x, x_t), EC_TOL,
            cost=kernels.cost.ec_matmul(m, k, batch), iters=10,
            library_fn=lambda: torch.matmul(at, x) + torch.matmul(da, x_t))}
        lay = kernels.matmul_layout(at, da, batch)
        res["ec_matmul"]["layout"] = lay._asdict()
        print(layout_line(f"ec_matmul batch {batch}", lay), flush=True)
        check(lay.staged, "ec_matmul did not take the staged kernel on the "
                          "main path's image")
        p = kernels.ec_matmul(at, da, x, x_t)
        check(torch.equal(p, kernels.ec_matmul(at, da, x, x_t)),
              "ec_matmul is not the same run to run")
        for lam in (cfg.lam, STENCIL_CHECK_LAM):
            # At the engine's lam = 1e-12 the stencil term is below fp32
            # resolution; STENCIL_CHECK_LAM checks the stencil itself.
            res[f"stencil_denoise@{lam:g}"] = compare(
                f"stencil_denoise {m}x{batch} lam {lam:g}",
                lambda: kernels.stencil_denoise(p, lam, cfg.h),
                lambda: kernels.stencil_denoise_plain(p, lam, cfg.h),
                ELEMENTWISE_TOL,
                cost=kernels.cost.stencil_denoise(m, batch), iters=50)
        # Timed at the engine's lam; its error is the one at the check lam.
        res["stencil_denoise"] = res.pop(f"stencil_denoise@{cfg.lam:g}")
        checked = res.pop(f"stencil_denoise@{STENCIL_CHECK_LAM:g}")
        res["stencil_denoise"].update(
            rel_l2=checked["rel_l2"], max_abs_err=checked["max_abs_err"],
            err_lam=STENCIL_CHECK_LAM, ms_lam=cfg.lam)
        # The pair a corrected MVM launches: the EC product, then tier-2 on
        # its output (the stencil's launch may overlap the product's tail).
        pair_ms = ec_stencil_pair_ms(kernels, at, da, x, x_t, cfg.lam, cfg.h)
        res["stencil_denoise"]["pair_ms"] = pair_ms
        print(f"    EC + stencil pair {m}x{k} batch {batch}: {pair_ms:.4f} "
              f"ms (ec_matmul alone {res['ec_matmul']['ms']:.4f}, "
              f"stencil_denoise alone {res['stencil_denoise']['ms']:.5f})",
              flush=True)
        # The same image read backwards: A_tilde^T y + dA^T y_tilde.
        y = torch.randn(m, batch, generator=gen, device=dev)
        y_t = crossbar._encode_vec(y, cfg, gen=generator(100 + batch, dev))
        res["ec_rmatmul"] = compare(
            f"ec_rmatmul {m}x{k} batch {batch}",
            lambda: kernels.ec_rmatmul(at, da, y, y_t),
            lambda: kernels.ec_rmatmul_plain(at, da, y, y_t), EC_TOL,
            cost=kernels.cost.ec_rmatmul(m, k, batch), iters=10,
            library_fn=lambda: torch.matmul(at.T, y) + torch.matmul(da.T, y_t))
        lay = kernels.rmatmul_layout(at, da, batch)
        res["ec_rmatmul"]["layout"] = lay._asdict()
        print(layout_line(f"ec_rmatmul batch {batch}", lay), flush=True)
        check(lay.staged, "ec_rmatmul did not take the staged kernel on the "
                          "main path's image")
        check(torch.equal(kernels.ec_rmatmul(at, da, y, y_t),
                          kernels.ec_rmatmul(at, da, y, y_t)),
              "ec_rmatmul is not the same run to run")
        # Thomas: held to its plain version and timed at STENCIL_CHECK_LAM,
        # the lam of the main path's Thomas engines ([3t], [5], [6]; the
        # identity in fp32 at the default engine's 1e-12), and also timed
        # there and at 1e3; checked at THOMAS_CHECK_LAMS -- at 1e3 against a
        # float64 solve, where the kernel's error must stay within twice the
        # plain version's (a scan that cut a carry short misses by far
        # more) -- and bit for bit run to run.  The plain version is 2n
        # small steps from the host: timed once.  Its bytes
        # (kernels.cost.thomas_solve): p read, y written, and the
        # coefficient rows before their fixed point, the only ones the
        # kernel reads.
        head = kernels.tridiag.thomas_tail(m, STENCIL_CHECK_LAM, cfg.h)[0]
        res["thomas_solve"] = compare(
            f"thomas_solve {m}x{batch} lam {STENCIL_CHECK_LAM:g}",
            lambda: kernels.thomas_solve(p, STENCIL_CHECK_LAM, cfg.h),
            lambda: kernels.thomas_solve_plain(p, STENCIL_CHECK_LAM, cfg.h),
            ELEMENTWISE_TOL,
            cost=kernels.cost.thomas_solve(m, batch, STENCIL_CHECK_LAM, cfg.h),
            iters=50, plain_iters=1, plain_warmup=0)
        lam10, lam_big = THOMAS_CHECK_LAMS
        got = kernels.thomas_solve(p, lam10, cfg.h)
        err10 = rel_l2(got, kernels.thomas_solve_plain(p, lam10, cfg.h))
        want64 = kernels.tridiag.thomas_solve_fp64(p, lam_big, cfg.h)
        got = kernels.thomas_solve(p, lam_big, cfg.h)
        fp64_err = rel_l2(got, want64)
        fp64_err_plain = rel_l2(
            kernels.thomas_solve_plain(p, lam_big, cfg.h), want64)
        same = torch.equal(got, kernels.thomas_solve(p, lam_big, cfg.h))
        lam_ms = {f"{lam:g}": device_time_ms(
            lambda: kernels.thomas_solve(p, lam, cfg.h), 50)
            for lam in (cfg.lam, lam_big)}
        print(f"    thomas_solve {m}x{batch}: rel-L2 against plain "
              f"{err10:.2e} at lam {lam10:g}; against float64 at lam "
              f"{lam_big:g} {fp64_err:.3e} (plain {fp64_err_plain:.3e}, "
              f"ratio {fp64_err / fp64_err_plain:.3f}); bit for bit run to "
              f"run: {same}; kernel ms by lam: " + ", ".join(
                  f"{lam} {ms:.5f}" for lam, ms in lam_ms.items()),
              flush=True)
        check(err10 <= ELEMENTWISE_TOL, f"thomas_solve: rel-L2 {err10:.3e} "
              f"against its plain version at lam {lam10:g}")
        check(fp64_err <= 2 * fp64_err_plain,
              f"thomas_solve: error against float64 at lam {lam_big:g} "
              f"above twice the plain version's")
        check(same, "thomas_solve is not the same run to run")
        del got, want64
        steps = 2 * (2 * THOMAS_ROWS_PER_THREAD + THOMAS_SCAN_LEVELS)
        res["thomas_solve"].update(
            err_lam=STENCIL_CHECK_LAM, ms_lam=STENCIL_CHECK_LAM,
            lam_ms=lam_ms, rel_l2_lam10=err10, fp64_err=fp64_err,
            fp64_err_plain=fp64_err_plain, coef_head_rows=head,
            scan_steps=steps,
            scan_ms=2 * (2 * THOMAS_ROWS_PER_THREAD * 4
                         + THOMAS_SCAN_LEVELS * 30) / SM_CLOCK_HZ * 1e3,
            split_ms=kernel_split(
                lambda: kernels.thomas_solve(p, STENCIL_CHECK_LAM, cfg.h)))
        print(f"    thomas_solve {m}x{batch} per call: " + ", ".join(
            f"{short_kernel_name(key)} {ms:.4f} ms" for key, ms in
            res["thomas_solve"]["split_ms"].items()), flush=True)
        v = [torch.randn(m, batch, generator=gen, device=dev)
             for _ in range(4)]
        alpha = torch.rand(batch, generator=gen, device=dev)
        res["cg_update"] = compare(
            f"cg_update {m}x{batch}",
            lambda: kernels.cg_update(*v, alpha),
            lambda: kernels.cg_update_plain(*v, alpha), ELEMENTWISE_TOL,
            cost=kernels.cost.cg_update(m, batch), iters=50)
        omega = torch.rand((), generator=gen, device=dev)
        res["richardson_update"] = compare(
            f"richardson_update {m}x{batch}",
            lambda: kernels.richardson_update(*v[:3], omega),
            lambda: kernels.richardson_update_plain(*v[:3], omega),
            ELEMENTWISE_TOL,
            cost=kernels.cost.richardson_update(m, batch), iters=50)
        for name in ("stencil_denoise", "thomas_solve", "cg_update",
                     "richardson_update"):
            res[name]["launch_floor_ms"] = floor_ms
        for name in ("stencil_denoise", "cg_update", "richardson_update"):
            res[name]["one_by_one_ms"] = floor[name]
        rows[batch] = res
    torch.cuda.synchronize()
    tier2_shapes = tier2_phase(dev, kernels, cfg.lam, cfg.h)

    # ------------------------------------------------------- 3. serve (main)
    xs = torch.randn(N, 8, generator=gen, device=dev)
    digital = torch.matmul(a, xs)
    kernels.reset_launches()
    t0 = time.perf_counter()
    singles = torch.stack([A @ xs[:, i] for i in range(8)], dim=1)
    batched = A @ xs
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    served = dict(kernels.LAUNCHES)
    check(served["ec_matmul"] > 0 and served["stencil_denoise"] > 0,
          f"serving did not launch the MVM kernels: {served}")
    check(tuple(singles.shape) == (N, 8) and tuple(batched.shape) == (N, 8),
          "unexpected output shapes")
    check(bool(torch.isfinite(singles).all() & torch.isfinite(batched).all()),
          "non-finite MVM output")
    err_cuda = rel_l2(singles, digital)
    err_batch = rel_l2(batched, digital)
    reference = AnalogEngine(cfg, backend="reference", device=dev)
    err_ref = rel_l2(reference.mvm(A, xs), digital)
    print(f"[3] served 8 requests + 1 batch of 8 in {serve_s * 1e3:.1f} ms; "
          f"launches {served}", flush=True)
    print(f"    rel-L2 vs digital a @ x: cuda {err_cuda:.4e} (batch "
          f"{err_batch:.4e}), reference backend {err_ref:.4e}", flush=True)
    check(err_cuda < 0.1 and 0.5 < err_cuda / err_ref < 2.0,
          "cuda and reference backends disagree in accuracy")
    # With the DAC off both backends are deterministic functions of the
    # image: the kernel path must equal the plain reference pipeline.
    exact = dataclasses.replace(cfg, encode_inputs=False)
    views = [AnalogMatrix(engine=AnalogEngine(exact, backend=be, device=dev),
                          shape=A.shape, base_key=0,
                          write_stats=A.write_stats, at_pad=A.at_pad,
                          da_pad=A.da_pad) for be in ("cuda", "reference")]
    det = [h @ xs for h in views]
    det_err = rel_l2(det[0], det[1])
    print(f"    DAC off: cuda vs reference pipeline rel-L2 {det_err:.3e} "
          f"(vs digital {rel_l2(det[0], digital):.3e})", flush=True)
    check(det_err <= 1e-5, "cuda path disagrees with the reference pipeline")
    x1 = xs[:, :1].contiguous()
    mvm_ms = {be: call_time_ms(lambda: AnalogEngine(cfg, backend=be,
                                                    device=dev).mvm(A, x1), 5)
              for be in ("cuda", "reference")}
    print(f"    corrected MVM, batch 1, per call: cuda {mvm_ms['cuda']:.3f} "
          f"ms, reference {mvm_ms['reference']:.3f} ms", flush=True)
    for k_, v_ in hook_check(
            "[3]", "mvm_fn(A) vs engine.mvm (batch 8, one key)",
            lambda: engine.mvm_fn(A)(xs, HOOK_KEY),
            lambda: engine.mvm(A, xs, key=HOOK_KEY),
            {"ec_matmul": 1, "stencil_denoise": 1}).items():
        served[k_] += v_
    del digital, det, batched, singles

    # ------------------------------------- 3t. serve transposed + Thomas (main)
    ys = torch.randn(N, 8, generator=gen, device=dev)
    digital_t = torch.matmul(a.T, ys)
    # DAC off, the exact Thomas tier-2 at a lam where it is not the identity.
    thomas_cfg = dataclasses.replace(exact, denoise_method="thomas",
                                     lam=STENCIL_CHECK_LAM)
    thomas = {be: AnalogMatrix(
        engine=AnalogEngine(thomas_cfg, backend=be, device=dev),
        shape=A.shape, base_key=0, write_stats=A.write_stats,
        at_pad=A.at_pad, da_pad=A.da_pad) for be in ("cuda", "reference")}
    kernels.reset_launches()
    t0 = time.perf_counter()
    singles = torch.stack([A.T @ ys[:, i] for i in range(8)], dim=1)
    batched = A.T @ ys
    torch.cuda.synchronize()
    serve_t_s = time.perf_counter() - t0
    th_cuda = (thomas["cuda"] @ xs, thomas["cuda"].T @ ys)
    torch.cuda.synchronize()
    served_t = dict(kernels.LAUNCHES)
    check(served_t["ec_rmatmul"] > 0 and served_t["thomas_solve"] > 0,
          f"transposed serving did not launch its kernels: {served_t}")
    check(tuple(singles.shape) == (N, 8) and tuple(batched.shape) == (N, 8),
          "unexpected transposed output shapes")
    check(bool(torch.isfinite(singles).all() & torch.isfinite(batched).all()
               & torch.isfinite(th_cuda[0]).all()
               & torch.isfinite(th_cuda[1]).all()),
          "non-finite transposed MVM output")
    err_cuda = rel_l2(singles, digital_t)
    err_batch = rel_l2(batched, digital_t)
    err_ref = rel_l2(reference.rmvm(A, ys), digital_t)
    print(f"[3t] served 8 A.T @ y requests + 1 batch of 8 in "
          f"{serve_t_s * 1e3:.1f} ms; with the Thomas engine, launches "
          f"{served_t}", flush=True)
    print(f"    rel-L2 vs digital a.T @ y: cuda {err_cuda:.4e} (batch "
          f"{err_batch:.4e}), reference backend {err_ref:.4e}", flush=True)
    check(err_cuda < 0.1 and 0.5 < err_cuda / err_ref < 2.0,
          "cuda and reference backends disagree in transposed accuracy")
    det = [h.T @ ys for h in views]
    det_err = rel_l2(det[0], det[1])
    print(f"    DAC off: cuda vs reference pipeline, A.T @ y, rel-L2 "
          f"{det_err:.3e} (vs digital {rel_l2(det[0], digital_t):.3e})",
          flush=True)
    check(det_err <= 1e-5,
          "transposed cuda path disagrees with the reference pipeline")
    t0 = time.perf_counter()
    th_ref = (thomas["reference"] @ xs, thomas["reference"].T @ ys)
    torch.cuda.synchronize()
    th_ref_s = time.perf_counter() - t0
    th_err = [rel_l2(g, w) for g, w in zip(th_cuda, th_ref)]
    print(f"    DAC off, Thomas tier-2 at lam {STENCIL_CHECK_LAM:g}: cuda vs "
          f"reference pipeline rel-L2 {th_err[0]:.3e} (A @ x), "
          f"{th_err[1]:.3e} (A.T @ y); the reference pair took "
          f"{th_ref_s:.1f} s (host-loop Thomas)", flush=True)
    check(max(th_err) <= 1e-5,
          "Thomas cuda path disagrees with the reference pipeline")
    y1 = ys[:, :1].contiguous()
    rmvm_ms = {be: call_time_ms(lambda: AnalogEngine(cfg, backend=be,
                                                     device=dev).rmvm(A, y1), 5)
               for be in ("cuda", "reference")}
    print(f"    corrected A.T @ y, batch 1, per call: cuda "
          f"{rmvm_ms['cuda']:.3f} ms, reference {rmvm_ms['reference']:.3f} ms",
          flush=True)
    for k_, v_ in hook_check(
            "[3t]", "mvm_fn(A, transpose=True) vs engine.rmvm (batch 8, one "
            "key)", lambda: engine.mvm_fn(A, transpose=True)(ys, HOOK_KEY),
            lambda: engine.rmvm(A, ys, key=HOOK_KEY),
            {"ec_rmatmul": 1, "stencil_denoise": 1}).items():
        served_t[k_] += v_
    # at / da (phase 2's names for the image) go too, or the 8 GiB image
    # stays alive through every later phase.
    del A, a, at, da, digital_t, views, det, batched, singles, thomas, \
        th_cuda, th_ref
    torch.cuda.empty_cache()

    # ------------------------------------------------------- 4. solve (main)
    scfg = CrossbarConfig(device=get_device("epiram"))
    a = torch.randn(N, N, generator=gen, device=dev).div_(N)
    a = a + a.T
    a.diagonal().add_(2.0)
    x_true = torch.randn(N, generator=gen, device=dev)
    b = torch.matmul(a, x_true)
    A = AnalogEngine(scfg, backend="cuda", device=dev).program(a, 2)
    torch.cuda.empty_cache()   # ``a`` stays for [4e]'s digital checks
    # The one-MVM noise floor: a bare analog solve stalls near it, refinement
    # (digital outer residual) goes below it.
    noise_floor = rel_l2(A @ x_true, b)
    kernels.reset_launches()
    solved, results = {}, {}
    runs = (
        ("cg", lambda: solvers.cg(A, b, tol=SOLVE_TOL, maxiter=50,
                                  backend="cuda")),
        ("richardson", lambda: solvers.richardson(A, b, tol=SOLVE_TOL,
                                                  maxiter=50, backend="cuda")),
        ("bicgstab", lambda: solvers.bicgstab(A, b, tol=SOLVE_TOL,
                                              maxiter=50)),
        ("gmres", lambda: solvers.gmres(A, b, restart=GMRES_RESTART,
                                        tol=SOLVE_TOL, maxiter=100)),
        ("refine[cg]", lambda: solvers.refine(A, b, inner="cg",
                                              tol=REFINE_TOL, maxiter=20,
                                              backend="cuda")))
    print(f"[4] {N}^2 SPD image (epiram, EC on): one-MVM noise floor "
          f"rel-L2(A @ x_true, b) {noise_floor:.3e}", flush=True)
    for name, solve in runs:
        for run in ("cold", "warm"):   # cold: first use of its ops' kernels
            before = dict(kernels.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            err = rel_l2(res.x, x_true)
            led = res.ledger
            mvms = led.mvms + led.mvms_single
            used = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
            solved[name], results[name] = used, res
            print(f"[4] {name} ({run}): {res.iterations} iterations, {mvms} "
                  f"MVMs, converged={res.converged}, x err {err:.3e}, "
                  f"residual {res.final_residual:.3e}, {wall * 1e3:.1f} ms = "
                  f"{wall * 1e3 / max(res.iterations, 1):.3f} ms/iteration "
                  f"({wall * 1e3 / mvms:.3f} ms/MVM); energy: write "
                  f"{led.write_energy_j:.4e} J, iterations "
                  f"{led.iteration_energy_j:.4e} J; launches {used}",
                  flush=True)
            check(used["ec_matmul"] == mvms and used["stencil_denoise"] == mvms,
                  f"{name}: not one ec_matmul + one stencil_denoise launch "
                  f"an MVM ({mvms} MVMs): {used}")
            if name.startswith("refine"):
                print(f"    {name}: digital relative residual "
                      f"{res.final_residual:.3e} against the one-MVM noise "
                      f"floor {noise_floor:.3e}", flush=True)
                check(res.converged and res.final_residual <= REFINE_TOL
                      and res.final_residual < noise_floor,
                      f"{name} did not reach a digital residual <= "
                      f"{REFINE_TOL} below the noise floor")
            else:
                check(res.converged and err <= SOLVE_TOL,
                      f"{name} did not reach x error <= {SOLVE_TOL}")
    check(solved["cg"]["cg_update"] > 0 and
          solved["richardson"]["richardson_update"] > 0 and
          solved["refine[cg]"]["cg_update"] > 0,
          f"the solvers did not launch their update kernels: {solved}")
    solve_counts = dict(kernels.LAUNCHES)
    # The CG core at the public call's settings: the warm solve bit for bit.
    _, used = core_check(
        "[4]", "cg_pipeline(backend='cuda')",
        solvers.cg_pipeline(solvers.as_operator(A), tol=SOLVE_TOL,
                            maxiter=50, backend="cuda"),
        (b[:, None], torch.zeros(N, 1, device=dev), 0), results["cg"],
        lambda k, mvms: {"ec_matmul": mvms, "stencil_denoise": mvms,
                         "cg_update": k})
    for k_, v_ in used.items():
        solve_counts[k_] += v_
    # A CG and a Richardson step's device time (not in the tally above).
    cg_mvms, cg_step_ms, tier2_ms = cg_step(solvers, A, b)
    print(f"[4] a CG step: {cg_step_ms:.4f} ms device (the solve's kernels "
          f"over its {cg_mvms} MVMs: an MVM, its reductions and "
          f"cg_update), of which stencil_denoise + cg_update "
          f"{tier2_ms:.5f} ms", flush=True)
    rich_mvms, rich_step_ms, rich_tier2_ms = richardson_step(solvers, A, b)
    print(f"[4] a Richardson step: {rich_step_ms:.4f} ms device (the "
          f"solve's kernels over its {rich_mvms} MVMs at the estimated "
          f"omega: an MVM, its norms and richardson_update), of which "
          f"stencil_denoise + richardson_update {rich_tier2_ms:.5f} ms",
          flush=True)

    # ------------------------------------- 4e. eigen solvers on the image
    t0 = time.perf_counter()
    eigen_counts = eigen_phase(dev, A, a, b, x_true, noise_floor)
    print(f"[4e] phase wall time {time.perf_counter() - t0:.2f} s",
          flush=True)
    del A, a, b, x_true
    torch.cuda.empty_cache()

    # ------------------------------ 4r. the solver registry on the card
    t0 = time.perf_counter()
    registry_counts = registry_phase(dev)
    print(f"[4r] phase wall time {time.perf_counter() - t0:.2f} s",
          flush=True)

    # ------------------------------ 5. least squares and LP (main, A.T @ y)
    def check_image(A):
        """The MVM kernels at batch 1 on a phase-5 image, with its own M, K
        and transposed layout, against their plain versions; the stencil on
        its shorter output panel; DAC off, A.T @ y against the reference."""
        at, da = A.at_pad, A.da_pad
        m, k = at.shape
        x = torch.randn(k, 1, generator=gen, device=dev)
        x_t = crossbar._encode_vec(x, scfg, gen=generator(1, dev))
        y = torch.randn(m, 1, generator=gen, device=dev)
        y_t = crossbar._encode_vec(y, scfg, gen=generator(101, dev))
        res = {"ec_matmul": compare(
            f"ec_matmul {m}x{k} batch 1",
            lambda: kernels.ec_matmul(at, da, x, x_t),
            lambda: kernels.ec_matmul_plain(at, da, x, x_t), EC_TOL,
            cost=kernels.cost.ec_matmul(m, k, 1), iters=10,
            library_fn=lambda: torch.matmul(at, x) + torch.matmul(da, x_t)),
            "ec_rmatmul": compare(
            f"ec_rmatmul {m}x{k} batch 1",
            lambda: kernels.ec_rmatmul(at, da, y, y_t),
            lambda: kernels.ec_rmatmul_plain(at, da, y, y_t), EC_TOL,
            cost=kernels.cost.ec_rmatmul(m, k, 1), iters=10,
            library_fn=lambda: torch.matmul(at.T, y) + torch.matmul(da.T, y_t))}
        for name, query in (("ec_matmul", kernels.matmul_layout),
                            ("ec_rmatmul", kernels.rmatmul_layout)):
            lay = query(at, da, 1)
            res[name]["layout"] = lay._asdict()
            print(layout_line(f"{name} {m}x{k}", lay), flush=True)
            check(lay.staged, f"{name} did not take the staged kernel on "
                              f"the {m}x{k} image")
        # DAC off, A.T @ y through the kernels equals the reference
        # pipeline, with the Neumann stencil and with Thomas at lam 1e-2.
        det_err = {}
        for label, dcfg in (("neumann", dataclasses.replace(
                scfg, encode_inputs=False)), ("thomas", dataclasses.replace(
                scfg, encode_inputs=False, denoise_method="thomas",
                lam=STENCIL_CHECK_LAM))):
            det = [AnalogMatrix(
                engine=AnalogEngine(dcfg, backend=be, device=dev),
                shape=A.shape, base_key=0, write_stats=A.write_stats,
                at_pad=at, da_pad=da).T @ y[:A.shape[0]]
                for be in ("cuda", "reference")]
            det_err[label] = rel_l2(det[0], det[1])
        print(f"    DAC off, A.T @ y: cuda vs reference pipeline rel-L2 "
              f"{det_err['neumann']:.3e} (Neumann), {det_err['thomas']:.3e} "
              f"(Thomas at lam {STENCIL_CHECK_LAM:g})", flush=True)
        check(max(det_err.values()) <= 1e-5,
              f"transposed cuda path disagrees with the reference pipeline "
              f"on the {m}x{k} image")
        p = (kernels.ec_matmul(at, da, x, x_t) if m < k
             else kernels.ec_rmatmul(at, da, y, y_t))
        res["stencil_denoise"] = compare(
            f"stencil_denoise {p.shape[0]}x1 lam {STENCIL_CHECK_LAM:g}",
            lambda: kernels.stencil_denoise(p, STENCIL_CHECK_LAM, scfg.h),
            lambda: kernels.stencil_denoise_plain(p, STENCIL_CHECK_LAM,
                                                  scfg.h),
            ELEMENTWISE_TOL,
            cost=kernels.cost.stencil_denoise(p.shape[0], 1), iters=50)
        res["stencil_denoise"].update(err_lam=STENCIL_CHECK_LAM,
                                      ms_lam=STENCIL_CHECK_LAM)
        for row in res.values():
            row.update(shape=f"{m}x{k}", batch=1)
        return res

    more_shapes = list(tier2_shapes)
    m, n = LSTSQ_SHAPE
    a = torch.randn(m, n, generator=gen, device=dev).div_(m ** 0.5)
    x_true = torch.randn(n, generator=gen, device=dev)
    b = torch.matmul(a, x_true)
    # kappa of a Gaussian m x n matrix: (1 + sqrt(n/m)) / (1 - sqrt(n/m))
    kappa = (1 + (n / m) ** 0.5) / (1 - (n / m) ** 0.5)
    A = AnalogEngine(scfg, backend="cuda", device=dev).program(a, 3)
    torch.cuda.empty_cache()   # ``a`` stays for [5e]'s digital checks
    print(f"[5] {m}x{n} image: kernels vs plain", flush=True)
    more_shapes.append(check_image(A))
    kernels.reset_launches()
    for name in ("lsqr", "lsmr"):
        for run in ("cold", "warm"):
            before = dict(kernels.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = getattr(solvers, name)(A, b, tol=SOLVE_TOL, maxiter=200)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            err = rel_l2(res.x, x_true)
            led = res.ledger
            used = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
            print(f"[5] {name} ({run}) {m}x{n}: {res.iterations} iterations, "
                  f"{led.mvms} + {led.mvms_t} transposed MVMs, normal "
                  f"residual {res.final_residual:.3e}, converged="
                  f"{res.converged}, x err {err:.3e} (bound kappa^2 tol = "
                  f"{kappa ** 2 * SOLVE_TOL:.2e}), {wall * 1e3:.1f} ms = "
                  f"{wall * 1e3 / max(res.iterations, 1):.3f} ms/iteration; "
                  f"launches {used}", flush=True)
            check(res.converged and bool(torch.isfinite(res.x).all()),
                  f"{name} did not reach normal residual <= {SOLVE_TOL}")
            check(err <= kappa ** 2 * SOLVE_TOL,
                  f"{name}: x error {err:.3e} above kappa^2 tol")
            check(used["ec_rmatmul"] == led.mvms_t,
                  f"{name} did not run every A.T @ u through ec_rmatmul")
        # The core at the public call's settings: the warm solve bit for bit.
        core_check(
            "[5]", f"{name}_pipeline",
            getattr(solvers, f"{name}_pipeline")(
                solvers.as_operator(A), tol=SOLVE_TOL, maxiter=200),
            (b[:, None], torch.zeros(n, 1, device=dev), 0), res,
            lambda k, mvms: {"ec_matmul": mvms, "ec_rmatmul": mvms,
                             "stencil_denoise": 2 * mvms})
    lstsq_counts = dict(kernels.LAUNCHES)

    # ------------------------------- 5e. ||A||_2 of the least-squares image
    t0 = time.perf_counter()
    norm_counts = operator_norm_phase(dev, A, a, b, x_true)
    print(f"[5e] phase wall time {time.perf_counter() - t0:.2f} s",
          flush=True)

    # ------------------------- 5q. a box QP by ADMM on the same image
    t0 = time.perf_counter()
    admm_counts = admm_phase(dev, A, a)
    print(f"[5q] phase wall time {time.perf_counter() - t0:.2f} s",
          flush=True)
    del A, a, b, x_true
    torch.cuda.empty_cache()

    m, n = LP_SHAPE
    a, b, c, x_star, y_star = solvers.random_feasible_lp(SEED, m, n,
                                                         device=dev)
    obj = float(torch.dot(c, x_star))
    A = AnalogEngine(scfg, backend="cuda", device=dev).program(a, 4)
    del a
    torch.cuda.empty_cache()
    print(f"[5] {m}x{n} image: kernels vs plain", flush=True)
    more_shapes.append(check_image(A))
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solvers.pdhg(A, b, c, tol=SOLVE_TOL, maxiter=PDHG_MAXITER)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    led = res.ledger
    lp_counts = dict(kernels.LAUNCHES)
    gap = abs(float(torch.dot(c, res.x)) - obj) / (1 + abs(obj))
    print(f"[5] pdhg {m}x{n}: {res.iterations} iterations, {led.mvms} + "
          f"{led.mvms_t} transposed MVMs (+ {led.mvms_single} + "
          f"{led.mvms_single_t} power-iteration), KKT "
          f"{res.final_residual:.3e}, converged={res.converged}, objective "
          f"gap vs c'x* {gap:.3e}, {wall:.2f} s = "
          f"{wall * 1e3 / max(res.iterations, 1):.3f} ms/iteration; "
          f"launches {lp_counts}", flush=True)
    check(res.converged and bool(torch.isfinite(res.x).all()),
          f"pdhg did not reach KKT <= {SOLVE_TOL} in {PDHG_MAXITER} "
          f"iterations")
    check(lp_counts["ec_rmatmul"] == led.mvms_t + led.mvms_single_t,
          "pdhg did not run every A.T @ y through ec_rmatmul")
    # The core at the public call's settings (power-iteration steps
    # included): the solve bit for bit, its dual too.
    out, used = core_check(
        "[5]", "pdhg_pipeline", solvers.pdhg_pipeline(
            solvers.as_operator(A), tol=SOLVE_TOL, maxiter=PDHG_MAXITER),
        (b[:, None], c[:, None], torch.zeros(n, 1, device=dev),
         torch.zeros(m, 1, device=dev), 0), res,
        lambda k, mvms: {"ec_matmul": mvms + led.mvms_single,
                         "ec_rmatmul": mvms + led.mvms_single_t,
                         "stencil_denoise": 2 * mvms + led.mvms_single
                         + led.mvms_single_t})
    check(torch.equal(out[1][:, 0], res.dual) and out[5] == led.mvms_single,
          "[5] pdhg_pipeline's dual or power steps differ from pdhg's")
    for k_, v_ in used.items():
        lp_counts[k_] += v_
    del out
    del A, b, c, x_star, y_star
    torch.cuda.synchronize()

    torch.cuda.empty_cache()

    # ---------------------------- 6. Mixtral-8x7B expert group (main, groups)
    def group_view(G, gcfg, backend):
        """The same stacks under another engine configuration / backend."""
        return AnalogMatrixGroup(
            engine=AnalogEngine(gcfg, backend=backend, device=dev),
            size=G.size, shape=G.shape, base_key=G.base_key,
            member_keys=G.member_keys, write_stats=G.write_stats,
            at_pad=G.at_pad, da_pad=G.da_pad)

    geng = AnalogEngine(cfg, backend="cuda", device=dev)
    gref = AnalogEngine(cfg, backend="reference", device=dev)
    w1 = torch.randn(N_EXPERTS, D_FF, D_MODEL, generator=gen,
                     device=dev).div_(D_MODEL ** 0.5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    G = geng.program_group(w1, 5)
    torch.cuda.synchronize()
    print(f"[6] programmed {N_EXPERTS} experts' w1 ({D_FF} x {D_MODEL}) as "
          f"one group in {time.perf_counter() - t0:.2f} s; stacks "
          f"{tuple(G.at_pad.shape)}, {G.image_nbytes / 1e9:.3f} GB; peak "
          f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB (A "
          f"{w1.nbytes / gib:.2f} GiB)", flush=True)
    g_, mp, np_ = G.at_pad.shape
    check((g_, mp, np_) == (N_EXPERTS, 16384, D_MODEL),
          "unexpected group stack shape")
    # A group call hands the kernels the live (14,336, 4,096) view of each
    # member (the padding is zeros), so they and the bound read real rows.
    mr = D_FF
    check(not (G.at_pad[:, mr:].any() or G.da_pad[:, mr:].any()),
          "the padding rows of the group stacks are not zero")
    at, da = G.at_pad[:, :mr], G.da_pad[:, :mr]
    for batch in (1, 8):
        x = torch.randn(np_, g_ * batch, generator=gen, device=dev)
        x_t = crossbar._encode_vec(x, cfg, gen=generator(200 + batch, dev))
        y = torch.randn(mr, g_ * batch, generator=gen, device=dev)
        y_t = crossbar._encode_vec(y, cfg, gen=generator(300 + batch, dev))

        def members(u):    # (rows, g * b) panel -> (g, rows, b) for bmm
            return u.view(u.shape[0], g_, batch).permute(1, 0, 2)

        rows[batch]["ec_group_matmul"] = compare(
            f"ec_group_matmul {g_}x{mr}x{np_} batch {batch}",
            lambda: kernels.ec_group_matmul(at, da, x, x_t),
            lambda: kernels.ec_group_matmul_plain(at, da, x, x_t), EC_TOL,
            cost=kernels.cost.ec_group_matmul(g_, mr, np_, batch),
            iters=10,
            library_fn=lambda: torch.bmm(at, members(x))
            + torch.bmm(da, members(x_t)))
        rows[batch]["ec_group_rmatmul"] = compare(
            f"ec_group_rmatmul {g_}x{mr}x{np_} batch {batch}",
            lambda: kernels.ec_group_rmatmul(at, da, y, y_t),
            lambda: kernels.ec_group_rmatmul_plain(at, da, y, y_t), EC_TOL,
            cost=kernels.cost.ec_group_rmatmul(g_, mr, np_, batch),
            iters=10,
            library_fn=lambda: torch.bmm(at.transpose(1, 2), members(y))
            + torch.bmm(da.transpose(1, 2), members(y_t)))
        for name in ("ec_group_matmul", "ec_group_rmatmul"):
            rows[batch][name]["shape"] = f"{g_}x{mr}x{np_} (of {mp})"
        for name, query in (("ec_group_matmul", kernels.matmul_layout),
                            ("ec_group_rmatmul", kernels.rmatmul_layout)):
            lay = query(at, da, batch)
            rows[batch][name]["layout"] = lay._asdict()
            print(layout_line(f"{name} batch {batch}", lay), flush=True)
            check(lay.staged, f"{name} did not take the staged kernel on "
                              f"the group's live views")
        # A group of one is the solo call, bit for bit.
        u, u_t = x[:, :batch].contiguous(), x_t[:, :batch].contiguous()
        check(torch.equal(kernels.ec_group_matmul(at[:1], da[:1], u, u_t),
                          kernels.ec_matmul(at[0], da[0], u, u_t)),
              "ec_group_matmul on one member differs from ec_matmul")
        v, v_t = y[:, :batch].contiguous(), y_t[:, :batch].contiguous()
        check(torch.equal(kernels.ec_group_rmatmul(at[:1], da[:1], v, v_t),
                          kernels.ec_rmatmul(at[0], da[0], v, v_t)),
              "ec_group_rmatmul on one member differs from ec_rmatmul")
        del x, x_t, y, y_t, u, u_t, v, v_t
    gx = {b: torch.randn(N_EXPERTS, D_MODEL, b, generator=gen, device=dev)
          for b in (1, 8)}
    gy = {b: torch.randn(N_EXPERTS, D_FF, b, generator=gen, device=dev)
          for b in (1, 8)}
    kernels.reset_launches()
    t0 = time.perf_counter()
    fwd = {b: G @ gx[b] for b in (1, 8)}
    bwd = {b: geng.group_rmvm(G, gy[b]) for b in (1, 8)}
    torch.cuda.synchronize()
    group_s = time.perf_counter() - t0
    group_counts = dict(kernels.LAUNCHES)
    print(f"[6] 2 group_mvm + 2 group_rmvm (batch 1, 8) in "
          f"{group_s * 1e3:.1f} ms; launches {group_counts}", flush=True)
    check(group_counts["ec_group_matmul"] == 2
          and group_counts["ec_group_rmatmul"] == 2
          and group_counts["stencil_denoise"] == 4
          and sum(group_counts.values()) == 8,
          f"a group call is not one grouped EC + one tier-2 launch: "
          f"{group_counts}")
    for b in (1, 8):
        check(tuple(fwd[b].shape) == (N_EXPERTS, D_FF, b)
              and tuple(bwd[b].shape) == (N_EXPERTS, D_MODEL, b)
              and bool(torch.isfinite(fwd[b]).all()
                       & torch.isfinite(bwd[b]).all()),
              "group outputs: wrong shape or non-finite")
    digital = {b: (torch.bmm(w1, gx[b]), torch.bmm(w1.transpose(1, 2), gy[b]))
               for b in (1, 8)}
    ref_out = {b: (gref.group_mvm(G, gx[b]), gref.group_rmvm(G, gy[b]))
               for b in (1, 8)}
    for b in (1, 8):
        errs = [rel_l2(fwd[b], digital[b][0]), rel_l2(bwd[b], digital[b][1]),
                rel_l2(ref_out[b][0], digital[b][0]),
                rel_l2(ref_out[b][1], digital[b][1])]
        print(f"    batch {b}: rel-L2 vs digital bmm: cuda {errs[0]:.4e} "
              f"(A.T: {errs[1]:.4e}), reference {errs[2]:.4e} (A.T: "
              f"{errs[3]:.4e})", flush=True)
        check(max(errs[:2]) < 0.1 and 0.5 < errs[0] / errs[2] < 2.0
              and 0.5 < errs[1] / errs[3] < 2.0,
              "group cuda and reference backends disagree in accuracy")
    # Member g of a group call under key k is its solo execute under
    # fold_in(k, g): the same DAC draw, the same image.  Forward the grouped
    # kernel sums each row as the solo one does (bit for bit); transposed
    # the group's rows are cut otherwise than a member's alone (equal to
    # fp32 rounding).
    same_fwd, solo_err_t = True, 0.0
    out, out_t = geng.group_mvm(G, gx[8], key=7), geng.group_rmvm(G, gy[8],
                                                                key=7)
    for i in range(N_EXPERTS):
        k_i = fold_in(7, i)
        same_fwd &= torch.equal(out[i], geng.mvm(G.member(i), gx[8][i],
                                                 key=k_i))
        solo_err_t = max(solo_err_t, rel_l2(
            out_t[i], geng.rmvm(G.member(i), gy[8][i], key=k_i)))
    print(f"    member g vs solo member(g) under the same key: forward bit "
          f"for bit {same_fwd}, transposed max rel-L2 {solo_err_t:.3e}",
          flush=True)
    check(same_fwd and solo_err_t <= EC_TOL,
          "a group member differs from its solo execute")
    for k_, v_ in hook_check(
            "[6]", "group_mvm_fn(G) vs group_mvm (batch 8, one key)",
            lambda: geng.group_mvm_fn(G)(gx[8], HOOK_KEY),
            lambda: geng.group_mvm(G, gx[8], key=HOOK_KEY),
            {"ec_group_matmul": 1, "stencil_denoise": 1}).items():
        group_counts[k_] += v_
    det_err = {}
    for label, gcfg in (("neumann", exact), ("thomas", thomas_cfg)):
        views = [group_view(G, gcfg, be) for be in ("cuda", "reference")]
        t0 = time.perf_counter()
        det = [(h.engine.group_mvm(h, gx[8]), h.engine.group_rmvm(h, gy[8]))
               for h in views]
        torch.cuda.synchronize()
        det_err[label] = (rel_l2(det[0][0], det[1][0]),
                          rel_l2(det[0][1], det[1][1]),
                          time.perf_counter() - t0)
    print(f"    DAC off, cuda vs reference pipeline: rel-L2 "
          f"{det_err['neumann'][0]:.3e} / {det_err['neumann'][1]:.3e} "
          f"(G @ x / G.T @ y); Thomas at lam {STENCIL_CHECK_LAM:g} "
          f"{det_err['thomas'][0]:.3e} / {det_err['thomas'][1]:.3e} (the "
          f"pair took {det_err['thomas'][2]:.1f} s with the reference's "
          f"host-loop Thomas)", flush=True)
    check(max(max(e[:2]) for e in det_err.values()) <= 1e-5,
          "group cuda path disagrees with the reference pipeline")
    group_ms = {}
    for b in (1, 8):
        group_ms[b] = {
            "cuda": call_time_ms(lambda: geng.group_mvm(G, gx[b], key=1), 5),
            "cuda_t": call_time_ms(lambda: geng.group_rmvm(G, gy[b], key=1),
                                   5),
            "reference": call_time_ms(lambda: gref.group_mvm(G, gx[b], key=1),
                                      3),
            "reference_t": call_time_ms(
                lambda: gref.group_rmvm(G, gy[b], key=1), 3)}
        print(f"    per group call, batch {b}: cuda {group_ms[b]['cuda']:.3f}"
              f" ms (G.T: {group_ms[b]['cuda_t']:.3f} ms), reference "
              f"{group_ms[b]['reference']:.3f} ms (G.T: "
              f"{group_ms[b]['reference_t']:.3f} ms)", flush=True)
    for name in ("ec_group_matmul", "ec_group_rmatmul"):
        for b in (1, 8):
            rows[b][name]["group_call_ms"] = \
                group_ms[b]["cuda_t" if "rmatmul" in name else "cuda"]
    del G, w1, at, da, fwd, bwd, digital, ref_out, det, views, gx, gy, out, \
        out_t
    torch.cuda.empty_cache()

    # ------------------------ 6c. 32 chained 4,096^2 layers (main, chain_mvm)
    layers = torch.randn(N_LAYERS, D_MODEL, D_MODEL, generator=gen,
                         device=dev).mul_((2.0 / D_MODEL) ** 0.5)
    t0 = time.perf_counter()
    C = geng.program_group(layers, 6)
    torch.cuda.synchronize()
    print(f"[6c] programmed {N_LAYERS} layers of {D_MODEL}^2 in "
          f"{time.perf_counter() - t0:.2f} s ({C.image_nbytes / 1e9:.3f} GB)",
          flush=True)
    h = torch.randn(D_MODEL, 1, generator=gen, device=dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    chained = geng.chain_mvm(C, h, activation="relu")
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    chain_counts = dict(kernels.LAUNCHES)
    want = h
    for g in range(N_LAYERS):
        want = torch.relu(torch.matmul(layers[g], want))
    chain_ref = gref.chain_mvm(C, h, activation="relu")
    views = [group_view(C, exact, be) for be in ("cuda", "reference")]
    det = [v.engine.chain_mvm(v, h, activation="relu", key=3) for v in views]
    chain_det = rel_l2(det[0], det[1])
    chain_ms = {"cuda": call_time_ms(
        lambda: geng.chain_mvm(C, h, activation="relu", key=1), 3),
        "reference": call_time_ms(
        lambda: gref.chain_mvm(C, h, activation="relu", key=1), 3)}
    print(f"[6c] chain of {N_LAYERS} (relu, batch 1): {chain_s * 1e3:.1f} ms "
          f"cold, {chain_ms['cuda']:.3f} ms per chain warm (reference "
          f"{chain_ms['reference']:.3f} ms); launches {chain_counts}; rel-L2 "
          f"vs digital: cuda {rel_l2(chained, want):.4e}, reference "
          f"{rel_l2(chain_ref, want):.4e}; DAC off cuda vs reference "
          f"{chain_det:.3e}; bound {bound_ms(0, N_LAYERS * 2 * 4 * D_MODEL ** 2)[0]:.3f} ms",
          flush=True)
    check(bool(torch.isfinite(chained).all())
          and tuple(chained.shape) == (D_MODEL, 1), "chain output")
    check(chain_counts["ec_matmul"] == N_LAYERS,
          f"chain did not run one ec_matmul per layer: {chain_counts}")
    check(chain_det <= CHAIN_TOL,
          "chain cuda path disagrees with the reference pipeline")
    for k_, v_ in hook_check(
            "[6c]", "chain_fn(C, relu) vs chain_mvm (one key)",
            lambda: geng.chain_fn(C, activation="relu")(h, HOOK_KEY),
            lambda: geng.chain_mvm(C, h, key=HOOK_KEY, activation="relu"),
            nonzero(chain_counts)).items():
        chain_counts[k_] += v_
    del C, layers, chained, chain_ref, want, views, det
    torch.cuda.empty_cache()

    # ------------------------- 7. single-pass encode (main, rram_encode_matmul)
    taox = get_device("taox-hfox")
    sigma = effective_sigma_py(taox, cfg.k_iters)
    m, k, n = ENCODE_ROWS, D_MODEL, D_FF
    x = torch.randn(m, k, generator=gen, device=dev)
    wt = torch.randn(k, n, generator=gen, device=dev).div_(k ** 0.5)
    eps = torch.randn(k, n, generator=gen, device=dev)
    kw = dict(sigma=sigma, levels=taox.levels)
    kernels.reset_launches()
    y = kernels.rram_encode_matmul(x, wt, eps, **kw)
    y_rng = kernels.encode_matmul_rng(ENCODE_SEED, x, wt, **kw)
    torch.cuda.synchronize()
    encode_counts = dict(kernels.LAUNCHES)
    check(encode_counts["encode_matmul"] == 1
          and encode_counts["encode_matmul_rng"] == 1,
          f"the encode entry points did not launch their kernels: "
          f"{encode_counts}")
    check(tuple(y.shape) == (m, n) and bool(torch.isfinite(y).all()
                                           & torch.isfinite(y_rng).all()),
          "encode outputs: wrong shape or non-finite")
    tiles = dict(block_k=512, block_n=512)
    q = kernels.quantize_tile_plain(wt, taox.levels, 512, 512)
    w_tilde = q * (1.0 + sigma * eps)
    print(f"[7] x {m}x{k} @ encode(W {k}x{n}), 512^2 tiles, levels "
          f"{taox.levels}, sigma {sigma:.4g}; rel-L2 vs digital x @ W "
          f"{rel_l2(y, torch.matmul(x, wt)):.4e}; launches {encode_counts}",
          flush=True)
    rows[1]["encode_matmul"] = compare(
        f"encode_matmul {m}x{k}x{n}",
        lambda: kernels.encode_matmul(x, wt, eps, **kw, **tiles),
        lambda: kernels.encode_matmul_plain(x, wt, eps, sigma, taox.levels,
                                            512, 512), EC_TOL,
        cost=kernels.cost.encode_matmul(m, k, n), iters=5,
        library_fn=lambda: torch.matmul(x, w_tilde))
    del w_tilde
    w_rng = q * (1.0 + sigma * kernels.philox_normal_plain(
        ENCODE_SEED, k, n, 512, 512, dev))
    rows[1]["encode_matmul_rng"] = compare(
        f"encode_matmul_rng {m}x{k}x{n}",
        lambda: kernels.encode_matmul_rng(ENCODE_SEED, x, wt, **kw, **tiles),
        lambda: kernels.encode_matmul_rng_plain(ENCODE_SEED, x, wt, **kw,
                                                **tiles), EC_TOL,
        cost=kernels.cost.encode_matmul_rng(m, k, n), iters=5,
        plain_iters=1, plain_warmup=1,
        library_fn=lambda: torch.matmul(x, w_rng))
    # What holds the product back: registers and spills (ptxas), the SM clock
    # and power while it runs (the fp32 bound assumes the 1.98 GHz boost
    # clock), the rate reached and the share of each CUDA kernel in a call.
    # encode_matmul_rng's second bound counts the generator's instructions
    # on the FMAs' issue slots.
    flops = 2.0 * m * k * n
    timed = {"encode_matmul": lambda: kernels.encode_matmul(x, wt, eps, **kw,
                                                            **tiles),
             "encode_matmul_rng": lambda: kernels.encode_matmul_rng(
                 ENCODE_SEED, x, wt, **kw, **tiles)}
    for name, fn in timed.items():
        row = rows[1][name]
        row["shape"] = f"{m}x{k}x{n}"
        instance = "true" if name.endswith("rng") else "false"
        row["ptxas"] = ptxas.get(f"encode_matmul_kernel<{instance}>")
        mhz, watts, samples = clock_under_load(fn)
        row.update(sm_mhz=mhz, watts=watts, tflops=flops / row["ms"] / 1e9,
                   split_ms=kernel_split(fn))
        print(f"    {name}: {row['tflops']:.2f} TFLOP/s "
              f"({row['tflops'] / (HW['peak_flops'] / 1e12):.1%} of fp32 "
              f"peak) at SM {mhz} MHz, {watts} W ({samples} nvidia-smi "
              f"samples); ptxas {row['ptxas']}; per call "
              + ", ".join(f"{short_kernel_name(key)} {ms:.4f} ms"
                          for key, ms in row["split_ms"].items()), flush=True)
    gen_ms = (k * n * GEN_INSTRUCTIONS_PER_DRAW
              / (HW['peak_flops'] / 2) * 1e3)
    rows[1]["encode_matmul_rng"].update(
        bound_gen_ms=rows[1]["encode_matmul_rng"]["bound_ms"] + gen_ms,
        bound_gen_by=f"operations + generator ({GEN_INSTRUCTIONS_PER_DRAW} "
                     f"instructions a draw, counted from the source)")
    print(f"    encode_matmul_rng bound with the generator: "
          f"{rows[1]['encode_matmul_rng']['bound_gen_ms']:.4f} ms "
          f"({gen_ms:.4f} ms of it for {k * n} draws)", flush=True)
    zero = dict(kw, sigma=0.0)
    same_zero = torch.equal(
        kernels.encode_matmul_rng(ENCODE_SEED, x, wt, **zero),
        kernels.encode_matmul(x, wt, torch.zeros_like(wt), **zero))
    same_run = torch.equal(y_rng, kernels.encode_matmul_rng(ENCODE_SEED, x,
                                                            wt, **kw))
    # W of ones quantizes to ones, so eye @ encode(W) = 1 + sigma * eta
    # (64 rows of x: the 256-row output tile masks the rest).
    eye, ones = torch.eye(64, device=dev), torch.ones(64, 32768, device=dev)
    eta = (kernels.encode_matmul_rng(ENCODE_SEED, eye, ones, sigma=0.5,
                                     levels=taox.levels) - 1.0) / 0.5
    moments = (float(eta.mean()), float(eta.var()))
    print(f"    rng kernel: sigma = 0 equals encode_matmul with zero eps: "
          f"{same_zero}; bit for bit run to run: {same_run}; {eta.numel()} "
          f"draws read back: mean {moments[0]:.2e}, variance "
          f"{moments[1]:.4f}", flush=True)
    check(same_zero and same_run, "encode_matmul_rng is not deterministic "
                                  "or not encode_matmul at sigma = 0")
    check(abs(moments[0]) <= 0.01 and abs(moments[1] - 1.0) <= 0.02,
          "encode_matmul_rng's draws are not standard normal")
    del x, wt, eps, q, w_rng, y, y_rng, eta, eye, ones
    torch.cuda.synchronize()

    # ---------------------------- 8. the paper's Table 1 on the card (main)
    # M1 = bcsstk02 and M2 = Iperturb (66^2, one 66 x 66 MCA), x from seed
    # 42: every device of benchmarks/table1_ec.py, programmed once per cell
    # on the cuda backend, TABLE1_REPS MVMs a cell (its full mode), cell
    # keys fold_in(0, device index) and rep r's fold_in(cell key, r).
    x66 = torch.from_numpy(np.random.default_rng(42).standard_normal(66)
                           .astype(np.float32)).to(dev)
    geom66 = MCAGeometry(1, 1, 66, 66)
    mats = {"M1_bcsstk02": paper_matrix("bcsstk02"),
            "M2_iperturb": make_iperturb(66)}
    grid = [("epiram", False)] + [(d, ec) for d in TABLE1_DEVICES[1:]
                                  for ec in (False, True)]
    table1 = {}
    table1_counts = dict.fromkeys(kernels.LAUNCHES, 0)
    t0 = time.perf_counter()
    for mname, mat in mats.items():
        a66 = torch.from_numpy(mat.astype(np.float32)).to(dev)
        b66 = torch.matmul(a66, x66)
        for dname, ec in grid:
            tcfg = CrossbarConfig(device=get_device(dname), geom=geom66,
                                  k_iters=5, ec=ec)
            ckey = fold_in(0, TABLE1_DEVICES.index(dname))
            teng = AnalogEngine(tcfg, backend="cuda", device=dev)
            T = teng.program(a66, ckey)
            tcfg_exact = dataclasses.replace(tcfg, encode_inputs=False)

            def view(c, be):    # the cell's image under another engine
                return AnalogMatrix(
                    engine=AnalogEngine(c, backend=be, device=dev),
                    shape=T.shape, base_key=ckey, write_stats=T.write_stats,
                    at_pad=T.at_pad, da_pad=T.da_pad)

            kernels.reset_launches()
            ys = [teng.mvm(T, x66, key=fold_in(ckey, r))
                  for r in range(TABLE1_REPS)]
            torch.cuda.synchronize()
            for k_, v_ in kernels.LAUNCHES.items():
                table1_counts[k_] += v_
            ref = view(tcfg, "reference")
            check(all(bool(torch.isfinite(y).all()) and tuple(y.shape) ==
                      (66,) for y in ys), f"table 1 {mname} {dname}: output")
            per_call = T.input_write_stats(batch=1)
            det = rel_l2(view(tcfg_exact, "cuda") @ x66,
                         view(tcfg_exact, "reference") @ x66)
            cell = {
                "eps_l2": statistics.fmean(rel_l2(y, b66) for y in ys),
                "eps_linf": statistics.fmean(float(rel_linf(y, b66))
                                             for y in ys),
                "E_w": T.write_stats.energy_j + per_call.energy_j,
                "L_w": T.write_stats.latency_s + per_call.latency_s,
                "E_program": T.write_stats.energy_j,
                "E_per_mvm": per_call.energy_j,
                "ms_cuda": call_time_ms(lambda: teng.mvm(T, x66, key=1), 20),
                "ms_reference": call_time_ms(
                    lambda: ref.engine.mvm(ref, x66, key=1), 20),
                "dac_off_rel_l2": det}
            table1[(mname, dname, ec)] = cell
            print(f"[8] {mname} {dname:9s} {'ec ' if ec else 'raw'}: eps_l2 "
                  f"{cell['eps_l2']:.4f}, eps_linf "
                  f"{cell['eps_linf']:.4f}, E_w {cell['E_w']:.4e} J, L_w "
                  f"{cell['L_w']:.4e} s, E_program {cell['E_program']:.4e} "
                  f"J, E_per_mvm {cell['E_per_mvm']:.4e} J; per call cuda "
                  f"{cell['ms_cuda']:.4f} ms, reference "
                  f"{cell['ms_reference']:.4f} ms; DAC off cuda vs "
                  f"reference {det:.2e}", flush=True)
            check(det <= EC_TOL, f"table 1 {mname} {dname}: DAC off, the "
                                 f"cuda backend differs from reference")
            if mname == "M1_bcsstk02" and dname == "taox-hfox" and ec:
                m1_image, m1_cfg, m1_a = T, tcfg, a66
        get = {k[1:]: v for k, v in table1.items() if k[0] == mname}
        epi, raw = get[("epiram", False)], get[("taox-hfox", False)]
        tao = get[("taox-hfox", True)]
        print(f"[8] {mname} claims: EC keeps {tao['eps_l2'] / raw['eps_l2']:.3f}"
              f" of the raw TaOx-HfOx error (< 0.2), TaOx-HfOx + EC / EpiRAM "
              f"{tao['eps_l2'] / epi['eps_l2']:.3f} (< 1.5), write energy "
              f"ratio {epi['E_w'] / tao['E_w']:.1f} (> 300), latency ratio "
              f"{epi['L_w'] / tao['L_w']:.1f} (> 50)", flush=True)
        check(tao["eps_l2"] < 0.2 * raw["eps_l2"]
              and tao["eps_l2"] < 1.5 * epi["eps_l2"]
              and epi["E_w"] / tao["E_w"] > 300
              and epi["L_w"] / tao["L_w"] > 50,
              f"table 1 {mname}: a paper claim fails")
    n_ec = sum(1 for k in table1 if k[2])
    print(f"[8] {len(table1)} cells x {TABLE1_REPS} MVMs in "
          f"{time.perf_counter() - t0:.1f} s; launches (cuda backend) "
          f"{table1_counts}", flush=True)
    check(table1_counts["ec_matmul"] == n_ec * TABLE1_REPS
          and table1_counts["stencil_denoise"] == n_ec * TABLE1_REPS,
          f"table 1: not one ec_matmul + one stencil_denoise launch per EC "
          f"MVM: {table1_counts}")
    # The 66-wide image has a 264-byte row stride: the forward launcher
    # must take its register-load layout, held here against the plain
    # version on the engine's own image.
    at, da = m1_image.at_pad, m1_image.da_pad
    lay = kernels.matmul_layout(at, da, 1)
    print(layout_line("ec_matmul 66x66 batch 1", lay), flush=True)
    check(not lay.staged and at.stride(0) * 4 == 264,
          "the 66^2 image did not take the register-load layout")
    u = x66[:, None].contiguous()
    u_t = crossbar._encode_vec(u, m1_cfg, gen=generator(66, dev))
    row66 = compare("ec_matmul 66x66 batch 1",
                    lambda: kernels.ec_matmul(at, da, u, u_t),
                    lambda: kernels.ec_matmul_plain(at, da, u, u_t), EC_TOL,
                    cost=kernels.cost.ec_matmul(66, 66, 1), iters=200,
                    library_fn=lambda: torch.matmul(at, u)
                    + torch.matmul(da, u_t))
    row66.update(shape="66x66", batch=1, layout=lay._asdict())
    check(torch.equal(kernels.ec_matmul(at, da, u, u_t),
                      kernels.ec_matmul(at, da, u, u_t)),
          "ec_matmul on the 66^2 image is not the same run to run")
    more_shapes.append({"ec_matmul": row66})
    # The one-shot shim (plain PyTorch on the card) is the reference-backend
    # engine's program + first MVM under the same key, bit for bit.
    y_once, stats_once = corrected_mvm(m1_a, x66, 7, m1_cfg)
    y_eng = AnalogEngine(m1_cfg, backend="reference", device=dev) \
        .program(m1_a, 7) @ x66
    print(f"[8] corrected_mvm on M1 (taox-hfox, EC): rel-L2 vs digital "
          f"{rel_l2(y_once, torch.matmul(m1_a, x66)):.4f}, equal to the "
          f"reference engine bit for bit: {torch.equal(y_once, y_eng)}; "
          f"E_w {stats_once.energy_j:.4e} J", flush=True)
    check(torch.equal(y_once, y_eng),
          "corrected_mvm differs from the reference engine")
    # corrected_matmul, row-major, at one Mixtral expert's width: x (256,
    # 4,096) @ W (4,096, 14,336), both encoded (taox-hfox, k = 5).
    m, k, n = ENCODE_ROWS, D_MODEL, D_FF
    xm = torch.randn(m, k, generator=gen, device=dev)
    wm = torch.randn(k, n, generator=gen, device=dev).div_(k ** 0.5)
    xm_t = encode(xm, taox, cfg.k_iters, gen=generator(fold_in(8, 0), dev))
    wm_t = encode(wm, taox, cfg.k_iters, gen=generator(fold_in(8, 1), dev))
    fused = corrected_matmul(xm, wm, xm_t, wm_t, ec_mode="fused")
    faithful = corrected_matmul(xm, wm, xm_t, wm_t, ec_mode="faithful")
    digital = torch.matmul(xm, wm)
    mm_err = {"fused_vs_faithful": rel_l2(fused, faithful),
              "ec": rel_l2(fused, digital),
              "raw": rel_l2(torch.matmul(xm_t, wm_t), digital)}
    forms = [lambda mode=mode: corrected_matmul(xm, wm, xm_t, wm_t,
                                                ec_mode=mode)
             for mode in ("fused", "faithful")]
    (f_ms, f_lo, f_hi), (a_ms, a_lo, a_hi) = alternating_ms(forms, 50)
    mhz, watts, samples = clock_under_load(lambda: [f() for f in forms])
    print(f"[8] corrected_matmul x {m}x{k} @ W {k}x{n} (taox-hfox): fused vs "
          f"faithful rel-L2 {mm_err['fused_vs_faithful']:.2e}; vs digital "
          f"x @ W: EC {mm_err['ec']:.4e}, raw x~ @ W~ {mm_err['raw']:.4e}; "
          f"device ms a call over 50 alternating rounds (median, min-max): "
          f"fused {f_ms:.3f} ({f_lo:.3f}-{f_hi:.3f}), faithful {a_ms:.3f} "
          f"({a_lo:.3f}-{a_hi:.3f}); both forms in turn at SM {mhz} MHz, "
          f"{watts} W ({samples} nvidia-smi samples)", flush=True)
    check(mm_err["fused_vs_faithful"] <= EC_TOL
          and mm_err["ec"] < mm_err["raw"],
          "corrected_matmul: fused != faithful, or EC no better than raw")
    del xm, wm, xm_t, wm_t, fused, faithful, digital, m1_image, at, da
    torch.cuda.empty_cache()

    # ------------------------------------------ 9. streamed execution (main)
    streamed_counts, dub = streamed_phase(dev, gen, cfg, engine,
                                          more_shapes, N,
                                          PAPER_MATRICES["dubcova2"][0],
                                          MCAGeometry(8, 8, 1024, 1024))

    # ------------------------- 10. distributed placement over a mesh (main)
    t0 = time.perf_counter()
    dist_counts = distributed_phase(dev, gen, dub)
    print(f"[10] phase wall time {time.perf_counter() - t0:.2f} s",
          flush=True)

    # ------------------------------- 11. device-lifetime reliability (main)
    t0 = time.perf_counter()
    rel_counts = reliability_phase(dev, gen)
    print(f"[11] phase wall time {time.perf_counter() - t0:.2f} s",
          flush=True)

    return smi, rows, more_shapes, [
        served, served_t, solve_counts, eigen_counts, registry_counts,
        lstsq_counts, norm_counts, admm_counts, lp_counts, group_counts,
        chain_counts, encode_counts, table1_counts, streamed_counts,
        dist_counts, rel_counts]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    t_start = time.perf_counter()
    smi, rows, more_shapes, all_counts = kernel_phases()

    # --------------- 12. the transformer LM served on the programmed image
    t0 = time.perf_counter()
    all_counts.append(lm_phase(torch.device("cuda"), more_shapes))
    print(f"[12] phase wall time {time.perf_counter() - t0:.2f} s",
          flush=True)

    # ------------ 13. the attention-based families served (MoE, whisper,
    # llama-vision)
    t0 = time.perf_counter()
    all_counts.append(families_phase(torch.device("cuda"), more_shapes))
    print(f"[13] phase wall time {time.perf_counter() - t0:.2f} s",
          flush=True)

    # -------- 14. the recurrent families served (rwkv6-1.6b, zamba2-1.2b)
    t0 = time.perf_counter()
    all_counts.append(recurrent_phase(torch.device("cuda"), more_shapes))
    print(f"[14] phase wall time {time.perf_counter() - t0:.2f} s",
          flush=True)

    # ---------------------- 15. training on one card (qwen3-1.7b, full)
    t0 = time.perf_counter()
    all_counts.append(train_phase(torch.device("cuda")))
    print(f"[15] phase wall time {time.perf_counter() - t0:.2f} s",
          flush=True)

    # ------------- 16. the serving simulator, and the image cache at full
    # width (qwen3-1.7b)
    t0 = time.perf_counter()
    all_counts.append(serving_phase(torch.device("cuda")))
    print(f"[16] phase wall time {time.perf_counter() - t0:.2f} s",
          flush=True)

    # ------------- 17. the analysis cores at the paper's 65,536^2 scale
    t0 = time.perf_counter()
    all_counts.append(analysis_phase(torch.device("cuda")))
    print(f"[17] phase wall time {time.perf_counter() - t0:.2f} s",
          flush=True)

    # -------------- 18. the invariant registry at the paper's 65,536^2
    t0 = time.perf_counter()
    all_counts.append(invariants_phase(torch.device("cuda")))
    print(f"[18] phase wall time {time.perf_counter() - t0:.2f} s",
          flush=True)

    # ------------------------ 19. the roofline of the main path on the card
    t0 = time.perf_counter()
    free_cuda()
    all_counts.append(roofline_in_own_process())
    print(f"[19] phase wall time {time.perf_counter() - t0:.2f} s",
          flush=True)

    # ---------------- 20. sharded execution on a one-card mesh (MoE TP,
    # the sharded train step, the collectives)
    t0 = time.perf_counter()
    free_cuda()
    all_counts.append(sharded_phase(torch.device("cuda")))
    print(f"[20] phase wall time {time.perf_counter() - t0:.2f} s",
          flush=True)

    # ---------------------------------------------------------- report
    sources = {
        "ec_matmul": ("src/repro_torch/kernels/csrc/rram_mvm.cu",
                      "src/repro/kernels/rram_mvm.py:236"),
        # The same pallas_call read backwards by the JAX engine.
        "ec_rmatmul": ("src/repro_torch/kernels/csrc/rram_mvm.cu",
                       "src/repro/engine.py:613"),
        "stencil_denoise": ("src/repro_torch/kernels/csrc/tridiag.cu",
                            "src/repro/kernels/tridiag.py:108"),
        "thomas_solve": ("src/repro_torch/kernels/csrc/tridiag.cu",
                         "src/repro/kernels/tridiag.py:54"),
        "cg_update": ("src/repro_torch/kernels/csrc/solver_update.cu",
                      "src/repro/kernels/solver_update.py:83"),
        "richardson_update": ("src/repro_torch/kernels/csrc/solver_update.cu",
                              "src/repro/kernels/solver_update.py:46"),
        # The grouped wrappers reach the pallas_call of ec_matmul per member.
        "ec_group_matmul": ("src/repro_torch/kernels/csrc/rram_mvm.cu",
                            "src/repro/kernels/ops.py:150"),
        "ec_group_rmatmul": ("src/repro_torch/kernels/csrc/rram_mvm.cu",
                             "src/repro/kernels/ops.py:174"),
        "encode_matmul": ("src/repro_torch/kernels/csrc/encode_matmul.cu",
                          "src/repro/kernels/rram_mvm.py:79"),
        "encode_matmul_rng": ("src/repro_torch/kernels/csrc/encode_matmul.cu",
                              "src/repro/kernels/rram_mvm.py:166"),
    }
    table = []
    for name, (source, replaces) in sources.items():
        launches = sum(counts[name] for counts in all_counts)
        check(launches > 0, f"{name} was not launched on the main path")
        row = rows[1][name]
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "rel_l2": row["rel_l2"],
            **{k: row[k] for k in ("err_lam", "ms_lam", "lam_ms",
                                   "rel_l2_lam10", "fp64_err",
                                   "fp64_err_plain", "coef_head_rows",
                                   "scan_steps", "scan_ms",
                                   "launch_floor_ms", "one_by_one_ms",
                                   "pair_ms", "shape",
                                   "layout", "group_call_ms", "ptxas",
                                   "sm_mhz", "watts", "tflops", "split_ms",
                                   "bound_gen_ms", "bound_gen_by")
               if k in row},
            "ms": row["ms"],
            "call_ms": row["call_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "batch": 1,
            "batch8": ({k: rows[8][name][k] for k in
                        ("ms", "call_ms", "plain_ms", "bound_ms",
                         "library_ms", "group_call_ms", "layout", "pair_ms",
                         "lam_ms", "rel_l2_lam10", "fp64_err",
                         "fp64_err_plain", "split_ms")
                        if k in rows[8][name]}
                       if name in rows[8] else None),
            # The phase-5, 8 and 9 images: other M, K and layouts, batch 1.
            "shapes": [res[name] for res in more_shapes if name in res],
        })
    print(f"total wall time {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
