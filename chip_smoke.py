#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

Phases, each of which stops the run with a non-zero exit on failure:

1. device: one sm_90 card; prints ``nvidia-smi``'s name and power limit;
2. build: compiles every ``src/repro_torch/csrc/*.cu`` with nvcc (one process
   per source, all at once) and prints the build time, registers and
   spills, and each K3 kernel's registers and spill bytes (a K3 kernel that
   spills fails the run);
3. each CUDA kernel against its plain PyTorch version on the card: the
   GEMM over the reference's shapes, ragged, decode-shaped (M = 1, 7),
   unaligned and one large product, in both dtypes, each aligned bf16 one
   checked to have gone to the wgmma kernel, and the wgmma kernel's edge
   shapes, split-K and a walk over more tiles than SMs at every built tile
   over 1 and 3 splits, every bf16 product also against the fp32 product
   relative to its row scale (``ref.gemm_rel_err``); flash attention over
   GQA / window / softcap / ragged / dtype / head_dim cases (head_dim 96
   causal, non-causal over 1500 keys, and in decode), every instantiation
   of each dtype's prefill kernel (bf16 on the tensor cores, fp32 on the
   CUDA cores), and ragged multi-head, Tq = 1, offset + window, GQA group
   1 / 4 / 32 and softcap at head_dim 256 cases at each built tile, head
   by head, every bf16 prefill also against the plain version in fp32
   relative to the output's row scale; K2 decode (split across blocks)
   at GQA groups 1 / 2 / 4 / 8, S = 4096 and 4097, pos at 0, 100, the
   chunk edges, S/2 and S - 1, windows and softcap, and Gemma-2's 4096
   window over 8192 positions, bf16 also against the fp32 plain version;
   K2 in bf16 at the full shapes of phases 4g-4k's configs (FULL_PREFILL:
   prefill at head_dim 256 over 2048 positions and over 8192 with
   Gemma-2's window 4096 and softcap 50, GQA groups 16 and 5;
   FULL_DECODE: decode at batch 4 over 4096 positions at groups 16 and 5
   and head_dim 256 at group 1), within 3e-2 and the row-relative gate;
   the RWKV-6 recurrence
   over dtype / head size / (B, H) / ragged T, and over the whole range of
   decays (w = 0, w = 1e-30, w = 1, strong and mild mixed in one chunk),
   every bf16 call checked to have taken the tensor-core kernel and held
   also to one bf16 ulp of the fp32 plain version (``ref.rwkv6_rel_err``)
   and to the chunked plain version (``ref.rwkv6_chunked_ref``); the Mamba
   selective scan over dtype / state size / (Bt, L, Dm) (one Dm whose rows
   are not 16-byte aligned) / decays (dt = 0 on a third of the steps, dt·A
   below -104 on every other state, strong and mild decays mixed 30/70,
   and the long memory of a trained Mamba: decays within ~1e-3 of 1),
   h_last also held relative to its (b, d) row (``ref.state_rel_err``),
   bf16 y also to one bf16 ulp of the fp32 plain version
   (``ref.scan_rel_err``); and the fp32 scan over a long memory at the
   main shape, kernel and fp32 plain version, against the scan in float64
   (each built N; each reading also as a multiple of the 1e-4 gate, held
   at its measured tolerance, F64_KERNEL_TOL and F64_PLAIN_TOL);
4. the main paths, in bf16 with random weights from a seeded generator, the
   kernels' launch counters reset before and read after each run (and
   every K2 prefill launch checked to have been reported by the library as
   a launch of the tensor-core kernel).  Every decode step runs the serve
   step of ``build_serve_step``, captured in a CUDA graph on its first
   call and replayed (the counters count replays); its tokens are held to
   the eager step's (``TF.decode_step`` / ``ED.decode_step_encdec`` in the
   same loop), and its time at batch 4 beside the eager step's, the
   weight-read bound and one profiled replay's device-busy time:
   a. Mistral-NeMo-12B at full width and depth — ``forward`` on a
      2048-token prompt and ``generate`` (batch 4, prompt 16, 24 new);
      then decode steps at batch 4 over a 4096-position cache (every K2
      decode call split), eager and captured, on the host clock and, for
      one step of each, its device-busy time (and K2 decode's part of the
      eager step's) from ``torch.profiler``;
   b. RWKV-6 7B at full width and depth — the same two runs (``forward``
      through the wkv kernel once per layer, every call on its tensor-core
      kernel as the library reports it, ``generate`` through the plain
      recurrence step, as in the reference);
   c. Jamba-1.5-Large at full width, the first 7 layers of its 8-layer
      period (a whole period does not fit the card) — the same two runs
      (``forward`` through the scan kernel once per Mamba layer and the
      attention kernel once; ``generate`` through the plain Mamba step);
   d. Whisper-base at full width and depth — ``forward_encdec`` over 4 x
      1500 frames and 128 tokens, ``encode``, and a teacher-forced + greedy
      loop (batch 4, prompt 16, 24 new) through ``build_serve_step``;
   e. Phi-3-vision 4.2B at full width and depth — ``forward`` on a
      576-patch prefix + 1472 tokens and ``generate`` (batch 4, 16 + 24);
   f. ``ops.gemm``, K1's entry point (no model path runs it, as in the
      reference): the micro-bench's 512^3 fp32 product and Mistral-NeMo's
      up-projection at T = 2048 in bf16, the latter checked to have gone to
      the wgmma kernel as the library reports it;
   g-k. (SERVED_WIDE) Gemma-7B, GLM-4-9B, Gemma-2-9B, DeepSeek-MoE-16B at
      full width and depth and Llama-4-Scout at full width on 12 of its 48
      layers (the whole model, 200.74 GiB in bf16, exceeds the card), as in
      a: ``forward`` on 2048 positions (Gemma-2 on 8192, so that its
      windowed layers skip kv blocks), K2 prefill once a layer, and
      ``generate`` (batch 4, prompt 16, 24 new; the MoE ones at their
      configured capacity factor, which drops tokens in a decode step),
      K2 decode once a layer and step, captured tokens equal to the eager
      step's, the replay beside the eager step, its device-busy time, the
      weight-read bound and the peak memory;
5. fp32 consistency at Mistral-NeMo and RWKV-6 width (depth 2), at Jamba
   width (Mamba, Mamba + MoE and attention layers, capacity factor 8.0),
   at Whisper-base's full width and at Phi-3-vision's width (depth 2, with
   the prefix), and at the width of each of phases 4g-4k's configs (depth
   2; Gemma-2 one period, a windowed and a global layer; the MoE ones at
   capacity factor E / k, which drops nothing): teacher-forced decode
   steps against the forward, and the forward through the kernels against
   the plain path on the card;
6. Gemma-2 smoke width (window, softcap, post-norms, tied head) and Jamba
   smoke width in fp32 at its own capacity factor (MoE drops in decode)
   through ``generate``, kernels against the plain path;
7. each kernel timed with CUDA events (after 0.1 s of warm-up calls) at the
   main paths' shapes beside its bound, its plain version and, where there
   is one, one PyTorch library call (a yardstick the port never calls),
   with the card's clock, power and temperature logged before and after;
   K1 also at 512^3 fp32 and the decode-shaped (1 and 7) x 5120 . (5120 x
   5120) in bf16 (as CUDA graphs, eager calls logged), with every built
   tile's time at each, K2 prefill also at Phi-3-vision's, Whisper's
   encoder and Whisper's cross-attention step shapes, with every built
   tile's time at each and the output also held to the fp32 plain version;
   K2 prefill also at FULL_PREFILL's shapes and K2 decode at
   FULL_DECODE's, each as a CUDA graph beside SDPA (over the same keys;
   without the softcap, which SDPA does not take) and its bound;
   K2 decode at Mistral-NeMo's, Phi-3-vision's, Jamba's, Gemma-2's
   (window 4096 over 8192) and phase 4's (40 positions) shapes, the kernel
   and SDPA timed as CUDA graphs (the eager calls are paced by the host);
   K4 as a CUDA graph too (eager logged), its bound the larger of its
   bytes and of its own products at the bf16 rate plus its element-wise
   work at the fp32 rate; K3 as a CUDA graph (eager and the fp32 route
   logged), beside its bytes bound its exp count and the special-function
   units' floor at the SM clock nvidia-smi reads;
8. training, through the plain path under autograd (the reference trains
   with ``KB = "ref"``; no kernel has a backward pass), every kernel
   counter held at 0 over every training step:
   a. Mistral-NeMo-12B at full width, the first 4 of its 40 layers, bf16,
      global batch 2 x 2048 tokens: variant A (fp32 moments, no remat, 5
      steps on one batch, its loss must fall), A with remat (its peak
      memory must be below A's), B (accumulation 2, EF-bf16 compression,
      remat; its residuals must be non-zero) and C (bf16 moments), each
      with its step time (host clock, synchronised, median after a warm-up
      step), tokens/s, model-FLOP share of the bf16 dense peak, peak
      memory and losses; and one step of A under ``torch.profiler``, its
      device time split into bf16 products, fp32 products (the plain
      attention), other kernels and the optimizer;
   d. (run after a) RWKV-6 7B at full width, its first 8 of 32 layers,
      and Jamba-1.5-Large at full width, its first layer (Mamba and a
      dense GLU MLP; with its second, 16 experts, it exceeds the card),
      bf16 parameters, fp32 moments, remat, 8a's global batch: T = 2048
      reaches ``chunk_threshold``, so the plain path takes the reference's
      chunked forms (``ref.chunked_rwkv6_ref``,
      ``ref.chunked_selective_scan_ref``; their calls counted, and a run
      with none fails); 4 steps each, step time (median after the first),
      tokens/s, model-FLOP share of the bf16 peak, peak memory and finite
      losses; beside each, one layer forward and backward at that shape
      through the per-step loop against the chunked form (time, peak
      memory, device events);
   b. glm4 smoke in fp32 (TF32 off): one train step on the card against
      the same step on the CPU, accumulation 4 against 1 on the card, and
      the kernel backend refused in a train step; then the RWKV-6 and
      Jamba smokes in fp32 with chunk_threshold 8 and scan_chunk 4, one
      train step each through the chunked forms, on the card against the
      CPU at the same gates;
   c. ``train_lm --preset 100m`` (the twin of ``examples/train_lm.py``), 30
      steps at batch 8 x 256 with a checkpoint every 10, its checkpoint
      restored bit for bit, the run resumed to 40 and held to an
      uninterrupted continuation.

9. the DSE scoring engine (``repro_torch.dse.batch_sweep.prefill_sweep``,
   no kernel of its own: plain PyTorch in int64/float64): the mapping
   cache of the ``large`` space (624 designs in 28 tiles) over the DSE's
   default zoo at seq 512 and 4096, objective cycles, prefilled on the
   card into ``.chipscratch/``, its wall time split into host enumeration,
   dispatches (and their device time by CUDA events) and host selection
   plus rescoring, candidates scored a second, entries written and peak
   device memory; the card's raw (design, candidate) scores of every
   design held to the NumPy ``perf_kernel`` design by design (integer
   outputs bit-identical, ``energy_pj`` within ENERGY_RTOL, the largest
   difference logged); the cache's winners of every tile's first design
   held to ``best_mappings(engine="numpy")``; and the first tile prefilled
   again by the card and by the NumPy engine, each timed.
10. the sharded entry points on a one-card ``DeviceMesh`` (``nccl`` at
   world size 1 over an in-process store; the "fake" group of the dry run
   in subprocesses):
   a. serve: Mistral-NeMo-12B at full width and depth, its parameters and
      decode state laid out by the sharding rules (``build_serve_step(cfg,
      mesh).jit_with``) and a ``forward`` on the DTensors; ``generate`` with
      phase 4a's prompts and new-token count through the mesh's captured
      step, its tokens identical to phase 4a's and its K2 launches (replays
      counted, and the forward's K2 prefill launches) equal to phase 4a's;
      the replayed step's time beside phase 4a's;
   b. train: ``build_train_step(cfg, mesh)`` at phase 8a's shape (4 of 40
      layers, global batch 2 x 2048) with remat and bf16 moments, three
      steps each way, the first loss within 1e-5 (relative) of the
      unsharded step's in the same run; step times and peak memory;
   c. dry run: ``python -m repro_torch.launch.dryrun`` on
      mistral_nemo_12b x {train_4k, decode_32k} and jamba_1_5_large_398b x
      long_500k on the 16x16 mesh of the "fake" group, three subprocesses
      at once, each cell's status ``ok`` and its counted FLOPs per device
      within its stated factor of the model's; GB/dev, Tc, Tm and Tx
      logged (predictions from operation counts against the H100's
      constants); and, in a fourth subprocess, RWKV-6's loss and gradients
      at smoke width counted on a fake 2x2x4 mesh, a device's products
      1/16 of the unsharded step's (this machine's torch once repeated a
      layer's channel mix over ``model``; the full rwkv6_7b x train_4k
      cell took 187 s to trace here and left the list).
11. the DSE's evaluation on the card (``repro_torch.dse``: Evaluator,
   searches, supervised pool, serving replay, report; no kernel of its
   own), every search held to the NumPy engine's in the same run (names,
   integers and visit orders equal, energies within ENERGY_RTOL), times
   logged beside the card's name and power limit:
   a. ``batch_sweep`` of the ``large`` space over phase 9's warm cache
      (624 designs, the DSE's default zoo at seq 512 and 4096, objective
      cycles): 0 dispatches, 0 entries added, 0 misses; its evals and
      frontier against the NumPy engine's cold ``exhaustive_search`` of the
      same designs (a pool of spawned workers); the frontier printed;
   b. ``exhaustive_search`` of ``small`` with ``Evaluator(engine="torch")``
      and a cold cache, the misses scored on the card counted;
   c. ``evolve_search`` of ``huge``, budget 64, seed 0: the visit order,
      prefilter and frontier of both engines identical;
   d. a pool of 2 workers over ``small`` once CUDA is up: it spawns, and
      its evals and frontier are the in-process run's;
   e. ``Evaluator(serving=ServingSpec())`` (the reference's default trace
      and SLO) over ``tiny``: every design's serving summary (the
      cross-model study runs through the CLI in phase 13b).
12. the LEGO generator (``repro_torch.core``: ADG, DAG, LP/ILP back end,
   Verilog on the host; the simulators, plain PyTorch in float64/int64 and
   no kernel of their own, on the card), times logged beside the card's
   name and power limit: the paper's four fused 256-FU designs
   (GEN_DESIGNS, built from ``repro_torch.designs``, the port's copy of
   ``benchmarks/designs.py``) built and emitted;
   every dataflow through ``oracle``, ``simulate`` and ``simulate_rtl`` on
   the card, each output equal to the card's oracle and every output,
   counter, FIFO and join check and ``hw`` record equal to the same call
   on the CPU (Attention through the staged entry points, P = S and P =
   softmax(S), the softmax stage held to the CPU at GEN_SOFTMAX_RTOL);
   Conv2d-MNICOC's conv-icoc at ``oh = ow = 56`` (T = 112,896), funcsim
   not run on the CPU at that size; the FIFO words at a FIFO feeding a
   FIFO bit-exact, and a corrupted delay matching caught.
13. the two front doors, each run in-process as a user runs it, on the
   card, and held to the same command on the CPU or with the NumPy engine
   (each a process of its own with CUDA hidden, all started with the phase
   and run beside the card's runs): standard output with the wall times
   masked, files byte for byte, the sweep JSON without walls and
   provenance; times logged beside the card's name and power limit:
   a. ``python -m repro_torch.generate_accelerator``: MobileNetV2 on
      LEGO-MNICOC with ``--emit-rtl``; ``--model llama4_scout_17b_a16e
      --seq 512`` on the fused attention class, its two-stage netlist
      check (QK, softmax on the PPUs, PV) bit-exact on the card;
      ``--model rwkv6_7b`` on the switch class with ``--vcd``;
   b. ``python -m repro_torch.dse.batch_sweep --models all --quick`` (the
      ten configs at seq 256 over ``tiny``, Gemmini baselines, the
      one-architecture winner) against ``--engine numpy``;
   c. a sweep of ``tiny`` with ``--nets MobileNetV2 --emit-dir`` against
      ``--engine numpy``, its JSON fed to ``generate_accelerator --dse``.
14. the paper's evaluation: ``python -m repro_torch.paper_figures`` (the
   twin of ``benchmarks/run.py``), whole, on the card in this process
   (every network of Fig. 11 and Tables II and V mapped by the torch
   engine there, K1 timed at 512 x 512 fp32 by ``kernel_micro``; the
   kernels' counters reset before and read after: 11 K1 launches and no
   other) and with ``--device cpu`` in a process of its own started
   alongside: all 46 rows, each row's name and every field but its timings
   equal; each row's seconds logged card / CPU beside the card's name and
   power limit; K1's product on ``kernel_micro``'s inputs held to its
   plain version (1e-5 of the output's scale).

The seconds of each phase are logged at the end.

Prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.
Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# what phase 4's serve runs gave, by config name, for phase 10 to hold its
# sharded run to: prompts and tokens of generate, launch counts, the
# replayed step's median ms
SERVED: dict = {}

F32_TOL, BF16_TOL = 2e-4, 3e-2
SCAN_TOL = 1e-4             # tests/test_kernels.py's fp32 tolerance for scans
GEMM_F32_TOL, GEMM_BF16_TOL = 1e-5, 2e-2   # ... and for the GEMM
GEMM = dict(source="src/repro_torch/csrc/gemm.cu",
            replaces="src/repro/kernels/gemm.py:26")
FLASH = dict(source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:34")
RWKV = dict(source="src/repro_torch/csrc/rwkv6.cu",
            replaces="src/repro/kernels/rwkv6.py:25")
SSM = dict(source="src/repro_torch/csrc/ssm_scan.cu",
           replaces="src/repro/kernels/ssm_scan.py:28")
BF16_ULP = 2.0 ** -7        # one bf16 ulp, relative
# bf16 K2 prefill against the plain version in fp32 from the same inputs,
# relative to |want| plus the rms of want's row (ref.attention_rel_err):
# the reference's own roundings (P and O to bf16) read up to 2.6 x 2^-8 on
# this file's cases, a kv tile skipped in long rows or late rows 10% off
# read 0.08 and more; the 3e-2 gate alone does not see the latter
BF16_REL_TOL = 3 * BF16_ULP
# bf16 K4 against the plain version in fp32 from the same inputs, relative
# to |want| plus the rms of want's row (ref.rwkv6_rel_err): the kernel
# rounds o once (at most half an ulp) and runs every product as split bf16
# products (~2^-16 of each term), so one ulp is twice what the design can
# read; a dropped u term, a decay one step late or a chunk's state lost read
# tens to hundreds of ulps
RWKV_REL_TOL = BF16_ULP
# K3's h_last (and, where h's memory is long, its fp32 y) against the fp32
# plain version, relative to |want| plus the rms of want's row
# (ref.state_rel_err, ref.scan_rel_err): over ~2000 steps of decays within
# 1e-3 of 1 the kernel's ex2.approx, up to 2 ulps a step, compounds to
# ~3.8e-4 in a plain-version model of it, past the absolute 1e-4; h
# rounded to bf16 once a chunk reads ~3e-2 (tools/k3_fault_check.py)
SCAN_ROW_TOL = 2.0 ** -10
# the fp32 kernel and the fp32 plain scan (torch.exp, the card's expf) over
# a long memory (decays within ~1e-3 of 1) against the scan in float64,
# rtol = atol: neither holds to SCAN_TOL there (each exp's rounding bias
# compounds over h's memory, and y sums N states of h); each is held at
# the tolerance measured at the main shape (rtol = atol at which each
# passes: kernel 3.9e-4 to 6.7e-4, plain 9.4e-4 to 1.27e-3 over N = 4, 8,
# 16 and three draws on an H100)
F64_KERNEL_TOL, F64_PLAIN_TOL = 1e-3, 2e-3
# K3 inputs: dt after a softplus, as tests/test_kernels.py draws it, and
# the decays' range (ssm_inputs); the shapes: Jamba's forward, ragged L and
# Dm, L = 1, and a Dm whose bf16 and fp32 rows are not 16-byte aligned
SSM_DECAYS = ("softplus", "zero", "underflow", "mixed", "long_memory")
SSM_SHAPES = ((1, 2048, 16384), (2, 77, 48), (2, 1, 32), (2, 16, 32),
              (3, 45, 37))
RWKV_DECAYS = ("sigmoid", "zero", "tiny", "one", "mixed")
# bf16 K1 against the product in fp32 from the same inputs, relative to
# |want| plus the rms of want's row (ref.gemm_rel_err): one rounding reads
# at most 2^-8; a k16 slice dropped or a stale ring stage at K = 5120 reads
# a few hundredths, which the 2e-2 gate can miss where |want| is large
GEMM_REL_TOL = 2 * BF16_ULP
# K1 cases (M, K, N): the reference's shapes, ragged, decode-shaped, K and
# N not multiples of 8, and the up-projection; then the wgmma kernel's
# edges (tests/test_torch_cuda.py holds the same): M, N, K not multiples
# of the tile, K below a k-step, M below a warpgroup's rows, M = 1, N = 8,
# 512^3 (split-K in fp32), and more output tiles than SMs
GEMM_CASES = ((32, 64, 32), (64, 32, 48), (16, 16, 128), (33, 70, 45),
              (1, 5120, 5120), (7, 5120, 5120), (100, 77, 123),
              (257, 1001, 250), (2048, 5120, 14336))
GEMM_EDGES = ((200, 328, 392), (130, 40, 264), (33, 136, 520),
              (1, 2000, 1000), (64, 8, 136), (129, 72, 8), (512, 512, 512),
              (2176, 200, 4104))
# phase 4g-4k: (phase, config, seed, forward's T, layers kept or None).
# Gemma-2's forward takes 8192 positions, so that its 21 windowed layers
# skip kv blocks (window 4096); Llama-4-Scout (200.74 GiB in bf16) keeps 12
# of its 48 identical layers (53.1 GiB), as phase 4c cuts Jamba
SERVED_WIDE = (("4g", "gemma_7b", 20, 2048, None),
               ("4h", "glm4_9b", 21, 2048, None),
               ("4i", "gemma2_9b", 22, 8192, None),
               ("4j", "deepseek_moe_16b", 23, 2048, None),
               ("4k", "llama4_scout_17b_a16e", 24, 2048, 12))
# K2 prefill edge cases, (B, Hq, Hkv, Tq, Tk, D, causal, window, softcap,
# offset); tests/test_torch_cuda.py holds the same
EDGE_CASES = (
    (2, 4, 2, 77, 150, 64, False, None, None, 0),
    (3, 4, 4, 33, 333, 96, True, None, None, 300),
    (4, 8, 8, 1, 1500, 64, False, None, None, 0),
    (1, 8, 2, 64, 512, 128, True, 256, None, 448),
    (1, 4, 1, 100, 612, 128, True, 40, None, 512),
    (2, 4, 4, 130, 130, 64, True, None, None, 0),
    (2, 16, 4, 130, 130, 64, True, None, None, 0),
    (1, 32, 1, 130, 130, 32, True, None, None, 0),
    (2, 8, 4, 200, 200, 256, True, None, 50.0, 0),
    (1, 4, 2, 77, 130, 256, False, 30, 30.0, 0),
)
# K2 at the full shapes of the configs phase 4g-4k serves: prefill
# (tag, B, Hq, Hkv, T, D, window, softcap), causal, and decode (tag, Hq,
# Hkv, D) at batch 4 over a 4096-position cache, at the groups and head_dim
# the other cases do not reach (16: two blocks of 8 rows a group; 5: one
# block of 8 with 3 rows padded; head_dim 256 at group 1)
FULL_PREFILL = (("Gemma-7B", 1, 16, 16, 2048, 256, None, None),
                ("Gemma-2", 1, 16, 8, 8192, 256, 4096, 50.0),
                ("GLM-4", 1, 32, 2, 2048, 128, None, None),
                ("Llama-4-Scout", 1, 40, 8, 2048, 128, None, None))
FULL_DECODE = (("GLM-4", 32, 2, 128), ("Llama-4-Scout", 40, 8, 128),
               ("Gemma-7B", 16, 16, 256))


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check_close(name, got, want, tol, quiet=False) -> float:
    """|got - want| <= tol + tol*|want| everywhere; returns the max abs error
    (logged unless ``quiet``; a failure is always reported)."""
    import torch
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite output")
    diff = (got.float() - want.float()).abs()
    excess = (diff - tol * want.float().abs()).max().item()
    err = diff.max().item()
    if not quiet or excess > tol:
        log(f"  {name}: max_abs_err={err:.3e} (tol {tol:g})")
    if excess > tol:
        fail(f"{name}: outside tolerance {tol}")
    return err


def check_rel(name, got, q, k, v, kw, quiet=False) -> float:
    """A bf16 K2 output (prefill, or decode as Tq = 1 at offset pos) within
    ``BF16_REL_TOL`` of the plain version computed in fp32
    (``ref.attention_rel_err``); returns the reading."""
    from repro_torch.kernels import ref as R
    err = R.attention_rel_err(got, q, k, v, **kw)
    if not quiet or err > BF16_REL_TOL:
        log(f"  {name}: rel_err={err:.3e} (tol {BF16_REL_TOL:g} of |want| "
            "+ row rms, fp32 plain)")
    if err > BF16_REL_TOL:
        fail(f"{name}: outside {BF16_REL_TOL:g} of the fp32 plain version")
    return err


def check_gemm(name, got, x, w, quiet=False) -> float:
    """A K1 output against the plain version on the same inputs: fp32
    within 1e-5 of the output's scale; bf16 within 2e-2 and within
    ``GEMM_REL_TOL`` of the product in fp32 (``ref.gemm_rel_err``).
    Returns the max abs error."""
    import torch

    from repro_torch.kernels import ref as R
    want = R.gemm_ref(x, w)
    if got.dtype != want.dtype:
        fail(f"{name}: dtype {got.dtype}, want {want.dtype}")
    if want.dtype == torch.float32:
        return check_scaled(name, got, want, GEMM_F32_TOL, quiet=quiet)
    err = check_close(name, got, want, GEMM_BF16_TOL, quiet=True)
    rel = R.gemm_rel_err(got, x, w)
    if not quiet or rel > GEMM_REL_TOL:
        log(f"  {name}: max_abs_err={err:.3e} (tol {GEMM_BF16_TOL:g}), "
            f"rel_err={rel:.3e} (tol {GEMM_REL_TOL:g} of |want| + row rms, "
            "fp32 product)")
    if rel > GEMM_REL_TOL:
        fail(f"{name}: outside {GEMM_REL_TOL:g} of the fp32 product")
    return err


def check_scaled(name, got, want, tol, quiet=False) -> float:
    """max |got - want| <= tol * max(1, max |want|): an fp32 product of K
    terms summed in another order than cuBLAS's differs near zero by far
    more than tol, so the tolerance is relative to the output's scale.
    Returns the max abs error."""
    import torch
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite output")
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {tuple(got.shape)} {got.dtype}, want "
             f"{tuple(want.shape)} {want.dtype}")
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    if not quiet or err > tol * scale:
        log(f"  {name}: max_abs_err={err:.3e} (tol {tol:g} x scale "
            f"{scale:.3g})")
    if err > tol * scale:
        fail(f"{name}: outside tolerance {tol} x {scale:.3g}")
    return err


def time_ms(fn, reps: int = 20, warm_s: float = 0.1,
            graph: bool = False) -> float:
    """Mean ms of ``fn`` over ``reps`` calls between CUDA events, after at
    least 3 calls and ``warm_s`` seconds of them (the clocks settle).  With
    ``graph`` the ``reps`` calls are captured once in a CUDA graph and 5
    replays are timed: the device's time per call, where an eager call
    that the host issues slower than the card runs it is timed at the
    host's pace."""
    import torch
    t0, n = time.perf_counter(), 0
    while n < 3 or time.perf_counter() - t0 < warm_s:
        fn()
        torch.cuda.synchronize()
        n += 1
    run, runs, calls = fn, reps, reps
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        run, runs, calls = g.replay, 5, 5 * reps
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < warm_s:
            g.replay()
            torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def on_tensor_cores(n: int) -> str:
    """Fails unless all ``n`` K2 prefill launches since the counters were
    reset went, as the library reports, to the tensor-core kernel (the only
    bf16 route); returns the log's note."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    tc = flash_attention_cuda.tensor_core_launches
    if tc != n:
        fail(f"{tc} of {n} bf16 K2 prefill launches took the tensor-core "
             "kernel")
    return f"K2 prefill on the tensor-core kernel: {tc} of {n}"


def check_rwkv(name, o, s_last, args, quiet=False) -> float:
    """A K4 output against the plain version on the same inputs: o at the
    dtype's tolerance (1e-4 fp32, 3e-2 bf16), S_last at the scans' 1e-4
    (fp32 from the same inputs on both sides); bf16 also within
    ``RWKV_REL_TOL`` of the plain version in fp32 (``ref.rwkv6_rel_err``)
    and against the chunked plain version, the kernel's own algorithm, at
    the same tolerances.  Returns the max abs error of o."""
    import torch

    from repro_torch.kernels import ref as R
    bf16 = o.dtype == torch.bfloat16
    tol = BF16_TOL if bf16 else SCAN_TOL
    o_ref, s_ref = R.rwkv6_ref(*args)
    err = check_close(f"{name} o", o, o_ref, tol, quiet=quiet)
    check_close(f"{name} S_last", s_last, s_ref, SCAN_TOL, quiet=quiet)
    if bf16:
        rel = R.rwkv6_rel_err(o, *args)
        o_c, s_c = R.rwkv6_chunked_ref(*args)
        check_close(f"{name} o vs chunked plain", o, o_c, tol, quiet=True)
        check_close(f"{name} S_last vs chunked plain", s_last, s_c, SCAN_TOL,
                    quiet=True)
        if not quiet or rel > RWKV_REL_TOL:
            log(f"  {name}: rel_err={rel:.3e} (tol {RWKV_REL_TOL:g} of "
                "|want| + row rms, fp32 plain)")
        if rel > RWKV_REL_TOL:
            fail(f"{name}: outside {RWKV_REL_TOL:g} of the fp32 plain version")
    return err


def check_scan(name, y, h_last, args, quiet=False,
               long_memory=False) -> tuple:
    """A K3 output against the plain version on the same inputs: y and
    h_last are fp32 sums of the same inputs on both sides (1e-4); a bf16 y
    is rounded once from them, so the two may differ by one bf16 ulp, and
    it is also held to one bf16 ulp of the plain version in fp32 relative
    to |want| plus its row's rms (``ref.scan_rel_err``: the ulp gate's
    absolute floor can miss a fault on small outputs).  h_last is also
    held to SCAN_ROW_TOL relative to its (b, d) row (``ref.state_rel_err``).
    Where h's memory is long (``long_memory``: decays within ~1e-3 of 1)
    the exps' rounding compounds past 1e-4 of h's size, so fp32 y and
    h_last are held by the row gates alone.  Returns (the max abs error of
    y, the rel_err reading of y, the state_rel_err reading)."""
    import torch

    from repro_torch.kernels import ref as R
    bf16 = y.dtype == torch.bfloat16
    y_ref, h_ref = R.selective_scan_ref(*args)
    err = (y.float() - y_ref.float()).abs().max().item()
    if bf16:
        err = check_close(f"{name} y", y, y_ref, BF16_ULP, quiet=quiet)
    elif not long_memory:
        err = check_close(f"{name} y", y, y_ref, SCAN_TOL, quiet=quiet)
    if not long_memory:
        check_close(f"{name} h_last", h_last, h_ref, SCAN_TOL, quiet=quiet)
    h_rel = R.state_rel_err(h_last, *args)
    rel = R.scan_rel_err(y, *args) if bf16 or long_memory else None
    y_tol = BF16_ULP if bf16 else SCAN_ROW_TOL
    if not quiet or h_rel > SCAN_ROW_TOL or (rel or 0.0) > y_tol:
        log(f"  {name}: h_last state_rel_err={h_rel:.3e} (tol "
            f"{SCAN_ROW_TOL:g})" + ("" if rel is None else
                                    f", y rel_err={rel:.3e} (tol {y_tol:g})")
            + " of |want| + row rms, fp32 plain")
    if h_rel > SCAN_ROW_TOL:
        fail(f"{name}: h_last outside {SCAN_ROW_TOL:g} of the fp32 plain "
             "version")
    if rel is not None and rel > y_tol:
        fail(f"{name}: y outside {y_tol:g} of the fp32 plain version")
    return err, rel, h_rel


def on_rwkv_tensor_cores(n: int) -> str:
    """Fails unless all ``n`` K4 launches since the counters were reset went,
    as the library reports, to the tensor-core kernel (the bf16 route);
    returns the log's note."""
    from repro_torch.kernels.rwkv6 import rwkv6_cuda
    tc = rwkv6_cuda.tensor_core_launches
    if tc != n:
        fail(f"{tc} of {n} bf16 K4 launches took the tensor-core kernel")
    return f"K4 on the tensor-core kernel: {tc} of {n}"


def rwkv6_tc_work(B: int, H: int, T: int, D: int) -> tuple[float, float]:
    """(tensor-core flops, CUDA-core flops) that the bf16 K4 kernel runs at
    these shapes, counted from its design: per chunk of 64 steps the six
    16 x 16 score tiles between sub-chunks and the four inner 16 x 8 tiles
    (R K^T over D, three split products each), A V over the ten lower
    16 x 16 blocks (two), R S and K^T V over 64 x D x D (three and two);
    a chunk before a block's run only K^T V.  On the CUDA cores the
    diagonal 8 x 8 blocks (an FMA and a multiply per entry and channel),
    the decayed operands (a product and the hi/lo rest per element) and
    the state's decay."""
    from repro_torch.kernels import autotile
    tiles = autotile.rwkv6_tiles(B, H, T, D, D)
    starts = autotile.rwkv6_segment_starts(T, tiles.segments)
    full = starts[-1]
    carried = sum(starts[:-1])
    mac_full = (6 * 16 * 16 * D * 3 + 4 * 16 * 8 * D * 3
                + 10 * 16 * 16 * D * 2 + 64 * D * D * 3 + D * 64 * D * 2)
    mac_carried = D * 64 * D * 2
    tc = 2 * B * H * (full * mac_full + carried * mac_carried)
    # 8 blocks x 36 entries x D channels x (FMA + multiply); 19 operand
    # tiles of 16 x D x (product + rest); the state's decay and rescale
    cc_full = 8 * 36 * D * 3 + 19 * 16 * D * 2 + 5 * D * D * 2
    cc = B * H * (full * cc_full + carried * (4 * 16 * D * 2 + 5 * D * D * 2))
    return float(tc), float(cc)


def bound(flops: float, nbytes: float,
          dtype_bytes: int) -> tuple[float, str]:
    """The least time (ms) for ``flops`` at the H100's peak rate for the
    element size (dense bf16 tensor cores, fp32 outside them) and ``nbytes``
    at its HBM3 rate, and which of the two bounds it.  The rates are
    ``autotile``'s, which its split-K model uses too."""
    from repro_torch.kernels.autotile import PEAK_BYTES, PEAK_FLOPS
    t_ops = flops / PEAK_FLOPS[dtype_bytes]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    t_start = time.perf_counter()
    marks: list[tuple[str, float]] = []

    def mark(phase: str) -> None:
        marks.append((phase, time.perf_counter()))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, autotile, ops
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                     decode_attention_cuda,
                                                     flash_attention_cuda)
    from repro_torch.kernels.gemm import gemm_cuda
    from repro_torch.kernels.rwkv6 import HEAD_DIMS as RWKV_HEAD_DIMS
    from repro_torch.kernels.rwkv6 import rwkv6_cuda
    from repro_torch.kernels.ssm_scan import STATE_DIMS, ssm_scan_cuda
    from repro_torch.models import blocks
    from repro_torch.models import transformer as TF
    from repro_torch.serve.engine import generate

    # ---- 1. device --------------------------------------------------------
    mark("1")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs the card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        fail(f"need an sm_90 card, got {torch.cuda.get_device_capability(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    # fp32 products run in full fp32 (no TF32) in the projections and refs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 2. build ---------------------------------------------------------
    mark("2")
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"phase 2 build: {', '.join(_build.sources())} in "
        f"{time.perf_counter() - t0:.1f}s")
    for name, text in logs.items():
        spills = [ln for ln in text.splitlines()
                  if "spill stores" in ln and " 0 bytes spill stores" not in ln]
        regs = [int(ln.split("Used ")[1].split()[0])
                for ln in text.splitlines() if "Used " in ln]
        # ptxas's note that it serialized a kernel's wgmma (C7518), e.g.
        # for a wgmma issued in a divergent branch
        serial = sum("C7518" in ln for ln in text.splitlines())
        log(f"  {name}: {len(regs)} kernels, max {max(regs, default=0)} "
            f"registers, {len(spills)} with spills, {serial} with wgmma "
            f"serialized (log: {_build.lib_path(name).with_suffix('.log')})")
    # K3's kernels one by one (T, N, S states a thread, 16-byte loads)
    k3 = _ptxas_kernels(
        _build.lib_path("ssm_scan").with_suffix(".log").read_text())
    for kname, (regs, spill) in k3.items():
        log(f"  ssm_scan {kname}: {regs} registers, {spill} bytes of spill "
            "stores")
    if not k3 or any(spill for _, spill in k3.values()):
        fail(f"K3 kernels spill or were not found in the ptxas log: {k3}")

    gen = torch.Generator(dev).manual_seed(0)

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def rwkv_inputs(B, H, T, D, dtype, decay="sigmoid"):
        """r, k, v, w, u as tests/test_kernels.py draws them: w in (0, 1);
        other ``decay``s cover the range a trained RWKV-6 has (w =
        exp(-exp(w_raw)), models/blocks.py), as tests/test_torch_kernels.py
        draws them: ``zero`` w = 0 exactly on a third of the steps,
        ``tiny`` w = 1e-30 on every other step, ``one`` w = 1 exactly on
        the even channels and every fourth step, ``mixed`` strong (1e-6 to
        1e-3) and mild (0.95 to 0.999) decays mixed in one chunk."""
        r, v = rand(B, H, T, D, dtype=dtype), rand(B, H, T, D, dtype=dtype)
        k = (0.3 * rand(B, H, T, D, dtype=torch.float32)).to(dtype)
        w = torch.sigmoid(rand(B, H, T, D, dtype=torch.float32) + 2.0)
        if decay == "zero":
            w[..., ::3, :] = 0.0
        elif decay == "tiny":
            w[..., 1::2, :] = 1e-30
        elif decay == "one":
            w[..., ::2] = 1.0
            w[..., ::4, :] = 1.0
        elif decay == "mixed":
            unit = torch.rand(w.shape, generator=gen, device=dev)
            strong = 10.0 ** (-6.0 + 3.0 * unit)
            mild = 0.95 + 0.049 * torch.rand(w.shape, generator=gen,
                                              device=dev)
            w = torch.where(torch.rand(w.shape, generator=gen, device=dev)
                            < 0.3, strong, mild)
        u = (0.1 * rand(H, D, dtype=torch.float32)).to(dtype)
        return r, k, v, w.to(dtype), u

    def ssm_inputs(Bt, L, Dm, N, dtype, decay="softplus"):
        """x, dt, A, B, C, D as tests/test_kernels.py draws them (dt after a
        softplus, A < 0); A and D fp32, as the Mamba block passes them.
        Other ``decay``s cover exp(dt·A)'s range, as
        tests/test_torch_kernels.py draws them: ``zero`` dt = 0 (a decay
        of exactly 1) on every third step, ``underflow`` A = -1e5 on the
        odd states (dt·A below -104 wherever dt > 1.04e-3: the decay
        underflows fp32), ``mixed`` A strong (|A| from 5 to 50) on 30% and
        mild (|A| from 0.02 to 0.2, log-uniform) on 70% of the (d, n).
        Strong decays come from A, as in a trained Mamba, not from a large
        dt: dt·x then stays of the order of x, and y is no cancellation of
        terms near 1e4 (where two fp32 sums in different orders differ by
        more than 1e-4).  Mild decays keep h's memory to ~100 steps;
        ``long_memory`` takes |A| log-uniform in [1e-3, 5e-2] on every
        (d, n), as in a trained Mamba (dt in [1e-3, 0.1], |A| up to 16):
        decays within ~1e-3 of 1 for most steps, h remembering hundreds
        to thousands of them, where the exps' own rounding (ex2.approx
        against torch.exp, up to 2 ulps a step) compounds past 1e-4 of h
        (check_scan holds that draw by the row gates)."""
        x = rand(Bt, L, Dm, dtype=dtype)
        dt = torch.nn.functional.softplus(
            rand(Bt, L, Dm, dtype=torch.float32) - 1.0)
        if decay == "zero":
            dt[:, ::3] = 0.0
        dt = dt.to(dtype)
        A = -torch.exp(0.5 * rand(Dm, N, dtype=torch.float32))
        if decay == "underflow":
            A[:, 1::2] = -1e5
        elif decay == "mixed":
            unit = lambda: torch.rand(A.shape, generator=gen, device=dev)
            strong, mild = 5.0 * 10.0 ** unit(), 0.02 * 10.0 ** unit()
            A = -torch.where(unit() < 0.3, strong, mild)
        elif decay == "long_memory":
            A = -1e-3 * 50.0 ** torch.rand(A.shape, generator=gen, device=dev)
        B, C = rand(Bt, L, N, dtype=dtype), rand(Bt, L, N, dtype=dtype)
        return x, dt, A, B, C, torch.full((Dm,), 0.5, device=dev)

    # ---- 3. kernels against their plain versions ---------------------------
    mark("3")
    log("phase 3 kernels vs plain")
    t0 = time.perf_counter()
    # K1: (M, K, N); fp32 within 1e-5 of the output's scale, bf16 2e-2 and
    # 2 bf16 ulps of the fp32 product (ref.gemm_rel_err).  Through ops.gemm
    # (the picked tile and split; every aligned bf16 product on the wgmma
    # kernel, as the library reports it), and the wgmma edge and split
    # shapes also at every built tile over 1 and 3 splits
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for (M, K, N), edge in [(c, False) for c in GEMM_CASES] + \
                [(c, True) for c in GEMM_EDGES]:
            x, w = rand(M, K, dtype=dtype), rand(K, N, dtype=dtype)
            t = autotile.gemm_tiles(M, N, K, x.element_size())
            splits = autotile.gemm_splits(M, N, K, t, x.element_size())
            name = (f"gemm {tag} ({M}x{K})@({K}x{N}) tiles=({t.bm},{t.bn},"
                    f"{t.bk}) splits={splits}")
            tc = gemm_cuda.wgmma_launches
            got = ops.gemm(x, w)
            aligned = dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0
            if gemm_cuda.wgmma_launches - tc != int(aligned):
                fail(f"{name}: {gemm_cuda.wgmma_launches - tc} launches of "
                     f"the wgmma kernel, want {int(aligned)}")
            runs = [(name, got)]
            if edge:
                for tb, tn, tk in autotile.GEMM_TILES[x.element_size()]:
                    for sp in sorted({1, min(3, -(-K // tk))}):
                        runs.append((f"  at ({tb},{tn},{tk}) splits={sp}",
                                     gemm_cuda(x, w, bm=tb, bn=tn, bk=tk,
                                               splits=sp)))
            for label, out in runs:
                check_gemm(label, out, x, w, quiet=label != name)
            del x, w, got, runs
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        cases = [((32, 8, 128), 384, 384, True, None, None, 0),
                 ((32, 32, 96), 2048, 2048, True, None, None, 0),
                 ((8, 8, 96), 333, 1500, False, None, None, 0),
                 ((8, 8, 64), 1, 1500, False, None, None, 0),
                 ((16, 8, 256), 384, 384, True, None, None, 0),
                 ((4, 1, 128), 384, 384, True, None, None, 0)]
        for window in (None, 16, 4096):
            for cap in (None, 50.0):
                T = 4224 if window == 4096 else 640
                heads = (16, 8, 256) if cap else (32, 8, 128)
                cases.append((heads, T, T, True, window, cap, 0))
        cases += [((32, 8, 128), 200, 333, False, None, None, 0),
                  ((16, 8, 256), 77, 130, False, None, 50.0, 0),
                  ((32, 8, 128), 64, 512, True, 256, None, 448)]
        for (Hq, Hkv, D), Tq, Tk, causal, window, cap, off in cases:
            q, k, v = (rand(1, Hq, Tq, D, dtype=dtype),
                       rand(1, Hkv, Tk, D, dtype=dtype),
                       rand(1, Hkv, Tk, D, dtype=dtype))
            kw = dict(causal=causal, window=window, softcap=cap, offset=off)
            got = ops.flash_attention(q, k, v, **kw)
            name = (f"prefill {tag} H=({Hq},{Hkv}) D={D} Tq={Tq} Tk={Tk} "
                    f"causal={causal} window={window} softcap={cap} "
                    f"offset={off}")
            check_close(name, got, R.attention_ref(q, k, v, **kw), tol)
            if dtype == torch.bfloat16:
                check_rel(name, got, q, k, v, kw)
        # every built (head_dim, bq, bk) instantiation of the dtype's
        # kernel, ragged and windowed
        route = "tensor-core" if dtype == torch.bfloat16 else "CUDA-core"
        for D in HEAD_DIMS:
            q, k, v = (rand(2, 4, 150, D, dtype=dtype),
                       rand(2, 2, 150, D, dtype=dtype),
                       rand(2, 2, 150, D, dtype=dtype))
            want = R.attention_ref(q, k, v, window=40, softcap=30.0)
            for bq, bk in autotile.attention_built_tiles(D, q.element_size()):
                got = flash_attention_cuda(q, k, v, bq=bq, bk=bk, window=40,
                                           softcap=30.0)
                name = (f"prefill {tag} {route} D={D} tiles=({bq},{bk}) "
                        "T=150 window=40 softcap=30")
                check_close(name, got, want, tol)
                if dtype == torch.bfloat16:
                    check_rel(name, got, q, k, v,
                              dict(window=40, softcap=30.0))
            q1 = q[:, :, :1].contiguous()
            pos = torch.tensor(97, dtype=torch.int32, device=dev)
            check_close(f"decode {tag} D={D} S=150 pos=97 window=40",
                        decode_attention_cuda(q1, k, v, pos, window=40),
                        R.decode_attention_ref(q1, k, v, window=40, pos=97),
                        tol)
        # ragged Tq and Tk with B*H > 1 (a tile past T reads and writes no
        # row of the next head), Whisper's cross step, offset + window, GQA
        # groups 1 / 4 / 32 and softcap at D = 256: every head, every tile
        for B, Hq, Hkv, Tq, Tk, D, causal, window, cap, off in EDGE_CASES:
            q, k, v = (rand(B, Hq, Tq, D, dtype=dtype),
                       rand(B, Hkv, Tk, D, dtype=dtype),
                       rand(B, Hkv, Tk, D, dtype=dtype))
            kw = dict(causal=causal, window=window, softcap=cap, offset=off)
            want = R.attention_ref(q, k, v, **kw)
            rel = []
            for bq, bk in autotile.attention_built_tiles(D, q.element_size()):
                got = flash_attention_cuda(q, k, v, bq=bq, bk=bk, **kw)
                name = (f"prefill {tag} {route} B={B} H=({Hq},{Hkv}) D={D} "
                        f"Tq={Tq} Tk={Tk} causal={causal} window={window} "
                        f"softcap={cap} offset={off} tiles=({bq},{bk})")
                if dtype == torch.bfloat16:
                    rel.append(check_rel(name, got, q, k, v, kw, quiet=True))
                for b in range(B):
                    for h in range(Hq):
                        check_close(f"{name} b={b} h={h}", got[b, h],
                                    want[b, h], tol, quiet=True)
            log(f"  prefill {tag} {route} B={B} H=({Hq},{Hkv}) D={D} Tq={Tq} "
                f"Tk={Tk} causal={causal} window={window} softcap={cap} "
                f"offset={off}: every head within {tol:g} at tiles "
                f"{autotile.attention_built_tiles(D, q.element_size())}"
                + (f", rel_err at most {max(rel):.3e} (tol "
                   f"{BF16_REL_TOL:g})" if rel else ""))
        # K2 decode, split across blocks: GQA groups 4 / 2 / 1 / 8
        # (Mistral-NeMo, Gemma-2, Phi-3-vision, Jamba), S whole and ragged
        # (4097: a last chunk of one row), pos at 0, 100, the chunk edges
        # L - 1 and L, S/2 and S - 1, windows that leave whole chunks out
        # or cross an edge, softcap; and Gemma-2's 4096 window over 8192
        # positions; bf16 also against the fp32 plain version
        dec_cases = [(heads, S, window, cap)
                     for heads in ((32, 8, 128), (16, 8, 256), (32, 32, 96),
                                   (64, 8, 128))
                     for S in (4096, 4097)
                     for window, cap in ((None, None), (16, 50.0),
                                         (1000, None))]
        dec_cases.append(((16, 8, 256), 8192, 4096, 50.0))
        for (Hq, Hkv, D), S, window, cap in dec_cases:
            q = rand(4, Hq, 1, D, dtype=dtype)
            k, v = rand(4, Hkv, S, D, dtype=dtype), rand(4, Hkv, S, D,
                                                         dtype=dtype)
            L, splits = autotile.decode_splits(4, Hkv, Hq // Hkv, S, D,
                                               q.element_size())
            name = (f"decode {tag} H=({Hq},{Hkv}) D={D} S={S} "
                    f"window={window} softcap={cap} chunk={L} "
                    f"splits={splits}")
            errs, rel = [], []
            for pos in sorted({0, 100, L - 1, L, S // 2, S - 1}):
                pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
                kw = dict(window=window, softcap=cap)
                got = ops.decode_attention(q, k, v, pos=pos_t, **kw)
                errs.append(check_close(
                    f"{name} pos={pos}", got,
                    R.decode_attention_ref(q, k, v, pos=pos, **kw), tol,
                    quiet=True))
                if dtype == torch.bfloat16:
                    rel.append(check_rel(
                        f"{name} pos={pos}", got, q, k, v,
                        dict(causal=True, offset=pos, **kw), quiet=True))
            log(f"  {name}: pos 0, 100, L-1, L, S/2, S-1 within {tol:g}, "
                f"max_abs_err {max(errs):.3e}"
                + (f", rel_err at most {max(rel):.3e} (tol "
                   f"{BF16_REL_TOL:g})" if rel else ""))
    # K2 at the full shapes of phase 4g-4k's configs, bf16 (the dtype they
    # serve in): prefill through ops.flash_attention (the picked tile)
    # within 3e-2 and the row-relative gate, every head; decode split across
    # blocks at pos 0, 100, the chunk edges, S/2 and S - 1
    for tag, Bf, Hq, Hkv, T, D, window, cap in FULL_PREFILL:
        q = rand(Bf, Hq, T, D, dtype=torch.bfloat16)
        k, v = (rand(Bf, Hkv, T, D, dtype=torch.bfloat16) for _ in range(2))
        kw = dict(causal=True, window=window, softcap=cap)
        got = ops.flash_attention(q, k, v, **kw)
        name = (f"prefill bf16 at the {tag} shape B={Bf} H=({Hq},{Hkv}) T={T} "
                f"D={D} window={window} softcap={cap} tiles="
                f"{autotile.attention_tiles(T, T, D, 2)}")
        check_close(name, got, R.attention_ref(q, k, v, **kw), BF16_TOL)
        check_rel(name, got, q, k, v, kw)
        del q, k, v, got
        torch.cuda.empty_cache()
    for tag, Hq, Hkv, D in FULL_DECODE:
        S, Bd = 4096, 4
        q = rand(Bd, Hq, 1, D, dtype=torch.bfloat16)
        k, v = (rand(Bd, Hkv, S, D, dtype=torch.bfloat16) for _ in range(2))
        L, splits = autotile.decode_splits(Bd, Hkv, Hq // Hkv, S, D, 2)
        name = (f"decode bf16 at the {tag} shape B={Bd} H=({Hq},{Hkv}) D={D} "
                f"S={S} rows={autotile.decode_rows(Hq // Hkv)} chunk={L} "
                f"splits={splits}")
        errs, rel = [], []
        for pos in sorted({0, 100, L - 1, L, S // 2, S - 1}):
            pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
            got = ops.decode_attention(q, k, v, pos=pos_t)
            errs.append(check_close(
                f"{name} pos={pos}", got,
                R.decode_attention_ref(q, k, v, pos=pos), BF16_TOL,
                quiet=True))
            rel.append(check_rel(f"{name} pos={pos}", got, q, k, v,
                                 dict(causal=True, offset=pos), quiet=True))
        log(f"  {name}: pos 0, 100, L-1, L, S/2, S-1 within {BF16_TOL:g}, "
            f"max_abs_err {max(errs):.3e}, rel_err at most {max(rel):.3e} "
            f"(tol {BF16_REL_TOL:g})")
        del q, k, v
    # the RWKV-6 recurrence: o at the dtype's tolerance; S_last is fp32 from
    # the same rounded inputs on both sides, so it is held at the scan's;
    # bf16 (the tensor-core kernel, every call checked) also within one ulp
    # of the fp32 plain version and against the chunked plain version; then
    # decays across the whole range, at a ragged T over three chunks and
    # over 32 chunks
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        cases = [(Dk, B, H, T, "sigmoid") for Dk, _ in RWKV_HEAD_DIMS
                 for B, H in ((1, 64), (2, 4)) for T in (1, 16, 77, 2048)]
        cases += [(Dk, B, H, T, decay) for decay in RWKV_DECAYS[1:]
                  for Dk, _ in RWKV_HEAD_DIMS
                  for B, H, T in ((2, 4, 131), (1, 8, 2048))]
        for Dk, B, H, T, decay in cases:
            args = rwkv_inputs(B, H, T, Dk, dtype, decay)
            tc = rwkv6_cuda.tensor_core_launches
            o, s_last = rwkv6_cuda(*args)
            name = f"rwkv6 {tag} D={Dk} B={B} H={H} T={T} decay={decay}"
            if rwkv6_cuda.tensor_core_launches - tc != int(
                    dtype == torch.bfloat16):
                fail(f"{name}: the library reported another route than "
                     "the dtype's kernel")
            check_rwkv(name, o, s_last, args)
    # the Mamba selective scan (check_scan: fp32 1e-4, bf16 one ulp and
    # rel_err one ulp, h_last 1e-4 and SCAN_ROW_TOL of its row; the long
    # memory by the row gates), through ops.ssm_scan (the one built S for
    # each N) over N, the shapes and the decays
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for N in STATE_DIMS:
            for Bt, L, Dm in SSM_SHAPES:
                errs, rels, h_rels = [], {}, {}
                for decay in SSM_DECAYS:
                    args = ssm_inputs(Bt, L, Dm, N, dtype, decay)
                    before = ssm_scan_cuda.launches
                    y, h_last = ops.ssm_scan(*args)
                    if ssm_scan_cuda.launches != before + 1:
                        fail("ops.ssm_scan did not launch K3 once")
                    long = decay == "long_memory"
                    err, rels[decay], h_rels[decay] = check_scan(
                        f"ssm_scan {tag} N={N} Bt={Bt} L={L} Dm={Dm} "
                        f"decay={decay}", y, h_last, args, quiet=True,
                        long_memory=long)
                    if not long:
                        errs.append(err)
                y_tol = BF16_ULP if dtype == torch.bfloat16 else SCAN_TOL
                log(f"  ssm_scan {tag} N={N} S={dict(autotile.SSM_TILES)[N]}"
                    f" Bt={Bt} L={L} Dm={Dm}: decays but long_memory, y "
                    f"within {y_tol:g} and h_last within {SCAN_TOL:g}, "
                    f"max_abs_err {max(errs):.3e}; state_rel_err "
                    + ", ".join(f"{d} {r:.3e}" for d, r in h_rels.items())
                    + f" (tol {SCAN_ROW_TOL:g}); y rel_err "
                    + ", ".join(f"{d} {r:.3e}" for d, r in rels.items()
                                if r is not None))
    # the fp32 route over a long memory against the scan in float64, the
    # arbiter of the kernel and of the fp32 plain scan, at the main shape
    # for each built N: each reading as max |got - want| and as the ratio
    # |got - want| / (tol + tol |want|) at SCAN_TOL (at most 1 within it;
    # with rtol = atol the ratio scales as 1 / tol), each held at its
    # measured tolerance
    for N in STATE_DIMS:
        args = ssm_inputs(*SSM_SHAPES[0], N, torch.float32, "long_memory")
        want = R.selective_scan_ref(*(t.double() for t in args))
        for who, got, tol in (("kernel", ops.ssm_scan(*args), F64_KERNEL_TOL),
                              ("plain", R.selective_scan_ref(*args),
                               F64_PLAIN_TOL)):
            read = {}
            for part, g, w in zip(("y", "h_last"), got, want):
                err = (g.double() - w).abs()
                read[part] = (err.max().item(), (err / (
                    SCAN_TOL + SCAN_TOL * w.abs())).max().item())
            log(f"  ssm_scan fp32 {who} N={N} long_memory {SSM_SHAPES[0]} "
                "vs float64: " + ", ".join(
                    f"{k} max_abs_err {a:.3e}, {r:.3f} x the {SCAN_TOL:g} "
                    "gate" for k, (a, r) in read.items())
                + f" (held at {tol:g})")
            if any(r * SCAN_TOL > tol for _, r in read.values()):
                fail(f"ssm_scan fp32 {who} N={N} long_memory: outside "
                     f"rtol = atol = {tol:g} of the float64 scan")
    torch.cuda.synchronize()
    log(f"phase 3 done in {time.perf_counter() - t0:.1f}s")

    # ---- 4. main paths at full width and depth, bf16 ----------------------
    mark("4")
    counters = (flash_attention_cuda, decode_attention_cuda, rwkv6_cuda,
                ssm_scan_cuda, gemm_cuda)

    def reset():
        for fn, name in ops.COUNTERS:
            setattr(fn, name, 0)

    def launches():
        """(flash prefill, flash decode, rwkv6, ssm_scan, gemm) launches
        since reset()."""
        return tuple(c.launches for c in counters)

    t4 = time.perf_counter()
    # a. Mistral-NeMo-12B: K2 prefill once per layer in forward, K2 decode
    #    once per layer and step in generate (one split: the cache holds
    #    40 positions); then decode steps over a 4096-position cache, where
    #    every K2 decode call splits
    cfg = get_config("mistral_nemo_12b")
    L = cfg.n_layers
    log(f"phase 4a main path: {cfg.name} d_model={cfg.d_model} "
        f"heads=({cfg.n_heads},{cfg.n_kv_heads}) head_dim={cfg.hd} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} depth {L} of {L} (no cut) "
        f"dtype={cfg.dtype}")
    fwd_launches, gen_launches = _serve(
        cfg, 0, dev, gen, reset, launches, want_fwd=(L, 0, 0, 0, 0),
        want_gen=lambda steps: (0, L * steps, 0, 0, 0),
        then=lambda params: _long_cache(cfg, params, dev, gen, reset,
                                        launches))

    # b. RWKV-6 7B: K4 once per layer in forward; generate runs the plain
    #    recurrence step (as the reference does) and launches no kernel
    rcfg = get_config("rwkv6_7b")
    RL = rcfg.n_layers
    log(f"phase 4b main path: {rcfg.name} d_model={rcfg.d_model} heads="
        f"{rcfg.d_model // rcfg.rwkv_head_dim}x{rcfg.rwkv_head_dim} "
        f"decay_rank={rcfg.rwkv_decay_rank} d_ff={rcfg.d_ff} "
        f"vocab={rcfg.vocab_size} depth {RL} of {RL} (no cut) "
        f"dtype={rcfg.dtype}")
    rwkv_fwd_launches, _ = _serve(
        rcfg, 3, dev, gen, reset, launches, want_fwd=(0, 0, RL, 0, 0),
        want_gen=lambda steps: (0, 0, 0, 0, 0))

    # c. Jamba-1.5-Large: K3 once per Mamba layer and K2 prefill once in
    #    forward; generate runs the plain Mamba step (as the reference does)
    #    and K2 decode once per step in its attention layer
    full = get_config("jamba_1_5_large_398b")
    jcfg = dataclasses.replace(full, layer_pattern=full.layer_pattern[:7],
                               n_periods=1)
    kinds = ", ".join(f"{i}:{s.kind}{'+moe' if s.moe else ''}"
                      for i, s in enumerate(jcfg.layer_pattern))
    n_mamba = sum(s.kind == "mamba" for s in jcfg.layer_pattern)
    n_attn = sum(s.kind == "attn" for s in jcfg.layer_pattern)
    one_period = dataclasses.replace(full, n_periods=1)
    log(f"phase 4c main path: {jcfg.name} d_model={jcfg.d_model} "
        f"d_inner={jcfg.d_inner} d_state={jcfg.d_state} dt_rank={jcfg.dtr} "
        f"d_conv={jcfg.d_conv} heads=({jcfg.n_heads},{jcfg.n_kv_heads})x"
        f"{jcfg.hd} experts={jcfg.n_experts} top-{jcfg.top_k} "
        f"d_ff={jcfg.d_ff} vocab={jcfg.vocab_size} dtype={jcfg.dtype}")
    log(f"  cut: layers [{kinds}] of the first period, {jcfg.n_layers} of "
        f"{full.n_layers}: one whole period is "
        f"{one_period.n_params() / 1e9:.2f}B parameters, "
        f"{one_period.n_params() * 2 / 2**30:.2f} GiB in bf16, more than "
        "the card holds; the first 7 layers keep every layer kind (Mamba, "
        "Mamba + MoE, attention) at full width")
    jamba_fwd_launches, _ = _serve(
        jcfg, 5, dev, gen, reset, launches,
        want_fwd=(n_attn, 0, 0, n_mamba, 0),
        want_gen=lambda steps: (0, n_attn * steps, 0, 0, 0))

    # d. Whisper-base: K2 prefill in every attention of forward_encdec (6
    #    encoder, 6 decoder, 6 cross); per serve step K2 decode in each
    #    decoder self-attention and K2 prefill in each cross-attention
    wcfg = get_config("whisper_base")
    log(f"phase 4d main path: {wcfg.name} encoder {wcfg.n_enc_layers} + "
        f"decoder {wcfg.n_layers} layers (no cut) d_model={wcfg.d_model} "
        f"heads=({wcfg.n_heads},{wcfg.n_kv_heads})x{wcfg.hd} "
        f"d_ff={wcfg.d_ff} vocab={wcfg.vocab_size} frames="
        f"{wcfg.enc_seq_len} dtype={wcfg.dtype}")
    _whisper(wcfg, 10, dev, gen, reset, launches)

    # e. Phi-3-vision 4.2B: K2 prefill once per layer over prefix + tokens,
    #    K2 decode once per layer and step in generate (no prefix, as in the
    #    reference)
    pcfg = get_config("phi_3_vision_4_2b")
    PL = pcfg.n_layers
    log(f"phase 4e main path: {pcfg.name} d_model={pcfg.d_model} "
        f"heads=({pcfg.n_heads},{pcfg.n_kv_heads})x{pcfg.hd} "
        f"d_ff={pcfg.d_ff} vocab={pcfg.vocab_size} prefix={pcfg.prefix_len} "
        f"depth {PL} of {PL} (no cut) dtype={pcfg.dtype}")
    phi_fwd_launches, _ = _serve(
        pcfg, 11, dev, gen, reset, launches, want_fwd=(PL, 0, 0, 0, 0),
        want_gen=lambda steps: (0, PL * steps, 0, 0, 0),
        prefix=pcfg.prefix_len)

    # f. K1's path, ops.gemm: the micro-bench's product
    #    (benchmarks/run.py:435-449) and Mistral-NeMo's up-projection at
    #    T = 2048; no model path launches K1 (the projections are plain
    #    products, as the reference's are XLA dots)
    log("phase 4f K1 path: ops.gemm (each model path above launched K1 "
        "0 times, as its checked counts show)")
    gemm_path = ((512, 512, 512, torch.float32),
                 (2048, cfg.d_model, cfg.d_ff, torch.bfloat16))
    operands = [(rand(M, K, dtype=dt), rand(K, N, dtype=dt))
                for M, K, N, dt in gemm_path]
    reset()
    outs = [ops.gemm(x, w) for x, w in operands]
    torch.cuda.synchronize()
    gemm_launches = launches()
    if gemm_launches != (0, 0, 0, 0, len(gemm_path)):
        fail(f"ops.gemm launches {gemm_launches}, want "
             f"{(0, 0, 0, 0, len(gemm_path))}")
    if gemm_cuda.wgmma_launches != 1:
        fail(f"{gemm_cuda.wgmma_launches} of ops.gemm's launches took the "
             "wgmma kernel, want 1 (the bf16 product)")
    log("  K1 on the wgmma kernel: 1 of 1 bf16 launch (the fp32 product "
        "on the CUDA cores)")
    for (x, w), out in zip(operands, outs):
        check_gemm(f"ops.gemm ({x.shape[0]}x{x.shape[1]})@({w.shape[0]}x"
                   f"{w.shape[1]}) {str(x.dtype)[6:]}", out, x, w)
    del operands, outs
    log(f"phase 4a-4f done in {time.perf_counter() - t4:.1f}s")

    # g-k. the five configs not served above, at full width: K2 prefill
    #      once per layer in forward, K2 decode once per layer and step in
    #      generate; MoE layers run their experts on the plain products
    #      (no kernel), at the configured capacity factor
    t4 = time.perf_counter()
    for phase, arch, seed, T, cut in SERVED_WIDE:
        whole = get_config(arch)
        wcfg_ = (whole if cut is None
                 else dataclasses.replace(whole, n_periods=cut))
        n = wcfg_.n_layers
        windows = sorted({str(s.window) for s in wcfg_.layer_pattern})
        log(f"phase {phase} main path: {wcfg_.name} d_model={wcfg_.d_model} "
            f"heads=({wcfg_.n_heads},{wcfg_.n_kv_heads})x{wcfg_.hd} "
            f"d_ff={wcfg_.d_ff} vocab={wcfg_.vocab_size} windows={windows} "
            f"softcap={wcfg_.attn_softcap}/{wcfg_.final_softcap} "
            f"post_norm={wcfg_.post_block_norm} act={wcfg_.activation} "
            f"glu={wcfg_.glu} tied={wcfg_.tie_embeddings} "
            f"scaled={wcfg_.scale_embeddings} rope_theta={wcfg_.rope_theta}"
            + (f" experts={wcfg_.n_experts} top-{wcfg_.top_k} shared="
               f"{wcfg_.n_shared_experts} d_ff_expert={wcfg_.d_ff_e} "
               f"capacity_factor={wcfg_.capacity_factor} (decode at batch "
               f"4: {blocks.moe_capacity(wcfg_, 4)} slot an expert)"
               if wcfg_.n_experts else "")
            + f" depth {n} of {whole.n_layers} dtype={wcfg_.dtype}")
        if cut is not None:
            log(f"  cut: the first {n} of {whole.n_layers} layers: the whole "
                f"model is {whole.n_params() / 1e9:.2f}B parameters, "
                f"{whole.n_params() * 2 / 2**30:.2f} GiB in bf16, more than "
                f"the card holds; {n} layers are "
                f"{wcfg_.n_params() * 2 / 2**30:.2f} GiB, every layer of "
                "the same kind (attention + MoE with a shared expert)")
        _serve(wcfg_, seed, dev, gen, reset, launches,
               want_fwd=(n, 0, 0, 0, 0),
               want_gen=lambda steps, n=n: (0, n * steps, 0, 0, 0), T=T)
    log(f"phase 4g-4k done in {time.perf_counter() - t4:.1f}s")

    # ---- 5. fp32 consistency at mistral and rwkv width, depth 2 ------------
    mark("5")
    log("phase 5 fp32 consistency (tol 1e-3: cuBLAS sums in another order "
        "for the 128-row forward than for the 2-row decode step, and the "
        "kernels than the plain versions)")
    _consistency(dataclasses.replace(cfg, n_periods=2, dtype="float32"), 1,
                 dev, gen, reset, launches, want_fwd=(2, 0, 0, 0, 0))
    log("  (the RWKV decode step keeps w in fp32, as the forward does in "
        "fp32)")
    _consistency(dataclasses.replace(rcfg, n_periods=2, dtype="float32"), 4,
                 dev, gen, reset, launches, want_fwd=(0, 0, 2, 0, 0))
    pat = full.layer_pattern
    log("  (Jamba: layers 0, 1 and 4 — Mamba, Mamba + MoE, attention — at "
        "capacity factor 8.0, so neither the forward nor a decode step "
        "drops a token; the Mamba decode step keeps dt in fp32, as the "
        "forward does in fp32)")
    _consistency(dataclasses.replace(full, layer_pattern=(pat[0], pat[1],
                                                          pat[4]),
                                     n_periods=1, dtype="float32",
                                     capacity_factor=8.0), 6,
                 dev, gen, reset, launches, want_fwd=(1, 0, 0, 2, 0))
    log("  (Whisper-base at full width and depth: forward_encdec over 2 x "
        "1500 frames, kernels vs plain, and 64 teacher-forced serve steps "
        "vs forward_encdec)")
    _whisper_consistency(dataclasses.replace(wcfg, dtype="float32"), 12, dev,
                         gen, reset, launches)
    log("  (Phi-3-vision at depth 2 with its 576-patch prefix: forward "
        "kernels vs plain)")
    p2 = dataclasses.replace(pcfg, n_periods=2, dtype="float32")
    params = TF.init_params(p2, torch.Generator(dev).manual_seed(13), dev)
    with torch.inference_mode():
        toks = torch.randint(0, p2.vocab_size, (2, 64), generator=gen,
                             device=dev, dtype=torch.int32)
        prefix = rand(2, p2.prefix_len, p2.d_model, dtype=torch.float32)
        reset()
        lk, _ = TF.forward(params, toks, p2, prefix_embeds=prefix)
        if launches() != (2, 0, 0, 0, 0):
            fail(f"{p2.name} fp32 forward launches {launches()}, want "
                 "(2, 0, 0, 0, 0)")
        lr, _ = TF.forward(params, toks, p2, prefix_embeds=prefix,
                           backend="ref")
        check_close(f"{p2.name} depth 2 prefix {p2.prefix_len} + 64 forward "
                    "kernel vs plain", lk, lr, 1e-3)
    del params, lk, lr
    torch.cuda.empty_cache()
    log("  (phase 4g-4k's configs at full width, depth 2: Gemma-2 one "
        "period, a windowed and a global layer; the MoE ones at capacity "
        "factor E / k, at which every capacity is the token count: 8.0 "
        "leaves Llama-4-Scout's top-1 of 16 experts one slot an expert in "
        "a decode step at batch 2, so a decode step could drop a token)")
    for _, arch, seed, _, _ in SERVED_WIDE:
        whole = get_config(arch)
        over = dict(n_periods=2 // len(whole.layer_pattern), dtype="float32")
        if whole.n_experts:
            over["capacity_factor"] = whole.n_experts / whole.top_k
        _consistency(dataclasses.replace(whole, **over), seed + 10, dev, gen,
                     reset, launches, want_fwd=(2, 0, 0, 0, 0))

    # ---- 6. gemma2_9b smoke width through generate --------------------------
    mark("6")
    cfg3 = dataclasses.replace(get_config("gemma2_9b", reduced=True),
                               dtype="float32")
    log(f"phase 6 {cfg3.name}: window {cfg3.layer_pattern[0].window}, "
        f"softcap {cfg3.attn_softcap}/{cfg3.final_softcap}, post-norm, tied")
    params3 = TF.init_params(cfg3, torch.Generator(dev).manual_seed(2), dev)
    with torch.inference_mode():
        prompts3 = torch.randint(0, cfg3.vocab_size, (2, 24), generator=gen,
                                 device=dev, dtype=torch.int32)
        got = generate(params3, cfg3, prompts3, max_new=16)
        want = generate(params3, cfg3, prompts3, max_new=16, backend="ref")
        if not torch.equal(got, want):
            fail("gemma2 smoke: kernel and plain generate disagree")
        log(f"  generate kernel == plain: {got.shape[1] - 24} new tokens, "
            f"sample {got[0, -8:].tolist()}")
        seq = got[:, :-1]
        check_close("gemma2 forward kernel vs plain",
                    TF.forward(params3, seq, cfg3)[0],
                    TF.forward(params3, seq, cfg3, backend="ref")[0], F32_TOL)
    del params3
    # Jamba smoke in fp32 at its own capacity factor: at batch 4 a decode
    # step has capacity 3 per expert for 8 choices, so MoE drops happen on
    # the card and must pick the same tokens as the plain path
    cfg4 = dataclasses.replace(get_config("jamba_1_5_large_398b",
                                          reduced=True), dtype="float32")
    log(f"phase 6 {cfg4.name}: fp32, capacity factor "
        f"{cfg4.capacity_factor}, d_state {cfg4.d_state}")
    params4 = TF.init_params(cfg4, torch.Generator(dev).manual_seed(7), dev)
    with torch.inference_mode():
        prompts4 = torch.randint(0, cfg4.vocab_size, (4, 24), generator=gen,
                                 device=dev, dtype=torch.int32)
        got = generate(params4, cfg4, prompts4, max_new=16)
        want = generate(params4, cfg4, prompts4, max_new=16, backend="ref")
        if not torch.equal(got, want):
            fail("jamba smoke: kernel and plain generate disagree")
        log(f"  generate kernel == plain: {got.shape[1] - 24} new tokens, "
            f"sample {got[0, -8:].tolist()}")
        seq = got[:, :-1]
        want4 = tuple(cfg4.n_periods * sum(s.kind == kind
                                           for s in cfg4.layer_pattern)
                      for kind in ("attn", "", "", "mamba", ""))
        reset()
        lk, aux_k = TF.forward(params4, seq, cfg4)
        if launches() != want4:
            fail(f"jamba smoke forward launches {launches()}, want {want4}")
        lr, aux_r = TF.forward(params4, seq, cfg4, backend="ref")
        check_close("jamba smoke forward kernel vs plain", lk, lr, F32_TOL)
        check_close("jamba smoke aux kernel vs plain", aux_k, aux_r, F32_TOL)
    del params4

    # ---- 7. timings at the main paths' shapes -----------------------------
    mark("7")
    log("phase 7 timings (CUDA events; bf16 unless marked)")
    log(f"  card at the start: {_clocks()}")
    bf = torch.bfloat16
    kernels = []
    # K1 at Mistral-NeMo's up-projection at T = 2048 in bf16 (the row, with
    # every built tile's time), the micro-bench's 512^3 in fp32 and the
    # decode-shaped (1 and 7) x 5120 . (5120 x 5120) in bf16 (logged);
    # 2MNK flops, each operand read and the product written once; the
    # library call is torch.matmul (cuBLAS, TF32 off).  The small products
    # (split across blocks) are also timed as CUDA graphs: their eager
    # calls are paced by the host
    for tag, (M, K, N, dt) in (
            ("Mistral-NeMo's up-projection", gemm_path[1]),
            ("the micro-bench's shape", gemm_path[0]),
            ("decode shape M=1", (1, cfg.d_model, cfg.d_model, bf)),
            ("decode shape M=7", (7, cfg.d_model, cfg.d_model, bf))):
        x, w = rand(M, K, dtype=dt), rand(K, N, dtype=dt)
        eb = x.element_size()
        t = autotile.gemm_tiles(M, N, K, eb)
        splits = autotile.gemm_splits(M, N, K, t, eb)
        kern = lambda: gemm_cuda(x, w, bm=t.bm, bn=t.bn, bk=t.bk,
                                 splits=splits)
        plain = lambda: R.gemm_ref(x, w)
        lib = lambda: torch.matmul(x, w)
        err = check_gemm(f"gemm at {tag}", kern(), x, w)
        flops = 2 * M * N * K
        nbytes = eb * (M * K + K * N + M * N)
        b_ms, b_by = bound(flops, nbytes, eb)
        small = M * N < 2 ** 20
        row = _row("gemm", gemm_launches[4], err, kern, plain, lib, b_ms,
                   b_by, f"{tag}: ({M}x{K})@({K}x{N}) {str(dt)[6:]} tiles=("
                   f"{t.bm},{t.bn},{t.bk}) splits={splits}"
                   + ("; ms and library ms as CUDA graphs" if small else ""),
                   graph=small, **GEMM)
        log(f"    {flops / row['ms'] / 1e9:.1f} TFLOP/s, "
            f"{nbytes / row['ms'] / 1e6:.0f} GB/s, "
            f"{b_ms / row['ms'] * 100:.1f}% of the bound")
        if small:
            log(f"    eager (host-paced) calls: kernel {time_ms(kern):.4f} "
                f"ms, torch.matmul {time_ms(lib):.4f} ms")
        for tb, tn, tk in autotile.GEMM_TILES[eb]:
            sp = autotile.gemm_splits(M, N, K, (tb, tn, tk), eb)
            ms = time_ms(lambda: gemm_cuda(x, w, bm=tb, bn=tn, bk=tk,
                                           splits=sp), graph=small)
            picked = " (picked)" if (tb, tn, tk) == (t.bm, t.bn, t.bk) else ""
            log(f"    tiles ({tb},{tn},{tk}) splits={sp}{picked}: {ms:.4f} "
                f"ms, {flops / ms / 1e9:.1f} TFLOP/s")
        if tag == "Mistral-NeMo's up-projection":
            kernels.append(row)
        del x, w
    # K2 prefill in bf16 (the tensor-core kernel) at the main paths' shapes:
    # Mistral-NeMo's forward (the row), Phi-3-vision's, Whisper's encoder
    # and Whisper's cross-attention step (Tq = 1 over the 1500 frames), each
    # beside its bound, the plain version and SDPA, with every built tile's
    # time so that the intensity objective's pick can be judged.  4·D flops
    # per unmasked (q, k) pair; q, k, v read and o written once
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    for tag, Bp, Hp, Hkvp, Tqp, Tkp, Dp, causal, *extra in (
            ("Mistral-NeMo", 1, Hq, Hkv, 2048, 2048, D, True),
            ("Phi-3-vision", 1, pcfg.n_heads, pcfg.n_kv_heads, 2048, 2048,
             pcfg.hd, True),
            ("Whisper encoder", 4, wcfg.n_heads, wcfg.n_kv_heads,
             wcfg.enc_seq_len, wcfg.enc_seq_len, wcfg.hd, False),
            ("Whisper cross-attention step", 4, wcfg.n_heads,
             wcfg.n_kv_heads, 1, wcfg.enc_seq_len, wcfg.hd, False),
            *((tag, Bf, Hf, Hkvf, Tf, Tf, Df, True, window, cap)
              for tag, Bf, Hf, Hkvf, Tf, Df, window, cap in FULL_PREFILL)):
        window, cap = (tuple(extra) + (None, None))[:2]
        q = rand(Bp, Hp, Tqp, Dp, dtype=bf)
        k, v = (rand(Bp, Hkvp, Tkp, Dp, dtype=bf) for _ in range(2))
        bq, bk = autotile.attention_tiles(Tqp, Tkp, Dp, q.element_size())
        kw = dict(causal=causal, window=window, softcap=cap)
        kern = lambda: flash_attention_cuda(q, k, v, bq=bq, bk=bk, **kw)
        plain = lambda: R.attention_ref(q, k, v, **kw)
        got = kern()
        err = check_close(f"prefill at the {tag} shape", got, plain(),
                          BF16_TOL)
        check_rel(f"prefill at the {tag} shape", got, q, k, v, kw)
        del got
        pairs = (Tqp * Tkp if not causal else Tqp * (Tqp + 1) / 2
                 if window is None else
                 sum(min(i + 1, window) for i in range(Tqp)))
        flops = 4 * Bp * Hp * Dp * pairs
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        b_ms, b_by = bound(flops, nbytes, 2)
        # SDPA takes no softcap, so the windowed shape's library call is
        # timed over the same keys (the window as a boolean mask) without it
        lib = (_sdpa(q, k, v, causal=causal) if window is None else
               _sdpa_window(q, k, v, window))
        row = _row("flash_attention_prefill",
                   fwd_launches[0] if tag == "Mistral-NeMo" else None, err,
                   kern, plain, lib, b_ms, b_by,
                   f"{tag}: B={Bp} Hq={Hp} Hkv={Hkvp} Tq={Tqp} Tk={Tkp} "
                   f"D={Dp} causal={causal} window={window} softcap={cap} "
                   f"tiles=({bq},{bk})"
                   + ("" if window is None else "; library without the "
                      "softcap, the window as a mask")
                   + ("; ms and library ms as CUDA graphs" if extra else ""),
                   graph=bool(extra), **FLASH)
        log(f"    {flops / row['ms'] / 1e9:.1f} TFLOP/s, "
            f"{b_ms / row['ms'] * 100:.1f}% of the bound")
        for tb, tk in autotile.attention_built_tiles(Dp, q.element_size()):
            ms = time_ms(lambda: flash_attention_cuda(q, k, v, bq=tb, bk=tk,
                                                      **kw))
            picked = " (picked)" if (tb, tk) == (bq, bk) else ""
            log(f"    tiles ({tb},{tk}){picked}: {ms:.4f} ms, "
                f"{flops / ms / 1e9:.1f} TFLOP/s")
        if tag == "Mistral-NeMo":
            kernels.append(row)
        del q, k, v
    # K2 decode (split across blocks) in bf16 at the main paths' decode
    # shapes, batch 4: Mistral-NeMo over 4096 positions (the row),
    # Phi-3-vision, Jamba's attention layer, Gemma-2's 4096 window over 8192
    # positions (half the splits empty; timed without its softcap, which
    # SDPA does not take) and phase 4's 40-position cache.  The eager call
    # is bound by the host's launch cost, so the kernel and SDPA (over the
    # keys the mask keeps) are also timed as CUDA graphs of 20 calls: the
    # device's time, which the row reports.  Bound: q, the kept K and V
    # rows read and o written once; 4·D flops per (q head, key), fp32
    g2 = get_config("gemma2_9b")
    for tag, Hqd, Hkvd, Dd, S, pos_i, window in (
            ("Mistral-NeMo", Hq, Hkv, D, 4096, 4095, None),
            ("Phi-3-vision", pcfg.n_heads, pcfg.n_kv_heads, pcfg.hd, 4096,
             4095, None),
            ("Jamba attention", jcfg.n_heads, jcfg.n_kv_heads, jcfg.hd, 4096,
             4095, None),
            ("Gemma-2 window", g2.n_heads, g2.n_kv_heads, g2.hd, 8192, 8191,
             g2.layer_pattern[0].window),
            ("phase 4 generate", Hq, Hkv, D, 40, 39, None),
            *((tag, Hf, Hkvf, Df, 4096, 4095, None)
              for tag, Hf, Hkvf, Df in FULL_DECODE)):
        Bd = 4
        q = rand(Bd, Hqd, 1, Dd, dtype=bf)
        k, v = rand(Bd, Hkvd, S, Dd, dtype=bf), rand(Bd, Hkvd, S, Dd,
                                                     dtype=bf)
        pos = torch.tensor(pos_i, dtype=torch.int32, device=dev)
        lo = 0 if window is None else max(0, pos_i - window + 1)
        kern = lambda: decode_attention_cuda(q, k, v, pos, window=window)
        plain = lambda: R.decode_attention_ref(q, k, v, pos=pos,
                                               window=window)
        kept_k, kept_v = k[:, :, lo:pos_i + 1], v[:, :, lo:pos_i + 1]
        lib = _sdpa(q, kept_k, kept_v, causal=False)
        got = kern()
        err = check_close(f"decode at the {tag} shape", got, plain(),
                          BF16_TOL)
        check_rel(f"decode at the {tag} shape", got, q, k, v,
                  dict(causal=True, offset=pos_i, window=window))
        rows = pos_i + 1 - lo
        flops = 4 * Bd * Hqd * Dd * rows
        nbytes = 2 * (2 * q.numel() + 2 * Bd * Hkvd * rows * Dd)
        b_ms, b_by = bound(flops, nbytes, 4)
        chunk, splits = autotile.decode_splits(Bd, Hkvd, Hqd // Hkvd, S, Dd,
                                               2)
        row = _row("flash_attention_decode",
                   gen_launches[1] if tag == "Mistral-NeMo" else None, err,
                   kern, plain, lib, b_ms, b_by,
                   f"{tag}: B={Bd} Hq={Hqd} Hkv={Hkvd} cache={S} D={Dd} "
                   f"pos={pos_i} window={window} chunk={chunk} "
                   f"splits={splits}; ms and library ms as CUDA graphs",
                   graph=True, **FLASH)
        log(f"    eager (host-paced) calls: kernel {time_ms(kern):.4f} ms, "
            f"SDPA {time_ms(lib):.4f} ms; {nbytes / row['ms'] / 1e6:.0f} "
            f"GB/s, {b_ms / row['ms'] * 100:.1f}% of the bound")
        if tag == "Mistral-NeMo":
            kernels.append(row)
        del q, k, v, kept_k, kept_v
    # K4 at rwkv6_7b's forward shape: B=1, H=64, T=2048, Dk=Dv=64, bf16,
    # the kernel timed as a CUDA graph (an eager call allocates o and S_last
    # and is paced by the host at these times; logged too)
    Bw, Hw, Tw = 1, rcfg.d_model // rcfg.rwkv_head_dim, 2048
    Dw = rcfg.rwkv_head_dim
    args = rwkv_inputs(Bw, Hw, Tw, Dw, bf)
    kern = lambda: rwkv6_cuda(*args)
    plain = lambda: R.rwkv6_ref(*args)
    o, s_last = kern()
    err = check_rwkv("rwkv6 at the main path's shape", o, s_last, args)
    # bytes: r, k, v, w, u read and o written in bf16, S_last written in
    # fp32; operations: the design's own products at the bf16 rate plus its
    # element-wise work at the fp32 rate (rwkv6_tc_work)
    from repro_torch.kernels.autotile import PEAK_BYTES, PEAK_FLOPS
    nbytes = 2 * (5 * Bw * Hw * Tw * Dw + Hw * Dw) + 4 * Bw * Hw * Dw * Dw
    tc_flops, cc_flops = rwkv6_tc_work(Bw, Hw, Tw, Dw)
    ops_ms = (tc_flops / PEAK_FLOPS[2] + cc_flops / PEAK_FLOPS[4]) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    b_ms, b_by = max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                         else "operations")
    log(f"  rwkv6 bound: bytes {nbytes / 1e6:.1f} MB -> {bytes_ms:.4f} ms; "
        f"operations {tc_flops / 1e9:.2f} GFLOP on the tensor cores + "
        f"{cc_flops / 1e9:.3f} GFLOP on the CUDA cores -> {ops_ms:.4f} ms; "
        f"the recurrence in fp32 (4 Dk Dv flops a step) would be "
        f"{bound(4 * Bw * Hw * Tw * Dw * Dw, 0, 4)[0]:.4f} ms")
    row = _row("rwkv6_wkv", rwkv_fwd_launches[2], err, kern, plain, None,
               b_ms, b_by, f"B={Bw} H={Hw} T={Tw} Dk=Dv={Dw} bf16; ms as a "
               "CUDA graph", graph=True, **RWKV,
               no_library="no single PyTorch call computes the wkv "
               "recurrence")
    log(f"    eager (host-paced) calls: kernel {time_ms(kern):.4f} ms; "
        f"{nbytes / row['ms'] / 1e6:.0f} GB/s, "
        f"{b_ms / row['ms'] * 100:.1f}% of the bound")
    kernels.append(row)
    del args, o, s_last
    # the fp32 route (the recurrence on the CUDA cores) at the same shape,
    # logged with its plain version's time: bound 4 Dk Dv flops a step at
    # the fp32 rate
    args = rwkv_inputs(Bw, Hw, Tw, Dw, torch.float32)
    log(f"  rwkv6 fp32 (CUDA cores) [B={Bw} H={Hw} T={Tw} Dk=Dv={Dw}]: "
        f"{time_ms(lambda: rwkv6_cuda(*args)):.4f} ms, bound "
        f"{bound(4 * Bw * Hw * Tw * Dw * Dw, 0, 4)[0]:.4f} ms (operations), "
        f"plain {time_ms(lambda: R.rwkv6_ref(*args), reps=5):.4f} ms")
    del args
    # K3 at jamba's forward shape: Bt=1, L=2048, Dm=d_inner, N=d_state,
    # bf16, timed as a CUDA graph (an eager call allocates y and h_last and
    # is paced by the host; logged too)
    Bs, Ls, Ds, Ns = 1, 2048, jcfg.d_inner, jcfg.d_state
    args = ssm_inputs(Bs, Ls, Ds, Ns, bf)
    kern = lambda: ssm_scan_cuda(*args)
    plain = lambda: R.selective_scan_ref(*args)
    y, h_last = kern()
    err, _, _ = check_scan("ssm_scan at the main path's shape", y, h_last,
                           args)
    # per (l, d, n): dt*A, dA*h, (dt*x)*B, the add, h*C and its sum, in
    # fp32 (the exps run on the special-function units, not counted); x,
    # dt, B, C read and y written in bf16, A, D read and h_last written in
    # fp32
    flops = 6 * Bs * Ls * Ds * Ns
    nbytes = (2 * (3 * Bs * Ls * Ds + 2 * Bs * Ls * Ns)
              + 4 * (Ds * Ns + Ds + Bs * Ds * Ns))
    b_ms, b_by = bound(flops, nbytes, 4)
    S = dict(autotile.SSM_TILES)[Ns]
    row = _row("ssm_scan", jamba_fwd_launches[3], err, kern, plain, None,
               b_ms, b_by, f"Bt={Bs} L={Ls} Dm={Ds} N={Ns} bf16 S={S}; ms "
               "as a CUDA graph", graph=True, **SSM,
               no_library="no PyTorch call computes the selective scan")
    # the floor the design aims at: one exp per (l, d, n) on the special-
    # function units, 16 per SM per clock, at the SM clock read right after
    # the timing and at the card's maximum
    exps = Bs * Ls * Ds * Ns
    clk, clk_max = (_smi_mhz(q) for q in ("clocks.sm", "clocks.max.sm"))
    sfu_ms = [exps / (16 * autotile.H100_SMS * c * 1e6) * 1e3
              for c in (clk, clk_max)]
    log(f"    {exps / 1e6:.1f} M exps: special-function floor "
        f"{sfu_ms[0]:.4f} ms at clocks.sm {clk:g} MHz, {sfu_ms[1]:.4f} ms "
        f"at clocks.max.sm {clk_max:g} MHz (the kernel at "
        f"{row['ms'] / sfu_ms[1]:.2f}x it); {nbytes / row['ms'] / 1e6:.0f} "
        f"GB/s, {b_ms / row['ms'] * 100:.1f}% of the bytes bound")
    log(f"    eager (host-paced) calls: kernel {time_ms(kern):.4f} ms")
    kernels.append(row)
    del args, y, h_last
    # the fp32 route at the same shape, logged (phase 5's depth-2 forwards
    # run it): x, dt, B, C read and y written in fp32
    args = ssm_inputs(Bs, Ls, Ds, Ns, torch.float32)
    f32_bytes = 4 * (3 * Bs * Ls * Ds + 2 * Bs * Ls * Ns + Ds * Ns + Ds
                     + Bs * Ds * Ns)
    log(f"  ssm_scan fp32 [Bt={Bs} L={Ls} Dm={Ds} N={Ns}]: "
        f"{time_ms(lambda: ssm_scan_cuda(*args), graph=True):.4f} ms as a "
        f"CUDA graph, bytes bound {bound(0, f32_bytes, 4)[0]:.4f} ms")
    del args
    # one Jamba decode step's MoE FFN and Mamba step at full width (batch 4:
    # MoE capacity 1, so every expert's weights are read for one row),
    # each against reading its weights once
    with torch.inference_mode():
        xm = rand(4, 1, jcfg.d_model, dtype=bf)
        moe_p = blocks.moe_init(jcfg, torch.Generator(dev).manual_seed(8),
                                dev)
        _step_vs_weights(f"MoE FFN decode step [B=4 C="
                         f"{blocks.moe_capacity(jcfg, 4)}]", moe_p,
                         lambda: blocks.moe_fwd(jcfg, moe_p, xm))
        del moe_p
        mamba_p = blocks.mamba_init(jcfg, torch.Generator(dev).manual_seed(9),
                                    dev)
        state = blocks.mamba_init_state(jcfg, 4, dev)
        _step_vs_weights("Mamba decode step [B=4]", mamba_p,
                         lambda: blocks.mamba_step(jcfg, mamba_p, xm, state))
        del mamba_p, state

    log(f"  card at the end: {_clocks()}")

    # ---- 8. training ------------------------------------------------------
    mark("8")
    _training(dev, reset)

    # ---- 9. DSE scoring engine ---------------------------------------------
    mark("9")
    _dse(dev, smi)

    # ---- 10. sharded entry points on a one-card mesh -------------------------
    mark("10")
    _sharded(dev, reset, launches)

    # ---- 11. the DSE's evaluation on the card --------------------------------
    mark("11")
    _dse_eval(dev, smi)

    # ---- 12. the LEGO generator on the card ---------------------------------
    mark("12")
    _generator(dev, smi, t_start)

    # ---- 13. the front doors on the card ------------------------------------
    mark("13")
    _front_doors(dev, smi, t_start)

    # ---- 14. the paper's evaluation on the card -----------------------------
    mark("14")
    _paper_figures(dev, smi, t_start)

    mark("end")
    log("per-phase seconds: " + ", ".join(
        f"{a} {t1 - t0:.1f}" for (a, t0), (_, t1) in zip(marks, marks[1:])))
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f}s [{smi}]")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _serve(cfg, seed, dev, gen, reset, launches, *, want_fwd, want_gen,
           prefix=0, then=None, T=2048):
    """One main path: ``cfg`` at full width with random weights from
    ``seed``, ``forward`` on ``T`` positions (``prefix`` random patch
    embeddings, then tokens) and ``generate`` (batch 4, prompt 16, 24 new),
    each between ``reset()`` and ``launches()``, which must read
    ``want_fwd`` and ``want_gen(decode steps)``, its tokens those of the
    eager step (``TF.decode_step``) in the same loop; the captured step
    beside the eager one (``_step_times``); then ``then(params)`` if given.
    Returns the two launch counts; frees the weights."""
    import torch

    from repro_torch.kernels.flash_attention import decode_attention_cuda
    from repro_torch.models import transformer as TF
    from repro_torch.serve.engine import build_serve_step, generate

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = TF.init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    torch.cuda.synchronize()
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"  init: {sum(t.numel() for t in _leaves(params)) / 1e9:.3f}B "
        f"parameters, {weight_bytes / 2**30:.2f} GiB, "
        f"{time.perf_counter() - t0:.1f}s")
    with torch.inference_mode():
        prompt = torch.randint(0, cfg.vocab_size, (1, T - prefix),
                               generator=gen, device=dev, dtype=torch.int32)
        pre = (torch.randn((1, prefix, cfg.d_model), generator=gen,
                           device=dev).to(cfg.torch_dtype) if prefix
               else None)
        TF.forward(params, prompt[:, :128], cfg,   # warm-up (cuBLAS etc.)
                   prefix_embeds=pre)
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        logits, _ = TF.forward(params, prompt, cfg, prefix_embeds=pre)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        fwd_launches = launches()
        if fwd_launches != want_fwd:
            fail(f"{cfg.name} forward launches (flash prefill, flash decode, "
                 f"rwkv6, ssm_scan, gemm) = {fwd_launches}, want {want_fwd}")
        if logits.shape != (1, T, cfg.vocab_size) or \
                not torch.isfinite(logits).all():
            fail(f"{cfg.name} forward logits: wrong shape or non-finite")
        fwd_peak = torch.cuda.max_memory_allocated() / 2**30
        del logits
        mm_flops = _weight_flops(cfg, T)
        log(f"  forward B=1 T={T} (prefix {prefix}): {fwd_ms:.1f} ms "
            f"({T / fwd_ms * 1e3:.0f} "
            f"prompt tok/s), logits finite, launches {fwd_launches} "
            f"({on_tensor_cores(fwd_launches[0])}"
            + (f"; {on_rwkv_tensor_cores(fwd_launches[2])}"
               if fwd_launches[2] else "") + "); weight "
            f"products {mm_flops / 1e12:.2f} TFLOP, bound "
            f"{bound(mm_flops, 0, 2)[0]:.2f} ms at the bf16 peak")

        B, Tp, new = 4, 16, 24
        prompts = torch.randint(0, cfg.vocab_size, (B, Tp), generator=gen,
                                device=dev, dtype=torch.int32)
        generate(params, cfg, prompts, max_new=2)   # warm-up
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        out = generate(params, cfg, prompts, max_new=new)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        steps = Tp + new - 1
        gen_launches = launches()
        if gen_launches != want_gen(steps):
            fail(f"{cfg.name} generate launches (flash prefill, flash "
                 f"decode, rwkv6, ssm_scan, gemm) = {gen_launches}, want "
                 f"{want_gen(steps)}")
        if out.shape != (B, Tp + new) or not torch.equal(out[:, :Tp], prompts) \
                or out.min() < 0 or out.max() >= cfg.vocab_size:
            fail(f"{cfg.name} generate: wrong shape, prompt not kept or "
                 "token out of range")
        eager = _greedy(lambda p, st, t, pos: TF.decode_step(p, st, t, pos,
                                                               cfg),
                        params, TF.init_decode_state(cfg, B, Tp + new,
                                                     device=dev),
                        prompts, new)
        if not torch.equal(out, eager):
            fail(f"{cfg.name} generate: the captured step's tokens differ "
                 "from the eager step's")
        log(f"  generate B={B} prompt={Tp} new={new}: {gen_s * 1e3:.1f} ms "
            f"(its first step eager and captured, then {steps - 1} replays), "
            f"{gen_s * 1e3 / steps:.2f} ms per decode step ({steps} steps; "
            f"weight-read bound {bound(0, weight_bytes, 2)[0]:.2f} ms), "
            f"{B * new / gen_s:.1f} tok/s, launches {gen_launches} (replays "
            f"counted), K2 decode calls over more than one split "
            f"{decode_attention_cuda.split_launches}; tokens == the eager "
            "step's")
        replay_ms = _step_times(
            cfg.name, params, lambda: TF.init_decode_state(
                cfg, B, Tp + new, device=dev), build_serve_step(cfg),
            lambda p, st, t, pos: TF.decode_step(p, st, t, pos, cfg),
            prompts[:, 0], (), reset, launches, want_gen, weight_bytes)
        SERVED[cfg.name] = dict(prompts=prompts, out=out, new=new,
                                fwd_launches=fwd_launches,
                                gen_launches=gen_launches,
                                replay_ms=replay_ms, seed=seed, T=T)
        log(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB ({fwd_peak:.2f} GiB by the end of the forward)")
        if then is not None:
            then(params)
    del params
    torch.cuda.empty_cache()
    return fwd_launches, gen_launches


def long_cache_step(cfg, params, dev, gen, *, S: int = 4096, B: int = 4,
                    steps: int = 6) -> dict:
    """Decode steps of ``cfg`` (batch ``B``) over an ``S``-position cache
    filled with random keys and values, at the last 2 (steps + 2)
    positions: the eager step (``TF.decode_step``) after a warm-up, each
    step's host-clock ms (synchronised), then one more step under
    ``torch.profiler``: its device-busy ms (the sum of the kernels'
    durations), the part of it in K2 decode (split and combine kernels),
    the step's ms on the host clock inside the trace, and the K2 decode
    calls (and, where the package counts them, split ones) of the timed
    steps.  Then the same for the serve step (``build_serve_step``: its
    first call captures, ``captured_*`` are its replays), the keys above
    prefixed ``captured_`` (all but the K2 ones).  Also used by
    tools/k2_ab.py on an older tree, whose serve step may be eager."""
    import torch

    from repro_torch.kernels.flash_attention import decode_attention_cuda
    from repro_torch.models import transformer as TF
    from repro_torch.serve.engine import build_serve_step

    with torch.inference_mode():
        state = TF.init_decode_state(cfg, B, S, device=dev)
        for leaf in _leaves(state):
            leaf.normal_(generator=gen)
        kv_bytes = sum(t.numel() * t.element_size() for t in _leaves(state))
        tok = torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                            device=dev, dtype=torch.int32)
        pos = torch.tensor(S - 2 * (steps + 2), dtype=torch.int32,
                           device=dev)
        TF.decode_step(params, state, tok, pos, cfg)   # warm-up
        pos += 1
        torch.cuda.synchronize()
        before = (decode_attention_cuda.launches,
                  getattr(decode_attention_cuda, "split_launches", None))
        host_ms = []
        for _ in range(steps):
            t0 = time.perf_counter()
            logits, state = TF.decode_step(params, state, tok, pos, cfg)
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            pos += 1
        calls = decode_attention_cuda.launches - before[0]
        split = (None if before[1] is None
                 else decode_attention_cuda.split_launches - before[1])
        finite = bool(torch.isfinite(logits).all())
        traced_ms, dev_events = _traced(
            lambda: TF.decode_step(params, state, tok, pos, cfg))
        pos += 1
        step = build_serve_step(cfg)
        step(params, state, tok, pos)                   # captures
        pos += 1
        cap_ms = []
        for _ in range(steps):
            t0 = time.perf_counter()
            logits, state = step(params, state, tok, pos)
            torch.cuda.synchronize()
            cap_ms.append((time.perf_counter() - t0) * 1e3)
            pos += 1
        finite = finite and bool(torch.isfinite(logits).all())
        cap_traced_ms, cap_events = _traced(
            lambda: step(params, state, tok, pos))
    k2 = sum(e.device_time for e in dev_events
             if "flash_decode" in e.name) / 1e3
    del state, step
    torch.cuda.empty_cache()
    return {"S": S, "B": B, "kv_bytes": kv_bytes, "host_ms": host_ms,
            "traced_ms": traced_ms, "device_events": len(dev_events),
            "busy_ms": sum(e.device_time for e in dev_events) / 1e3,
            "k2_decode_ms": k2, "decode_calls": calls,
            "split_calls": split, "logits_finite": finite,
            "captured_host_ms": cap_ms, "captured_traced_ms": cap_traced_ms,
            "captured_device_events": len(cap_events),
            "captured_busy_ms": sum(e.device_time for e in cap_events) / 1e3}


def _traced(fn):
    """``fn()`` once under ``torch.profiler``, synchronised: its ms on the
    host clock and the trace's device events (kernels and copies, those a
    CUDA graph replays too)."""
    import torch
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    return ms, [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]


def _long_cache(cfg, params, dev, gen, reset, launches) -> None:
    """Phase 4a's long-cache step: Mistral-NeMo at full width and depth,
    batch 4, over a 4096-position cache; fails unless every K2 decode call
    of the timed steps split the cache and the logits are finite."""
    from repro_torch.kernels.flash_attention import decode_attention_cuda

    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    reset()
    r = long_cache_step(cfg, params, dev, gen)
    steps = len(r["host_ms"])
    # the timed steps, a warm-up step and the profiled one, eager and
    # captured (the capture's own eager call, the replays)
    want = (0, cfg.n_layers * 2 * (steps + 2), 0, 0, 0)
    if launches() != want or r["decode_calls"] != cfg.n_layers * steps:
        fail(f"long-cache decode launches {launches()}, want {want}")
    if r["split_calls"] != cfg.n_layers * steps or \
            decode_attention_cuda.split_launches != want[1]:
        fail(f"{decode_attention_cuda.split_launches} of {want[1]} "
             "long-cache K2 decode calls split the cache")
    if not r["logits_finite"]:
        fail("long-cache decode step: non-finite logits")
    host = sorted(r["host_ms"])
    log(f"  decode step B={r['B']} over a {r['S']}-position cache "
        f"({r['kv_bytes'] / 2**30:.2f} GiB of KV beside "
        f"{weight_bytes / 2**30:.2f} GiB of weights; bound "
        f"{bound(0, weight_bytes + r['kv_bytes'], 2)[0]:.2f} ms): host "
        f"clock {', '.join(f'{t:.2f}' for t in r['host_ms'])} ms (median "
        f"{host[len(host) // 2]:.2f}), launches {launches()} (with a "
        f"warm-up and the profiled step), every K2 decode call split "
        f"({decode_attention_cuda.split_launches})")
    cap = sorted(r["captured_host_ms"])[len(host) // 2]
    log(f"  captured step over it: host clock "
        f"{', '.join(f'{t:.2f}' for t in r['captured_host_ms'])} ms (median "
        f"{cap:.2f}, {cap / host[len(host) // 2]:.2f}x the eager step's)")
    if r["device_events"] == 0 or r["captured_device_events"] == 0:
        log("  profiler: a trace holds no device event, so device-busy "
            "time is not measured")
        return
    log(f"  profiled eager step: {r['traced_ms']:.2f} ms on the host clock, "
        f"device busy {r['busy_ms']:.3f} ms over {r['device_events']} "
        f"device events (idle {1 - r['busy_ms'] / r['traced_ms']:.1%}), "
        f"K2 decode {r['k2_decode_ms']:.3f} ms "
        f"({r['k2_decode_ms'] / r['busy_ms']:.1%} of busy)")
    log(f"  profiled replay: {r['captured_traced_ms']:.2f} ms on the host "
        f"clock under the profiler, device busy {r['captured_busy_ms']:.3f} "
        f"ms over {r['captured_device_events']} device events; the captured "
        f"step's median {cap / r['captured_busy_ms']:.2f}x its device-busy "
        f"time (idle {1 - r['captured_busy_ms'] / cap:.1%})")


def _greedy(step, params, state, prompts, new: int, *extra):
    """``generate``'s loop over ``step(params, state, token, pos,
    *extra)``: the prompt teacher-forced, then ``new`` greedy tokens;
    ``pos`` lives on the device.  Returns (B, Tp + new) int32 tokens."""
    import torch

    pos = torch.zeros((), dtype=torch.int32, device=prompts.device)
    logits = None
    for t in range(prompts.shape[1]):
        logits, state = step(params, state, prompts[:, t], pos, *extra)
        pos += 1
    out = [prompts]
    tok = logits.argmax(-1).to(torch.int32)
    for i in range(new):
        out.append(tok[:, None])
        if i == new - 1:
            break
        logits, state = step(params, state, tok, pos, *extra)
        pos += 1
        tok = logits.argmax(-1).to(torch.int32)
    return torch.cat(out, dim=1)


def _step_times(name, params, new_state, step, eager, tok, extra, reset,
                launches, want, weight_bytes, n: int = 10) -> float:
    """The captured serve step beside the eager one on a fresh state from
    ``new_state()`` (batch 4, generate's 40-position cache): ``step``'s
    first call (eager, then the capture) and two replays, then ``n``
    replays and ``n`` eager steps, each on the host clock (synchronised);
    the replays' launches must read ``want(n)``.  Then one replay under
    ``torch.profiler``: its device-busy ms, and the idle share of a replay
    (1 - busy / the replays' median; the traced replay's own host clock,
    which tracing lengthens, is logged too).  Logged beside the
    weight-read bound.  Returns the replays' median ms."""
    import torch

    state = new_state()
    pos = torch.zeros((), dtype=torch.int32, device=tok.device)

    def timed(fn):
        nonlocal pos
        t0 = time.perf_counter()
        fn(params, state, tok, pos, *extra)
        torch.cuda.synchronize()
        pos += 1
        return (time.perf_counter() - t0) * 1e3

    for _ in range(3):
        timed(step)
    reset()
    cap = sorted(timed(step) for _ in range(n))
    if launches() != want(n):
        fail(f"{name} {n} replays launched {launches()}, want {want(n)}")
    eag = sorted(timed(eager) for _ in range(n))
    traced, events = _traced(lambda: step(params, state, tok, pos, *extra))
    c, e = cap[n // 2], eag[n // 2]
    busy = sum(ev.device_time for ev in events) / 1e3
    log(f"  decode step B={tok.shape[0]}, captured vs eager (medians of {n}, "
        f"host clock): {c:.3f} ms vs {e:.3f} ms ({c / e:.2f}x; weight-read "
        f"bound {bound(0, weight_bytes, 2)[0]:.3f} ms), replays' launches "
        f"{want(n)}; one replay profiled: " + (
            f"device busy {busy:.3f} ms over {len(events)} device events, "
            f"idle {1 - busy / c:.1%} of the median replay ({traced:.3f} ms "
            f"on the host clock under the profiler, idle "
            f"{1 - busy / traced:.1%})"
            if events else "no device event in the trace (device-busy time "
            "not measured)"))
    del state
    return c


def _whisper(cfg, seed, dev, gen, reset, launches) -> None:
    """Whisper at full width: ``forward_encdec`` (batch 4, all frames, 128
    tokens), ``encode``, and greedy decoding through ``build_serve_step``
    (batch 4, prompt 16, 24 new), each between ``reset()`` and
    ``launches()``."""
    import torch

    from repro_torch.models import encdec as ED
    from repro_torch.serve.engine import build_serve_step

    torch.cuda.reset_peak_memory_stats()
    params = ED.init_params_encdec(cfg, torch.Generator(dev).manual_seed(seed),
                                   dev)
    leaves = list(_leaves(params))
    log(f"  init: {sum(t.numel() for t in leaves) / 1e6:.2f}M parameters "
        f"counted from the tree's leaves (ModelConfig.n_params(), which "
        f"leaves out the encoder, says {cfg.n_params() / 1e6:.2f}M), "
        f"{sum(t.numel() * t.element_size() for t in leaves) / 2**20:.1f} "
        "MiB")
    L = cfg.n_layers
    B, Te, Td = 4, cfg.enc_seq_len, 128
    with torch.inference_mode():
        frames = torch.randn((B, Te, cfg.d_model), generator=gen,
                             device=dev).to(cfg.torch_dtype)
        toks = torch.randint(0, cfg.vocab_size, (B, Td), generator=gen,
                             device=dev, dtype=torch.int32)
        ED.forward_encdec(params, toks, frames, cfg)   # warm-up
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        logits = ED.forward_encdec(params, toks, frames, cfg)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        want = (cfg.n_enc_layers + 2 * L, 0, 0, 0, 0)
        if launches() != want:
            fail(f"{cfg.name} forward_encdec launches {launches()}, want "
                 f"{want}")
        if logits.shape != (B, Td, cfg.vocab_size) or \
                not torch.isfinite(logits).all():
            fail(f"{cfg.name} forward_encdec logits: wrong shape or "
                 "non-finite")
        del logits
        log(f"  forward_encdec B={B} frames={Te} tokens={Td}: {fwd_ms:.1f} "
            f"ms, logits finite, launches {want} "
            f"({on_tensor_cores(want[0])})")
        reset()
        t0 = time.perf_counter()
        enc_out = ED.encode(params, frames, cfg)
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t0) * 1e3
        if launches() != (cfg.n_enc_layers, 0, 0, 0, 0):
            fail(f"{cfg.name} encode launches {launches()}")
        Tp, new = 16, 24
        prompts = toks[:, :Tp]
        _greedy(build_serve_step(cfg), params, ED.init_decode_state_encdec(
            cfg, B, Tp + 2, device=dev), prompts, 2, enc_out)   # warm-up
        torch.cuda.synchronize()
        step = build_serve_step(cfg)
        state = ED.init_decode_state_encdec(cfg, B, Tp + new, device=dev)
        reset()
        t0 = time.perf_counter()
        out = _greedy(step, params, state, prompts, new, enc_out)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        steps = Tp + new - 1
        if launches() != (L * steps, L * steps, 0, 0, 0):
            fail(f"{cfg.name} serve-step launches {launches()}, want "
                 f"{(L * steps, L * steps, 0, 0, 0)}")
        if out.shape != (B, Tp + new) or not torch.equal(out[:, :Tp],
                                                        prompts) \
                or out.min() < 0 or out.max() >= cfg.vocab_size:
            fail(f"{cfg.name} decoding: wrong shape, prompt not kept or "
                 "token out of range")
        log(f"  encode B={B} frames={Te}: {enc_ms:.1f} ms; serve steps "
            f"B={B} prompt={Tp} new={new}: {gen_s * 1e3:.1f} ms (the first "
            f"step eager and captured, then {steps - 1} replays), "
            f"{gen_s * 1e3 / steps:.2f} ms per step ({steps} steps), "
            f"{B * new / gen_s:.1f} tok/s, launches {launches()} (replays "
            f"counted; {on_tensor_cores(L * steps)})")
        eager = lambda p, st, t, pos, e: ED.decode_step_encdec(p, st, t, pos,
                                                               e, cfg)
        want = _greedy(eager, params, ED.init_decode_state_encdec(
            cfg, B, Tp + new, device=dev), prompts, new, enc_out)
        if not torch.equal(out, want):
            fail(f"{cfg.name} decoding: the captured step's tokens differ "
                 "from the eager step's")
        log("  tokens == the eager step's (ED.decode_step_encdec)")
        weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
        _step_times(cfg.name, params, lambda: ED.init_decode_state_encdec(
            cfg, B, Tp + new, device=dev), build_serve_step(cfg), eager,
            prompts[:, 0], (enc_out,), reset, launches,
            lambda n: (L * n, L * n, 0, 0, 0), weight_bytes)
        log(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            "GiB")
    del params, enc_out, state, step
    torch.cuda.empty_cache()


def _whisper_consistency(cfg, seed, dev, gen, reset, launches) -> None:
    """fp32 Whisper: ``forward_encdec`` through the kernels against the
    plain path, and 64 teacher-forced serve steps against it, within
    1e-3."""
    import torch

    from repro_torch.models import encdec as ED
    from repro_torch.serve.engine import build_serve_step

    tol = 1e-3
    params = ED.init_params_encdec(cfg, torch.Generator(dev).manual_seed(seed),
                                   dev)
    with torch.inference_mode():
        frames = torch.randn((2, cfg.enc_seq_len, cfg.d_model), generator=gen,
                             device=dev)
        toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                             device=dev, dtype=torch.int32)
        reset()
        lk = ED.forward_encdec(params, toks, frames, cfg)
        want = (cfg.n_enc_layers + 2 * cfg.n_layers, 0, 0, 0, 0)
        if launches() != want:
            fail(f"{cfg.name} fp32 forward_encdec launches {launches()}, "
                 f"want {want}")
        lr = ED.forward_encdec(params, toks, frames, cfg, backend="ref")
        check_close(f"{cfg.name} forward_encdec kernel vs plain", lk, lr, tol)
        enc_out = ED.encode(params, frames, cfg)
        step = build_serve_step(cfg)
        state = ED.init_decode_state_encdec(cfg, 2, 64, device=dev)
        pos = torch.zeros((), dtype=torch.int32, device=dev)
        steps = []
        for t in range(64):
            lt, state = step(params, state, toks[:, t], pos, enc_out)
            pos += 1
            steps.append(lt)
        check_close(f"{cfg.name} serve steps vs forward_encdec",
                    torch.stack(steps, 1), lk, tol)
    del params, state, enc_out
    torch.cuda.empty_cache()


def _weight_flops(cfg, n_tok: int) -> float:
    """Flops (2 per multiply-add) of the weight products of one ``forward``
    over ``n_tok`` tokens, as the code computes them: an MoE layer's
    experts run on their E·C capacity rows (``moe_capacity``), not on every
    token times every expert, beside the router and the shared experts per
    token; a Mamba layer's in, x, dt and out projections; the untied
    embedding is a gather, the head one product.  Attention scores and the
    scans are not counted."""
    from repro_torch.models.blocks import moe_capacity

    d, V = cfg.d_model, cfg.vocab_size
    per_tok, rows = 0, 0        # multiply-adds per token, and per MoE layer
    for spec in cfg.layer_pattern:
        if spec.kind == "rwkv":  # rkvwg, out, cr, decay LoRA, channel mix
            per_tok += 6 * d * d + 2 * d * cfg.rwkv_decay_rank \
                + 2 * d * cfg.d_ff
            continue
        if spec.kind == "attn":
            per_tok += d * cfg.hd * (cfg.n_heads + 2 * cfg.n_kv_heads) \
                + cfg.n_heads * cfg.hd * d
        else:
            di, r, N = cfg.d_inner, cfg.dtr, cfg.d_state
            per_tok += d * 2 * di + di * (r + 2 * N) + r * di + di * d
        if spec.moe:
            f = cfg.d_ff_e
            per_tok += d * cfg.n_experts + cfg.n_shared_experts * 3 * d * f
            rows += cfg.n_experts * moe_capacity(cfg, n_tok) * 3 * d * f
        else:
            per_tok += (3 if cfg.glu else 2) * d * cfg.d_ff
    return 2 * (cfg.n_periods * (n_tok * per_tok + rows) + n_tok * d * V)


def _consistency(cfg, seed, dev, gen, reset, launches, *, want_fwd):
    """fp32 at ``cfg``'s width: ``forward`` through the kernels (launching
    ``want_fwd``) against the plain path, and 64 teacher-forced
    ``decode_step`` calls against ``forward``, within 1e-3."""
    import torch

    from repro_torch.models import transformer as TF

    tol = 1e-3
    params = TF.init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    with torch.inference_mode():
        toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                             device=dev, dtype=torch.int32)
        reset()
        lk, _ = TF.forward(params, toks, cfg)
        if launches() != want_fwd:
            fail(f"{cfg.name} fp32 forward launches {launches()}, want "
                 f"{want_fwd}")
        lr, _ = TF.forward(params, toks, cfg, backend="ref")
        check_close(f"{cfg.name} depth {cfg.n_layers} forward kernel vs "
                    "plain", lk, lr, tol)
        state = TF.init_decode_state(cfg, 2, 64, device=dev)
        steps = []
        for t in range(64):
            lt, state = TF.decode_step(params, state, toks[:, t], t, cfg)
            steps.append(lt)
        check_close(f"{cfg.name} depth {cfg.n_layers} decode_step vs "
                    "forward", torch.stack(steps, 1), lk, tol)
    del params, state
    torch.cuda.empty_cache()


def _step_vs_weights(name, params, fn) -> None:
    """Logs ``fn``'s time (CUDA events) beside the time to read ``params``
    once at the HBM rate."""
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    ms = time_ms(fn)
    log(f"  {name}: {ms:.4f} ms, weight-read bound "
        f"{bound(0, nbytes, 2)[0]:.4f} ms ({nbytes / 1e9:.2f} GB)")


def _clocks() -> str:
    """The card's SM clock, power draw and temperature, from nvidia-smi."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _smi_mhz(query: str) -> float:
    """One clock of the card, in MHz, from nvidia-smi (e.g. clocks.sm)."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60).stdout
    return float(out.strip().splitlines()[0])


def _ptxas_kernels(text: str) -> dict:
    """{kernel: (registers, spill store bytes)} from ``-Xptxas -v``'s log
    of ``csrc/ssm_scan.cu``, each kernel named by its template arguments
    (dtype, N, S states a thread, 16-byte loads)."""
    import re
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            t = re.search(r"kernelI(13__nv_bfloat16|f)Li(\d+)ELi(\d+)ELb(\d)E",
                          m.group(1))
            name = (f"{'bf16' if t[1] != 'f' else 'fp32'} N={t[2]} S={t[3]} "
                    f"vec={t[4]}" if t else m.group(1))
        elif name and "spill stores" in ln:
            spill = int(ln.split("bytes spill stores")[0].split()[-1])
            out[name] = (out.get(name, (0, 0))[0], spill)
        elif name and "Used " in ln:
            regs = int(ln.split("Used ")[1].split()[0])
            out[name] = (regs, out.get(name, (0, 0))[1])
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _sdpa(q, k, v, causal):
    """One PyTorch call computing the same attention (the yardstick)."""
    import torch.nn.functional as F
    return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=True)


def _sdpa_window(q, k, v, window):
    """SDPA over the keys a causal ``window`` keeps, as a boolean mask."""
    import torch
    import torch.nn.functional as F
    i = torch.arange(q.shape[2], device=q.device)[:, None]
    j = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = (j <= i) & (j > i - window)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def _row(name, launches, err, kern, plain, lib, b_ms, b_by, shape, *,
         source, replaces, no_library=None, graph=False):
    """One entry of the ``kernels`` line (logged too); ``lib`` is None
    (with the reason in ``no_library``) where no PyTorch call computes the
    same function.  With ``graph`` the kernel and the library call are
    timed as CUDA graphs (``time_ms``), the plain version eagerly."""
    ms, plain_ms = time_ms(kern, graph=graph), time_ms(plain, reps=5)
    lib_ms = time_ms(lib, graph=graph) if lib is not None else None
    lib_txt = (f"{lib_ms:.4f} ms" if lib_ms is not None
               else f"none ({no_library})")
    log(f"  {name} [{shape}]: {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"plain {plain_ms:.4f} ms, library {lib_txt}, max_abs_err {err:.3e}")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


# ---------------------------------------------------------------------------
# phase 8: training
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 4            # phase 8a's cut of Mistral-NeMo-12B's 40 layers
TRAIN_B, TRAIN_T = 2, 2048  # phase 8a's global batch
TRAIN_LR = 5e-4
# phase 8b: the card against the CPU (the reference's own accumulation
# tolerance, tests/test_runtime.py, for the updated parameters)
STEP_RTOL = 1e-5            # loss and gradient norm, relative
GRAD_TOL = 1e-4             # gradients, of each leaf's largest magnitude
PARAM_ATOL, PARAM_RTOL = 2e-5, 2e-4
# phase 8c: the resumed run against an uninterrupted one, loss relative
# (the embedding's backward adds with atomics, so two runs of one step
# may differ in the last bits, and AdamW carries that on)
RESUME_RTOL = 1e-3
# phase 8d: RWKV-6 7B cut to TRAIN_SCAN_LAYERS of its 32 layers, Jamba to
# its first layer; 8a's global batch (T = 2048 = chunk_threshold)
TRAIN_SCAN_LAYERS = 8
TRAIN_SCAN_STEPS = 4        # one warm-up step, the median of the others
# phase 8b: smoke configs whose T = 16 reaches a lowered threshold, so that
# the train step takes the chunked scans (and Jamba's chunked attention)
CHUNKED_SMOKES = (("rwkv6_7b", dict(chunk_threshold=8, scan_chunk=4)),
                  ("jamba_1_5_large_398b",
                   dict(chunk_threshold=8, scan_chunk=4, attn_kv_chunk=4)))
NO_KERNEL = ("the reference trains with KB='ref' "
             "(src/repro/models/blocks.py:19) and no kernel has a backward "
             "pass")


def _training(dev, reset) -> None:
    """Phase 8; fails unless every training step launched no kernel."""
    import gc

    import torch

    from repro_torch.kernels import ops

    def no_launches(what):
        if any(ops.launch_counts()):
            fail(f"{what}: kernel launches {ops.launch_counts()} over "
                 f"training, want none: {NO_KERNEL}")

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log("phase 8 training (plain path under autograd; every kernel counter "
        f"reset before and read after each run: {NO_KERNEL})")
    _train_full_width(dev, reset, no_launches)
    _train_scans(dev, reset, no_launches)
    _train_consistency(dev, reset, no_launches)
    _train_lm_twin(dev, reset, no_launches)
    log(f"phase 8 done in {time.perf_counter() - t0:.1f}s")


def _train_full_width(dev, reset, no_launches) -> None:
    """8a: Mistral-NeMo-12B at full width, cut to TRAIN_LAYERS layers."""
    import gc
    import math
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM, batch_at
    from repro_torch.kernels.autotile import PEAK_FLOPS
    from repro_torch.models import transformer as TF
    from repro_torch.train.step import build_train_step, make_train_state
    from repro_torch.tree import tree_leaves

    full = get_config("mistral_nemo_12b")
    base = dataclasses.replace(full, n_periods=TRAIN_LAYERS)
    d, V, L = base.d_model, base.vocab_size, TRAIN_LAYERS
    ends = 2 * V * d                       # embedding and lm_head
    layer = dataclasses.replace(full, n_periods=1).n_params() - ends
    N = base.n_params()
    log(f"phase 8a {base.name} d_model={d} heads=({base.n_heads},"
        f"{base.n_kv_heads})x{base.hd} d_ff={base.d_ff} vocab={V} bf16, "
        f"global batch {TRAIN_B} x {TRAIN_T}")
    log(f"  cut: depth {L} of {full.n_layers} layers: {layer / 1e6:.1f} M "
        f"parameters a layer and {ends / 1e9:.3f} B for the embedding and "
        f"lm_head, {N / 1e9:.3f} B at {L} layers; bf16 parameters and "
        f"gradients and fp32 moments (12 B a parameter) "
        f"{12 * N / 1e9:.1f} GB; accumulation's fp32 sum and the fp32 EF "
        f"residuals {4 * N / 1e9:.1f} GB each")
    # model FLOPs: 6 per parameter and token for the products (the
    # embedding lookup does none), and the causal attention's QK^T and PV
    # (half of the T x T pairs) forward and backward: 6·B·Hq·hd·T^2 a layer
    tokens = TRAIN_B * TRAIN_T
    flops = (6 * (N - V * d) * tokens
             + 6 * L * TRAIN_B * base.n_heads * base.hd * TRAIN_T ** 2)
    peak_flops = PEAK_FLOPS[2]
    log(f"  model FLOPs a step {flops:.4e} (6 N tokens over the "
        f"{(N - V * d) / 1e9:.3f} B parameters that multiply, plus causal "
        f"attention); share of the bf16 dense peak {peak_flops:.3e} FLOP/s")
    batch = batch_at(SyntheticLM(V, TRAIN_T, TRAIN_B, seed=0), 0, dev)
    free0, total = torch.cuda.mem_get_info()
    # (name, remat, accum_steps, compress_grads, moments, steps, indexed):
    # "indexed" runs the forward of the parent commit, which indexed each
    # period's parameters out of the stacks (TF._period) where the forward
    # now unbinds each stack once (TF._unbind): at A's microbatch with
    # remat, where the extra zero stacks of its backward fit on the card
    variants = (("A", False, 1, False, torch.float32, 5, False),
                ("A+remat", True, 1, False, torch.float32, 2, False),
                ("A+remat indexed", True, 1, False, torch.float32, 2, True),
                ("B", True, 2, True, torch.float32, 3, False),
                ("C", False, 1, False, torch.bfloat16, 2, False))
    unbind = TF._unbind
    res = {}
    for name, remat, accum, compress, mdt, steps, indexed in variants:
        TF._unbind = (lambda tree, n: [TF._period(tree, i) for i in range(n)]
                      ) if indexed else unbind
        cfg = dataclasses.replace(base, remat=remat)
        state = make_train_state(cfg, torch.Generator(dev).manual_seed(0),
                                 dev, compress_grads=compress, opt_dtype=mdt)
        step = build_train_step(cfg, lr=TRAIN_LR, accum_steps=accum,
                                compress_grads=compress)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        ms, losses, gnorms = [], [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        no_launches(f"8a variant {name}")
        peak = torch.cuda.max_memory_allocated()
        finite = all(math.isfinite(x) for x in losses + gnorms) and bool(
            torch.stack([torch.isfinite(t).all()
                         for t in tree_leaves(state.params)]).all())
        if not finite:
            fail(f"8a variant {name}: a loss, gradient norm or updated "
                 "parameter is not finite")
        med = statistics.median(ms[1:])
        res[name] = dict(peak=peak, losses=losses, med=med)
        log(f"  {name}: remat={remat} accum_steps={accum} "
            f"compress_grads={compress} moments={str(mdt)[6:]}: step "
            f"{', '.join(f'{t:.1f}' for t in ms)} ms (median after the "
            f"first {med:.1f} ms), {tokens / med * 1e3:.0f} tokens/s, "
            f"model-FLOP share of the bf16 peak "
            f"{flops / (med / 1e3) / peak_flops:.2%}, peak memory "
            f"{peak / 2**30:.2f} GiB of {total / 2**30:.2f} (headroom "
            f"{(total - peak) / 2**30:.2f} GiB), losses "
            f"{', '.join(f'{x:.4f}' for x in losses)}, grad norms "
            f"{', '.join(f'{x:.3f}' for x in gnorms)}")
        if name == "B":
            ef = sum(float(e.abs().sum()) for e in tree_leaves(state.ef))
            if not ef > 0:
                fail("8a variant B: the EF residuals are all zero")
            log(f"  B: EF residuals sum |r| = {ef:.4e} (non-zero)")
        if name == "A":
            _train_profile(cfg, state, batch)
        del state, step, m
        gc.collect()
        torch.cuda.empty_cache()
    TF._unbind = unbind
    a = res["A"]["losses"]
    if not a[-1] < a[0]:
        fail(f"8a variant A: the loss did not fall over {len(a)} steps on "
             f"one batch ({a[0]:.4f} -> {a[-1]:.4f})")
    log(f"  A's loss falls over its {len(a)} steps on one batch: "
        f"{a[0]:.4f} -> {a[-1]:.4f}")
    pa, pr = res["A"]["peak"], res["A+remat"]["peak"]
    if not pr < pa:
        fail(f"8a remat: peak {pr / 2**30:.2f} GiB not below "
             f"{pa / 2**30:.2f} GiB without it")
    log(f"  remat at A's microbatch: peak {pr / 2**30:.2f} GiB against "
        f"{pa / 2**30:.2f} GiB without it ({(pa - pr) / 2**30:.2f} GiB "
        "less)")
    pi, ri = res["A+remat indexed"]["peak"], res["A+remat indexed"]["med"]
    log(f"  the stacks unbound once a forward against indexed period by "
        f"period (the parent's forward), remat on: peak {pr / 2**30:.2f} "
        f"against {pi / 2**30:.2f} GiB ({(pi - pr) / 2**30:.2f} GiB less), "
        f"step {res['A+remat']['med']:.1f} against {ri:.1f} ms")
    if res["A+remat indexed"]["losses"] != res["A+remat"]["losses"]:
        log("  (the indexed forward's losses differ: "
            f"{res['A+remat indexed']['losses']})")
    log(f"  0 kernel launches over every 8a step: {NO_KERNEL}")
    del batch


def _train_scans(dev, reset, no_launches) -> None:
    """8d: RWKV-6 7B (TRAIN_SCAN_LAYERS of its 32 layers) and
    Jamba-1.5-Large (its first layer: Mamba and a dense GLU MLP) trained at
    full width on the plain path, bf16 parameters, fp32 moments and remat,
    at 8a's global batch: T = 2048 reaches ``chunk_threshold``, so both
    take the reference's chunked forms (``ref.chunked_rwkv6_ref``,
    ``ref.chunked_selective_scan_ref``).  Beside each, one layer at that
    shape through the per-step loop against the chunked form, forward and
    backward."""
    import gc
    import math
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM, batch_at
    from repro_torch.kernels.autotile import PEAK_FLOPS
    from repro_torch.models import blocks
    from repro_torch.train.step import build_train_step, make_train_state
    from repro_torch.tree import tree_leaves

    rwkv = get_config("rwkv6_7b")
    jamba = get_config("jamba_1_5_large_398b")
    two = dataclasses.replace(jamba, layer_pattern=jamba.layer_pattern[:2],
                              n_periods=1).n_params()
    cuts = (
        (dataclasses.replace(rwkv, n_periods=TRAIN_SCAN_LAYERS, remat=True),
         "rwkv", f"depth {TRAIN_SCAN_LAYERS} of {rwkv.n_layers} layers"),
        (dataclasses.replace(jamba, layer_pattern=jamba.layer_pattern[:1],
                             n_periods=1, remat=True),
         "mamba", f"its first layer of {jamba.n_layers} (Mamba and a dense "
         f"GLU MLP); with the second, which carries {jamba.n_experts} "
         f"experts, {two / 1e9:.2f} B parameters, {12 * two / 1e9:.0f} GB at "
         "12 B a parameter, more than the card holds"))
    tokens = TRAIN_B * TRAIN_T
    peak_flops = PEAK_FLOPS[2]
    chunked = {"chunked_rwkv6_ref": 0, "chunked_selective_scan_ref": 0}
    originals = {n: getattr(blocks.R, n) for n in chunked}

    def counting(name):
        def run(*a, **kw):
            chunked[name] += 1
            return originals[name](*a, **kw)
        return run

    for name in chunked:
        setattr(blocks.R, name, counting(name))
    try:
        for cfg, kind, cut in cuts:
            d, V = cfg.d_model, cfg.vocab_size
            N = cfg.n_params()
            log(f"phase 8d {cfg.name} d_model={d} d_ff={cfg.d_ff} vocab={V} "
                f"bf16, global batch {TRAIN_B} x {TRAIN_T} (chunk_threshold "
                f"{cfg.chunk_threshold}, scan_chunk {cfg.scan_chunk}), "
                "remat, fp32 moments")
            log(f"  cut: {cut}; {N / 1e9:.3f} B parameters, "
                f"{12 * N / 1e9:.1f} GB of parameters, gradients and moments")
            # 6 per parameter and token for the products (the embedding
            # lookup does none); the scans' own work is under 0.3% of it
            flops = 6 * (N - V * d) * tokens
            state = make_train_state(cfg, torch.Generator(dev).manual_seed(0),
                                     dev)
            step = build_train_step(cfg, lr=TRAIN_LR)
            batch = batch_at(SyntheticLM(V, TRAIN_T, TRAIN_B, seed=0), 0, dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset()
            for n in chunked:
                chunked[n] = 0
            ms, losses = [], []
            for _ in range(TRAIN_SCAN_STEPS):
                t0 = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(m["loss"]))
            no_launches(f"8d {cfg.name}")
            peak = torch.cuda.max_memory_allocated()
            calls = sum(chunked.values())
            if not calls:
                fail(f"8d {cfg.name}: the train step at T = {TRAIN_T} took "
                     "no chunked form")
            if not (all(math.isfinite(x) for x in losses) and bool(
                    torch.stack([torch.isfinite(t).all() for t in
                                 tree_leaves(state.params)]).all())):
                fail(f"8d {cfg.name}: a loss or updated parameter is not "
                     "finite")
            med = statistics.median(ms[1:])
            log(f"  step {', '.join(f'{t:.1f}' for t in ms)} ms (median "
                f"after the first {med:.1f} ms), {tokens / med * 1e3:.0f} "
                f"tokens/s, model-FLOP share of the bf16 peak "
                f"{flops / (med / 1e3) / peak_flops:.2%} ({flops:.4e} FLOPs "
                f"a step), peak memory {peak / 2**30:.2f} GiB, losses "
                f"{', '.join(f'{x:.4f}' for x in losses)}; chunked forms "
                f"called {calls} times over {TRAIN_SCAN_STEPS} steps "
                "(forward and remat's recompute); 0 kernel launches")
            del state, step, m, batch
            gc.collect()
            torch.cuda.empty_cache()
            _scan_layer_paths(cfg, kind, dev)
    finally:
        for name, fn in originals.items():
            setattr(blocks.R, name, fn)


def _scan_layer_paths(cfg, kind, dev) -> None:
    """One layer of ``cfg`` (an RWKV-6 block or a Mamba block) at 8a's
    shape, forward and backward (a mean square of its output, gradients to
    its input and every parameter), through the per-step loop
    (``chunk_threshold=0``) and through the chunked form: host-clock ms
    (the second of two calls), peak memory above the layer's own tensors,
    and the device events of one profiled call."""
    import gc

    import torch

    from repro_torch.models import blocks

    init, fwd = ((blocks.rwkv_init, blocks.rwkv_fwd) if kind == "rwkv"
                 else (blocks.mamba_init, blocks.mamba_fwd))
    p = init(cfg, torch.Generator(dev).manual_seed(1), dev)
    leaves = [t.requires_grad_() for t in _leaves(p)]
    gen = torch.Generator(dev).manual_seed(2)
    x = torch.randn((TRAIN_B, TRAIN_T, cfg.d_model), generator=gen,
                    device=dev).to(cfg.torch_dtype).requires_grad_()
    rows = []
    for name, c in (("per-step loop", dataclasses.replace(
            cfg, chunk_threshold=0)), ("chunked", cfg)):
        def run():
            y = fwd(c, p, x, backend="ref")
            torch.autograd.grad(y.float().square().mean(), [x, *leaves])

        run()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        _, events = _traced(run)
        rows.append((name, ms, peak, len(events)))
        gc.collect()
        torch.cuda.empty_cache()
    (_, ms0, pk0, ev0), (_, ms1, pk1, ev1) = rows
    log(f"  one {kind} layer, forward and backward at {TRAIN_B} x "
        f"{TRAIN_T}: per-step loop {ms0:.1f} ms, peak {pk0 / 2**30:.2f} GiB, "
        f"{ev0} device events; chunked {ms1:.1f} ms, peak "
        f"{pk1 / 2**30:.2f} GiB, {ev1} device events ({ms0 / ms1:.1f}x "
        f"faster, {ev0 / max(ev1, 1):.0f}x fewer events)")
    del p, leaves, x


def _train_profile(cfg, state, batch) -> None:
    """One step of ``state`` under ``torch.profiler``, as its two parts
    (forward and backward, then AdamW): each part's host-clock ms and its
    device time in bf16 products, fp32 products (on this path: the plain
    attention's QK^T and PV) and other kernels."""
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.train.step import loss_and_grads

    def buckets(events):
        out = {"bf16 products": 0.0, "fp32 products": 0.0, "other": 0.0}
        for e in events:
            n = e.name.lower()
            if any(k in n for k in ("gemm", "nvjet", "xmma", "cutlass")):
                # cuBLAS names its fp32 products f32f32_f32f32 (xmma) or
                # sgemm; the bf16 ones (nvjet_*_h_*, *bf16*) otherwise
                fp32 = any(k in n for k in ("sgemm", "f32f32_f32f32",
                                             "nvjet_sss"))
                out["fp32 products" if fp32 else "bf16 products"] += \
                    e.device_time / 1e3
            else:
                out["other"] += e.device_time / 1e3
        return out

    grads = {}

    def fwd_bwd():
        grads["g"] = loss_and_grads(cfg, state.params, batch)[2]

    fb_ms, fb = _traced(fwd_bwd)
    opt_ms, opt = _traced(lambda: adamw_update(state.params, grads["g"],
                                               state.opt, TRAIN_LR))
    if not fb or not opt:
        log("  profiler: a trace holds no device event, so the step's "
            "device time is not measured")
        return
    a, b = buckets(fb), buckets(opt)
    busy = sum(a.values()) + sum(b.values())
    log(f"  profiled step of A: forward + backward {fb_ms:.1f} ms on the "
        f"host clock, AdamW {opt_ms:.1f} ms; device busy {busy:.1f} ms: "
        + ", ".join(f"{k} {v:.1f} ms ({v / busy:.1%})" for k, v in a.items())
        + f", optimizer {sum(b.values()):.1f} ms "
        f"({sum(b.values()) / busy:.1%}); idle "
        f"{1 - busy / (fb_ms + opt_ms):.1%} of the host-clock time")
    top = {}
    for e in fb + opt:
        top[e.name] = top.get(e.name, 0.0) + e.device_time / 1e3
    log("  top kernels: " + "; ".join(
        f"{k[:60]} {v:.1f} ms" for k, v in
        sorted(top.items(), key=lambda kv: -kv[1])[:8]))


def _train_consistency(dev, reset, no_launches) -> None:
    """8b: glm4 smoke in fp32, one train step on the card against the CPU,
    accumulation 4 against 1, and the kernel backend refused; then the
    RWKV-6 and Jamba smokes in fp32 through the chunked scans
    (CHUNKED_SMOKES), one train step on the card against the CPU."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM, batch_at
    from repro_torch.models import transformer as TF
    from repro_torch.train.step import build_train_step, make_train_state
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config("glm4_9b", reduced=True),
                              dtype="float32")
    log(f"phase 8b {cfg.name} fp32 (TF32 off): a train step on the card "
        "against the CPU")
    batch = batch_at(SyntheticLM(cfg.vocab_size, 16, 4, seed=2), 0, "cpu")
    reset()
    cpu = _train_once(cfg, batch, "cpu")
    card = _train_once(cfg, batch, dev)
    m4, _, p4 = _train_once(cfg, batch, dev, accum=4)
    no_launches("8b")
    _card_matches_cpu(cfg.name, cpu, card)
    mg, pg = card[0], card[2]
    worst = 0.0
    for (path, a), (_, b) in zip(pg, p4):
        ex = float(((b - a).abs() - PARAM_RTOL * a.abs()).max())
        worst = max(worst, ex)
        if ex > PARAM_ATOL:
            fail(f"8b accum 4 vs 1, {path}: outside {PARAM_ATOL:g} + "
                 f"{PARAM_RTOL:g}|x|")
    log(f"  accum_steps=4 against 1 on the card: every leaf within "
        f"{PARAM_ATOL:g} + {PARAM_RTOL:g}|x| (worst excess over the "
        f"relative part {worst:.2e}); loss {m4['loss']:.7f} (the mean of "
        f"the microbatches' CE) against {mg['loss']:.7f}")
    try:
        build_train_step(cfg, backend="kernel")
    except ValueError as e:
        log(f"  build_train_step(backend='kernel') refused: {e}")
    else:
        fail("8b: a train step with backend='kernel' was built")
    state = make_train_state(cfg, torch.Generator(dev).manual_seed(0), dev)
    live = tree_map(lambda t: t.detach().requires_grad_(), state.params)
    b = {k: v.to(dev) for k, v in batch.items()}
    try:
        TF.loss_fn(live, b, cfg, backend="kernel")
    except RuntimeError as e:
        log(f"  the loss through the kernels under autograd raised: {e}")
    else:
        fail("8b: a kernel ran under autograd with inputs that require grad")
    for arch, over in CHUNKED_SMOKES:
        c = dataclasses.replace(get_config(arch, reduced=True),
                                dtype="float32", **over)
        log(f"phase 8b {c.name} fp32 with {over}: a train step at T = 16 "
            "through the chunked forms, on the card against the CPU")
        batch = batch_at(SyntheticLM(c.vocab_size, 16, 4, seed=2), 0, "cpu")
        reset()
        cpu = _train_once(c, batch, "cpu")
        card = _train_once(c, batch, dev)
        no_launches(f"8b {c.name}")
        _card_matches_cpu(c.name, cpu, card)


def _train_once(cfg, batch, device, accum=1):
    """One train step of ``cfg`` from seed 0's parameters on ``device``:
    (metrics, gradients, updated parameters), all on the CPU."""
    import torch

    from repro_torch.train.step import (build_train_step, loss_and_grads,
                                        make_train_state)
    from repro_torch.tree import tree_leaves, tree_map, tree_paths

    state = make_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    state = tree_map(lambda t: t.to(device), state)
    b = {k: v.to(device) for k, v in batch.items()}
    _, _, grads = loss_and_grads(cfg, state.params, b, accum)
    state, m = build_train_step(cfg, lr=1e-3, accum_steps=accum)(state, b)
    return ({k: float(v) for k, v in m.items()},
            [g.cpu() for g in tree_leaves(grads)],
            [(p, t.cpu()) for p, t in tree_paths(state.params)])


def _card_matches_cpu(name, cpu, card) -> None:
    """8b's gates on one train step: loss and gradient norm within
    STEP_RTOL, gradients within GRAD_TOL of each leaf's largest magnitude,
    updated parameters within PARAM_ATOL + PARAM_RTOL|x| where the
    gradient is not at rounding level."""
    (mc, gc_, pc), (mg, gg, pg) = cpu, card
    for k in ("loss", "grad_norm"):
        rel = abs(mg[k] - mc[k]) / abs(mc[k])
        log(f"  {k}: card {mg[k]:.7f} CPU {mc[k]:.7f} (rel {rel:.2e}, tol "
            f"{STEP_RTOL:g})")
        if rel > STEP_RTOL:
            fail(f"8b {name} {k}: the card and the CPU differ by {rel:.2e}")
    worst_g = 0.0
    for a, b in zip(gc_, gg):
        worst_g = max(worst_g, float((a - b).abs().max())
                      / max(float(a.abs().max()), 1e-30))
    log(f"  gradients: worst |card - CPU| / leaf max {worst_g:.2e} (tol "
        f"{GRAD_TOL:g})")
    if worst_g > GRAD_TOL:
        fail(f"8b {name} gradients: the card and the CPU differ")
    exempt = 0
    for g, (path, want), (_, got) in zip(gc_, pc, pg):
        bad = (got - want).abs() > PARAM_ATOL + PARAM_RTOL * want.abs()
        tiny = g.abs() < GRAD_TOL * float(g.abs().max())
        if bool((bad & ~tiny).any()):
            fail(f"8b {name} updated {path}: outside {PARAM_ATOL:g} + "
                 f"{PARAM_RTOL:g}|x| where the gradient is not at rounding "
                 "level")
        exempt += int(bad.sum())
    log(f"  updated parameters within {PARAM_ATOL:g} + {PARAM_RTOL:g}|x| "
        f"of the CPU's ({exempt} elements outside, each with |g| below "
        f"{GRAD_TOL:g} of its leaf's largest: AdamW's first step moves an "
        "element by about lr sign(g))")


def _train_lm_twin(dev, reset, no_launches) -> None:
    """8c: the twin of examples/train_lm.py at --preset 100m, checkpointed,
    restored and resumed."""
    import contextlib
    import io
    import tempfile

    import torch

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.data.pipeline import SyntheticLM, batch_at
    from repro_torch.optim.adamw import cosine_schedule
    from repro_torch.train import train_lm
    from repro_torch.train.step import build_train_step, make_train_state
    from repro_torch.tree import tree_paths

    cfg = train_lm.preset("100m")
    B, T = 8, 256
    log(f"phase 8c train_lm twin --preset 100m ({cfg.n_params() / 1e6:.1f}M "
        f"parameters, {cfg.n_layers} layers, fp32), batch {B} x {T}, "
        "checkpoints every 10 steps")

    def main(d, steps):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            run = train_lm.main(["--preset", "100m", "--steps", str(steps),
                                 "--batch", str(B), "--seq", str(T),
                                 "--ckpt", d, "--ckpt-every", "10",
                                 "--device", "cuda"])
        torch.cuda.synchronize()
        for line in out.getvalue().splitlines():
            log(f"    {line}")
        return run, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as d:
        reset()
        first, s1 = main(d, 30)
        no_launches("8c")
        l0, l29 = first.losses[0], first.losses[29]
        log(f"  30 steps in {s1:.1f} s (checkpoints included); loss at step "
            f"0 {l0:.4f}, at step 29 {l29:.4f}")
        if not l29 < l0:
            fail("8c: the loss at step 29 is not below the loss at step 0")
        step, restored = CheckpointManager(d).restore(
            make_train_state(cfg, device="meta"), device=dev)
        if step != 30:
            fail(f"8c: the latest checkpoint is step {step}, want 30")
        for (path, a), (_, b) in zip(tree_paths(restored),
                                     tree_paths(first.state)):
            if a.dtype != b.dtype or not torch.equal(a, b):
                fail(f"8c restore: {path} differs from the saved state")
        log(f"  restored step {step}: every one of "
            f"{len(tree_paths(restored))} leaves equal to the saved state, "
            "bit for bit")
        del restored
        reset()
        again, s2 = main(d, 40)
        no_launches("8c resume")
        if again.start != 30 or sorted(again.losses) != list(range(30, 40)):
            fail(f"8c: the re-run resumed at {again.start}, want 30")
        ds = SyntheticLM(cfg.vocab_size, T, B, seed=0)
        step_fn = build_train_step(cfg, lr=cosine_schedule(3e-3, 20, 40))
        _, cont = train_lm.train(step_fn, first.state,
                                 lambda i: batch_at(ds, i, dev), 30, 40,
                                 tokens_per_step=B * T, log=lambda s: None)
        worst = max(abs(again.losses[i] - cont[i]) / abs(cont[i])
                    for i in cont)
        log(f"  resumed at 30 and ran to 40 in {s2:.1f} s; losses 30-39 "
            f"against an uninterrupted continuation from the in-memory "
            f"state: worst relative difference {worst:.2e} (tol "
            f"{RESUME_RTOL:g}); loss at 39 {again.losses[39]:.4f}")
        if worst > RESUME_RTOL:
            fail("8c: the resumed run departs from the uninterrupted one")


# ---------------------------------------------------------------------------
# phase 9: the DSE scoring engine
# ---------------------------------------------------------------------------

DSE_SPACE, DSE_SEQS, DSE_TILE = "large", (512, 4096), 32


def _dse(dev, smi: str) -> None:
    """Phase 9: the `large` space's mapping prefill on the card, its raw
    scores held to the NumPy kernel and its winners to the NumPy engine."""
    import gc

    import numpy as np
    import torch

    from repro_torch.core.mapper_batch import (_dn_row, _true_rows,
                                               best_mappings, build_batch)
    from repro_torch.core.perf_model import perf_kernel
    from repro_torch.core.perf_model_torch import (ENERGY_RTOL, RESULT_KEYS,
                                                   perf_kernel_torch_design)
    from repro_torch.dse import batch_sweep as B
    from repro_torch.dse.cache import MappingCache, mapping_key
    from repro_torch.dse.space import SPACES

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    space = SPACES[DSE_SPACE]
    zoo = B.sweep_zoo(B.DEFAULT_ZOO, DSE_SEQS)
    path = ROOT / ".chipscratch" / "dse_large_cache.json"
    path.parent.mkdir(exist_ok=True)
    path.unlink(missing_ok=True)
    log(f"phase 9 DSE scoring engine: space {space.name}, zoo "
        f"{','.join(B.DEFAULT_ZOO)}, seq {DSE_SEQS}, d_tile {DSE_TILE}, "
        f"objective cycles [{smi}]")

    # 9a. the main path: prefill_sweep on the card, cold cache
    cache = MappingCache(path)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st = B.prefill_sweep(space, zoo, cache, objective="cycles",
                         d_tile=DSE_TILE, device=dev)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    t0 = time.perf_counter()
    cache.save()
    save_s = time.perf_counter() - t0
    if st["designs"] != 624 or st["dispatches"] == 0 or \
            st["device_ms"] <= 0 or st["entries_added"] != len(cache) or \
            len(MappingCache(path)) != len(cache):
        fail(f"DSE prefill: {st}, {len(cache)} entries in the cache")
    log(f"  9a prefill: {st['designs']} designs in {st['tiles']} tiles, "
        f"{st['dispatches']} dispatches, {st['entries_added']} entries "
        f"written, {st['candidates_scored']} candidates scored")
    log(f"     wall {st['wall_s']:.3f} s = host enumeration (build_batch) "
        f"{st['enum_s']:.3f} + dispatches {st['dispatch_s']:.3f} (device "
        f"{st['device_ms']:.1f} ms by CUDA events) + host selection and "
        f"rescoring {st['select_s']:.3f} + query planning and cache puts "
        f"{st['other_s']:.3f}; save {save_s:.3f} s")
    log(f"     {st['candidates_scored'] / st['wall_s']:.0f} candidates/s "
        f"over the wall time, "
        f"{st['candidates_scored'] / st['dispatch_s']:.0f} over the "
        f"dispatches; peak device memory {peak:.1f} MiB; largest batch per "
        f"kind (candidates, loops): {st['kinds']}")

    # 9b. the card's raw (D, C) scores against the NumPy kernel, design by
    # design, every design of every tile
    t0 = time.perf_counter()
    tiles = B.plan_tiles(list(space.enumerate()), DSE_TILE)
    worst, n_designs, n_rows = 0.0, 0, 0
    for tile in tiles:
        hws = [p.hw_config() for p in tile]
        for wl, sps, dn, queries in B.prefill_queries(zoo, tile[0]):
            dims_list = [q[0] for q in queries]
            b = build_batch(wl, dims_list, sps, hws[0])
            true = _true_rows(wl, dims_list)[b.layer_id]
            ppu = np.array([q[1] for q in queries])[b.layer_id]
            dn_rows = np.array([_dn_row(wl, hw, dn) for hw in hws])
            args = (b.loop_dim, b.loop_size, b.S, b.n_fus, b.fill, true)
            got = perf_kernel_torch_design(wl, hws, *args, dn_rows, ppu,
                                           device=dev)
            for di, hw in enumerate(hws):
                want = perf_kernel(wl, hw, *args, np.broadcast_to(
                    dn_rows[di], (b.n_candidates, dn_rows.shape[1])), ppu)
                for k in RESULT_KEYS:
                    g = got[k][di]
                    if k == "energy_pj":
                        rel = float(np.max(np.abs(g - want[k])
                                           / np.abs(want[k])))
                        worst = max(worst, rel)
                        if rel > ENERGY_RTOL:
                            fail(f"DSE {tile[di].name} {wl.name}: energy_pj "
                                 f"{rel:.3e} from NumPy's, over "
                                 f"{ENERGY_RTOL:g}")
                    elif not np.array_equal(g, want[k]):
                        fail(f"DSE {tile[di].name} {wl.name}: {k} differs "
                             f"from NumPy's perf_kernel")
                n_rows += b.n_candidates
        n_designs += len(tile)
    log(f"  9b raw scores of all {n_designs} designs ({n_rows} design x "
        f"candidate rows) vs the NumPy perf_kernel: integer outputs "
        f"bit-identical, energy_pj max rel diff {worst:.3e} (gate "
        f"{ENERGY_RTOL:g}) in {time.perf_counter() - t0:.1f}s")

    # 9c. the cache's winners of every tile's first design against the
    # NumPy engine's mappings
    t0 = time.perf_counter()
    n_q = 0
    for tile in tiles:
        p, hw = tile[0], tile[0].hw_config()
        for wl, sps, dn, queries in B.prefill_queries(zoo, p):
            want = best_mappings(wl, queries, sps, hw,
                                 data_nodes_per_tensor=dn,
                                 objective="cycles", engine="numpy")
            for (dims, ppu), m in zip(queries, want):
                e = cache.get(mapping_key(wl, dims, sps, hw, dn, ppu,
                                          "cycles"))
                if e != {"perf": m.perf.as_dict(), "spatial": m.spatial.name,
                         "dataflow": m.dataflow.name}:
                    fail(f"DSE {p.name} {wl.name} {dims}: the cache holds "
                         f"{e}, the NumPy engine gives {m}")
                n_q += 1
    log(f"  9c winners: {n_q} queries of {len(tiles)} tiles' first designs "
        f"== best_mappings(engine='numpy') (perf, spatial, dataflow) in "
        f"{time.perf_counter() - t0:.1f}s")

    # 9d. one tile by the card and by the NumPy engine, in turns
    times = {}
    for engine in ("torch", "numpy", "numpy", "torch"):
        one = B.new_stats()
        t0 = time.perf_counter()
        B.prefill_tile(zoo, tiles[0], MappingCache(), "cycles", device=dev,
                       engine=engine, stats=one)
        times.setdefault(engine, []).append(
            (time.perf_counter() - t0, one["dispatch_s"]))
    log(f"  9d first tile ({len(tiles[0])} designs x {tiles[0][0].n_fus} "
        f"FUs): wall / scoring s, card "
        + ", ".join(f"{w:.3f} / {d:.3f}" for w, d in times["torch"])
        + "; NumPy engine "
        + ", ".join(f"{w:.3f} / {d:.3f}" for w, d in times["numpy"]))
    log(f"phase 9 done in {time.perf_counter() - t_phase:.1f}s")




# ---------------------------------------------------------------------------
# phase 10: the sharded entry points
# ---------------------------------------------------------------------------

# the dry run's cells on the card machine, (arch, shape), on pod16x16
# 10c's cells, each with the most counted FLOPs a device may run over the
# model's FLOPs per device: the larger of the cell's ratios under torch 2.13
# (on the CPU) and 2.11 (this machine's), with 5% to spare.  The ratios
# hold attention over the context, which the model FLOPs leave out, and
# remat's recomputation (train_4k 1.616 and 1.312; decode_32k 14.973 and
# long_500k 1156.935 under both, since local_call splits a mesh dim it
# would otherwise leave repeating the work and each device holds its q
# heads and their kv head).  A mesh dim on which every device repeats the
# same work fails the cell.  rwkv6_7b x train_4k (187 s to trace on this
# machine's host) left the list: RWKV-6's split is counted on a small fake
# mesh instead (RWKV_SPLIT_*).
DRYRUN_CELLS = (("mistral_nemo_12b", "train_4k", 1.70),
                ("mistral_nemo_12b", "decode_32k", 15.7),
                ("jamba_1_5_large_398b", "long_500k", 1215.0))
# 10c: RWKV-6's loss and gradients at smoke width on a fake pod 2 x data 2
# x model 4 mesh, as tests/test_torch_sharding_counts.py counts them: a
# device's products must be 1/16 of the unsharded step's (torch 2.11 once
# ran a layer's channel mix on every device of model)
RWKV_SPLIT_MESH = ((2, 2, 4), ("pod", "data", "model"))
RWKV_SPLIT_B, RWKV_SPLIT_T, RWKV_SPLIT_VOCAB = 16, 32, 509
SHARD_LOSS_RTOL = 1e-5


def _sharded(dev, reset, launches) -> None:
    """Phase 10: the dry run starts first (four subprocesses on the CPU,
    the "fake" group), then 10a and 10b run on the card under one nccl
    group of world size 1, then the dry run's records are read."""
    import os
    import tempfile

    from repro_torch.launch.mesh import local_group, shape_mesh

    t0 = time.perf_counter()
    log("phase 10 sharded entry points on a one-card DeviceMesh (data=1, "
        "model=1; nccl, world size 1, an in-process store)")
    out_dir = tempfile.mkdtemp(prefix="dryrun_", dir=ROOT / ".chipscratch"
                               if (ROOT / ".chipscratch").is_dir() else None)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", out_dir], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for arch, shape, _ in DRYRUN_CELLS]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke._rwkv6_split()"],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True))
    try:
        with local_group(str(dev)):
            mesh = shape_mesh((1, 1), ("data", "model"), device_type="cuda")
            _sharded_serve(dev, mesh, reset, launches)
            _sharded_train(dev, mesh, reset)
        _dryrun_records(procs, out_dir)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    log(f"phase 10 done in {time.perf_counter() - t0:.1f}s")


def _sharded_serve(dev, mesh, reset, launches) -> None:
    """10a: phase 4a again through the mesh's entry points."""
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TF
    from repro_torch.serve.engine import build_serve_step, generate

    cfg = get_config("mistral_nemo_12b")
    ref = SERVED[cfg.name]
    L, prompts, new = cfg.n_layers, ref["prompts"], ref["new"]
    B, Tp = prompts.shape
    torch.cuda.reset_peak_memory_stats()
    params = TF.init_params(cfg, torch.Generator(dev).manual_seed(
        ref["seed"]), dev)
    with torch.inference_mode():
        step, dparams, dstate = build_serve_step(cfg, mesh=mesh).jit_with(
            params, TF.init_decode_state(cfg, B, Tp + new, device=dev))
        placements = {str(p) for p in dparams["layers"]["pos0"]["core"][
            "wq"]["w"].placements}
        log(f"10a {cfg.name} full width and depth on the mesh: params and "
            f"state laid out as DTensors (wq {placements}); forward on the "
            "DTensors, then generate through the mesh's captured step "
            "(local tensors of the one-card mesh)")
        tok = torch.randint(0, cfg.vocab_size, (1, 512), device=dev,
                            dtype=torch.int32)
        TF.forward(dparams, tok[:, :64], cfg, mesh=mesh)      # warm-up
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        logits, _ = TF.forward(dparams, tok, cfg, mesh=mesh)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        got = launches()
        t0 = time.perf_counter()
        plain_logits, _ = TF.forward(params, tok, cfg)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        diff = (logits.to_local() - plain_logits).abs().max().item()
        if got != (L, 0, 0, 0, 0) or not torch.isfinite(
                logits.to_local()).all():
            fail(f"10a forward on the mesh: launches {got}, want "
                 f"{(L, 0, 0, 0, 0)}, or non-finite logits")
        log(f"  forward B=1 T=512 on the DTensors: {fwd_ms:.1f} ms (the "
            f"unsharded forward {plain_ms:.1f} ms, {fwd_ms / plain_ms:.1f}x: "
            "DTensor's dispatch on the host), "
            f"launches {got} (K2 prefill once a layer, as phase 4a's "
            f"{ref['fwd_launches'][0]} at T={ref['T']}), logits max |diff| "
            f"against the unsharded forward {diff:.3e}")
        del logits, plain_logits
        generate(params, cfg, prompts, max_new=2, mesh=mesh)   # warm-up
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        out = generate(params, cfg, prompts, max_new=new, mesh=mesh)
        torch.cuda.synchronize()
        gen_ms = (time.perf_counter() - t0) * 1e3
        got = launches()
        if not torch.equal(out, ref["out"]):
            fail("10a generate on the mesh: tokens differ from phase 4a's")
        if got != ref["gen_launches"]:
            fail(f"10a generate on the mesh: launches {got}, phase 4a's "
                 f"{ref['gen_launches']}")
        log(f"  generate B={B} prompt={Tp} new={new}: {gen_ms:.1f} ms, "
            f"tokens identical to phase 4a's, launches {got} == phase 4a's "
            "(replays counted)")
        # the replayed step: the mesh's captured step, ten replays
        pos = torch.zeros((), dtype=torch.int32, device=dev)
        t = prompts[:, 0]
        ms = []
        for i in range(13):
            t0 = time.perf_counter()
            step(dparams, dstate, t, pos)
            torch.cuda.synchronize()
            pos += 1
            if i >= 3:
                ms.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(ms)
        if step.captures != 1:
            fail(f"10a: the mesh's step captured {step.captures} times, "
                 "want 1")
        log(f"  replayed step B={B} on the mesh: median {med:.3f} ms of "
            f"{len(ms)} (host clock), phase 4a's {ref['replay_ms']:.3f} ms "
            f"({med / ref['replay_ms']:.2f}x); captures {step.captures}, "
            f"replays {step.replays}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params, dparams, dstate, step
    torch.cuda.empty_cache()


def _sharded_train(dev, mesh, reset) -> None:
    """10b: phase 8a's shape, unsharded and through the mesh."""
    import gc
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM, batch_at
    from repro_torch.kernels import ops
    from repro_torch.train.step import build_train_step, make_train_state

    cfg = dataclasses.replace(get_config("mistral_nemo_12b"),
                              n_periods=TRAIN_LAYERS, remat=True)
    batch = batch_at(SyntheticLM(cfg.vocab_size, TRAIN_T, TRAIN_B, seed=0),
                     0, dev)
    log(f"10b {cfg.name} {TRAIN_LAYERS} of 40 layers, global batch "
        f"{TRAIN_B} x {TRAIN_T}, remat, bf16 moments: three steps unsharded, "
        "then three through build_train_step(cfg, mesh)")
    res = {}
    for name in ("unsharded", "mesh"):
        gc.collect()
        torch.cuda.empty_cache()
        state = make_train_state(cfg, torch.Generator(dev).manual_seed(0),
                                 dev, opt_dtype=torch.bfloat16)
        if name == "mesh":
            step, state = build_train_step(cfg, mesh, lr=TRAIN_LR).jit_with(
                state)
        else:
            step = build_train_step(cfg, lr=TRAIN_LR)
        steps = 3
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        ms, losses = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        if any(ops.launch_counts()):
            fail(f"10b {name}: kernel launches {ops.launch_counts()} in "
                 "training, want none")
        res[name] = dict(loss=losses[0], losses=losses, ms=ms,
                         peak=torch.cuda.max_memory_allocated())
        log(f"  {name}: step {', '.join(f'{t:.1f}' for t in ms)} ms, "
            f"losses {', '.join(f'{x:.6f}' for x in losses)}, peak memory "
            f"{res[name]['peak'] / 2**30:.2f} GiB")
        del state, step, m
    a, b = res["unsharded"]["loss"], res["mesh"]["loss"]
    rel = abs(b - a) / abs(a)
    if not rel <= SHARD_LOSS_RTOL:
        fail(f"10b: the mesh step's loss {b:.8f} is {rel:.2e} from the "
             f"unsharded {a:.8f}, want <= {SHARD_LOSS_RTOL}")
    med = statistics.median(res["mesh"]["ms"][1:])
    later = max(abs(x - y) / abs(y) for x, y in zip(
        res["mesh"]["losses"][1:], res["unsharded"]["losses"][1:]))
    log(f"  loss on the mesh {b:.8f} vs unsharded {a:.8f}: {rel:.2e} "
        f"relative (<= {SHARD_LOSS_RTOL}); the later steps' losses "
        f"{later:.2e} apart (after the updates); mesh step {med:.1f} ms vs "
        f"unsharded {statistics.median(res['unsharded']['ms'][1:]):.1f} ms "
        f"(medians after the first), peak "
        f"{res['mesh']['peak'] / 2**30:.2f} vs "
        f"{res['unsharded']['peak'] / 2**30:.2f} GiB")
    del batch
    gc.collect()
    torch.cuda.empty_cache()


def _rwkv6_split() -> None:
    """10c, in a subprocess with CUDA hidden: RWKV-6's loss and gradients
    counted (``launch.opcount``) under fake tensors, unsharded and a device
    of the fake ``RWKV_SPLIT_MESH``; prints one JSON line."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import fake_group, shape_mesh
    from repro_torch.launch.opcount import OpCounter
    from repro_torch.models import transformer as TF
    from repro_torch.parallel.sharding import (distribute, distribute_tree,
                                               shard_params_spec)
    from repro_torch.train.step import loss_and_grads

    cfg = dataclasses.replace(get_config("rwkv6_7b", reduced=True),
                              vocab_size=RWKV_SPLIT_VOCAB, dtype="float32")

    def count(mesh=None) -> float:
        fake = FakeTensorMode()
        with fake:
            params = TF.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
            batch = {k: torch.zeros((RWKV_SPLIT_B, RWKV_SPLIT_T),
                                    dtype=torch.int32)
                     for k in ("tokens", "labels")}
            if mesh is not None:
                params = distribute_tree(
                    params, shard_params_spec(params, mesh), mesh)
                batch = {k: distribute(v, mesh, ("batch", "none"))
                         for k, v in batch.items()}
        with fake, OpCounter() as oc:
            loss_and_grads(cfg, params, batch, mesh=mesh)
        return oc.counts.flops

    n = 1
    for d in RWKV_SPLIT_MESH[0]:
        n *= d
    whole = count()
    with fake_group(n):
        per = count(shape_mesh(*RWKV_SPLIT_MESH))
    print(json.dumps({"whole": whole, "per_device": per, "devices": n,
                      "torch": torch.__version__}), flush=True)


def _dryrun_records(procs, out_dir) -> None:
    """10c: waits for the dry run's subprocesses and reads their records."""
    import os
    excessive = []
    out, _ = procs[-1].communicate(timeout=600)
    if procs[-1].returncode != 0:
        fail(f"10c RWKV-6 split count: exit {procs[-1].returncode}\n"
             f"{out[-3000:]}")
    rec = json.loads(out.strip().splitlines()[-1])
    if not abs(rec["per_device"] * rec["devices"] - rec["whole"]) <= \
            1e-9 * rec["whole"]:
        fail(f"10c RWKV-6 split count: a device counts "
             f"{rec['per_device']:.6g} of {rec['whole']:.6g} FLOPs over "
             f"{rec['devices']} devices")
    log(f"10c RWKV-6 split (smoke width, B={RWKV_SPLIT_B} T={RWKV_SPLIT_T}, "
        f"fake {'x'.join(map(str, RWKV_SPLIT_MESH[0]))} mesh, torch "
        f"{rec['torch']}): a device counts {rec['per_device']:.6g} FLOPs, "
        f"1/{rec['devices']} of the unsharded step's {rec['whole']:.6g}")
    for p, (arch, shape, excess) in zip(procs, DRYRUN_CELLS):
        out, _ = p.communicate(timeout=600)
        path = os.path.join(out_dir, f"{arch}__{shape}__pod16x16.json")
        if p.returncode != 0 or not os.path.exists(path):
            fail(f"10c dry run {arch} x {shape}: exit {p.returncode}\n"
                 f"{out[-3000:]}")
        rec = json.loads(Path(path).read_text())
        if rec["status"] != "ok":
            fail(f"10c dry run {arch} x {shape}: {rec['status']} "
                 f"{rec.get('error')}")
        m, r = rec["memory"], rec["roofline"]
        gb = (m["argument_size"] + m["temp_size"] + m["output_size"]
              - m["alias_size"]) / 1e9
        ratio = r["flops_global"] / r["model_flops"]
        if not ratio <= excess:
            excessive.append(f"{arch} x {shape}: a device counts "
                             f"{ratio:.3f}x the model's FLOPs per device, "
                             f"above {excess}")
        log(f"10c dry run {arch} x {shape} pod16x16: ok in "
            f"{rec['seconds']:.1f}s, {gb:.2f} GB/dev, Tc "
            f"{r['t_compute_s'] * 1e3:.2f} ms, Tm {r['t_memory_s'] * 1e3:.2f}"
            f" ms, Tx {r['t_collective_s'] * 1e3:.2f} ms -> "
            f"{r['bottleneck']}, counted / model FLOPs {ratio:.3f} (at most "
            f"{excess}; predictions from operation counts against the H100's "
            "constants)")
    if excessive:
        fail("10c dry run " + "; ".join(excessive))



# ---------------------------------------------------------------------------
# phase 11: the DSE's evaluation on the card
# ---------------------------------------------------------------------------

DSE_POOL = 8                # 11a's NumPy sweep: spawned workers, one a core
DSE_BUDGET, DSE_SEED = 64, 0  # 11c: benchmarks/dse.py's evolve defaults


def _dse_same(what, got, want, path="") -> None:
    """Scorecards of the two engines: names and every number equal, the
    energies (and what derives from them) within ENERGY_RTOL relative."""
    from repro_torch.core.perf_model_torch import ENERGY_RTOL
    if isinstance(want, dict):
        if not isinstance(got, dict) or list(got) != list(want):
            fail(f"{what}{path}: keys {list(got)} vs {list(want)}")
        for k in want:
            _dse_same(what, got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            fail(f"{what}{path}: {len(got)} items vs {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            _dse_same(what, g, w, f"{path}[{i}]")
    elif isinstance(want, float) and any(
            k in path for k in ("energy", "gops_per_w")):
        if not abs(got - want) <= ENERGY_RTOL * abs(want):
            fail(f"{what}{path}: {got!r} vs {want!r} (rtol {ENERGY_RTOL:g})")
    elif type(got) is not type(want) or got != want:
        fail(f"{what}{path}: {got!r} vs {want!r}")


def _dse_same_result(what, got, want) -> None:
    """Two SearchResults: the same designs in the same order, the same
    scorecards, the same frontier."""
    for part in ("evals", "frontier"):
        g, w = getattr(got, part), getattr(want, part)
        if [e.point.name for e in g] != [e.point.name for e in w]:
            fail(f"{what}: the {part} differ in their designs or order")
        _dse_same(f"{what} {part}", [e.as_dict() for e in g],
                  [e.as_dict() for e in w])


def _dse_eval(dev, smi: str) -> None:
    """Phase 11: the Evaluator, the searches, the pool, the serving replay
    and the report of the port, each miss scored on the card, held to the
    NumPy engine in the same run."""
    import os

    import torch

    from repro_torch.dse import batch_sweep as B
    from repro_torch.dse.cache import MappingCache
    from repro_torch.dse.evaluate import Evaluator, load_zoo
    from repro_torch.dse.report import format_frontier, format_serving
    from repro_torch.dse.search import evolve_search, exhaustive_search
    from repro_torch.dse.space import SPACES
    from repro_torch.dse.supervisor import Supervisor
    from repro_torch.serve.sim import ServingSpec

    t_phase = time.perf_counter()
    if not torch.cuda.is_initialized():
        fail("11: CUDA is not up before the DSE's searches")
    log(f"phase 11 the DSE's evaluation on the card [{smi}]")

    def timed(fn):
        t0 = time.perf_counter()
        return fn(), time.perf_counter() - t0

    # 11a. large, design-batched over phase 9's warm cache, against the
    # NumPy engine's cold exhaustive search of the same designs
    space = SPACES[DSE_SPACE]
    zoo = B.sweep_zoo(B.DEFAULT_ZOO, DSE_SEQS)
    path = ROOT / ".chipscratch" / "dse_large_cache.json"
    cache = MappingCache(path)
    n_warm = len(cache)
    ev = Evaluator(zoo=zoo, cache=cache, objective="cycles", engine="torch",
                   device=dev)
    st = B.new_stats()
    res, card_s = timed(lambda: B.batch_sweep(space, ev, d_tile=DSE_TILE,
                                              stats=st))
    if n_warm == 0 or st["designs"] != len(list(space.enumerate())) or \
            st["dispatches"] != 0 or \
            st["entries_added"] != 0 or res.cache_stats["misses"] != 0:
        fail(f"11a: the sweep over phase 9's cache ({n_warm} entries) "
             f"solved something: {st}, {res.cache_stats}")
    workers = min(DSE_POOL, os.cpu_count() or 1)
    ref, numpy_s = timed(lambda: exhaustive_search(
        space, Evaluator(zoo=zoo, cache=MappingCache(), engine="numpy"),
        workers=workers))
    if ref.supervisor["respawns"] or ref.supervisor["degraded_sequential"]:
        fail(f"11a: the NumPy engine's pool: {ref.supervisor}")
    _dse_same_result("11a large", res, ref)
    log(f"  11a {space.name}: batch_sweep on the card over phase 9's "
        f"{n_warm} entries: {st['designs']} designs in {st['tiles']} "
        f"tiles, prefill {st['prefill_s']:.3f} s (0 dispatches, 0 "
        f"entries), evaluation {st['eval_s']:.3f} s, "
        f"{res.cache_stats['hits']} hits / 0 misses, wall {card_s:.3f} s; "
        f"the NumPy engine's cold exhaustive_search ({workers} spawned "
        f"workers, {ref.cache_stats['misses']} misses) {numpy_s:.3f} s; "
        f"evals and frontier identical (energy within ENERGY_RTOL)")
    for line in format_frontier(res).splitlines():
        log(f"     {line}")

    # 11b. small, per design, cold: every miss scored on the card
    zoo512 = load_zoo(B.DEFAULT_ZOO, seq=512)
    small = SPACES["small"]
    got, t_card = timed(lambda: exhaustive_search(
        small, Evaluator(zoo=zoo512, engine="torch", device=dev)))
    want, t_np = timed(lambda: exhaustive_search(
        small, Evaluator(zoo=zoo512, engine="numpy")))
    _dse_same_result("11b small", got, want)
    if got.cache_stats["misses"] == 0:
        fail("11b: the cold search scored nothing on the card")
    log(f"  11b {small.name} ({got.n_designs} designs, seq 512), cold, per "
        f"design: torch engine on the card {t_card:.3f} s "
        f"({got.cache_stats['misses']} misses scored on the card, "
        f"{got.cache_stats['hits']} hits), NumPy engine {t_np:.3f} s; evals "
        f"and frontier identical")

    # 11c. huge, guided: the same visit order and frontier on either engine
    huge = SPACES["huge"]
    g3, t_card3 = timed(lambda: evolve_search(
        huge, Evaluator(zoo=zoo512, engine="torch", device=dev),
        budget=DSE_BUDGET, seed=DSE_SEED))
    w3, t_np3 = timed(lambda: evolve_search(
        huge, Evaluator(zoo=zoo512, engine="numpy"), budget=DSE_BUDGET,
        seed=DSE_SEED))
    if g3.extra != w3.extra:
        fail(f"11c: the guided searches differ: {g3.extra} vs {w3.extra}")
    _dse_same_result("11c huge", g3, w3)
    log(f"  11c {huge.name} evolve_search budget {DSE_BUDGET} seed "
        f"{DSE_SEED}: {g3.extra['spent']} designs visited in the same order "
        f"({g3.extra['prefilter_evals']} prefilter evaluations on "
        f"{g3.extra['prefilter_zoo']}), {len(g3.frontier)} on the frontier; "
        f"torch engine on the card {t_card3:.3f} s "
        f"({g3.cache_stats['misses']} misses), NumPy engine {t_np3:.3f} s")

    # 11d. the pool after CUDA is up: it must spawn; its frontier is the
    # in-process one (11b's NumPy run)
    ev4 = Evaluator(zoo=zoo512, engine="torch", device=dev)
    with Supervisor(ev4, workers=2) as sup:
        method = sup._ctx.get_start_method()
        pooled, t_pool = timed(lambda: exhaustive_search(small, ev4,
                                                         supervisor=sup))
    if method != "spawn":
        fail(f"11d: the pool starts its workers by {method!r} with CUDA up")
    if pooled.supervisor["evaluated"] != want.n_designs or \
            pooled.supervisor["respawns"]:
        fail(f"11d: the pool's run: {pooled.supervisor}")
    _dse_same_result("11d pool", pooled, want)
    log(f"  11d pool of 2 workers ({method}, CUDA up in the parent) over "
        f"{small.name}: {t_pool:.3f} s, evals and frontier == workers=1's")

    # 11e. serving: the reference's default trace and SLO over tiny
    tiny = SPACES["tiny"]
    g5, t_card5 = timed(lambda: exhaustive_search(tiny, Evaluator(
        zoo=zoo512, engine="torch", device=dev, serving=ServingSpec())))
    w5, t_np5 = timed(lambda: exhaustive_search(tiny, Evaluator(
        zoo=zoo512, engine="numpy", serving=ServingSpec())))
    _dse_same_result("11e serving", g5, w5)
    if any(e.serving is None for e in g5.evals) or \
            format_serving(g5) != format_serving(w5):
        fail("11e: the serving scorecards differ")
    best = g5.best("goodput")
    log(f"  11e serving over {tiny.name} (trace "
        f"'{best.serving['trace']['spec']}'): every design's summary == the "
        f"NumPy engine's; goodput winner {best.point.name} at "
        f"{best.serving['goodput_tps']:.3f} tokens/s (simulated); torch "
        f"engine on the card {t_card5:.3f} s ({g5.cache_stats['misses']} "
        f"misses), NumPy engine {t_np5:.3f} s")

    log(f"phase 11 done in {time.perf_counter() - t_phase:.1f}s")


# ---------------------------------------------------------------------------
# phase 12: the LEGO generator on the card
# ---------------------------------------------------------------------------

# the paper's fused 256-FU designs (repro_torch.designs, the port's copy of
# benchmarks/designs.py)
GEN_DESIGNS = ("GEMM-MJ", "Conv2d-MNICOC", "MTTKRP-MJ", "Attention")
# the long run: Conv2d-MNICOC with conv-icoc's oh and ow at 56, the spatial
# size of ResNet-50's conv2_x layers (T = 2*2*56*56*3*3 = 112,896 cycles,
# 28.9 M MACs)
GEN_LONG_OHOW = 56
# the PV stage behind a softmax: the card's exp against the CPU's
GEN_SOFTMAX_RTOL = 1e-12


def _gen_recipe(name: str, ohow: int | None = None):
    """The design's (workload, dataflow) pairs; with ``ohow``, conv-icoc's
    oh and ow loops run to ``ohow``."""
    from repro_torch.core.dataflow import build_dataflow
    from repro_torch.designs import DESIGNS
    specs = []
    for wl, df in DESIGNS[name]():
        if ohow is not None and df.name == "conv-icoc":
            df = build_dataflow(
                wl, spatial=[(l.dim, l.size) for l in df.spatial],
                temporal=[(l.dim, ohow if l.dim in ("oh", "ow") else l.size)
                          for l in df.temporal],
                c=tuple(int(v) for v in df.c), name=df.name)
        specs.append((wl, df))
    return specs


def _gen_build(name: str, specs):
    """Host: ADG, DAG, the LP/ILP back end and the Verilog, each timed."""
    from repro_torch.core.adg import generate_adg
    from repro_torch.core.cost import dag_area_um2, dag_power_mw
    from repro_torch.core.dag import codegen
    from repro_torch.core.emit import emit_netlist
    from repro_torch.core.passes import run_backend
    t0 = time.perf_counter()
    adg = generate_adg(specs, name=name)
    t1 = time.perf_counter()
    dag = codegen(adg)
    rep = run_backend(dag)
    t2 = time.perf_counter()
    text = emit_netlist(dag)
    t3 = time.perf_counter()
    if "pipe(" in text or not text.startswith("// generated by"):
        fail(f"12 {name}: emitted Verilog is malformed")
    log(f"  12 {name}: ADG {t1 - t0:.2f} s ({adg.summary()['links']} links, "
        f"{adg.summary()['data_nodes']} data nodes), DAG + back end "
        f"{t2 - t1:.2f} s ({len(dag.nodes)} nodes, {len(dag.edges)} edges, "
        f"register bits {rep['register_bits']}, depth "
        f"{rep['pipeline_depth']}), Verilog {t3 - t2:.2f} s "
        f"({len(text.splitlines())} lines, {len(text)} bytes); "
        f"{dag_area_um2(dag).total_um2 / 1e6:.3f} mm2, "
        f"{dag_power_mw(dag).total_mw:.1f} mW")
    return adg, dag


def _gen_same(tag, card, cpu, fields) -> None:
    """The card's result equal to the CPU's: output bit for bit and each
    named field (counters, checks, introspection) equal."""
    import torch
    if not torch.equal(card.output.cpu(), cpu.output):
        fail(f"12 {tag}: the card's output differs from the CPU's")
    for f in fields:
        if getattr(card, f) != getattr(cpu, f):
            fail(f"12 {tag}: {f} differs between the card and the CPU: "
                 f"{getattr(card, f)} vs {getattr(cpu, f)}")


def _gen_timed(dev, fn):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


SIM_FIELDS = ("fills", "mem_reads", "link_transfers", "cycles")
RTL_FIELDS = SIM_FIELDS + ("pipeline_depth", "checks", "hw")


def _gen_dataflow(tag, adg, dag, df_name, dev, seed, *, cpu_sim=True):
    """One dataflow through the oracle, funcsim and the netlist simulator
    on the card and on the CPU: every output equal to the card's oracle,
    and every output, counter, check and hw record equal to the CPU's."""
    import numpy as np
    import torch

    from repro_torch.core.funcsim import oracle, simulate
    from repro_torch.core.rtlsim import simulate_rtl
    spec = adg.spec(df_name)
    wl, df = spec.workload, spec.dataflow
    r = np.random.default_rng(seed)
    host = {t.name: torch.from_numpy(
        r.integers(-4, 5, size=wl.tensor_shape(t, df.sizes()))
        .astype(np.float64)) for t in wl.inputs}
    card = {k: v.to(dev) for k, v in host.items()}
    cpu = torch.device("cpu")
    ref, t_or = _gen_timed(dev, lambda: oracle(wl, df.sizes(), card))
    sim, t_sim = _gen_timed(dev, lambda: simulate(adg, df_name, card))
    rtl, t_rtl = _gen_timed(dev, lambda: simulate_rtl(dag, adg, df_name,
                                                       card))
    for what, res in (("funcsim", sim), ("netlist", rtl)):
        if not torch.equal(res.output, ref):
            fail(f"12 {tag} {df_name}: {what} on the card != the card's "
                 f"oracle")
    c_ref, c_or = _gen_timed(cpu, lambda: oracle(wl, df.sizes(), host))
    if not torch.equal(ref.cpu(), c_ref):
        fail(f"12 {tag} {df_name}: the card's oracle != the CPU's")
    c_rtl, c_t_rtl = _gen_timed(cpu, lambda: simulate_rtl(dag, adg, df_name,
                                                           host))
    _gen_same(f"{tag} {df_name} netlist", rtl, c_rtl, RTL_FIELDS)
    if cpu_sim:
        c_sim, c_t_sim = _gen_timed(cpu, lambda: simulate(adg, df_name, host))
        _gen_same(f"{tag} {df_name} funcsim", sim, c_sim, SIM_FIELDS)
        cpu_sim_s = f"{c_t_sim:.3f}"
    else:
        cpu_sim_s = "skipped at this size"
    if (sim.fills, sim.mem_reads, sim.link_transfers) != \
            (rtl.fills, rtl.mem_reads, rtl.link_transfers):
        fail(f"12 {tag} {df_name}: funcsim's counters != the netlist's")
    log(f"  12 {tag} {df_name}: T = {df.total_cycles}, {df.n_fus} FUs, "
        f"{rtl.cycles} wall cycles, {len(rtl.checks['fifos'])} FIFOs, "
        f"{rtl.checks['joins_checked']} joins; bit-exact; card s / CPU s: "
        f"oracle {t_or:.3f} / {c_or:.3f}, funcsim {t_sim:.3f} / "
        f"{cpu_sim_s}, netlist {t_rtl:.3f} / {c_t_rtl:.3f}")


def _gen_attention(adg, dag, dev) -> None:
    """The staged Attention design, P = S and P = softmax(S) at the
    handover, on the card and on the CPU."""
    import numpy as np
    import torch

    from repro_torch.core.funcsim import simulate_stages, staged_oracle
    from repro_torch.core.rtlsim import simulate_rtl_stages
    stages, resident = ["attn-qk", "attn-pv"], {"S": "P"}
    r = np.random.default_rng(12)
    host = {}
    for dfn, names in (("attn-qk", ("Q", "K")), ("attn-pv", ("V",))):
        spec = adg.spec(dfn)
        for n in names:
            shape = spec.workload.tensor_shape(spec.workload.tensor(n),
                                               spec.dataflow.sizes())
            host[n] = torch.from_numpy(
                r.integers(-4, 5, size=shape).astype(np.float64))
    card = {k: v.to(dev) for k, v in host.items()}

    def softmax(s):
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        return e / e.sum(dim=-1, keepdim=True)

    for label, ppu in (("P = S", None), ("P = softmax(S)", softmax)):
        kw = dict(resident=resident, ppu=ppu)
        refs, t_or = _gen_timed(dev, lambda: staged_oracle(
            adg, stages, card, **kw))
        sims, t_sim = _gen_timed(dev, lambda: simulate_stages(
            adg, stages, card, **kw))
        rtls, t_rtl = _gen_timed(dev, lambda: simulate_rtl_stages(
            dag, adg, stages, card, **kw))
        c_rtls = simulate_rtl_stages(dag, adg, stages, host, **kw)
        c_sims = simulate_stages(adg, stages, host, **kw)
        for k, (o, s, x, cs, cx) in enumerate(zip(refs, sims, rtls, c_sims,
                                                  c_rtls)):
            if not (torch.equal(s.output, o) and torch.equal(x.output, o)):
                fail(f"12 Attention {label} stage {k}: funcsim or netlist "
                     f"on the card != the card's staged oracle")
            if ppu is not None and k == 1:
                got, want = x.output.cpu(), cx.output
                rel = float(((got - want).abs()
                             / want.abs().clamp_min(1e-300)).max())
                if rel > GEN_SOFTMAX_RTOL:
                    fail(f"12 Attention softmax stage: card vs CPU {rel:.3e}"
                         f" > {GEN_SOFTMAX_RTOL}")
                for f in RTL_FIELDS:
                    if getattr(x, f) != getattr(cx, f):
                        fail(f"12 Attention softmax stage: {f} differs")
            else:
                _gen_same(f"Attention {label} stage {k} netlist", x, cx,
                          RTL_FIELDS)
                _gen_same(f"Attention {label} stage {k} funcsim", s, cs,
                          SIM_FIELDS)
        log(f"  12 Attention {label}: two stages bit-exact against the "
            f"card's staged oracle; card s: oracle {t_or:.3f}, funcsim "
            f"{t_sim:.3f}, netlist {t_rtl:.3f}")


def _gen_repair(dev) -> None:
    """The FIFO word repaired in the port (a FIFO feeding a FIFO) and a
    corrupted delay matching, on the card."""
    import numpy as np
    import torch

    from repro_torch.core import workload as W
    from repro_torch.core.adg import generate_adg
    from repro_torch.core.dag import codegen
    from repro_torch.core.dataflow import build_dataflow
    from repro_torch.core.funcsim import oracle
    from repro_torch.core.passes import delay_matching, run_backend
    from repro_torch.core.rtlsim import RTLTimingError, simulate_rtl

    def inputs(wl, df):
        r = np.random.default_rng(0)
        return {t.name: torch.from_numpy(
            r.integers(-4, 5, size=wl.tensor_shape(t, df.sizes()))
            .astype(np.float64)).to(dev) for t in wl.inputs}

    wl = W.conv2d()
    df = build_dataflow(wl, spatial=[("ow", 2), ("oh", 2)],
                        temporal=[("n", 1), ("ow", 1), ("oh", 1), ("oc", 2),
                                  ("ic", 1), ("kh", 3), ("kw", 3)],
                        c=(0, 0), name="conv-h")
    adg = generate_adg([(wl, df)], name="t")
    dag = codegen(adg)
    run_backend(dag)
    x = inputs(wl, df)
    res = simulate_rtl(dag, adg, df.name, x)
    fifos = res.checks["fifos"]
    if not torch.equal(res.output, oracle(wl, df.sizes(), x)) or \
            any(f["programmed"] != f["delay"] for f in fifos.values()):
        fail("12 repair: the conv-h example is not bit-exact on the card")
    wl = W.gemm()
    df = build_dataflow(wl, spatial=[("k", 4), ("j", 4)],
                        temporal=[("i", 2), ("j", 2), ("k", 2), ("i", 4)],
                        c=(1, 1), name="gemm-jk")
    adg = generate_adg([(wl, df)], name="t")
    dag = codegen(adg)
    delay_matching(dag)
    next(e for e in dag.edges if e.el > 0).el += 1
    try:
        simulate_rtl(dag, adg, df.name, inputs(wl, df))
    except RTLTimingError as e:
        log(f"  12 repair: conv-h (p=2, kh=3, ic=1) bit-exact on the card, "
            f"{len(fifos)} FIFO words == their required delays; a corrupted "
            f"delay matching raises: {e}")
    else:
        fail("12: a corrupted delay matching was not caught")


def _generator(dev, smi: str, t_start: float) -> None:
    """Phase 12: the four fused 256-FU designs built on the host, every
    dataflow simulated on the card and held to the card's oracle and to
    the CPU, the long conv run, the FIFO-word repair."""
    import gc

    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    log(f"phase 12 the LEGO generator [{smi}]")
    built = {name: _gen_build(name, _gen_recipe(name))
             for name in GEN_DESIGNS}
    for seed, (name, (adg, dag)) in enumerate(built.items()):
        if name == "Attention":
            _gen_attention(adg, dag, dev)
            continue
        for df_name in adg.dataflow_names:
            _gen_dataflow(name, adg, dag, df_name, dev, seed)
    # the long run: conv-icoc at oh = ow = 56
    adg, dag = _gen_build(f"Conv2d-MNICOC oh=ow={GEN_LONG_OHOW}",
                          _gen_recipe("Conv2d-MNICOC", GEN_LONG_OHOW))
    del built
    gc.collect()
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    _gen_dataflow(f"Conv2d-MNICOC oh=ow={GEN_LONG_OHOW}", adg, dag,
                  "conv-icoc", dev, 7, cpu_sim=False)
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB"
            if on_card else "not measured")
    log(f"  12 long run: peak device memory {peak}; funcsim skipped on the "
        f"CPU at this size")
    _gen_repair(dev)
    log(f"phase 12 done in {time.perf_counter() - t_phase:.1f}s "
        f"(script at {time.perf_counter() - t_start:.1f}s) [{smi}]")


# ---------------------------------------------------------------------------
# phase 13: the two front doors on the card
# ---------------------------------------------------------------------------

# the wall times a front door prints (generation, Verilog, the sweep)
_WALL_S = r"(generation time: |\) in |configs in )[0-9.]+s"


def _front_run(main, argv, cwd: Path, phase="13") -> tuple[str, float]:
    """A front door's ``main(argv)`` run in-process from ``cwd``: its
    standard output and its seconds.  The metrics registry starts empty,
    as in a process of its own."""
    import contextlib
    import io
    import os

    from repro_torch.obs import METRICS
    cwd.mkdir(parents=True, exist_ok=True)
    here, buf = os.getcwd(), io.StringIO()
    METRICS.reset()
    t0 = time.perf_counter()
    try:
        os.chdir(cwd)
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    finally:
        os.chdir(here)
    if rc != 0:
        fail(f"{phase}: {' '.join(argv)} returned {rc}\n"
             f"{buf.getvalue()[-2000:]}")
    return buf.getvalue(), time.perf_counter() - t0


class _Counterpart:
    """The same front door on the CPU (or with the NumPy engine) in a
    process of its own, CUDA hidden, started at once so that it runs
    beside the card's run; a thread notes when it ends."""

    def __init__(self, module: str, argv: list, cwd: Path, phase="13"):
        import os
        import threading
        cwd.mkdir(parents=True, exist_ok=True)
        self.argv, self.phase = argv, phase
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module, *argv], cwd=cwd,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                     CUDA_VISIBLE_DEVICES=""),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.out = self.err = ""
        self.seconds = None
        self.thread = threading.Thread(target=self._wait, daemon=True)
        self.thread.start()

    def _wait(self) -> None:
        self.out, self.err = self.proc.communicate()
        self.seconds = time.perf_counter() - self.t0

    def result(self) -> tuple[str, float]:
        self.thread.join(timeout=600)
        if self.proc.returncode != 0:
            fail(f"{self.phase}: {' '.join(self.argv)} on the CPU returned "
                 f"{self.proc.returncode}\n{self.err[-2000:]}"
                 f"\n{self.out[-2000:]}")
        return self.out, self.seconds

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _front_same(what, a: str, b: str) -> None:
    import re
    if re.sub(_WALL_S, r"\1<t>s", a) != re.sub(_WALL_S, r"\1<t>s", b):
        fail(f"13 {what}: the card's output differs from its counterpart's"
             f"\n{a[-1500:]}\n---\n{b[-1500:]}")


def _sweep_payload(path: Path) -> dict:
    """A sweep's JSON without its walls, provenance, engine, device and the
    engine micro-benchmark the torch engine implies, with the candidates
    its batch enumerated taken out of the metrics (what differs between
    the two engines' runs by design), and without what ``--emit-dir``
    adds: the netlists' paths and the back end's metrics."""
    d = json.loads(path.read_text())
    for k in ("wall_s", "provenance", "artifacts"):
        d.pop(k, None)
    for k in ("total_wall_s", "engine", "device"):
        d["meta"].pop(k, None)
    bench = d["meta"].pop("engine_bench", None)
    if bench is not None:
        d["metrics"]["counters"]["mapper.candidates_enumerated"] -= \
            bench["candidates"]
    for e in d["frontier"] + d["designs"]:
        e.pop("rtl", None)
    for part in d["metrics"].values():
        for k in [k for k in part if k.startswith("backend.")]:
            del part[k]
    return d


def _front_doors(dev, smi: str, t_start: float) -> None:
    """Phase 13: ``python -m repro_torch.generate_accelerator`` in its three
    modes and the design search's CLI, each on the card (in this process)
    and held to the same command on the CPU (the generator) or with the
    NumPy engine (the CLI), each counterpart a process of its own started
    with the phase and run alongside."""
    import gc
    import shutil
    import tempfile

    import torch

    from repro_torch import generate_accelerator as GA
    from repro_torch.dse import batch_sweep as B

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    log(f"phase 13 the front doors [{smi}]")
    scratch = ROOT / ".chipscratch"
    scratch.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="front_", dir=scratch))
    card = ["--device", str(dev)]
    modes = (("MobileNetV2 on LEGO-MNICOC",
              ["--net", "MobileNetV2", "--emit-rtl", "o.v"], ["o.v"]),
             ("llama4_scout_17b_a16e seq 512 (attention_fused)",
              ["--model", "llama4_scout_17b_a16e", "--seq", "512"], []),
             ("rwkv6_7b (switch) with the VCD",
              ["--model", "rwkv6_7b", "--vcd", "w.vcd"], ["w.vcd"]))
    quick = ["--models", "all", "--quick", "-q", "--out", "m.json"]
    sweep = ["--space", "tiny", "--nets", "MobileNetV2", "-q", "--out",
             "s.json"]
    ga, cli = "repro_torch.generate_accelerator", "repro_torch.dse.batch_sweep"
    others = []
    try:
        # every counterpart starts now, on the CPU beside the card's runs
        others = [_Counterpart(ga, argv + ["--device", "cpu"],
                               work / f"ga{i}" / "cpu")
                  for i, (_, argv, _) in enumerate(modes)]
        others.append(_Counterpart(cli, quick + ["--engine", "numpy"],
                                   work / "models_numpy"))
        others.append(_Counterpart(cli, sweep + ["--engine", "numpy"],
                                   work / "sweep_numpy"))

        # 13a. generate_accelerator: the paper's design, a model on the
        # fused attention class, a model on the switch class with its VCD
        for i, (label, argv, files) in enumerate(modes):
            got, t_card = _front_run(GA.main, argv + card,
                                     work / f"ga{i}" / "card")
            want, t_cpu = others[i].result()
            _front_same(f"generate_accelerator {label}", got, want)
            for f in files:
                if (work / f"ga{i}" / "card" / f).read_bytes() != \
                        (work / f"ga{i}" / "cpu" / f).read_bytes():
                    fail(f"13 generate_accelerator {label}: {f} differs "
                         "between the card and the CPU")
            if i == 1 and "QK + PV bit-exact" not in got:
                fail("13: the two-stage netlist check did not run")
            size = ", ".join(
                f"{f} {(work / f'ga{i}' / 'card' / f).stat().st_size} bytes"
                for f in files)
            log(f"  13a generate_accelerator {label}: card {t_card:.1f} s, "
                f"CPU {t_cpu:.1f} s (a process of its own, alongside); "
                f"stdout (wall times masked)"
                f"{' and ' + size if files else ''} identical")
            for line in got.splitlines()[-3:]:
                log(f"     {line}")

        # 13b. the cross-model study, torch engine on the card against
        # the NumPy engine
        got, t_card = _front_run(B.main, quick + card, work / "models_card")
        want, t_np = others[3].result()
        _front_same("--models all --quick", got, want)
        if _sweep_payload(work / "models_card" / "m.json") != \
                _sweep_payload(work / "models_numpy" / "m.json"):
            fail("13b: BENCH_models.json differs between the engines")
        log(f"  13b --models all --quick: torch engine on the card "
            f"{t_card:.1f} s, NumPy engine {t_np:.1f} s (a process of its "
            f"own); stdout and BENCH_models.json identical (walls and "
            f"provenance aside)")
        for line in got.splitlines():
            if line.startswith("== cross-model winner"):
                log(f"     {line}")
        bench = json.loads((work / "models_card" / "m.json").read_text())[
            "meta"]["engine_bench"]
        log(f"     engine_bench ({bench['candidates']} candidates): "
            f"numpy warm {bench['engines']['numpy']['warm_ms']:.3f} ms, "
            f"torch on the card cold "
            f"{bench['engines']['torch']['cold_ms']:.3f} ms, warm "
            f"{bench['engines']['torch']['warm_ms']:.3f} ms")

        # 13c. a sweep with a CNN and the frontier's Verilog, whose JSON
        # feeds generate_accelerator --dse
        got, t_card = _front_run(B.main, sweep + ["--emit-dir", "rtl"]
                                 + card, work / "sweep_card")
        want, t_np = others[4].result()
        if _sweep_payload(work / "sweep_card" / "s.json") != \
                _sweep_payload(work / "sweep_numpy" / "s.json"):
            fail("13c: the sweep's JSON differs between the engines")
        rtl = json.loads((work / "sweep_card" / "s.json").read_text())[
            "artifacts"]
        for path in rtl.values():
            text = (work / "sweep_card" / path).read_text()
            if not text.startswith("// generated by") or "pipe(" in text:
                fail(f"13c: {path} is not the emitted Verilog")
        js = str(work / "sweep_card" / "s.json")
        pick = ["--dse", js, "--pick", "edp"]
        g2, t_card2 = _front_run(GA.main, pick + card, work / "pick_card")
        w2, t_cpu2 = _front_run(GA.main, pick + ["--device", "cpu"],
                                work / "pick_cpu")
        _front_same("--dse pick", g2, w2)
        log(f"  13c sweep tiny + MobileNetV2 --emit-dir ({len(rtl)} "
            f"netlists: {', '.join(sorted(rtl))}): torch engine on the card "
            f"{t_card:.1f} s, NumPy engine {t_np:.1f} s, JSON identical; "
            f"generate_accelerator --dse --pick edp: card {t_card2:.1f} s, "
            f"CPU {t_cpu2:.1f} s, stdout identical")
        log(f"     {g2.splitlines()[0]}")
    finally:
        for o in others:
            o.stop()
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 13 done in {time.perf_counter() - t_phase:.1f}s "
        f"(script at {time.perf_counter() - t_start:.1f}s) [{smi}]")


# ---------------------------------------------------------------------------
# phase 14: the paper's evaluation on the card
# ---------------------------------------------------------------------------

# the fields of the paper_figures rows that time something; every other
# field must be the same string on the card and on the CPU ("speedup"
# times something only in the micro rows)
_PAPER_TIMING = ("gen_time_s", "unmemoized_us", "memoized_us", "scalar_us",
                 "batched_us", "gflops")
PAPER_ROWS = 46        # benchmarks/run.py's rows, whole


def _paper_rows(what: str, text: str) -> list[tuple[str, int, list, str]]:
    """``(name, us_per_call, fields with the timings masked, derived)`` of
    each row of a ``paper_figures`` run's standard output."""
    lines = text.splitlines()
    if not lines or lines[0] != "name,us_per_call,derived":
        fail(f"14 {what}: no CSV header\n{text[-1500:]}")
    out = []
    for line in lines[1:]:
        name, us, derived = line.split(",", 2)
        if "ERROR=" in derived:
            fail(f"14 {what}: {line}")
        fields = [f"{f.split('=', 1)[0]}=<t>"
                  if f.split("=", 1)[0] in _PAPER_TIMING
                  or (f.startswith("speedup=") and name.startswith("micro."))
                  else f for f in derived.split(";")]
        out.append((name, int(us), fields, derived))
    return out


def _paper_figures(dev, smi: str, t_start: float) -> None:
    """Phase 14: ``python -m repro_torch.paper_figures``, whole, on the
    card (in this process, the kernels' counters reset before and read
    after: K1 launched 11 times, by ``kernel_micro``, and nothing else)
    and with ``--device cpu`` in a process of its own started alongside:
    every row's name and every field that is not a timing equal; each
    row's seconds logged card / CPU; K1's 512 x 512 fp32 product with the
    row's inputs held to its plain version."""
    import gc
    import shutil
    import tempfile

    import torch

    from repro_torch import paper_figures as PF
    from repro_torch.kernels import ops

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    log(f"phase 14 the paper's evaluation [{smi}]")
    scratch = ROOT / ".chipscratch"
    scratch.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="paper_", dir=scratch))
    cpu = None
    try:
        cpu = _Counterpart("repro_torch.paper_figures", ["--device", "cpu"],
                           work / "cpu", phase="14")
        for fn, name in ops.COUNTERS:
            setattr(fn, name, 0)
        got, t_card = _front_run(PF.main, ["--device", str(dev)],
                                 work / "card", phase="14")
        torch.cuda.synchronize()
        counts = dict(zip((f"{fn.__name__}.{name}"
                           for fn, name in ops.COUNTERS),
                          ops.launch_counts()))
        want_counts = {k: 0 for k in counts}
        want_counts["gemm_cuda.launches"] = 11
        if counts != want_counts:
            fail(f"14: kernel launches over the card's run {counts}, want "
                 f"{want_counts} (K1 in kernel_micro: 1 warm-up + 10)")
        want, t_cpu = cpu.result()
        card_rows = _paper_rows("card", got)
        cpu_rows = _paper_rows("CPU", want)
        if len(card_rows) != PAPER_ROWS:
            fail(f"14: {len(card_rows)} rows on the card, want "
                 f"{PAPER_ROWS}")
        for (n1, us1, f1, d1), (n2, us2, f2, _) in zip(card_rows, cpu_rows):
            if (n1, f1) != (n2, f2):
                fail(f"14: row {n1} on the card {';'.join(f1)} differs "
                     f"from the CPU's {n2} {';'.join(f2)}")
            log(f"  14 {n1}: {us1} / {us2} us (card / CPU); card {d1}")
        if len(cpu_rows) != len(card_rows):
            fail(f"14: {len(cpu_rows)} rows on the CPU, "
                 f"{len(card_rows)} on the card")
        log(f"  14 paper_figures: card {t_card:.1f} s (this process), CPU "
            f"{t_cpu:.1f} s (a process of its own, alongside); "
            f"{len(card_rows)} rows, every field but the timings equal; K1 "
            f"launched {counts['gemm_cuda.launches']} times, nothing else")

        # K1 at the row's shape and inputs against its plain version
        gen = torch.Generator().manual_seed(0)
        a = torch.randn(512, 512, generator=gen).to(dev)
        b = torch.randn(512, 512, generator=gen).to(dev)
        check_gemm("14 K1 512x512 fp32 (kernel_micro's inputs)",
                   ops.gemm(a, b), a, b)
    finally:
        if cpu is not None:
            cpu.stop()
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 14 done in {time.perf_counter() - t_phase:.1f}s "
        f"(script at {time.perf_counter() - t_start:.1f}s) [{smi}]")


if __name__ == "__main__":
    sys.exit(main())
