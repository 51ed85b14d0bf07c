"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (each prints its own lines and its wall time; any failure exits
non-zero and no phase carries on past its own failure):

  1. build    build the nine CUDA sources of the ported kernels from the
              repo, one nvcc each, started together; print their ptxas
              reports and the card (name and power limit, from nvidia-smi);
  2. kernel   the fused activation scorer (score_activation) against its
              plain version over the same packed buffer, on the card and on
              the CPU, over n 1..256, n_u 9/25/30/40, every one of the 39
              flag combinations (S resident-weighted, accelerator-only or
              missing_bytes), tasks without reads or accesses, masks 0
              and host-only masks: every output must be exactly equal
              (torch.equal); then the same with x_bias columns at +inf (a
              detached resource) and finite notice penalties, as HEFT's
              pressure fold gives them on a machine that lost resources,
              equal too (+inf where it belongs, no NaN). Then, at the main path's widest activation
              (n 128, LU NT 64, DADA+CP's call): ms per score_matrices call
              from Python (copies and sync included, card and CPU), the
              kernel's ms and its device ms from a CUDA-graph replay on
              pre-staged buffers, the plain version's ms and the bound.
              Then the standalone transfer-matrix kernel against its plain
              versions on seeded inputs (n_pad 8..256, r_pad 1..4, n_u
              9/25/30, with empty masks, host-only masks and padded reads),
              exactly equal, and its times at the widest shape;
  3. place    the placement kernels (dada_place: DADA's λ search as a
              speculative midpoint tree over one block's warps;
              heft_select: HEFT's EFT scan from staged shared memory)
              against their plain versions on seeded packed activations
              (tests/_place_cases.py, shared with the card tests): n 1 / 3 /
              37 / 128 / 256 on CPU+GPU, GPU-only and CPU-only machines
              (2..130 resources), α 0 / 0.5 / 1, ±CP, ±area bound,
              max_iters 1 and 30, values on a 1/8 grid (ties), empty
              affinity rows, finish times a few ulps apart (HEFT's 1e-15
              rule); searches cut short inside a tree round (max_iters 2..7,
              the stopping rule between levels); DADA at n 1 000..8 000
              (every staging level, shallower trees) and HEFT's ring (n
              4 000 at 440 resources, 512 resources); and liveness cases
              (tests/_place_cases.py live_case / live_heft_case): a dead
              rid 0, every GPU or every CPU dead but one, noticed columns
              under recover with their penalties, a dead and a noticed
              one, ±CP, ±area bound; +inf transfer columns and notice
              penalties through HEFT: every placement
              buffer must be equal bit for bit (torch.equal), λ and the
              finish times ==. The launchers' plans (tree depth, staging,
              ring, with and without the liveness inputs) must equal
              PlaceSpec.plan; prints d and the ptxas
              registers, shared memory and spills of sched_place.cu. Then
              at n 8 / 32 / 128 / 512 of LU NT 64 on paper_machine(8) (n 128
              is the main path's widest activation): each kernel's ms per
              launch, device ms from a CUDA-graph replay, d, probes and
              rounds, the plain version's ms on the host, a whole
              place_dada / place_heft call (card and CPU), the bound and the
              length of the dependent chain; then both again at n 128 with
              one GPU detached and one noticed (DADA with recover: the
              liveness inputs; HEFT: +inf and the penalty in x_bias);
              then DADA(0.5) and DADA(0.5)+CP under the missing_bytes
              affinity (S from the reads by the scorer's s_missing flag)
              over Cholesky, LU and QR at NT 16 on paper_machine(8), the
              kernels' counts set to 0 just before each card run and read
              just after: each equal to its device="cpu" twin, one
              score_activation and one dada_place launch per placed
              activation, no plain search;
  4. main     HEFT and DADA(0.5)+CP on the paper machine with 8 GPUs over
              the Cholesky, LU and QR tile DAGs at NT 16 (tile 512, the
              paper's shape) and NT 64 (the reference's scaling size), every
              activation scored and placed on the card (min_wide=1), plus
              one NT 64 Cholesky run per strategy at min_wide=32. Each run's
              (makespan, bytes, transfers, busy, intervals) must equal the
              port's own device="cpu" run, every task must run once, every
              activation placed on the card must be exactly one fused
              scoring launch and one placement launch (the standalone
              transfer kernel none), and the plain searches must run only
              for the activations narrower than min_wide; prints wall s
              beside PR 18's, the ms per placed activation on the card and
              the CPU, and the full garbage collections (count, seconds)
              inside each timed run (beside PR 25's walls too);
  5. gemm     the gemm_update kernel against its plain version on the card
              and on the CPU, over shapes (64,64,64) .. (1024,512,1024) x
              {f32, bf16} x alpha {-1, 1, 0.5} x trans_b, at the reference's
              TOL (atol TOL*sqrt(k), rtol TOL; 2e-4 f32, 5e-2 bf16), with
              TF32 off, launches_split moving as each plan splits k or not;
              matmul likewise; split plans whose last split is one stage or
              ragged (GEMM_SPLIT_EDGES); views misaligned by one element with
              an odd row stride must give their contiguous copies' bits; two
              calls and a CUDA-graph replay must give equal bits; a
              non-tiling shape, an f64 CUDA tensor and mixed types must raise
              and launch nothing; then its plan and time at the linalg
              path's three shapes beside the plain version, torch.addmm
              (torch.mm for matmul) and the bound, and its ptxas
              registers, spills and shared memory;
  6. linalg   tile Cholesky, LU and QR of an 8192^2 f32 matrix (tile 512,
              NT 16) on the card: HEFT and DADA(0.5)+CP schedule the DAG on
              paper_machine(8) (scores on the card, fused launches), execute_graph runs it
              in program order and execute_schedule replays each schedule.
              Each replay must equal program order exactly, the residual
              must be within tests/test_linalg.py's bound, and gemm_update
              must launch once per GEMM-shaped task (680 / 1 240 / 1 360);
              then execute_graph at NT 4 on the card against the CPU; then
              an NT 16 execution per factorization under torch.profiler
              (twice; the second is read): device busy time, idle share and
              gemm_update's share;
  7. attention  flash_attention and flash_decode against their plain
              versions on the card and on the CPU: tests/test_kernels.py's
              sweeps at its tolerances, ragged lengths, and the serving
              path's shapes (chatglm3-6b: 32 query heads, 2 KV heads, hd
              128, bf16), printing the route each case took (tensor-core
              "tc" / split-KV "split", or "simt") and checking it against
              the counters; MLA's widths, a value head dim of its own
              ((dk, dv) = (96, 64) at 40 heads, and (48, 32)) in f32 and
              bf16, so on every route; unaligned views take the SIMT
              routes; refusals; then their times at those shapes (and
              decode at a decode_32k-like shape: B 16, S 32 768; and
              minicpm3-4b's prefill B 4 x 2048 and serving step) beside
              the plain version, the bound and
              scaled_dot_product_attention; the MoE models' widths (grok-1:
              48 query heads over 8 KV heads; kimi-k2: 64 over 8; hd 128)
              at the serving shapes on the "tc" and "split" routes;
  8. serve    chatglm3-6b at full width and depth (6.24e9 random bf16
              parameters from a seeded generator) on the card: prefill of
              4 x 2048 tokens through make_prefill_step; then
              prefill_into_cache on a 64-token prompt and 32 greedy decode
              steps. The two paths' last-position logits on that prompt must
              agree within SERVE_LOGIT_TOL, every logit must be finite, and
              each kernel must launch 28 times per forward, all on its
              tensor-core route (flash_attention "tc", flash_decode
              "split"). Prints tokens/s
              and a profile of one prefill and one decode step. Then the
              smoke configs served on the card against the CPU at f32;
  8b. mla     the same for minicpm3-4b (Multi-head Latent Attention: 62
              layers, d 2560, 40 heads, q/k head dim 96, v 64; 4.26e9
              random bf16 parameters, seed 0), the counts set to 0 just
              before its main path and read just after: 62 flash_attention
              launches per prefill forward, all "tc", and 62 flash_decode
              launches per decode forward, all "split"; the two paths'
              logits within SERVE_LOGIT_TOL; prints prefill tokens/s, ms a
              decode step and peak device memory; then its smoke config on
              the card against the CPU at f32;
  8c. moe     the MoE transformers at full width with the depth cut, as
              one card holds them: grok-1-314b at 4 of its 64 layers
              (d 6144, 48 / 8 heads, 8 experts top-2, expert ff 32 768;
              2.13e10 random bf16 parameters) and kimi-k2-1t-a32b at 1 of
              its 61 (d 7168, 64 / 8 heads, 384 experts top-8, expert ff
              2 048; 1.94e10), each as the serve phase runs chatglm3-6b
              (4 x 2048 prefill twice, a 64-token prompt through the cache,
              32 greedy steps; every prefill layer on "tc", every decode
              layer on "split"), one freed before the next is made. The
              timed runs use the config's capacity factor (1.25) and a
              third prefill prints the assignments it drops; the two
              paths' logits are compared at the factor that drops nothing
              (E / K), within MOE_LOGIT_TOL, with the tokens whose top-k
              set differs between the paths printed. An expert_perm from
              plan_expert_placement (4 groups) with the expert weights
              moved to their new slots must give equal logits
              (torch.equal), prefill and a decode step. Prints parameters,
              peak memory, tokens/s, ms a step beside their bounds, and a
              profile of one prefill and one decode step split into the
              expert products, the router, dispatch and combine, attention
              and idle time; then the smoke config on the card against
              the CPU at f32;
  8d. hybrid  the scan kernel (csrc/selective_scan.cu: one thread a
              channel, its 16 states in registers, a warp's own ring of
              cp.async-staged runs) against its plain versions on the
              card. The f32 instantiation (selective_scan) at
              tests/_scan_cases.py's SCAN_CASES: jamba's prefill (B 4, S
              2048, din 8 192, N 16, h0 zeros) and decode step (S 1, a
              normal h0), odd S and channels no multiple of a warp; y and
              hT each within SCAN_TOL of their largest magnitude. The fused
              Mamba scan (mamba_scan: softplus, A, the scan, the skip and
              the gate) against mamba_scan_plain at FUSED_CASES, f32 and
              bf16, prefill and decode (the state written in place), on
              mamba_apply's strided z and proj views: g at f32 and the
              state within SCAN_TOL, g at bf16 within MAMBA_SCAN_BF16_TOL
              and, element by element, within g_bf16_limit with at most
              G_BF16_SHARE not bit-equal (tests/_scan_cases.py), the skip
              left out (a planted fault) breaking that limit; two calls
              equal, refusals launching nothing. One Mamba layer at
              jamba's widths under the profiler: around its projections
              and conv, one mamba_scan_kernel launch and nothing else. Then
              jamba-v0.1-52b at full width and 16 of its 32 layers (14
              Mamba and 2 attention layers, 8 MoE and 8 dense MLPs; 2.6e10
              random bf16 parameters, seed 0) as the moe phase serves
              grok-1, the counts set to 0 just before its main path and
              read just after: 14 mamba_scan launches a forward (none of
              selective_scan), no softplus kernel in the profile, 2
              flash_attention ("tc") a prefill and 2 flash_decode
              ("split") a decode step. The prefill-against-cache check
              fills the first 63 prompt tokens and runs the 64th as the
              compared step (a Mamba state advances, it is not
              rewritten), every expert routed, within HYBRID_LOGIT_TOL;
              the timed greedy steps start from a cache that the whole
              prompt filled at the config's own top-2; the relabelling check moves the experts of the MoE layers
              only and restores the Mamba states between its two steps.
              Prints parameters (the config's count plus the routers and
              din (N + 2) a Mamba layer), peak memory, tokens/s and ms a
              step beside their bounds, drops at capacity factor 1.25, a
              profile split into Mamba (the scan apart, summed by kernel
              name), MoE, attention, other and idle; then the smoke config on the card against
              the CPU at f32, and both instantiations' ms, device ms,
              plain ms and bound (scan_bound: bytes, or FMA-pipe and
              special-function operations with the exponentials split to
              balance the two pipes) at the prefill and decode
              shapes;
  9. profile  one NT 16 Cholesky simulation per strategy under
              torch.profiler (twice with one strategy object; the second is
              read): device busy time against wall time, each placement
              kernel's device time summed over the run, and per placed
              activation the kernel launches (must be 2) and memcpy calls
              (must be 2), with no other kernel, memcpy or memset on the
              card;
 10. episode  the surrogate episode scan (episode_scan: one warp a
              configuration, the whole list-scheduling scan in one launch,
              reading the plan's selection order) against its plain
              version, on the card and on the CPU, every output and every
              schedule column equal (torch.equal) on the CPU tests' cases
              (tests/_episode_cases.py: capacities where eviction binds,
              the chain that needs all eight LRU rounds, a graph of
              assorted sizes, a wide graph whose every selection ties,
              pad_to and extra_steps), seeded batches over Cholesky, LU and
              QR at NT 4 / 8 / 16 on paper_machine(1..8) with the five
              figure specs, capacities of 8 and 32 MiB, a padded NT 16
              batch, and priorities cut to three values with some -inf (the
              plan's tables must then be refused, and the kernel reads
              tables derived from those priorities). The launcher's plan
              (configurations a block, shared bytes) must equal
              launch_plan's. Then the
              paper-figure sweep at full width through run_batch (the main
              path, its launch count read from 0): Cholesky, LU and QR at NT
              16, tile 512, paper_machine(1..8) x five specs x 30 seeds,
              1 200 configurations a graph, one launch each; every
              configuration must place every task and equal the CPU's
              run_batch; prints wall s, configs/s and tasks/s beside the
              CPU's, per-spec means at 8 GPUs, the order's build ms, the
              kernel's ms (CUDA events around three launches back to back
              of the kernel alone: the wrapper's argument checks left out,
              the plan's tables built with the plan), the plain version's
              ms on the card and the bound (the operations of the real
              reads, writes and successors at the f32 instruction rate,
              selection not counted since the order is an input; beside it
              the bound with a heap's 2 log2 n_pad a task and configuration
              for the ready set, the definition used before the order was
              an input). Then NT 32 rows for the three graphs and an NT 64
              Cholesky row, 132 configurations each, with the order's
              build ms, wall s and the kernel's ms;
 11. paper    the paper's experiment through repro_torch.bench, each
              engine's figure sweeps driven with the kernels' counts set to
              0 just before and read just after: fig1-fig4 (Cholesky, LU,
              QR at NT 16, tile 512) on the exact engine at the reference's
              fast depth (3 seeds x 2 / 4 / 8 GPUs; one scoring and one
              placement launch per placed activation, the ws rows on the
              host with steals), then on the surrogate at the paper's (30
              seeds x 1..8 GPUs: 6 000 configurations, one episode_scan
              launch per figure); C1-C6 on both (validate: C6 through
              run_many on the card), every claim must pass; fig2's
              summaries at 3 seeds on each engine must equal
              device="cpu" field for field (both timed).
              Prints every row, the claim tables, wall s per figure,
              runs/s and configs/s, and a paper JSON line;
 12. verify   the audit log and the independent verifier
              (repro_torch.verify) over the main path, the kernels' counts
              set to 0 just before and read just after: HEFT, DADA(0.5)+CP
              and ws over the Cholesky, LU and QR tile DAGs at NT 16 (tile
              512) on paper_machine(8), every activation scored and placed
              on the card, with audit=True. Each log must verify with 0
              errors, equal the port's own device="cpu" run's log record for
              record, and the result must equal the audit-off run's; the
              card's logs are written under build/verify/ and
              ``python -m repro_torch.verify schedule`` must pass them. Then
              64 surrogate configurations a graph (2 / 4 / 6 / 8 GPUs x heft
              and dada?alpha=0.5&use_cp=1 x 8 seeds) through one
              episode_scan launch with the schedule emitted, each turned
              into an audit log by episode_audit_logs: 0 errors each, every
              log equal to the CPU plain scan's. Prints records a run, wall
              s audit off and on (medians of three, off, on, on, off, off,
              on, after an untimed run), the verifier's s a log,
              and a verify JSON line;
 13. memory   the score-matrix policies and the capacity-bounded
              memories, the kernels' counts set to 0 just before and read
              just after: locality, priority, wfq and random over the
              Cholesky, LU and QR tile DAGs at NT 16 (tile 512) on
              paper_machine(8), seed 0, unbounded and at 64 MB with
              affinity eviction; HEFT and DADA(0.5)+CP at 128 / 64 / 32 MB,
              affinity and LRU. Every run audited: its fingerprint,
              evictions, write-backs, write-back bytes and highest resident
              bytes must equal the device="cpu" run's, its log must equal
              the CPU's and verify with 0 errors, and every activation
              placed on the card must be one score_activation launch (plus
              one placement launch for HEFT and DADA; random none). Then two
              Cholesky NT 16 tenants at priorities 1 and 2 under priority and
              wfq (results, WFQ's virtual times and logs equal the CPU's),
              then C7's capacity sweep on the card (rows equal the CPU's,
              the claim must pass). Prints wall s a run, ms per placed
              activation, evictions a run and a memory JSON line;
 14. faults   the fault layer on the card, the kernels' counts set to 0
              just before and read just after: C8's script (GPU 0 drained
              at a quarter of each strategy's fault-free makespan, GPU 1
              killed at two fifths, GPU 0 back at three fifths) on the
              Cholesky, LU and QR tile DAGs at NT 16 (tile 512) on
              paper_machine(8), seed 0, noise 0, under HEFT, DADA(0.5)+CP,
              DADA(0.5)+CP with recover and each detach noticed ahead, ws
              and locality; HEFT and DADA(0.5)+CP at 64 MB with affinity
              eviction under the same script; one seeded churn run with a
              notice; one run with link_flake 0.05. Every run audited: its
              fingerprint, fault counters and log must equal the
              device="cpu" run's, the log must verify with 0 errors, every
              activation must be placed on the card as one score_activation
              launch and (HEFT, DADA) one placement launch, dead or noticed
              resources present or not, with no plain search. Then C8 from
              the Cholesky rows (the claim must pass, its rows equal the
              CPU's). Each faulted run has a fault-free twin, audited too
              and held against the CPU's; both run three times on the card,
              alternated. Prints each run's wall s and ms per placed
              activation beside its twin's (medians of three), the
              evacuated and proactive bytes, the phase's wall and a faults
              JSON line;
 15. serving  the serving simulator on the card, the kernels' counts set
              to 0 just before and read just after, every serving run
              through run_serving (repro_torch.runtime.load): serving_load's
              sweep at full width (1 024 tenants at 2 000 arrivals a
              simulated second on paper_machine(4), poisson / bursty /
              diurnal x heft / dada(0.5)+cp / wfq, incremental rescoring),
              and the same at 256 tenants; every pool round that rebuilt
              rows must be exactly one score_activation launch (none on the
              CPU), the standalone transfer kernel never; each run equal to
              its device="cpu" twin (every column at 256 tenants, the
              poisson column at 1 024): tenants, report, events, rows built,
              every interval; the speed-up probe (256 tenants, 4 000
              events, full against incremental, card and CPU, both modes
              placing alike); admission reject and defer at 64 tenants
              under a capacity of the largest catalog working set, audited:
              0 verifier errors, logs equal to the CPU's; a streamed
              classic run (four Cholesky NT 16 tenants, two at t = 0 and
              two at 0.002 k, DADA(0.5)+CP on paper_machine(8), once with
              cancel_stale and audited): one scoring and one placement
              launch per activation, equal to the CPU; C9's scenario matrix
              at the fast shape (equal to the CPU's rows) and at full depth
              (20 seeds, LU NT 12, churn 40 and 150): every C9 row must
              pass. Prints events/s, rounds, rows built, score_activation
              launches, ms per pool round, p50/p99 slowdown and Jain's
              index per run, and a serving JSON line;
 16. report   a JSON line of every ported kernel (launches_paper,
              launches_verify, launches_memory, launches_faults and
              launches_serving: each kernel's launches in those phases;
              launches_mla, launches_moe, launches_hybrid and
              launches_missing_bytes likewise; selective_scan's launches
              are the hybrid phase's mamba_scan launches),
              then the last line ``{"ok": true, "device": {...}}``.

Needs one CUDA device; exits 2 without printing a result when there is
none. Imports nothing of JAX and nothing of the ``repro`` package.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
H100_HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
H100_FP64_FLOPS = 34e12  # H100 SXM data sheet, f64 outside the tensor cores
H100_FP32_FLOPS = 67e12  # f32 outside the tensor cores (the f32 contract forbids TF32)
# single f32 (or integer) instructions a second: the f32 rate counts an FMA as two
H100_FP32_OPS = H100_FP32_FLOPS / 2
H100_BF16_FLOPS = 989e12  # bf16 tensor cores, dense
H100_SM_CLOCK_HZ = 1.98e9  # H100 SXM boost clock, 1 980 MHz
# special-function unit results (MUFU: ex2, lg2, rcp) a second: 16 a clock
# and SM on Hopper, 132 SMs at the boost clock
H100_SFU_OPS = 132 * 16 * H100_SM_CLOCK_HZ
# f32 flop of an exponential run on the FMA pipe in place of MUFU.EX2: a
# range reduction (three adds) and a degree-5 polynomial (five FMAs), about
# f32's accuracy; the integer step that builds 2^j runs on the ALU pipe
EXP_FMA_FLOP = 3 + 5 * 2
GEMM_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}  # tests/test_kernels.py:21
# gemm_update plans the planner does not pick, launched as they are:
# (m, n, k, (bm, bn, n_split, k_chunk)); the last split one 16-deep stage,
# or ragged, on ragged m, n and k
GEMM_SPLIT_EDGES = [(64, 64, 528, (64, 64, 5, 128)), (130, 70, 528, (64, 64, 5, 128)),
                    (130, 70, 100, (64, 64, 2, 64)), (77, 45, 33, (64, 64, 3, 16))]
# tile size, NT, and the GEMM-shaped task kinds of each factorization
LINALG_N, LINALG_TILE = 8192, 512
GEMM_KINDS = {"cholesky": ("syrk", "gemm"), "lu": ("ssssm",), "qr": ("ormqr", "tsmqr")}
# flop of one gemm_update call per task kind, in units of tile^3: every body
# computes the full product, so syrk does 2 b^3 (the DAG counts b^3), and
# tsmqr multiplies the explicit (2b x 2b) Q by a (2b x b) pair: 8 b^3
KERNEL_FLOPS_B3 = {"syrk": 2, "gemm": 2, "ssssm": 2, "ormqr": 2, "tsmqr": 8}
RESIDUAL_BOUND = {"cholesky": 1e-5, "lu": 1e-5, "qr": 1e-4}  # tests/test_linalg.py
# tests/test_kernels.py:86-88 and :123-125
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
DECODE_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
# the serving path: chatglm3-6b, the default arch of repro/launch/serve.py
SERVE_ARCH, SERVE_B, SERVE_PREFILL, SERVE_PROMPT, SERVE_STEPS = "chatglm3-6b", 4, 2048, 64, 32
# |prefill logits - decode-path logits| over the largest |logit|, both bf16
# through 28 layers: a CPU run of the same code at 28 layers and widths
# 256 / 512 differs by 1.9e-2 (each path is that far from an f32 run);
# the tolerance is three times that
SERVE_LOGIT_TOL = 6e-2
# flash_attention cases: (B or None for the reference's 3-D call, hq, hk, sq, sk, d, causal)
ATTN_CASES = [
    (None, 4, 4, 128, 128, 128, True), (None, 4, 2, 128, 128, 128, True),
    (None, 8, 1, 128, 256, 128, True), (None, 4, 2, 128, 128, 256, True),
    (None, 4, 4, 128, 128, 128, False), (None, 8, 1, 128, 256, 128, False),
    (None, 2, 2, 256, 1024, 128, True),  # test_kernels.py's long context
    (None, 4, 2, 100, 100, 64, True), (None, 6, 3, 37, 130, 32, True),
    (None, 2, 1, 77, 45, 128, False), (None, 4, 4, 65, 65, 256, True),
    (SERVE_B, 32, 2, SERVE_PROMPT, SERVE_PROMPT, 128, True),  # the shared prompt
    (SERVE_B, 32, 2, SERVE_PREFILL, SERVE_PREFILL, 128, True),  # the prefill
    # the MoE models' prefill: grok-1 (group 6) and kimi-k2 (group 8)
    (SERVE_B, 48, 8, SERVE_PREFILL, SERVE_PREFILL, 128, True),
    (SERVE_B, 64, 8, SERVE_PREFILL, SERVE_PREFILL, 128, True),
    # the hybrid's prefill and prompt: jamba (group 4)
    (SERVE_B, 32, 8, SERVE_PREFILL, SERVE_PREFILL, 128, True),
    (SERVE_B, 32, 8, SERVE_PROMPT, SERVE_PROMPT, 128, True),
    # the tensor-core route's edges: d 64 and 128, sq / sk no multiple of 128
    # or 64, causal with sk > sq, B > 1 strided views
    (2, 8, 2, 77, 300, 64, True), (3, 32, 2, 257, 257, 128, True),
    (2, 6, 3, 200, 65, 64, False), (1, 4, 1, 1, 129, 128, True), (2, 4, 2, 130, 1000, 64, False),
]
# MLA's widths: minicpm3-4b (40 heads, every head its own keys; query/key
# head dim 96, value head dim 64) and a narrower pair (48, 32). flash_attention:
# (B or None, hq, hk, sq, sk, dk, dv, causal); flash_decode: (B, hq, hk, S,
# dk, dv, length). Each runs in f32 (the SIMT routes) and bf16 (the
# tensor-core routes).
MLA_ARCH = "minicpm3-4b"
ATTN_DV_CASES = [
    (None, 8, 8, 128, 128, 96, 64, True), (None, 4, 2, 100, 100, 48, 32, True),
    (2, 8, 2, 77, 300, 48, 32, False), (1, 40, 40, 130, 130, 96, 64, False),
    (SERVE_B, 40, 40, SERVE_PROMPT, SERVE_PROMPT, 96, 64, True),  # the MLA prompt
    (SERVE_B, 40, 40, SERVE_PREFILL, SERVE_PREFILL, 96, 64, True),  # the MLA prefill
]
# the MoE models at full width, depth cut to what one card holds:
# (arch, layers served)
MOE_ARCHS = (("grok-1-314b", 4), ("kimi-k2-1t-a32b", 1))
# |prefill logits - decode-path logits| over the largest |logit|, bf16, at
# the capacity factor that drops nothing: tools/moe_logit_gap.py (the same
# code on the CPU, widths 256 / 512, the published heads and experts) gives
# at most 1.67e-2 (grok-1, 4 layers, d 256, one token's route flipped); the
# tolerance is three times that
MOE_LOGIT_TOL = 5e-2
MOE_GROUPS = 4  # device groups of the relabelling check's placement
# the hybrid at full width, depth cut to what one card holds: 16 of 32 layers
# (two periods: 14 Mamba and 2 attention layers, 8 MoE and 8 dense MLPs;
# 52.1 GB of bf16 weights, where all 32 layers are 103.1 GB)
HYBRID_ARCH, HYBRID_LAYERS = "jamba-v0.1-52b", 16
# |prefill logits - decode-path logits| over the largest |logit| for the
# hybrid, bf16, compared with every expert routed (top-k 16 at capacity
# factor 1): at the published top-2 one bf16 ulp flips a token's experts and
# the Mamba recurrence carries the flip to every later token (at widths 256 /
# 512, 141-167 of 2 048 routes flip and the gap is 0.38-0.43,
# tools/moe_logit_gap.py); with every expert routed nothing discrete is left.
# On an H100, tools/hybrid_fault_gap.py reads 0.0440 sound and 0.958 with
# the decode step's conv window never shifted; the tolerance is about twice
# the sound reading. A decode step that never advances its ssm state reads
# 0.0581 there, inside bf16 rounding at this level: mamba_step_check holds
# the Mamba state path at f32 instead, where the same fault reads 7.2e-2
# against a sound 2.6e-6
HYBRID_LOGIT_TOL = 1e-1
# one Mamba layer at jamba's widths in f32: its full-sequence run against its
# decode steps, max |diff| over the largest |y| (the smoke configs' f32
# card-against-CPU limit; the two paths differ only in GEMM shapes and so in
# summation order)
MAMBA_STEP_TOL = 1e-4
# selective_scan against its plain version at tests/_scan_cases.py's
# SCAN_CASES: y and hT each within this of their largest magnitude (f32; the
# kernel sums over n and fuses multiply-adds in another order than the plain
# loop); mamba_scan's g at f32 and its state likewise at FUSED_CASES
SCAN_TOL = 1e-5
# mamba_scan's g at bf16 against mamba_scan_plain, over its largest magnitude:
# the f32 y of the two may differ in its last bits, and where y sits near a
# rounding boundary its bf16 value (and the gate's product) moves one ulp;
# besides, each element within tests/_scan_cases.py's g_bf16_limit
MAMBA_SCAN_BF16_TOL = 2.0 ** -7
DECODE_DV_CASES = [
    (SERVE_B, 40, 40, SERVE_PROMPT + SERVE_STEPS, 96, 64, SERVE_PROMPT + SERVE_STEPS),  # MLA
    (SERVE_B, 40, 40, 1, 96, 64, 1), (2, 8, 2, 700, 48, 32, 65), (2, 40, 40, 300, 48, 32, 300),
    (3, 16, 4, 200, 96, 64, 131),
]
# placement cases: resource classes by position (True: accelerator):
# paper_machine(8) (4 CPUs, 8 GPUs), a wide GPU-only machine, two CPUs, one
# of each, and a wide interleaved machine (the DADA kernel's lanes hold 1,
# 2 and 8 rids each)
PLACE_MACHINES = {"paper": [False] * 4 + [True] * 8, "gpu40": [True] * 40, "cpu2": [False] * 2,
                  "cpu1gpu1": [False, True], "mixed130": [i % 3 != 0 for i in range(130)]}
PLACE_N = (1, 3, 37, 128, 256)
# DADA's wide activations on paper_machine(8): C and the task vectors staged
# (1 000), the task vectors only (1 500), nothing (4 000, depth 4; 8 000,
# depth 2); HEFT's ring (n, n_res) and one pass at 440 resources
PLACE_WIDE_N = (1000, 1500, 4000, 8000)
PLACE_HEFT_RING = ((4000, 440), (2000, 14), (100, 512), (3, 440))
# the widths of the place phase's timing rows (LU NT 64's ready tasks)
PLACE_WIDTHS = (8, 32, 128, 512)
# the card's wall s of each main-path run in PR 18's final run (PERF.md §5),
# by (graph, NT, strategy, min_wide): printed beside this run's for the
# reader, never put in the kernels line
PR18_WALL_S = {
    ("cholesky", 16, "heft", 1): 0.061, ("cholesky", 16, "dada(0.5)+cp", 1): 0.081,
    ("lu", 16, "heft", 1): 0.066, ("lu", 16, "dada(0.5)+cp", 1): 0.261,
    ("qr", 16, "heft", 1): 0.129, ("qr", 16, "dada(0.5)+cp", 1): 0.132,
    ("cholesky", 64, "heft", 1): 1.394, ("cholesky", 64, "dada(0.5)+cp", 1): 1.947,
    ("lu", 64, "heft", 1): 2.351, ("lu", 64, "dada(0.5)+cp", 1): 3.205,
    ("qr", 64, "heft", 1): 8.284, ("qr", 64, "dada(0.5)+cp", 1): 12.413,
    ("cholesky", 64, "heft", 32): 1.233, ("cholesky", 64, "dada(0.5)+cp", 32): 2.049,
}
# the card's wall s of each main-path run in PR 25's final run (PR 18's
# keys), printed beside this run's
PR25_WALL_S = {
    ("cholesky", 16, "heft", 1): 0.048635, ("cholesky", 16, "dada(0.5)+cp", 1): 0.070351,
    ("lu", 16, "heft", 1): 0.079148, ("lu", 16, "dada(0.5)+cp", 1): 0.103392,
    ("qr", 16, "heft", 1): 0.117612, ("qr", 16, "dada(0.5)+cp", 1): 0.144821,
    ("cholesky", 64, "heft", 1): 1.826565, ("cholesky", 64, "dada(0.5)+cp", 1): 2.401103,
    ("lu", 64, "heft", 1): 3.572438, ("lu", 64, "dada(0.5)+cp", 1): 3.354999,
    ("qr", 64, "heft", 1): 12.137716, ("qr", 64, "dada(0.5)+cp", 1): 13.638914,
    ("cholesky", 64, "heft", 32): 1.492611, ("cholesky", 64, "dada(0.5)+cp", 32): 2.395884,
}
DECODE_32K = (16, 32768)  # (B, S) of the decode_32k-like timing and check
# flash_decode cases: (B, hq, hk, S, hd, length)
DECODE_CASES = [
    (2, 8, 2, 512, 128, 512), (2, 4, 1, 1024, 128, 700), (2, 16, 16, 256, 128, 256),
    (2, 4, 2, 300, 32, 171), (3, 16, 16, 50, 256, 1), (1, 8, 1, 33, 64, 33),
    (SERVE_B, 32, 2, SERVE_PROMPT + SERVE_STEPS, 128, 1),  # the serving cache
    (SERVE_B, 32, 2, SERVE_PROMPT + SERVE_STEPS, 128, SERVE_PROMPT + SERVE_STEPS),
    (DECODE_32K[0], 32, 2, DECODE_32K[1], 128, DECODE_32K[1]),
    # the MoE models' serving cache: grok-1 (group 6) and kimi-k2 (group 8)
    (SERVE_B, 48, 8, SERVE_PROMPT + SERVE_STEPS, 128, SERVE_PROMPT + SERVE_STEPS),
    (SERVE_B, 64, 8, SERVE_PROMPT + SERVE_STEPS, 128, SERVE_PROMPT + SERVE_STEPS),
    # the hybrid's serving cache: jamba (group 4), at its first and last length
    (SERVE_B, 32, 8, SERVE_PROMPT + SERVE_STEPS, 128, 1),
    (SERVE_B, 32, 8, SERVE_PROMPT + SERVE_STEPS, 128, SERVE_PROMPT + SERVE_STEPS),
    # the split route's edges: groups 1, 16 and 32 at lengths 1, a last
    # split of one position (chunk 64 + 1) and the whole cache
    *[(2, 2 * group, 2, 700, 128, length) for group in (1, 16, 32) for length in (1, 65, 700)],
    (1, 24, 1, 130, 16, 130), (2, 4, 4, 64, 256, 33),
]


# full garbage collections (generation 2) since the start, and the seconds
# they paused the program
GC_FULL = {"count": 0, "s": 0.0, "start": 0.0}


def _on_gc(stage, info):
    if info["generation"] != 2:
        return
    if stage == "start":
        GC_FULL["start"] = time.perf_counter()
    else:
        GC_FULL["count"] += 1
        GC_FULL["s"] += time.perf_counter() - GC_FULL["start"]


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(name, t0):
    print(f"== {name} done in {time.perf_counter() - t0:.3f} s", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_table(report: str):
    """Registers, spills and static shared memory of each kernel in an
    ``nvcc -Xptxas -v`` report."""
    rows, cur = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            cur = {"function": line.split("'")[1]}
            rows.append(cur)
        elif cur is not None and "spill stores" in line:
            words = line.replace(",", " ").split()
            cur["spill_stores"] = int(words[words.index("spill") - 2])
            cur["spill_loads"] = int(words[len(words) - 1 - words[::-1].index("spill") - 2])
        elif cur is not None and "Used" in line and "registers" in line:
            words = line.replace(",", " ").split()
            cur["registers"] = int(words[words.index("registers") - 1])
            cur["smem_bytes"] = int(words[words.index("smem") - 2]) if "smem" in words else 0
    return rows


def full_case(rng, n_pad, r_pad, n_u):
    """Seeded full residency masks: n_u 9 and 30 have the host as column 0
    (paper machines), n_u 25 has no host column (an all-GPU machine)."""
    if n_u == 25:
        shifts, host = list(range(1, n_u + 1)), [False] * n_u
    else:
        shifts, host = list(range(n_u)), [True] + [False] * (n_u - 1)
    bits = np.asarray(sorted({0, *shifts}), dtype=np.int64)
    pick = rng.random((n_pad, r_pad, len(bits))) < 0.3
    masks = (pick * (np.int64(1) << bits)).sum(axis=2).astype(np.int64)
    per_read = rng.random((n_pad, r_pad)) * 1e-3
    per_read[rng.random((n_pad, r_pad)) < 0.1] = 0.0
    masks[0] = 0  # data that exists nowhere
    if n_pad > 1:
        masks[1] = 1  # host-only copies
    pad = rng.random(n_pad) < 0.5
    pad[:2] = False
    masks[pad, r_pad - 1] = 0  # padded reads
    per_read[pad, r_pad - 1] = 0.0
    return masks, per_read, np.asarray(shifts, dtype=np.int64), np.asarray(host, dtype=bool)


def flag_combinations():
    """Every valid combination of score_activation's seven flags (39): S
    resident-weighted, on accelerators only, or missing_bytes (s_missing)."""
    out = []
    for x in ("none", "max", "max+bias", "rows", "rows+bias"):
        for s in ("none", "s", "s+accel", "s+missing"):
            for c in (False, True):
                if x != "none" or s != "none" or c:
                    out.append(dict(want_x=x != "none", x_rows=x.startswith("rows"),
                                    want_bias="bias" in x, want_s=s != "none",
                                    accel_only=s == "s+accel", want_c=c,
                                    s_missing=s == "s+missing"))
    return out


def activation_case(ss, rng, n, n_u, n_res, host, flags, fault_bias=False):
    """A seeded packed activation: (layout, packed input, machine buffer) as
    int64 numpy arrays. Masks over the host bit and n_u memory shifts up to
    62, data that exists nowhere (mask 0), host-only data, reads of size 0,
    task 0 without reads and task 1 without affinity accesses.
    ``fault_bias``: x_bias as on a machine that lost resources, +inf over
    a few columns (detached) and a finite penalty over others (noticed),
    on top of the pressure."""
    shifts = np.sort(rng.choice(np.arange(1, ss.MAX_SHIFT + 1), n_u - host, replace=False))
    if host:
        shifts = np.concatenate([[0], shifts])
    host_col = shifts == 0
    col_of = rng.permutation(np.concatenate([np.arange(n_u), rng.integers(0, n_u, n_res - n_u)]))
    machine = ss.pack_machine(n_res, latency=1.5e-5, bandwidth=1.2e10, mem_shift=shifts,
                              host_col=host_col, col_of=col_of, accel_res=~host_col[col_of])
    bits = np.concatenate([[0], shifts[shifts > 0]]).astype(np.int64)

    def csr(max_per_row, empty_row):
        counts = rng.integers(0, max_per_row + 1, n)
        counts[min(empty_row, n - 1)] = 0
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        pick = rng.random((indptr[-1], len(bits))) < 0.3
        masks = (pick * (np.int64(1) << bits)).sum(axis=1).astype(np.int64)
        masks[::5] = 0
        masks[1::7] = 1
        return indptr, masks, rng.integers(1, 1 << 22, len(masks)).astype(np.float64)

    reads = writes = None
    if flags["want_x"]:
        reads = csr(4, 0)
        reads[2][::6] = 0.0  # reads of size 0
    if flags["want_s"]:
        writes = csr(3, 1)
        if flags.get("s_missing"):
            writes[2][::6] = 0.0  # read-like: sizes of 0 too
    bias = None
    if flags["want_bias"]:
        bias = rng.random((n, n_res)) * 1e-3
        bias[rng.random((n, n_res)) < 0.5] = 0.0
        if fault_bias:
            cols = rng.permutation(n_res)
            bias[:, cols[:max(1, n_res // 5)]] = np.inf
            bias[:, cols[n_res // 5 + 1:n_res // 5 + 3]] += rng.integers(1, 64) / 64.0
    layout = ss.score_layout(ss.ScoreSpec(
        n=n, nnz_r=len(reads[1]) if reads else 0, nnz_w=len(writes[1]) if writes else 0,
        n_u=n_u, n_res=n_res, **flags))
    packed = np.zeros(layout.n_in, dtype=np.int64)
    ss.pack_activation(packed, layout, reads=reads, writes=writes,
                       p_cpu=rng.random(n) if flags["want_c"] else None,
                       p_gpu=rng.random(n) * 0.1 if flags["want_c"] else None, x_bias=bias)
    return layout, packed, machine


FAULT_SPECS = ("heft", "dada?alpha=0.5&use_cp=1", "dada?alpha=0.5&use_cp=1&recover=1", "ws",
               "locality")
FAULT_NOTICE = 0.1  # recover's notice window, as a fraction of the fault-free makespan
FAULT_REPS = 3  # card runs of each faulted run and of its fault-free twin, for the medians


def faults_phase(ss, sp, se):
    """The fault layer on the card, the kernels' counts set to 0 just
    before and read just after: C8's script over the three tile DAGs and
    five strategies, two bounded runs, a churn run with a notice and a
    flaky-link run; every run audited, verified and held against its
    device="cpu" twin; C8 from the Cholesky rows. Returns the ``faults``
    JSON entry and the launches by kernel."""
    from repro_torch.bench import paper_validation as pv
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.core import Simulator
    from repro_torch.linalg.cholesky import cholesky_graph
    from repro_torch.linalg.lu import lu_graph
    from repro_torch.linalg.qr import qr_graph
    from repro_torch.runtime.metrics import recovery_report
    from repro_torch.sched import resolve
    from repro_torch.verify import errors, verify_audit

    w_phase = time.perf_counter()
    counters = {"score_activation": ss.score_activation, "dada_place": sp.dada_place,
                "heft_select": sp.heft_select, "episode_scan": se.episode_scan}
    graph_of = {"cholesky": cholesky_graph, "lu": lu_graph, "qr": qr_graph}
    machine = paper_machine(8)
    gpus = [r.rid for r in machine.gpus]

    def read():
        return {name: fn.launches for name, fn in counters.items()}

    def plain_calls():
        return sp.dada_place_plain.calls + sp.heft_select_plain.calls

    def strategy(spec, device):
        return resolve(spec) if spec == "ws" else resolve(spec, device=device)

    def method_of(spec):
        name = spec.split("?")[0]
        return {"heft": "place_heft", "dada": "place_dada", "ws": None}.get(name, "score_matrices")

    def counted(strat, spec):
        """Count ``strat``'s activations, and time its backend calls, with
        those made while a resource was detached or noticed."""
        acts, calls, call_s, live = [0], [0], [0.0], [0]
        place = strat.place

        def counted_place(sim, ready, src):
            acts[0] += 1
            place(sim, ready, src)

        strat.place = counted_place
        method = method_of(spec)
        if method is not None:
            fn = getattr(strat.backend, method)

            def timed(sim, *args, **kwargs):
                s0 = time.perf_counter()
                out = fn(sim, *args, **kwargs)
                call_s[0] += time.perf_counter() - s0
                calls[0] += 1
                live[0] += sim.faults.any_dead or bool(sim.faults.noticed)
                return out

            setattr(strat.backend, method, timed)
        return acts, calls, call_s, live

    def run(device, gname, spec, script=(), makespan=0.0, **kw):
        """One audited run of ``spec`` on ``device`` with ``script``'s
        faults at fractions of ``makespan``; what it did and took."""
        strat = strategy(spec, device)
        acts, calls, call_s, live = counted(strat, spec)
        sim = Simulator(graph_of[gname](16, 512), machine, strat, seed=0, noise=0.0,
                        audit=True, **kw)
        for event, gi, frac, mode in script:
            sim.inject(event, gpus[gi], at=makespan * frac, mode=mode)
        before, plain0 = read(), plain_calls()
        w0 = time.perf_counter()
        res = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        return dict(sim=sim, res=res, wall=wall, acts=acts[0], calls=calls[0],
                    ms=call_s[0] / max(calls[0], 1) * 1e3, live=live[0],
                    plain=plain_calls() - plain0,
                    launches={k: v - before[k] for k, v in read().items()})

    def one(label, gname, spec, script=(), twin_kw=None, notice=0.0, **kw):
        """One faulted run on the card and on the CPU, held against each
        other, beside its fault-free twin (``twin_kw``: its arguments), also
        audited and held against the CPU's; then two more card runs of
        each, alternated, for the medians of three. ``notice``: each
        detach announced that fraction of the twin's makespan ahead. Its
        row."""
        twin = {d: run(d, gname, spec, **twin_kw) for d in ("cuda", "cpu")}
        if fingerprint(twin["cuda"]["res"]) != fingerprint(twin["cpu"]["res"]):
            raise SystemExit(f"faults {gname} {spec}: the fault-free card run differs from the CPU's")
        base = twin["cuda"]["res"]
        if notice:
            kw["notice_s"] = base.makespan * notice
        out = {d: run(d, gname, spec, script, base.makespan, **kw) for d in ("cuda", "cpu")}
        card, cpu = out["cuda"], out["cpu"]
        reps = {"twin": [twin["cuda"]], "faulted": [card]}
        for _ in range(FAULT_REPS - 1):
            reps["twin"].append(run("cuda", gname, spec, **twin_kw))
            reps["faulted"].append(run("cuda", gname, spec, script, base.makespan, **kw))
        if any(r["launches"] != reps[k][0]["launches"] or r["plain"] for k in reps
               for r in reps[k]):
            raise SystemExit(f"faults {label} {gname} {spec}: a repeated card run launched "
                             "otherwise than the first")
        wall, ms = ({k: float(np.median([r[key] for r in reps[k]])) for k in reps}
                    for key in ("wall", "ms"))
        sim, res, n = card["sim"], card["res"], len(card["sim"].graph)
        errs = errors(verify_audit(sim.audit)) + errors(verify_audit(twin["cuda"]["sim"].audit))
        launches, placed = card["launches"], card["calls"]
        f = res.faults or {}
        results[(label, gname, spec)] = res
        bases[(label, gname, spec)] = base
        row = dict(case=label, graph=gname, nt=16, spec=spec, strategy=res.strategy, tasks=n,
                   activations=card["acts"], placed=placed, placed_live=card["live"],
                   launches=launches, plain_calls=card["plain"], makespan=res.makespan,
                   total_bytes=res.total_bytes, faults=f, wall_s=wall["faulted"],
                   ms_per_placed=ms["faulted"], cpu_wall_s=cpu["wall"], cpu_ms_per_placed=cpu["ms"],
                   verify_errors=len(errs), base_makespan=base.makespan,
                   base_bytes=base.total_bytes, base_wall_s=wall["twin"],
                   base_ms_per_placed=ms["twin"],
                   wall_s_runs=[r["wall"] for r in reps["faulted"]],
                   base_wall_s_runs=[r["wall"] for r in reps["twin"]])
        print(f"faults {label} graph={gname} NT=16 strategy={res.strategy} tasks={n} "
              f"activations={card['acts']} placed={placed} placed_live={card['live']} "
              f"launches={launches} plain_calls={card['plain']} makespan={res.makespan!r} "
              f"total_bytes={res.total_bytes} detaches={f.get('n_detaches')} "
              f"attaches={f.get('n_attaches')} notices={f.get('n_notices')} "
              f"requeued={f.get('n_requeued')} killed={f.get('n_killed')} "
              f"evacuated_bytes={f.get('evacuated_bytes')} "
              f"proactive_bytes={f.get('proactive_bytes')} retries={f.get('n_retries')} "
              f"timeouts={f.get('n_timeouts')} wall_s={wall['faulted']:.6f} "
              f"ms_per_placed={ms['faulted']:.6f} cpu_wall_s={cpu['wall']:.6f} "
              f"cpu_ms_per_placed={cpu['ms']:.6f} verify_errors={len(errs)} "
              f"fault-free (audited): wall_s={wall['twin']:.6f} "
              f"ms_per_placed={ms['twin']:.6f} makespan={base.makespan!r} "
              f"(card medians of {FAULT_REPS}, alternated)", flush=True)
        if fingerprint(res) != fingerprint(cpu["res"]) or res.faults != cpu["res"].faults:
            raise SystemExit(f"faults {label} {gname} {spec}: the card run differs from the CPU run")
        if not same_log(sim.audit, cpu["sim"].audit):
            raise SystemExit(f"faults {label} {gname} {spec}: the card's log differs from the CPU's")
        if errs:
            raise SystemExit(f"faults {label} {gname} {spec}: {len(errs)} verifier errors: "
                             f"{[(e.code, e.message) for e in errs[:3]]}")
        if sorted(iv.tid for iv in res.intervals) != list(range(n)):
            raise SystemExit(f"faults {label} {gname} {spec}: not every task ran exactly once")
        if any(cpu["launches"].values()) or any(twin["cpu"]["launches"].values()):
            raise SystemExit(f"faults {label} {gname} {spec}: the CPU run launched a kernel")
        n_place = launches["dada_place"] + launches["heft_select"]
        if spec == "ws":
            ok = not any(launches.values()) and placed == 0
        elif method_of(spec) == "score_matrices":
            ok = launches["score_activation"] == placed == card["acts"] and not n_place
        else:
            ok = launches["score_activation"] == n_place == placed == card["acts"]
            ok = ok and launches[{"heft": "heft_select"}.get(spec, "dada_place")] == placed
        if not ok or launches["episode_scan"] or card["plain"]:
            raise SystemExit(f"faults {label} {gname} {spec}: launches {launches}, "
                             f"{card['plain']} plain searches for {card['acts']} activations "
                             f"({placed} placed on the card)")
        if spec != "ws" and script and not card["live"]:
            raise SystemExit(f"faults {label} {gname} {spec}: no activation placed on the card "
                             "while a resource was dead or noticed")
        return row

    for fn in counters.values():
        fn.launches = 0
    rows, bases, results = [], {}, {}
    c8_script = [(event, gi, frac, mode) for frac, event, gi, mode in pv.C8_FAULTS]
    for gname in graph_of:
        for spec in FAULT_SPECS:
            # the fault times are fractions of the strategy's own fault-free
            # makespan
            rows.append(one("c8", gname, spec, c8_script, {},
                            FAULT_NOTICE if "recover" in spec else 0.0))
    for spec in ("heft", "dada?alpha=0.5&use_cp=1"):
        bounded = dict(mem_capacity=64 * MB, eviction="affinity")
        rows.append(one("c8-64MB-affinity", "cholesky", spec, c8_script, bounded, **bounded))
    rows.append(one("churn-notice", "cholesky", "dada?alpha=0.5&use_cp=1&recover=1", (), {},
                    churn=40.0, fault_mode="kill", notice_s=0.01))
    rows.append(one("flaky-0.05", "cholesky", "dada?alpha=0.5&use_cp=1", (), {}, link_flake=0.05))
    launches = read()
    if not (rows[-2]["faults"]["n_detaches"] and rows[-2]["faults"]["n_notices"]):
        raise SystemExit("faults churn: no noticed detach happened")
    if not rows[-1]["faults"]["n_retries"]:
        raise SystemExit("faults flaky: no hop failed")
    if not all(r["faults"]["proactive_bytes"] for r in rows
               if r["case"] == "c8" and "recover" in r["spec"]):
        raise SystemExit("faults: a noticed C8 run replicated nothing ahead of its deaths")

    # C8 from the Cholesky rows (fault_recovery_runs' definition), against
    # the CPU's own fault_recovery_runs
    reps = {}
    for label, spec in pv.C8_SPECS:
        faulted, base = results[("c8", "cholesky", spec)], bases[("c8", "cholesky", spec)]
        row = next(r for r in rows if (r["case"], r["graph"], r["spec"]) == ("c8", "cholesky", spec))
        reps[label] = dict(recovery_report(faulted, base), bytes=faulted.total_bytes,
                           baseline_bytes=base.total_bytes, verify_errors=row["verify_errors"])
    c8 = pv.check_c8(reps=reps)
    pv.print_checks([c8])
    cpu_reps = pv.fault_recovery_runs(device="cpu")
    if reps != cpu_reps:
        raise SystemExit("faults C8: the card's rows differ from the CPU's fault_recovery_runs")
    if not c8["passed"]:
        raise SystemExit("faults C8: the claim failed")
    wall = time.perf_counter() - w_phase
    print(f"faults: {len(rows)} faulted runs on the card, each equal to the CPU's and verified "
          f"clean; {sum(r['placed_live'] for r in rows)} activations placed on the card while a "
          f"resource was dead or noticed; launches {launches}; phase wall {wall:.3f} s", flush=True)
    entry = dict(card=card_line(), runs=rows, c8=dict(passed=True, measured=c8["measured"],
                                                      rows=reps), launches=launches, wall_s=wall)
    return entry, launches


# the serving phase: serving_load's sweep at full width (1 024 tenants at
# 2 000 arrivals a simulated second on paper_machine(4)), its CPU twins
# (the poisson column at full width, every column at SERVING_CPU_TENANTS),
# the speed-up probe, admission, the streamed classic run and C9
SERVING_TENANTS, SERVING_RATE, SERVING_CPU_TENANTS = 1024, 2000.0, 256
SERVING_ADMIT_TENANTS = 64
SERVING_STREAM_NT = 16


def serving_phase(ss, sp, se):
    """The serving simulator on the card, the kernels' counts set to 0 just
    before and read just after: serving_load's sweep and probe through
    run_serving, admission control (audited), a streamed classic run with
    and without cancel_stale, and C9 (the scenario matrix at the fast
    shape against the CPU, then at full depth). Every pool round that
    rebuilt rows must be one score_activation launch, every run must equal
    its device="cpu" twin. Returns the ``serving`` JSON entry and the
    launches by kernel."""
    from repro_torch.bench import scenario_matrix as sm
    from repro_torch.bench import serving_load as sl
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.linalg.cholesky import cholesky_graph
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.load import default_catalog, make_arrivals, run_serving
    from repro_torch.runtime.rescore import ServingScheduler
    from repro_torch.sched import resolve
    from repro_torch.verify import errors, verify_audit

    w_phase = time.perf_counter()
    counters = {"score_activation": ss.score_activation, "dada_place": sp.dada_place,
                "heft_select": sp.heft_select, "episode_scan": se.episode_scan,
                "transfer_matrix": ss.transfer_matrix}

    def read():
        return {name: fn.launches for name, fn in counters.items()}

    # every pool rebuild: (rows, score_activation launches, seconds, min_wide)
    rebuilds = []
    rebuild = ServingScheduler._rebuild

    def counted(self, engine, keys):
        n = sum(1 for k in keys if k in self.entries)
        l0, t0 = ss.score_activation.launches, time.perf_counter()
        rebuild(self, engine, keys)
        rebuilds.append((n, ss.score_activation.launches - l0, time.perf_counter() - t0,
                         self.min_wide))

    def fp(out):
        e = out["engine"]
        return ({k: out[k] for k in ("tenants", "report", "n_events", "n_arrivals", "n_admitted",
                                     "n_rejected", "n_deferred", "rows_built")},
                [(c.gid, c.submit_at, c.admit_at, c.rejected,
                  [(iv.tid, iv.rid, iv.start, iv.end) for iv in c.intervals]) for c in e._ctxs],
                e._serving.n_rounds)

    machine = paper_machine(4)
    baselines = {}

    def serve(label, arr, spec, device, **kw):
        """One run_serving on ``device``; its output and what it took."""
        rebuilds.clear()
        before = read()
        w0 = time.perf_counter()
        out = run_serving(arr, machine, spec, seed=0, device=device,
                          baselines=baselines.setdefault((spec, device), {}), **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        pool = list(rebuilds)
        launches = {k: v - before[k] for k, v in read().items()}
        for n, l, _, mw in pool:
            if l != (1 if device == "cuda" and n >= mw else 0):
                raise SystemExit(f"serving {label}: a pool round of {n} rows made {l} "
                                 f"score_activation launches on {device}")
        if launches["transfer_matrix"]:
            raise SystemExit(f"serving {label}: the standalone transfer kernel launched")
        scored = [t for n, l, t, _ in pool if l]
        return dict(out=out, wall=wall, launches=launches, pool_launches=sum(l for _, l, _, _ in pool),
                    pool_ms=1e3 * sum(scored) / max(len(scored), 1),
                    rows_a_round=sum(n for n, _, _, _ in pool) / max(len(pool), 1))

    def row_of(label, card, cpu):
        out = card["out"]
        rep, e = out["report"], out["engine"]
        row = dict(case=label, strategy=e.strategy.name, n_tenants=rep["n_tenants"],
                   wall_s=card["wall"], events=out["n_events"],
                   events_per_s=out["n_events"] / card["wall"], rounds=e._serving.n_rounds,
                   rows_built=out["rows_built"], rows_a_round=card["rows_a_round"],
                   score_activation_launches=card["pool_launches"],
                   ms_per_pool_round=card["pool_ms"], p50_slowdown=rep["p50_slowdown"],
                   p99_slowdown=rep["p99_slowdown"], jain_fairness=rep["jain_fairness"],
                   n_admitted=out["n_admitted"], n_rejected=out["n_rejected"],
                   n_deferred=out["n_deferred"],
                   cpu_wall_s=None if cpu is None else cpu["wall"],
                   cpu_events_per_s=None if cpu is None else out["n_events"] / cpu["wall"])
        print(f"serving {label} strategy={row['strategy']} tenants={row['n_tenants']} "
              f"events={row['events']} wall_s={row['wall_s']:.6f} "
              f"events_per_s={row['events_per_s']:.1f} rounds={row['rounds']} "
              f"rows_built={row['rows_built']} rows_a_round={row['rows_a_round']:.3f} "
              f"score_activation_launches={row['score_activation_launches']} "
              f"ms_per_pool_round={row['ms_per_pool_round']:.6f} "
              f"p50_slowdown={row['p50_slowdown']!r} p99_slowdown={row['p99_slowdown']!r} "
              f"jain={row['jain_fairness']!r} admitted={row['n_admitted']} "
              f"rejected={row['n_rejected']} deferred={row['n_deferred']}"
              + ("" if cpu is None else f" cpu_wall_s={cpu['wall']:.6f}"), flush=True)
        return row

    def twin(label, arr, spec, with_cpu=True, **kw):
        card = serve(label, arr, spec, "cuda", **kw)
        cpu = serve(label, arr, spec, "cpu", **kw) if with_cpu else None
        if cpu is not None and fp(card["out"]) != fp(cpu["out"]):
            raise SystemExit(f"serving {label}: the card run differs from the CPU run")
        return card, cpu

    for fn in counters.values():
        fn.launches = 0
    ServingScheduler._rebuild = counted
    try:
        sweep, probe, admission = [], {}, []
        # serving_load's sweep at full width, incremental; CPU twins for the
        # poisson column at full width and every column at 256 tenants
        for tenants in (SERVING_TENANTS, SERVING_CPU_TENANTS):
            for arrival in sl.ARRIVALS:
                arr = make_arrivals(arrival, tenants, rate=SERVING_RATE, seed=7)
                for spec in sl.STRATEGIES:
                    label = f"sweep/{arrival}/{sl.STRATEGY_LABELS[spec]}/tenants{tenants}"
                    with_cpu = tenants == SERVING_CPU_TENANTS or arrival == "poisson"
                    card, cpu = twin(label, arr, spec, with_cpu, rescore="incremental")
                    sweep.append(row_of(label, card, cpu))
        # the speed-up probe: full against incremental, capped at the same
        # event count, on the card and the CPU
        arr = make_arrivals("poisson", sl.PROBE_TENANTS, rate=SERVING_RATE, seed=7)
        placed = {}
        for mode in ("full", "incremental"):
            card, cpu = twin(f"probe/{mode}", arr, "heft", rescore=mode,
                             max_events=sl.PROBE_EVENTS)
            probe[mode] = row_of(f"probe/{mode}", card, cpu)
            placed[mode] = fp(card["out"])[1]
        if placed["full"] != placed["incremental"]:
            raise SystemExit("serving probe: full and incremental placed differently")
        probe["speedup_card"] = probe["incremental"]["events_per_s"] / probe["full"]["events_per_s"]
        probe["speedup_cpu"] = probe["incremental"]["cpu_events_per_s"] / probe["full"]["cpu_events_per_s"]
        print(f"serving probe: incremental / full events a second {probe['speedup_card']:.3f}x "
              f"on the card, {probe['speedup_cpu']:.3f}x on the CPU", flush=True)
        # admission control under a tight capacity, audited
        catalog = default_catalog()
        probe_engine = Engine(machine, resolve("heft", device="cpu"), seed=0)
        ws = max(probe_engine.submit(b()).ws_bytes for b in catalog.values())
        arr = make_arrivals("poisson", SERVING_ADMIT_TENANTS, rate=5000.0, seed=1)
        for mode in ("reject", "defer"):
            card, cpu = twin(f"admission/{mode}", arr, "heft", admission=mode, mem_capacity=ws,
                             audit=True)
            log = card["out"]["engine"].audit
            errs = errors(verify_audit(log))
            if errs or not same_log(log, cpu["out"]["engine"].audit):
                raise SystemExit(f"serving admission {mode}: {len(errs)} verifier errors, or the "
                                 "card's log differs from the CPU's")
            row = row_of(f"admission/{mode}", card, cpu)
            row.update(verify_errors=0, records=n_records(log))
            if not (row["n_rejected"] if mode == "reject" else row["n_deferred"]):
                raise SystemExit(f"serving admission {mode}: the capacity turned no tenant away")
            admission.append(row)
    finally:
        ServingScheduler._rebuild = rebuild

    # a streamed classic run: four Cholesky NT 16 tenants, two at t = 0,
    # the rest at 0.002 k; one scoring and one placement launch per
    # activation placed; with cancel_stale too, audited
    streamed = []
    spec = "dada?alpha=0.5&use_cp=1"
    for cancel in (False, True):
        runs = {}
        for device in ("cuda", "cpu"):
            strat = resolve(spec, device=device)
            acts, place = [0], strat.place

            def counted_place(sim, ready, src, place=place, acts=acts):
                acts[0] += 1
                place(sim, ready, src)

            strat.place = counted_place
            eng = Engine(paper_machine(8), strat, seed=0, cancel_stale=cancel, audit=cancel)
            for k in range(4):
                eng.submit(cholesky_graph(SERVING_STREAM_NT, 512), at=None if k < 2 else 0.002 * k)
            before, plain0 = read(), sp.dada_place_plain.calls
            w0 = time.perf_counter()
            results = eng.run()
            torch.cuda.synchronize()
            runs[device] = dict(eng=eng, results=results, wall=time.perf_counter() - w0,
                                acts=acts[0], plain=sp.dada_place_plain.calls - plain0,
                                launches={k: v - before[k] for k, v in read().items()})
        card, cpu = runs["cuda"], runs["cpu"]
        key = [[(r.makespan, r.submit_at, r.total_bytes, [(iv.tid, iv.rid, iv.start, iv.end)
                                                          for iv in r.intervals])
                for r in runs[d]["results"]] for d in ("cuda", "cpu")]
        if key[0] != key[1]:
            raise SystemExit(f"serving streamed cancel_stale={cancel}: the card run differs "
                             "from the CPU run")
        lc = card["launches"]
        if not (lc["score_activation"] == lc["dada_place"] == card["acts"] > 0) or card["plain"]:
            raise SystemExit(f"serving streamed: launches {lc} for {card['acts']} activations, "
                             f"{card['plain']} plain searches")
        if any(cpu["launches"].values()):
            raise SystemExit("serving streamed: the CPU run launched a kernel")
        n_err = None
        if cancel:
            log = card["eng"].audit
            n_err = len(errors(verify_audit(log)))
            if n_err or not same_log(log, cpu["eng"].audit):
                raise SystemExit("serving streamed cancel_stale: verifier errors, or the card's "
                                 "log differs from the CPU's")
        row = dict(cancel_stale=cancel, tenants=4, nt=SERVING_STREAM_NT, strategy=spec,
                   activations=card["acts"], launches=lc, wall_s=card["wall"],
                   cpu_wall_s=cpu["wall"], makespans=[r.makespan for r in card["results"]],
                   submit_at=[r.submit_at for r in card["results"]], verify_errors=n_err)
        print(f"serving streamed cancel_stale={cancel}: 4 x Cholesky NT {SERVING_STREAM_NT} "
              f"{spec} activations={card['acts']} launches={lc} wall_s={card['wall']:.6f} "
              f"cpu_wall_s={cpu['wall']:.6f} makespans={row['makespans']}", flush=True)
        streamed.append(row)

    # C9: the scenario matrix at the fast shape against the CPU, then at
    # full depth on the card
    c9 = {}
    for shape, (seeds, nt, churn) in (("fast", sm.FAST), ("full", sm.FULL)):
        w0 = time.perf_counter()
        rows, checks = sm.run_matrix(seeds, nt, churn, device="cuda", verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        cpu_wall = None
        if shape == "fast":
            w0 = time.perf_counter()
            cpu_rows, cpu_checks = sm.run_matrix(seeds, nt, churn, device="cpu", verbose=False)
            cpu_wall = time.perf_counter() - w0
            if (rows, checks) != (cpu_rows, cpu_checks):
                raise SystemExit("serving C9 fast: the card's rows differ from the CPU's")
        ok = sm.print_checks(checks)
        print(f"serving C9 {shape}: {seeds} seeds, NT {nt}, churn {churn}: {len(rows)} rows, "
              f"{sum(c['passed'] for c in checks)}/{len(checks)} claims pass, wall {wall:.3f} s"
              + ("" if cpu_wall is None else f", CPU {cpu_wall:.3f} s"), flush=True)
        if not ok:
            raise SystemExit(f"serving C9 {shape}: a claim failed")
        c9[shape] = dict(seeds=seeds, nt=nt, churn=list(churn), rows=rows, checks=checks,
                         wall_s=wall, cpu_wall_s=cpu_wall)
    launches = read()
    wall = time.perf_counter() - w_phase
    print(f"serving: {len(sweep)} sweep runs, the probe, {len(admission)} admission runs, "
          f"{len(streamed)} streamed runs and C9, every run equal to its CPU twin; launches "
          f"{launches}; phase wall {wall:.3f} s", flush=True)
    entry = dict(card=card_line(), sweep=sweep, probe=probe, admission=admission,
                 streamed=streamed, c9=c9, launches=launches, wall_s=wall)
    return entry, launches


def place_check(sp, dev):
    """Both placement kernels against their plain versions over the case
    matrix (seeded activations of ``tests/_place_cases.py``, packed as the
    backend packs them); returns (cases, max |kernel - plain| over λ, loads
    and finish times)."""
    from _place_cases import (LIVE_KINDS, MID_ROUND, dada_case, heft_case, live_case,
                              live_heft_case, packed_dada, packed_heft)

    n_cases, max_err = 0, 0.0
    cases = []
    # searches cut short inside a round of the midpoint tree, wide
    # activations (every staging level, shallower trees), HEFT's ring
    for n in (37, 128):
        for accel in PLACE_MACHINES.values():
            for seed, max_iters, eps_rel in MID_ROUND:
                cases.append(("dada", packed_dada(dada_case(seed, n=n, accel=accel,
                                                            max_iters=max_iters, eps_rel=eps_rel))))
    for n in PLACE_WIDE_N:
        for seed in (0, 4, 9, 13):
            cases.append(("dada", packed_dada(dada_case(seed, n=n, accel=PLACE_MACHINES["paper"]))))
    for n, n_res in PLACE_HEFT_RING:
        cases.append(("heft", packed_heft(heft_case(len(cases), n=n, n_res=n_res))))
    for n in PLACE_N:
        for accel in PLACE_MACHINES.values():
            for alpha in (0.0, 0.5, 1.0):
                for use_cp in (False, True):
                    for area_bound in (False, True):
                        for max_iters in (1, 30):
                            cases.append(("dada", packed_dada(dada_case(
                                len(cases), n=n, accel=accel, alpha=alpha, use_cp=use_cp,
                                area_bound=area_bound, max_iters=max_iters))))
        for n_res in (2, 14, 40, 70):
            for _ in range(4):
                cases.append(("heft", packed_heft(heft_case(len(cases), n=n, n_res=n_res))))
    # liveness: dead and noticed resources (the plans take the penalties'
    # shared memory), wide ones included
    for n in (1, 37, 128, 1500):
        for live in LIVE_KINDS:
            for seed in range(8 if n < 1500 else 2):
                accel = PLACE_MACHINES["paper"] if seed % 2 else None
                cases.append(("dada", packed_dada(live_case(
                    seed, live, n=n, accel=None if live in ("one_gpu", "one_cpu") else accel,
                    area_bound=bool(seed % 3 == 1) if seed % 4 else None))))
    for seed in range(24):
        for dead, noticed in (((0,), ()), ((0, 2), (1,)), ((), (0, 3)), ((1, 3, 4, 5, 6), ())):
            cases.append(("heft", packed_heft(live_heft_case(seed, dead=dead, noticed=noticed))))
    for kind, (layout, buf, scores) in cases:
        kernel = sp.dada_place if kind == "dada" else sp.heft_select
        want_t = kernel(buf, scores, layout)
        before = kernel.launches
        got_t = kernel(buf.to(dev), scores.to(dev), layout)
        torch.cuda.synchronize()
        if kernel.launches != before + 1:
            raise SystemExit(f"{kernel.__name__} did not count its launch")
        got_t = got_t.cpu()
        want, got = sp.read_placement(want_t.numpy(), layout), sp.read_placement(got_t.numpy(), layout)
        exact = torch.equal(got_t, want_t) and got.rids == want.rids
        if kind == "dada":
            exact = exact and got.lam == want.lam and got.loads == want.loads and got.status == want.status
            if want.status != sp.STATUS_OK:
                raise SystemExit(f"dada_place: λ = upper infeasible at {layout.spec}")
            diffs = [abs(got.lam - want.lam)] + [abs(a - b) for a, b in zip(got.loads, want.loads)]
        else:
            exact = exact and got.efts == want.efts
            # a finish time is +inf only where every resource is dead (none here)
            diffs = [abs(a - b) for a, b in zip(got.efts, want.efts)]
        if not exact:
            raise SystemExit(f"{kernel.__name__} disagrees with its plain version at {layout.spec}: "
                             f"{got} vs {want}"[:2000])
        max_err = max([max_err] + diffs)
        n_cases += 1
    return n_cases, max_err


def place_plan_check(sp):
    """PlaceSpec.plan (the Python mirror) against the launchers' own plan
    (repro_place_plan) at the shapes this phase launches; returns the plans
    of the main path's widest activation (n 128 on paper_machine(8)).
    tests/test_torch_cuda.py checks the envelope's edges."""
    import ctypes

    got = (ctypes.c_int64 * 4)()
    shapes = [("dada", n, 12, 4, 8, 0, live) for n in PLACE_WIDTHS + PLACE_WIDE_N
              for live in (False, True)]
    shapes += [("dada", n, 12, 4, 6, 0, True) for n in (1500, 1900, 12880)]
    shapes += [("heft", n, 12, 0, 0, 2, False) for n in PLACE_WIDTHS]
    shapes += [("heft", n, n_res, 0, 0, 2, False) for n, n_res in PLACE_HEFT_RING]
    for kind, n, n_res, n_cpu, n_gpu, n_cls, live in shapes:
        spec = sp.PlaceSpec(kind, n, n_res, n_cpu=n_cpu, n_gpu=n_gpu, n_cls=n_cls, live=live)
        if spec.plan is None:
            continue
        err = sp._lib.repro_place_plan(int(kind == "heft"), n, n_res, n_cpu, n_gpu, n_cls,
                                       int(live), got)
        if err != 0 or tuple(got[:3]) != spec.plan:
            raise SystemExit(f"the launcher's plan {tuple(got)} (err {err}) differs from "
                             f"PlaceSpec.plan {spec.plan} at {spec}")
    dada = sp.PlaceSpec("dada", 128, 12, n_cpu=4, n_gpu=8).plan
    heft = sp.PlaceSpec("heft", 128, 12, n_cls=2).plan
    print(f"launch plans equal PlaceSpec.plan on {len(shapes)} shapes; at n 128 on "
          f"paper_machine(8): dada_place depth d={dada[0]} ({(1 << dada[0]) - 1} warps), staging "
          f"level {dada[1]}, {dada[2]} B shared; heft_select {heft[0]} tasks a buffer x {heft[1]} "
          f"buffer(s), {heft[2]} B shared")
    return {"dada_place": dict(zip(("depth", "stage", "smem_bytes"), dada)),
            "heft_select": dict(zip(("group", "buffers", "smem_bytes"), heft))}


def place_timing(sp, ss, name, spec, sim, tids, machine, resolve, dev, place_ptxas):
    """One placement kernel at one activation of ``sim`` (the tasks
    ``tids``, the strategy's own preamble): ms per launch (CUDA events),
    device ms from a CUDA-graph replay, the plain version's ms on the host,
    a whole place_dada / place_heft call on the card and on the CPU, the
    bound, the plan, and (DADA) probes and rounds of the tree. Checks the
    kernel and both calls against the plain placement."""
    from repro_torch.runtime.memory import pressure_rows_for

    strategy, cpu_strategy = resolve(spec), resolve(spec, device="cpu")
    res = machine.resources
    if name == "dada_place":
        p_cpu, p_gpu, section = strategy.preamble(sim, tids)
        pspec = sp.PlaceSpec("dada", len(tids), len(res), n_cpu=len(section["cpu_rids"]),
                             n_gpu=len(section["gpu_rids"]), live="pen" in section)
        score_kw = dict(p_cpu=p_cpu, p_gpu=p_gpu, use_cp=True, affinity="accel_write")
        call_kw = dict(score_kw, area_bound=False, **section)
    else:
        scan = strategy.preamble(sim, tids)
        pspec = sp.PlaceSpec("heft", len(tids), len(res), n_cls=len(scan["durations"]))
        # the pressure channel: +inf over detached columns, notice penalties
        P = pressure_rows_for(sim, tids, res)
        score_kw = dict(use_cp=True, x_rows=True, x_bias=P)
        call_kw = dict(scan, x_bias=P)
    layout, packed, mach = strategy.backend.pack(sim, tids, res, place=pspec, **score_kw)
    if name == "dada_place":
        sp.pack_dada(packed.numpy(), layout, tids=tids, **section)
    else:
        sp.pack_heft(packed.numpy(), layout, **scan)
    live = "live " if (name == "dada_place" and pspec.live) or (
        name == "heft_select" and score_kw["x_bias"] is not None) else ""
    kernel = getattr(sp, name)
    cpu_in = packed.clone()
    cpu_scores = ss.score_activation(cpu_in[:layout.score.n_in], layout.score, mach.cpu())
    d_in = cpu_in.to(dev)
    d_scores = ss.score_activation(d_in[:layout.score.n_in], layout.score, mach)
    d_out = torch.empty(layout.n_out, dtype=torch.int64, device=dev)
    want = kernel(cpu_in, cpu_scores, layout)
    kernel(d_in, d_scores, layout, out=d_out)
    if not torch.equal(d_out.cpu(), want):
        raise SystemExit(f"{name} disagrees with its plain version at n {len(tids)}")
    ms = time_ms(lambda: kernel(d_in, d_scores, layout, out=d_out))
    device_ms = graph_ms(lambda: kernel(d_in, d_scores, layout, out=d_out))
    reps = 20 if len(tids) <= 128 else 5
    w0 = time.perf_counter()
    for _ in range(reps):
        kernel(cpu_in, cpu_scores, layout)
    plain_ms = (time.perf_counter() - w0) / reps * 1e3
    call = {}  # a whole place_dada / place_heft call, card and CPU
    method = "place_dada" if name == "dada_place" else "place_heft"
    for d, st in (("cuda", strategy), ("cpu", cpu_strategy)):
        fn = getattr(st.backend, method)
        for _ in range(10):
            fn(sim, tids, res, **call_kw)
        reps = 300 if d == "cuda" else (50 if len(tids) <= 128 else 10)
        w0 = time.perf_counter()
        for _ in range(reps):
            got = fn(sim, tids, res, **call_kw)
        call[d] = (time.perf_counter() - w0) / reps * 1e3
        if got != sp.read_placement(want.numpy(), layout):
            raise SystemExit(f"{method} on {d} differs from the plain placement")
    n, n_res = len(tids), len(res)
    got = sp.read_placement(want.numpy(), layout)
    plan = layout.spec.plan
    # bytes: the scorer outputs read (C, S, the row maxima; X for HEFT),
    # the class durations and the section read, the placement written;
    # operations (f64, compares counted): per probe and task one addition
    # and one compare per candidate resource, plus the preference scan
    # and the bound (DADA); three additions and two compares per task and
    # resource (HEFT). The dependent chain: rounds x tasks (DADA: a round
    # places the tasks one after another), tasks (HEFT)
    sec = layout.n_in - layout.score.n_in
    if name == "dada_place":
        nbytes = 8 * (2 * n * n_res + n + 2 * n + sec + layout.n_out)
        ops = max(got.iters, 1) * 2 * n * n_res + n * n_res + n
        rounds = -(-got.iters // plan[0]) if got.iters else 1
        chain = rounds * n
    else:
        nbytes = 8 * (n * n_res + sec + layout.n_out)
        ops = 5 * n * n_res
        rounds = None
        chain = n
    bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    ops_ms = ops / H100_FP64_FLOPS * 1e3
    row = dict(
        n=n, n_res=n_res, plan=list(plan), iters=getattr(got, "iters", None), rounds=rounds,
        chain_steps=chain, ms=ms, device_ms=device_ms, plain_ms=plain_ms, call_ms=call["cuda"],
        cpu_call_ms=call["cpu"], bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations", bytes=nbytes, flop=ops,
        smem_bytes=layout.spec.smem_bytes, live=bool(live),
        ptxas=[r for r in place_ptxas if name.split("_")[0] in r["function"]],
    )
    tree = (f"depth d={plan[0]}, staging level {plan[1]}, probes {got.iters}, rounds {rounds}"
            if name == "dada_place" else f"{plan[0]} tasks a buffer x {plan[1]} buffer(s)")
    print(f"{live}{name} at n={n} n_res={n_res} (LU NT 64's first {n} tasks): kernel {ms:.6f} ms per "
          f"launch ({device_ms:.6f} ms on the device, from a CUDA graph), plain {plain_ms:.6f} ms "
          f"on the host; a whole {method} call {call['cuda']:.6f} ms on the card, "
          f"{call['cpu']:.6f} ms with device='cpu'; bound {row['bound_ms']:.3e} ms ({nbytes} "
          f"bytes, {ops} flop); dependent chain {chain} steps; {tree}; dynamic smem "
          f"{layout.spec.smem_bytes} B", flush=True)
    return row


# DADA under the missing_bytes affinity (S from the reads' sizes by the
# scorer's s_missing flag): its specs, and the place phase's runs of them
MISSING_SPECS = ("dada?alpha=0.5&affinity=missing_bytes",
                 "dada?alpha=0.5&use_cp=1&affinity=missing_bytes")


def missing_bytes_runs(ss, sp, resolve, Simulator, builders, machine):
    """DADA(0.5) and DADA(0.5)+CP with ``affinity="missing_bytes"`` over
    Cholesky, LU and QR at NT 16 (tile 512) on ``machine``: each card run,
    the kernels' counts set to 0 just before it and read just after, must
    equal its device="cpu" twin and score and place every activation on the
    card, one score_activation and one dada_place launch each. Returns the
    rows and the launches by kernel."""
    rows, launches = [], {"score_activation": 0, "dada_place": 0}
    for gname, build in builders.items():
        for spec in MISSING_SPECS:
            got = {}
            for device in ("cuda", "cpu"):
                strategy = resolve(spec, device=device)
                place, placed = strategy.backend.place_dada, [0]

                def counted(*args, place=place, placed=placed, **kwargs):
                    placed[0] += 1
                    return place(*args, **kwargs)

                strategy.backend.place_dada = counted
                sim = Simulator(build(16, 512), machine, strategy, seed=0)
                ss.score_activation.launches = sp.dada_place.launches = 0
                sp.heft_select.launches = ss.transfer_matrix.launches = 0
                plain0 = sp.dada_place_plain.calls
                w0 = time.perf_counter()
                res = sim.run()
                torch.cuda.synchronize()
                got[device] = dict(
                    res=res, wall=time.perf_counter() - w0, placed=placed[0],
                    score=ss.score_activation.launches, dada=sp.dada_place.launches,
                    other=sp.heft_select.launches + ss.transfer_matrix.launches,
                    plain=sp.dada_place_plain.calls - plain0)
            card, cpu = got["cuda"], got["cpu"]
            n = card["placed"]
            print(f"missing_bytes run graph={gname} NT=16 strategy={card['res'].strategy} "
                  f"spec={spec} placed={n} score_launches={card['score']} "
                  f"dada_place_launches={card['dada']} makespan={card['res'].makespan!r} "
                  f"total_bytes={card['res'].total_bytes} wall_s={card['wall']:.6f} "
                  f"cpu_wall_s={cpu['wall']:.6f}", flush=True)
            if fingerprint(card["res"]) != fingerprint(cpu["res"]) or n != cpu["placed"]:
                raise SystemExit(f"missing_bytes {gname} {spec}: the card run differs from the CPU's")
            if n == 0 or not card["score"] == card["dada"] == n or card["other"] or card["plain"]:
                raise SystemExit(f"missing_bytes {gname} {spec}: {card['score']} scoring and "
                                 f"{card['dada']} dada_place launches ({card['other']} others, "
                                 f"{card['plain']} plain searches) for {n} placed activations")
            if cpu["score"] or cpu["dada"] or cpu["other"]:
                raise SystemExit("the CPU run launched a kernel")
            launches["score_activation"] += card["score"]
            launches["dada_place"] += card["dada"]
            rows.append(dict(graph=gname, spec=spec, placed=n, makespan=card["res"].makespan,
                             total_bytes=card["res"].total_bytes, wall_s=card["wall"],
                             cpu_wall_s=cpu["wall"]))
    print(f"missing_bytes: {len(rows)} runs equal to their CPU twins, launches {launches}, one "
          f"score_activation and one dada_place per placed activation", flush=True)
    return rows, launches


def launch_counts(prof):
    """Device kernels and memcpys of a torch.profiler run, and the runtime
    calls that issued them."""
    out = dict(kernels=0, memcpy=0, memset=0, launch_calls=0, memcpy_calls=0, sync_calls=0)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kind = "memcpy" if e.key.startswith("Memcpy") else (
                "memset" if e.key.startswith("Memset") else "kernels")
            out[kind] += e.count
        elif e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            out["launch_calls"] += e.count
        elif e.key.startswith("cudaMemcpy"):
            out["memcpy_calls"] += e.count
        elif e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize"):
            out["sync_calls"] += e.count
    return out


def time_ms(fn, reps=200):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=100):
    """Device time of ``fn``'s kernels alone: ``reps`` calls captured in
    one CUDA graph and replayed, so no host launch cost is timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (10 * reps)


def fingerprint(res):
    return (
        res.makespan, res.total_bytes, res.n_transfers,
        tuple(sorted(res.busy.items())),
        tuple((iv.tid, iv.rid, iv.start, iv.end) for iv in res.intervals),
    )


def rel_err(x, y) -> float:
    return ((x - y).abs().max() / y.abs().max().clamp_min(1e-30)).item()


def must_refuse(what, fn, kernel):
    before = kernel.launches
    try:
        fn()
    except ValueError as e:
        print(f"  refused {what}: {e}")
    else:
        raise SystemExit(f"{kernel.__name__} did not refuse {what}")
    if kernel.launches != before:
        raise SystemExit(f"{kernel.__name__} launched while refusing {what}")


def gemm_check(tg, dev):
    """The kernel against its plain version on the card and on the CPU
    over the sweep; returns the largest |kernel - plain| seen."""
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")
    shapes = [(64, 64, 64), (128, 128, 128), (256, 128, 384), (384, 256, 128),
              (512, 512, 512), (1024, 512, 1024)]
    rng = np.random.default_rng(0)
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_cases = 0
    for m, n, k in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            tol = GEMM_TOL[dtype]
            for trans_b in (False, True):
                host = [
                    torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(dtype)
                    for sh in ((m, n), (m, k), (n, k) if trans_b else (k, n))
                ]
                c, a, b = (t.to(dev) for t in host)
                splits = tg.gemm_plan(m, n, k)[2] > 1
                for alpha in (-1.0, 1.0, 0.5):
                    before = tg.gemm_update.launches_split
                    got = tg.gemm_update(c, a, b, alpha=alpha, trans_b=trans_b)
                    if tg.gemm_update.launches_split - before != splits:
                        raise SystemExit(f"gemm_update.launches_split did not follow the plan at {(m, n, k)}")
                    plain_card = tg.gemm_update_plain(c, a, b, alpha=alpha, trans_b=trans_b)
                    plain_cpu = tg.gemm_update_plain(*host, alpha=alpha, trans_b=trans_b)
                    torch.cuda.synchronize()
                    g = got.cpu().float()
                    if got.shape != (m, n) or got.dtype != dtype or not torch.isfinite(g).all():
                        raise SystemExit(f"gemm_update output malformed at {(m, n, k)} {dtype}")
                    for want in (plain_card.cpu().float(), plain_cpu.float()):
                        bad = (g - want).abs() > tol * k ** 0.5 + tol * want.abs()
                        if bad.any():
                            raise SystemExit(
                                f"gemm_update disagrees with its plain version at {(m, n, k)} "
                                f"{dtype} alpha={alpha} trans_b={trans_b}: "
                                f"max |diff| {(g - want).abs().max().item()}"
                            )
                    max_err[dtype] = max(max_err[dtype], (g - plain_card.cpu().float()).abs().max().item())
                    n_cases += 1
            a_h = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(dtype)
            b_h = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(dtype)
            got = tg.matmul(a_h.to(dev), b_h.to(dev)).cpu().float()
            want = tg.matmul_plain(a_h, b_h).float()
            if ((got - want).abs() > tol * k ** 0.5 + tol * want.abs()).any():
                raise SystemExit(f"matmul disagrees with its plain version at {(m, n, k)} {dtype}")
            n_cases += 1
    print(
        f"gemm_update within TOL of its plain version (card and CPU) on {n_cases} cases; "
        f"max |kernel - plain on the card|: f32 {max_err[torch.float32]}, "
        f"bf16 {max_err[torch.bfloat16]}"
    )
    # plans the planner does not pick: the last split one stage, or ragged
    n_edge = 0
    for m, n, k, plan in GEMM_SPLIT_EDGES:
        for dtype in (torch.float32, torch.bfloat16):
            tol = GEMM_TOL[dtype]
            for trans_b in (False, True):
                host = [
                    torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(dtype)
                    for sh in ((m, n), (m, k), (n, k) if trans_b else (k, n))
                ]
                got = tg._launch(*(t.to(dev) for t in host), alpha=0.5, trans_b=trans_b, plan=plan)
                g = got.cpu().float()
                want = tg.gemm_update_plain(*host, alpha=0.5, trans_b=trans_b).float()
                if ((g - want).abs() > tol * k ** 0.5 + tol * want.abs()).any():
                    raise SystemExit(f"gemm_update disagrees with its plain version at {(m, n, k)} "
                                     f"{dtype} plan {plan} trans_b={trans_b}")
                max_err[dtype] = max(max_err[dtype], (g - want).abs().max().item())
                n_edge += 1
    # views one element off a 16-byte boundary with an odd row stride give
    # the bits of their contiguous copies
    n_views = 0
    for dtype in (torch.float32, torch.bfloat16):
        whole = torch.from_numpy(rng.standard_normal((1200, 1201)).astype(np.float32)).to(dtype).to(dev)
        for m, n, k in ((512, 512, 512), (100, 72, 384)):
            for trans_b in (False, True):
                c, a = whole[1:1 + m, 1:1 + n], whole[3:3 + m, 5:5 + k]
                b = whole[600:600 + (n if trans_b else k), 601:601 + (k if trans_b else n)]
                got = tg.gemm_update(c, a, b, trans_b=trans_b)
                want = tg.gemm_update(c.contiguous(), a.contiguous(), b.contiguous(), trans_b=trans_b)
                if not torch.equal(got, want):
                    raise SystemExit(f"a misaligned view differs from its contiguous copy at {(m, n, k)} "
                                     f"{dtype} trans_b={trans_b}")
                n_views += 1
    # two calls give equal bits; a CUDA-graph replay equals eager
    for m, n, k, trans_b in ((512, 512, 512, True), (1024, 512, 1024, False)):
        c, a, b = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(dev)
                   for sh in ((m, n), (m, k), (n, k) if trans_b else (k, n)))
        first = tg.gemm_update(c, a, b, trans_b=trans_b)
        if not torch.equal(first, tg.gemm_update(c, a, b, trans_b=trans_b)):
            raise SystemExit(f"two gemm_update calls differ at {(m, n, k)}")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            tg.gemm_update(c, a, b, trans_b=trans_b)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = tg.gemm_update(c, a, b, trans_b=trans_b)
        replayed.zero_()
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(replayed, first):
            raise SystemExit(f"gemm_update's CUDA-graph replay differs from eager at {(m, n, k)}")
    print(f"gemm_update: {n_edge} split-edge cases within TOL; {n_views} misaligned odd-stride views "
          f"equal to their contiguous copies; two calls and a CUDA-graph replay bit-equal")
    splits_before = tg.gemm_update.launches_split
    y = torch.zeros(100, 100, device=dev)
    must_refuse("a non-tiling shape", lambda: tg.gemm_update(y, y, y, bm=64, bn=64, bk=64),
                tg.gemm_update)
    x = torch.zeros(64, 64, dtype=torch.float64, device=dev)
    must_refuse("an f64 CUDA tensor", lambda: tg.gemm_update(x, x, x), tg.gemm_update)
    z = torch.zeros(512, 512, device=dev)
    must_refuse("mixed types at a splitting shape", lambda: tg.gemm_update(z, z.bfloat16(), z),
                tg.gemm_update)
    if tg.gemm_update.launches_split != splits_before:
        raise SystemExit("gemm_update counted a split launch while refusing")
    return {str(dt).replace("torch.", ""): err for dt, err in max_err.items()}


def gemm_timing(tg, dev):
    """Kernel, plain-version and library times at the linalg path's shapes;
    returns one row per (shape, dtype). gemm_update is set beside
    torch.addmm; matmul (no C, as tsmqr calls it) beside torch.mm, and its
    bound counts no read of C."""
    cases = [("syrk/gemm", 512, 512, 512, True, -1.0), ("ssssm", 512, 512, 512, False, -1.0),
             ("tsmqr (matmul)", 1024, 512, 1024, False, None)]
    rows = []
    rng = np.random.default_rng(2)
    for label, m, n, k, trans_b, alpha in cases:
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(dtype).to(dev)
            b = torch.from_numpy(
                rng.standard_normal((n, k) if trans_b else (k, n)).astype(np.float32)
            ).to(dtype).to(dev)
            plan = tg.gemm_plan(m, n, k)
            if alpha is None:  # matmul: A @ B, no C
                kernel = lambda: tg.matmul(a, b)  # noqa: E731
                plain = lambda: tg.matmul_plain(a, b)  # noqa: E731
                library = lambda: torch.mm(a, b)  # noqa: E731
                library_name, c_reads = "torch.mm", 0
            else:
                c = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(dtype).to(dev)
                bt = b.T if trans_b else b
                kernel = lambda: tg.gemm_update(c, a, b, alpha=alpha, trans_b=trans_b)  # noqa: E731
                plain = lambda: tg.gemm_update_plain(c, a, b, alpha=alpha, trans_b=trans_b)  # noqa: E731
                library = lambda: torch.addmm(c, a, bt, alpha=alpha)  # noqa: E731
                library_name, c_reads = "torch.addmm", m * n
            ms, device_ms = time_ms(kernel), graph_ms(kernel)
            plain_ms, plain_device_ms = time_ms(plain), graph_ms(plain)
            library_ms, library_device_ms = time_ms(library), graph_ms(library)
            flops = 2 * m * n * k
            nbytes = (c_reads + m * n + m * k + k * n) * a.element_size()
            peak = H100_FP32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
            ops_ms = flops / peak * 1e3
            bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
            bound_ms = max(ops_ms, bytes_ms)
            row = {
                "label": label, "shape": [m, n, k], "trans_b": trans_b, "alpha": alpha,
                "plan": {"bm": plan[0], "bn": plan[1], "n_split": plan[2], "k_chunk": plan[3],
                         "blocks": -(-m // plan[0]) * -(-n // plan[1]) * plan[2]},
                "dtype": str(dtype).replace("torch.", ""), "ms": ms, "device_ms": device_ms,
                "plain_ms": plain_ms, "plain_device_ms": plain_device_ms, "library": library_name,
                "library_ms": library_ms, "library_device_ms": library_device_ms, "bound_ms": bound_ms,
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "tflops": flops / device_ms / 1e9, "share_of_bound": bound_ms / device_ms,
            }
            rows.append(row)
            print(
                f"gemm_update {label} (m,n,k)={(m, n, k)} {row['dtype']} plan {row['plan']}: kernel {ms:.6f} ms "
                f"per call ({device_ms:.6f} ms on the device, from a CUDA graph), plain "
                f"{plain_ms:.6f} ms ({plain_device_ms:.6f}), {library_name} {library_ms:.6f} ms "
                f"({library_device_ms:.6f}), bound {bound_ms:.6f} ms "
                f"({row['bound_by']}: {flops} flop, {nbytes} bytes), {row['tflops']:.3f} TFLOP/s "
                f"on the device, {100 * row['share_of_bound']:.2f} % of the bound",
                flush=True,
            )
    return rows


def device_time(prof, skip=()):
    """Device time of a torch.profiler run: the total (us) and each
    kernel's, largest first (``skip``: record_function range names, whose
    device-side spans are no kernels)."""
    by_name = {
        e.key: e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.key not in skip
    }
    return sum(by_name.values()), sorted(by_name.items(), key=lambda kv: -kv[1])


def residual(kind, a, m) -> float:
    """The reference tests' residuals (tests/test_linalg.py)."""
    if kind == "cholesky":
        low = torch.tril(m)
        return rel_err(low @ low.T, a)
    if kind == "lu":
        low = torch.tril(m, -1) + torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
        return rel_err(low @ torch.triu(m), a)
    r = torch.triu(m)
    return rel_err(r.T @ r, a.T @ a)


def dense_residual(kind, a) -> float:
    """The same residual of the card's own dense factorization of the
    whole matrix (a yardstick only)."""
    if kind == "cholesky":
        low = torch.linalg.cholesky(a)
        return rel_err(low @ low.T, a)
    if kind == "lu":
        p, low, up = torch.linalg.lu(a)
        return rel_err(p @ (low @ up), a)
    r = torch.linalg.qr(a, mode="r")[1]
    return rel_err(r.T @ r, a.T @ a)


def r_rows_signed(m):
    """R with each row's sign set so that its diagonal is non-negative:
    QR factors are unique only up to these signs."""
    r = torch.triu(m)
    s = torch.sign(torch.diagonal(r))
    return r * torch.where(s == 0, torch.ones_like(s), s)[:, None]


def _draw(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def attention_check(fa, fd, dev):
    """Both attention kernels against their plain versions on the card and
    on the CPU, on every route, with dv = dk and with MLA's dv != dk;
    returns the largest |kernel - plain on the card| of each, by route,
    over all cases and over the dv != dk cases."""
    rng = np.random.default_rng(0)
    fa_err_dv, fd_err_dv = {}, {}
    fa_err = {}
    routes = {}
    attn_cases = [(*c[:6], c[5], c[6]) for c in ATTN_CASES] + ATTN_DV_CASES  # (.., dk, dv, causal)
    for dtype in (torch.float32, torch.bfloat16):
        tol = ATTN_TOL[dtype]
        for B, hq, hk, sq, sk, d, dv, causal in attn_cases:
            if B is None:
                host = [_draw(rng, s, dtype) for s in ((hq, sq, d), (hk, sk, d), (hk, sk, dv))]
                args = [t.to(dev) for t in host]
            else:  # the model's call: (B, S, H, d) projections as (B, H, S, d) views
                raw = [_draw(rng, s, dtype) for s in ((B, sq, hq, d), (B, sk, hk, d), (B, sk, hk, dv))]
                host = [t.transpose(1, 2) for t in raw]
                args = [t.to(dev).transpose(1, 2) for t in raw]
            route = fa.attention_route(*args)
            before = fa.flash_attention.launches_tc
            got = fa.flash_attention(*args, causal=causal)
            want_card = fa.flash_attention_plain(*args, causal=causal)
            torch.cuda.synchronize()
            g = got.cpu().float()
            shape = tuple(host[0].shape[:-1]) + (dv,)
            if tuple(got.shape) != shape or got.dtype != dtype or not torch.isfinite(g).all():
                raise SystemExit(f"flash_attention output malformed at {shape} {dtype}")
            if fa.flash_attention.launches_tc - before != (route == "tc"):
                raise SystemExit(f"flash_attention at {shape} {dtype}: the counters disagree "
                                 f"with the route {route}")
            routes[route] = routes.get(route, 0) + 1
            wants = [want_card.cpu().float()]
            if B is None or sq <= SERVE_PROMPT:  # the CPU plain run of the big case is slow
                wants.append(fa.flash_attention_plain(*host, causal=causal).float())
            for want in wants:
                if ((g - want).abs() > tol + tol * want.abs()).any():
                    raise SystemExit(
                        f"flash_attention disagrees with its plain version at {shape} "
                        f"{dtype} causal={causal}: max |diff| {(g - want).abs().max().item()}")
            err = (g - wants[0]).abs().max().item()
            fa_err[route] = max(fa_err.get(route, 0.0), err)
            print(f"  flash_attention {shape} kv heads {hk} dk {d} dv {dv} {str(dtype)[6:]} "
                  f"causal={causal}: "
                  f"route {route}, max |kernel - plain| {err}")
            if dv != d:
                fa_err_dv[route] = max(fa_err_dv.get(route, 0.0), err)
            del got, want_card, args
    print(f"flash_attention within tol of its plain version (card and CPU) on "
          f"{2 * len(attn_cases)} cases, by route {routes}; max |kernel - plain on the card| "
          f"by route {fa_err}; with dv != dk {fa_err_dv}")
    fd_err = {}
    routes = {}
    decode_cases = [(*c[:5], c[4], c[5]) for c in DECODE_CASES] + DECODE_DV_CASES
    for dtype in (torch.float32, torch.bfloat16):
        tol = DECODE_TOL[dtype]
        for B, hq, hk, S, hd, dv, length in decode_cases:
            host = [_draw(rng, s, dtype) for s in ((B, hq, hd), (B, S, hk, hd), (B, S, hk, dv))]
            args = [t.to(dev) for t in host]
            route = fd.decode_route(*args)
            before = fd.flash_decode.launches_split
            got = fd.flash_decode(*args, length)
            want_card = fd.flash_decode_plain(*args, length)
            torch.cuda.synchronize()
            g = got.cpu().float()
            if tuple(got.shape) != (B, hq, dv) or got.dtype != dtype or not torch.isfinite(g).all():
                raise SystemExit(f"flash_decode output malformed at {(B, hq, hk, S, hd, dv)} {dtype}")
            if fd.flash_decode.launches_split - before != (route == "split"):
                raise SystemExit(f"flash_decode at {(B, hq, hk, S, hd)} {dtype}: the counters "
                                 f"disagree with the route {route}")
            routes[route] = routes.get(route, 0) + 1
            wants = [want_card.cpu().float()]
            if S <= 4096:
                wants.append(fd.flash_decode_plain(*host, length).float())
            for want in wants:
                if ((g - want).abs() > tol + tol * want.abs()).any():
                    raise SystemExit(
                        f"flash_decode disagrees with its plain version at "
                        f"{(B, hq, hk, S, hd, length)} {dtype}: max |diff| "
                        f"{(g - want).abs().max().item()}")
            err = (g - wants[0]).abs().max().item()
            fd_err[route] = max(fd_err.get(route, 0.0), err)
            if dv != hd:
                fd_err_dv[route] = max(fd_err_dv.get(route, 0.0), err)
            splits = fd.decode_splits(B, hk, length)[1] if route == "split" else None
            print(f"  flash_decode {(B, hq, hk, S, hd)} dv {dv} length {length} {str(dtype)[6:]}: "
                  f"route {route}" + (f" ({splits} splits)" if splits else "")
                  + f", max |kernel - plain| {err}")
            del got, want_card, args
    print(f"flash_decode within tol of its plain version (card and CPU) on "
          f"{2 * len(decode_cases)} cases, by route {routes}; max |kernel - plain on the card| "
          f"by route {fd_err}; with dv != dk {fd_err_dv}")
    # unaligned bf16 views take the SIMT routes, by the counters
    raw = [_draw(rng, s, torch.bfloat16).to(dev) for s in ((8, 96, 136), (2, 96, 136))]
    q, kv = (t[..., 1:129] for t in raw)
    before = (fa.flash_attention.launches, fa.flash_attention.launches_tc)
    got = fa.flash_attention(q, kv, kv)
    err = (got.float() - fa.flash_attention_plain(q, kv, kv).float()).abs().max().item()
    if (fa.attention_route(q, kv, kv) != "simt" or err > ATTN_TOL[torch.bfloat16]
            or (fa.flash_attention.launches, fa.flash_attention.launches_tc) != (before[0] + 1, before[1])):
        raise SystemExit(f"flash_attention on an unaligned view: not the SIMT route, or wrong ({err})")
    cache = _draw(rng, (2, 96, 2, 136), torch.bfloat16).to(dev)[..., 1:129]
    qd = _draw(rng, (2, 32, 136), torch.bfloat16).to(dev)[..., 1:129]
    before = (fd.flash_decode.launches, fd.flash_decode.launches_split)
    got = fd.flash_decode(qd, cache, cache, 90)
    err = (got.float() - fd.flash_decode_plain(qd, cache, cache, 90).float()).abs().max().item()
    if (fd.decode_route(qd, cache, cache) != "simt" or err > DECODE_TOL[torch.bfloat16]
            or (fd.flash_decode.launches, fd.flash_decode.launches_split) != (before[0] + 1, before[1])):
        raise SystemExit(f"flash_decode on an unaligned view: not the SIMT route, or wrong ({err})")
    # and with MLA's widths: q / k 96 wide, v 64, cut one element in
    raw = [_draw(rng, s, torch.bfloat16).to(dev) for s in ((8, 96, 104), (8, 96, 104), (8, 96, 72))]
    q, k, v = raw[0][..., 1:97], raw[1][..., 1:97], raw[2][..., 1:65]
    before = (fa.flash_attention.launches, fa.flash_attention.launches_tc)
    err = (fa.flash_attention(q, k, v).float() - fa.flash_attention_plain(q, k, v).float()).abs().max().item()
    if (fa.attention_route(q, k, v) != "simt" or err > ATTN_TOL[torch.bfloat16]
            or (fa.flash_attention.launches, fa.flash_attention.launches_tc) != (before[0] + 1, before[1])):
        raise SystemExit(f"flash_attention on an unaligned dv-64 view: not the SIMT route, or wrong ({err})")
    fa_err_dv["simt"] = max(fa_err_dv.get("simt", 0.0), err)
    kc = _draw(rng, (2, 90, 8, 104), torch.bfloat16).to(dev)[..., 1:97]
    vc = _draw(rng, (2, 90, 8, 72), torch.bfloat16).to(dev)[..., 1:65]
    qd = _draw(rng, (2, 8, 104), torch.bfloat16).to(dev)[..., 1:97]
    before = (fd.flash_decode.launches, fd.flash_decode.launches_split)
    err = (fd.flash_decode(qd, kc, vc, 77).float() - fd.flash_decode_plain(qd, kc, vc, 77).float()).abs().max().item()
    if (fd.decode_route(qd, kc, vc) != "simt" or err > DECODE_TOL[torch.bfloat16]
            or (fd.flash_decode.launches, fd.flash_decode.launches_split) != (before[0] + 1, before[1])):
        raise SystemExit(f"flash_decode on an unaligned dv-64 view: not the SIMT route, or wrong ({err})")
    fd_err_dv["simt"] = max(fd_err_dv.get("simt", 0.0), err)
    print("unaligned bf16 views: both took the SIMT route and agree with the plain versions "
          "(dk = dv and dk 96, dv 64)")
    for name, errs in (("flash_attention", fa_err_dv), ("flash_decode", fd_err_dv)):
        if set(errs) != ({"tc", "simt"} if name == "flash_attention" else {"split", "simt"}):
            raise SystemExit(f"{name}: the dv != dk cases did not run on every route: {errs}")
    x = torch.zeros(4, 20, 32, device=dev)
    must_refuse("causal sq > sk", lambda: fa.flash_attention(x, x[:2, :10], x[:2, :10]),
                fa.flash_attention)
    must_refuse("an f64 CUDA tensor", lambda: fa.flash_attention(x.double(), x.double(), x.double()),
                fa.flash_attention)
    c = torch.zeros(2, 16, 2, 32, device=dev)
    must_refuse("length 0", lambda: fd.flash_decode(x[:2, :8], c, c, 0), fd.flash_decode)
    must_refuse("a CPU cache", lambda: fd.flash_decode(x[:2, :8], c.cpu(), c.cpu(), 4),
                fd.flash_decode)
    must_refuse("values wider than keys", lambda: fa.flash_attention(x, x, torch.zeros(4, 20, 48, device=dev)),
                fa.flash_attention)
    return fa_err, fd_err, fa_err_dv, fd_err_dv


def attention_timing(fa, fd, dev):
    """Kernel, plain-version and SDPA times at the serving path's shapes;
    returns one row per shape."""
    import torch.nn.functional as F

    rng = np.random.default_rng(3)
    dt = torch.bfloat16
    rows = []
    print(f"attention timing: device memory allocated {torch.cuda.memory_allocated()} bytes, "
          f"reserved {torch.cuda.memory_reserved()} bytes", flush=True)
    B, hq, hk, S, d = SERVE_B, 32, 2, SERVE_PREFILL, 128
    q, k, v = (_draw(rng, (B, S, h, d), dt).to(dev).transpose(1, 2) for h in (hq, hk, hk))
    pairs = S * (S + 1) // 2  # causal (query, key) pairs a head computes
    flops = 4 * d * pairs * B * hq
    nbytes = 2 * (2 * B * S * hq * d + 2 * B * S * hk * d)
    cases = [("flash_attention", f"prefill B{B} S{S} hq{hq} hk{hk} d{d} bf16 causal", flops, nbytes,
              {"route": fa.attention_route(q, k, v)},
              lambda: fa.flash_attention(q, k, v),
              lambda: fa.flash_attention_plain(q, k, v),
              lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True))]
    for B, S, label in ((SERVE_B, SERVE_PROMPT + SERVE_STEPS, "serving step"),
                        (*DECODE_32K, "decode_32k-like")):
        qd = _draw(rng, (B, hq, d), dt).to(dev)
        kc = _draw(rng, (B, S, hk, d), dt).to(dev)
        vc = _draw(rng, (B, S, hk, d), dt).to(dev)
        q4, k4, v4 = qd[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
        cases.append((
            "flash_decode", f"{label} B{B} S{S} hq{hq} hk{hk} d{d} bf16 length {S}",
            4 * B * hq * S * d, 2 * (2 * B * hq * d + 2 * B * S * hk * d),
            {"route": fd.decode_route(qd, kc, vc), "n_split": fd.decode_splits(B, hk, S)[1],
             "chunk": fd.decode_splits(B, hk, S)[0]},
            lambda qd=qd, kc=kc, vc=vc, S=S: fd.flash_decode(qd, kc, vc, S),
            lambda qd=qd, kc=kc, vc=vc, S=S: fd.flash_decode_plain(qd, kc, vc, S),
            lambda q4=q4, k4=k4, v4=v4: F.scaled_dot_product_attention(q4, k4, v4, enable_gqa=True),
        ))
    # MLA (minicpm3-4b): 40 heads, each its own keys; q / k 96 wide, v 64;
    # scale 1 / sqrt(96) (SDPA's default for a 96-wide q). The decode row is
    # the serving step's last: 96 live positions, expanded from the latents
    H, dk, dv, S = 40, 96, 64, SERVE_PREFILL
    q, k = (_draw(rng, (SERVE_B, S, H, dk), dt).to(dev).transpose(1, 2) for _ in range(2))
    v = _draw(rng, (SERVE_B, S, H, dv), dt).to(dev).transpose(1, 2)
    pairs = S * (S + 1) // 2
    cases.append((
        "flash_attention", f"MLA prefill B{SERVE_B} S{S} h{H} dk{dk} dv{dv} bf16 causal",
        2 * pairs * SERVE_B * H * (dk + dv), 2 * SERVE_B * S * H * (2 * dk + 2 * dv),
        {"route": fa.attention_route(q, k, v), "mla": True},
        lambda: fa.flash_attention(q, k, v), lambda: fa.flash_attention_plain(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)))
    L = SERVE_PROMPT + SERVE_STEPS
    qd = _draw(rng, (SERVE_B, H, dk), dt).to(dev)
    kc = _draw(rng, (SERVE_B, L, H, dk), dt).to(dev)
    vc = _draw(rng, (SERVE_B, L, H, dv), dt).to(dev)
    q4, k4, v4 = qd[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    cases.append((
        "flash_decode", f"MLA serving step B{SERVE_B} S{L} h{H} dk{dk} dv{dv} bf16 length {L}",
        2 * SERVE_B * H * L * (dk + dv), 2 * (SERVE_B * H * (dk + dv) + SERVE_B * L * H * (dk + dv)),
        {"route": fd.decode_route(qd, kc, vc), "n_split": fd.decode_splits(SERVE_B, H, L)[1],
         "chunk": fd.decode_splits(SERVE_B, H, L)[0], "mla": True},
        lambda: fd.flash_decode(qd, kc, vc, L), lambda: fd.flash_decode_plain(qd, kc, vc, L),
        lambda: F.scaled_dot_product_attention(q4, k4, v4)))
    for name, label, flops, nbytes, extra, kernel, plain, library in cases:
        ms, device_ms = time_ms(kernel, reps=20), graph_ms(kernel, reps=10)
        plain_ms = time_ms(plain, reps=5)
        library_ms, library_device_ms = time_ms(library, reps=20), graph_ms(library, reps=10)
        ops_ms = flops / H100_BF16_FLOPS * 1e3
        bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
        row = {
            "name": name, "label": label, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_device_ms": library_device_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flop": flops, "bytes": nbytes, **extra,
        }
        row["share_of_bound"] = row["bound_ms"] / device_ms
        rows.append(row)
        print(f"{name} {label} {extra}: kernel {ms:.6f} ms per call ({device_ms:.6f} ms on the device, "
              f"from a CUDA graph), plain {plain_ms:.6f} ms, SDPA {library_ms:.6f} ms "
              f"({library_device_ms:.6f}), bound {row['bound_ms']:.6f} ms ({row['bound_by']}: "
              f"{flops} flop, {nbytes} bytes), {flops / device_ms / 1e9:.3f} TFLOP/s and "
              f"{nbytes / device_ms / 1e9:.3f} TB/s on the device, "
              f"{100 * row['share_of_bound']:.2f} % of the bound", flush=True)
    return rows


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# the port's own kernels by name: they launch from their ctypes libraries,
# whose runtime calls torch.profiler does not tie to a record_function
# range, so a range's device time leaves them out and they are summed by name
OWN_KERNELS = {"mamba_scan": ("mamba_scan_kernel",),
               "flash": ("flash_attention", "flash_decode")}


def profile_window(fn, label, ranges=()):
    """``fn`` under torch.profiler (twice: the first run warms the profiler
    up); prints wall, device busy time, idle share and the top kernels, and
    the device time under each ``ranges`` name (torch.profiler
    record_function ranges, nested ranges inside their parents) and of each
    group of OWN_KERNELS (by kernel name); returns the window's figures."""
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - w0
    busy_us, top = device_time(prof, skip=ranges)
    print(f"profile {label}: wall_s={wall:.6f} device_busy_s={busy_us / 1e6:.6f} "
          f"device_idle_share={1.0 - busy_us / 1e6 / wall:.4f}", flush=True)
    for name, us in top[:8]:
        print(f"  {us / 1e6:.6f} s  {100 * us / busy_us:.1f} %  {name[:110]}")
    spans = dict.fromkeys(ranges, 0.0)
    for e in prof.events():  # the host-side range: its kernels and its children's
        if e.name in spans and e.device_type == DeviceType.CPU:
            spans[e.name] += getattr(e, "device_time_total", 0.0) / 1e6
    own = {group: sum(us for name, us in top if any(k in name for k in keys)) / 1e6
           for group, keys in OWN_KERNELS.items()}
    return dict(wall_s=wall, device_busy_s=busy_us / 1e6,
                device_idle_share=1.0 - busy_us / 1e6 / wall, spans_s=spans, own_kernels_s=own,
                kernel_names=[name for name, _ in top])


@contextlib.contextmanager
def patched(pairs):
    """Replace ``module.name`` by ``wrap(original)`` for each (module, name,
    wrap) inside the block."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in pairs]
    for mod, name, wrap in pairs:
        setattr(mod, name, wrap(getattr(mod, name)))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def ranged(label):
    """A wrapper that runs a function inside a record_function range."""
    def wrap(fn):
        def inner(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return inner
    return wrap


def frozen(keys):
    """A ``mamba_apply`` wrapper that plants a fault in the decode step: it
    puts the state's ``keys`` ("ssm", "conv") back after each step, as a
    step that forgot to write them would leave them."""
    def wrap(fn):
        def inner(params, x, *, state=None, **kwargs):
            saved = {} if state is None else {k: state[k].clone() for k in keys}
            out = fn(params, x, state=state, **kwargs)
            for k, t in saved.items():
                state[k].copy_(t)
            return out
        return inner
    return wrap


def routing_probe(moe_mod, record):
    """A ``moe_apply`` wrapper that appends, for each call, the call's
    expert ids (B, S, K, each token's set sorted), the assignments it drops
    and the assignments it routes (routing once more beside the layer)."""
    def wrap(fn):
        def inner(params, x, *, moe_cfg, expert_perm=None, n_chunks=1):
            B, S, d = x.shape
            _, _, idx = moe_mod.route(params, x.reshape(B * S, d), moe_cfg, expert_perm)
            X, Tc, C = moe_mod.dispatch_shape(B * S, n_chunks, moe_cfg)
            counts = torch.zeros((X, moe_cfg.n_experts), dtype=torch.int64, device=x.device)
            counts.scatter_add_(1, idx.reshape(X, -1), torch.ones_like(idx.reshape(X, -1)))
            record.append((idx.reshape(B, S, -1).sort(dim=-1).values,
                           int((counts - C).clamp(min=0).sum()), idx.numel()))
            return fn(params, x, moe_cfg=moe_cfg, expert_perm=expert_perm, n_chunks=n_chunks)
        return inner
    return wrap


def route_flips(record, n_pre, n_layers, prompt_len):
    """From a routing_probe record of a prefill (its first ``n_pre`` calls,
    one a layer) followed by ``prompt_len`` decode steps over the same
    tokens: by layer, the tokens whose top-k set differs between the two
    paths, and how many of them sit at the prompt's last position."""
    pre, steps = record[:n_pre], record[n_pre:n_pre + prompt_len * n_layers]
    flips, last = [], 0
    for layer in range(n_layers):
        dec = torch.cat([steps[i * n_layers + layer][0] for i in range(prompt_len)], 1)
        differs = (pre[layer][0] != dec).any(-1)
        flips.append(int(differs.sum()))
        last += int(differs[:, -1].sum())
    return flips, last


def moe_bounds(cfg, n_bytes):
    """The serving path's bounds on an H100 at ``cfg``'s widths (ms): the
    4 x 2048 prefill (the larger of its weight bytes over the memory rate
    and its bf16 tensor-core flop plus the router's f32 flop over their
    peaks; the expert products count every capacity row, as the dispatch
    buffer computes them) and a decode step at the serving cache (every
    parameter read once but the embedding table, of which B rows, plus the
    cache; and the same with only the min(B K, E) experts a step can
    touch)."""
    from repro_torch.models.moe import dispatch_shape

    d, hq, hk, hd, V, L = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.vocab, cfg.n_layers
    E, K, ff = cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff
    B, S = SERVE_B, SERVE_PREFILL
    T = B * S
    C = dispatch_shape(T, 1, cfg.moe)[2]
    proj = 2 * T * d * (hq * hd + 2 * hk * hd) + 2 * T * hq * hd * d
    attn = 4 * hd * hq * B * S * (S + 1) // 2
    experts = 6 * E * C * d * ff
    flop = L * (proj + attn + experts) + 2 * B * d * V
    router_flop = L * 2 * T * d * E
    prefill_ms = max(n_bytes / H100_HBM_BYTES_PER_S,
                     flop / H100_BF16_FLOPS + router_flop / H100_FP32_FLOPS) * 1e3
    cache = SERVE_PROMPT + SERVE_STEPS
    step_bytes = n_bytes - 2 * V * d + 2 * B * d + L * 2 * 2 * B * cache * hk * hd
    touched = min(B * K, E)
    touched_bytes = step_bytes - L * (E - touched) * 3 * d * ff * 2
    return dict(capacity_prefill=C, prefill_flop=flop, prefill_router_f32_flop=router_flop,
                prefill_bound_ms=prefill_ms, prefill_bound_tps=T / prefill_ms * 1e3,
                decode_bytes=step_bytes, decode_bound_ms=step_bytes / H100_HBM_BYTES_PER_S * 1e3,
                decode_touched_experts=touched, decode_touched_bytes=touched_bytes,
                decode_touched_bound_ms=touched_bytes / H100_HBM_BYTES_PER_S * 1e3)


def hybrid_bounds(cfg, n_bytes):
    """The serving path's bounds on an H100 for the attention / Mamba hybrid
    at ``cfg``'s widths and depth (ms), block kind by block kind: the 4 x
    2048 prefill (the larger of its weight bytes over the memory rate and
    its bf16 tensor-core flop plus its f32 operations over their peaks:
    Mamba's four projections in bf16, its conv taps in f32 and its fused
    scan at ``scan_bound``'s operations, the two pipes balanced; attention's projections and
    causal pairs at attention layers only, no rope; the experts over every
    capacity row and the f32 router at MoE positions; the dense MLP
    elsewhere) and a decode step at the serving cache (every parameter read
    once but the embedding table, of which B rows; each attention layer's
    live K/V; each Mamba layer's ``ssm`` read and written, B din N f32 each
    way, and its conv window; and the same with only the min(B K, E)
    experts a step can touch)."""
    from repro_torch.models.moe import dispatch_shape
    from repro_torch.models.transformer import _is_moe_position

    d, hq, hk, hd, V, L = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.vocab, cfg.n_layers
    din, N, w = cfg.mamba_expand * d, cfg.mamba_d_state, cfg.mamba_d_conv
    rank = max(1, d // 16)
    E, K, ff = cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff
    B, S = SERVE_B, SERVE_PREFILL
    T = B * S
    C = dispatch_shape(T, 1, cfg.moe)[2]
    kinds = [cfg.block_pattern[i % cfg.period] for i in range(L)]
    moe_layers = sum(_is_moe_position(cfg, i % cfg.period) for i in range(L))
    flop, f32_ops = 2 * B * d * V, 0  # the last position's logits
    scan_ms = 0
    for i, kind in enumerate(kinds):
        if kind == "mamba":
            flop += 2 * T * (d * 2 * din + din * (rank + 2 * N) + rank * din + din * d)
            f32_ops += 2 * T * din * w
            scan = scan_bound(B, S, din, N, fused=True, esize=2)
            scan_ms += scan["ops_ms"]
        else:
            flop += (2 * T * d * (hq * hd + 2 * hk * hd) + 2 * T * hq * hd * d
                     + 4 * hd * hq * B * S * (S + 1) // 2)
        if _is_moe_position(cfg, i % cfg.period):
            flop += 6 * E * C * d * ff
            f32_ops += 2 * T * d * E
        else:
            flop += 6 * T * d * cfg.d_ff
    prefill_ms = max(n_bytes / H100_HBM_BYTES_PER_S * 1e3,
                     (flop / H100_BF16_FLOPS + f32_ops / H100_FP32_FLOPS) * 1e3 + scan_ms)
    cache = SERVE_PROMPT + SERVE_STEPS
    state_bytes = kinds.count("mamba") * 2 * (B * din * N * 4 + B * (w - 1) * din * 2)
    kv_bytes = kinds.count("attn") * 2 * 2 * B * cache * hk * hd
    step_bytes = n_bytes - 2 * V * d + 2 * B * d + kv_bytes + state_bytes
    touched = min(B * K, E)
    touched_bytes = step_bytes - moe_layers * (E - touched) * 3 * d * ff * 2
    return dict(capacity_prefill=C, prefill_flop=flop, prefill_f32_ops=f32_ops,
                prefill_scan_ms=scan_ms,
                prefill_bound_ms=prefill_ms, prefill_bound_tps=T / prefill_ms * 1e3,
                decode_bytes=step_bytes, decode_state_bytes=state_bytes,
                decode_bound_ms=step_bytes / H100_HBM_BYTES_PER_S * 1e3,
                decode_touched_experts=touched, decode_touched_bytes=touched_bytes,
                decode_touched_bound_ms=touched_bytes / H100_HBM_BYTES_PER_S * 1e3)


def scan_bound(B, S, din, N, fused=False, esize=4, state=True):
    """The least time of one call of the scan kernel on an H100: the larger
    of its bytes (each input read once, each output written once) over 3.35
    TB/s and its operations: f32 operations on the FMA pipe (an FMA two, as
    the 67 TFLOP/s rate counts it) and special-function operations over
    H100_SFU_OPS (16 a clock and SM at the 1.98 GHz boost clock), with as
    many exponentials moved onto the FMA pipe (EXP_FMA_FLOP each) as balance
    the two pipes. Per (b, t, c, n): dt A, dx B and the state's and y's FMAs
    (6 flop) and one exponential; per (b, t, c): dt x and, fused, the bias
    add, the skip's product and sum, silu's add and the gate's product (5
    more), and softplus's and silu's exponentials and silu's reciprocal (3
    special; softplus's log1p is a polynomial on the FMA pipe, not counted).
    ``fused``: mamba_scan (dt_pre, x, z, B, C, a_log, dt_bias, d_skip in
    ``esize`` bytes read, g written; the f32 state read and written when
    ``state``); else selective_scan (f32 dt, x, B, C, A, h0 read, y and hT
    written). Returns ms, bound_by ("bytes" or "operations"), bytes, both
    operation counts with every exponential on the special-function unit
    (as the kernel runs them) and their times, the exponentials a (b, t, c)
    that the balance moves and the balanced operations' time."""
    cells, rows = B * S * din, B * S * N
    if fused:
        nbytes = esize * (4 * cells + 2 * rows + din * N + 2 * din)
        nbytes += 8 * B * din * N if state else 0
        fma, sfu, exps = 6 * N + 6, N + 3, N + 2
    else:
        nbytes = 4 * (3 * cells + 2 * rows + din * N + 2 * B * din * N)
        fma, sfu, exps = 6 * N + 1, N, N
    # (fma + EXP_FMA_FLOP k) / FP32_FLOPS = (sfu - k) / SFU_OPS, k in [0, exps]
    moved = (sfu * H100_FP32_FLOPS - fma * H100_SFU_OPS) / (H100_FP32_FLOPS
                                                           + EXP_FMA_FLOP * H100_SFU_OPS)
    moved = min(max(moved, 0.0), exps)
    ops_ms = cells * max((fma + EXP_FMA_FLOP * moved) / H100_FP32_FLOPS,
                         (sfu - moved) / H100_SFU_OPS) * 1e3
    bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations", bytes=nbytes,
                fma_ops=cells * fma, sfu_ops=cells * sfu, bytes_ms=bytes_ms,
                fma_ms=cells * fma / H100_FP32_FLOPS * 1e3,
                sfu_ms=cells * sfu / H100_SFU_OPS * 1e3, exps_moved=moved, ops_ms=ops_ms)


def scan_check(ssk, dev):
    """The scan kernel against its plain versions on the card. The f32
    instantiation (selective_scan) at SCAN_CASES: y and hT each within
    SCAN_TOL of their largest magnitude. The fused one (mamba_scan) at
    FUSED_CASES, f32 and bf16, on mamba_apply's strided views, prefill (from
    zeros) and decode (a state, written in place: the same storage): g at
    f32 and the state within SCAN_TOL of their largest magnitude; g at bf16
    within MAMBA_SCAN_BF16_TOL of its largest magnitude and, element by
    element, within tests/_scan_cases.py's g_bf16_limit, with at most
    G_BF16_SHARE of the elements not bit-equal. A fault planted at bf16 (the
    kernel run with d_skip zero: the skip left out) must break that limit.
    Two calls give the same bits; refusals launch nothing. Returns the
    errors and case counts by instantiation."""
    from _scan_cases import (FUSED_CASES, G_BF16_SHARE, SCAN_CASES, fused_inputs, g_bf16_limit,
                             g_bf16_reading, scan_inputs)

    max_abs = max_rel = 0.0
    for case in SCAN_CASES:
        args = scan_inputs(*case[:4], sum(case[:4]), dev, case[4])
        want = ssk.selective_scan_plain(*args)
        got = ssk.selective_scan(*args)
        again = ssk.selective_scan(*args)
        torch.cuda.synchronize()
        rels = [rel_err(g, w) for g, w in zip(got, want)]
        abss = [(g - w).abs().max().item() for g, w in zip(got, want)]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"selective_scan B{case[0]} S{case[1]} din{case[2]} N{case[3]} "
              f"h0 {'zeros' if case[4] else 'normal'}: y / hT max |diff| {abs(abss[0]):.3e} / "
              f"{abss[1]:.3e}, over their largest magnitude {rels[0]:.3e} / {rels[1]:.3e} "
              f"(tol {SCAN_TOL}); two calls equal {same}", flush=True)
        if not (max(rels) <= SCAN_TOL and same):
            raise SystemExit(f"selective_scan disagrees with its plain version at {case}")
        max_abs, max_rel = max(max_abs, *abss), max(max_rel, *rels)
    args = scan_inputs(2, 5, 70, 16, 1, dev)
    must_refuse("bf16 dt", lambda: ssk.selective_scan(args[0].bfloat16(), *args[1:]),
                ssk.selective_scan)
    must_refuse("a non-contiguous dt", lambda: ssk.selective_scan(
        args[0].transpose(1, 2).contiguous().transpose(1, 2), *args[1:]), ssk.selective_scan)
    must_refuse("an A of the wrong shape", lambda: ssk.selective_scan(
        *args[:4], args[4][:, :8], args[5]), ssk.selective_scan)
    must_refuse("N 12", lambda: ssk.selective_scan(*scan_inputs(2, 5, 70, 12, 1, dev)),
                ssk.selective_scan)
    must_refuse("a CPU h0", lambda: ssk.selective_scan(*args[:5], args[5].cpu()),
                ssk.selective_scan)
    out = {"selective_scan": dict(max_abs_err=max_abs, max_rel_err=max_rel, cases=len(SCAN_CASES),
                                  tol_rel=SCAN_TOL)}

    fused = {}
    for dtype, tol in ((torch.float32, SCAN_TOL), (torch.bfloat16, MAMBA_SCAN_BF16_TOL)):
        row = dict(max_abs_err=0.0, max_rel_err=0.0, state_max_rel_err=0.0, not_bit_equal=0.0,
                   tol_rel=tol, state_tol_rel=SCAN_TOL, cases=len(FUSED_CASES))
        if dtype == torch.bfloat16:
            row.update(over_limit=0.0, share_tol=G_BF16_SHARE, skip_left_out_over_limit=1.0,
                       skip_left_out_not_bit_equal=1.0)
        for case in FUSED_CASES:
            args = fused_inputs(*case, sum(case), dev, dtype)
            state0 = None if args[8] is None else args[8].clone()
            want_state = None if state0 is None else state0.clone()
            want = ssk.mamba_scan_plain(*args[:8], want_state).float()
            before = ssk.mamba_scan.launches
            ptr = None if args[8] is None else args[8].data_ptr()
            got = ssk.mamba_scan(*args)
            again_state = None if state0 is None else state0.clone()
            again = ssk.mamba_scan(*args[:8], again_state)
            torch.cuda.synchronize()
            launches = ssk.mamba_scan.launches - before
            same = torch.equal(got, again) and (state0 is None or torch.equal(args[8], again_state))
            rel = rel_err(got.float(), want)
            diff = (got.float() - want).abs()
            share = (diff != 0).float().mean().item()
            state_rel = 0.0 if state0 is None else rel_err(args[8], want_state)
            in_place = state0 is None or (args[8].data_ptr() == ptr
                                          and not torch.equal(args[8], state0))
            holds, elementwise = True, ""
            if dtype == torch.bfloat16:
                limit = g_bf16_limit(args[:8] + [state0], want, ssk.selective_scan_plain)
                ratio, over, _, holds = g_bf16_reading(got, want, limit)
                # the planted fault: the skip left out (d_skip zero in the kernel)
                bad = ssk.mamba_scan(*args[:7], torch.zeros_like(args[7]),
                                     None if state0 is None else state0.clone())
                bad_ratio, bad_over, bad_share, bad_holds = g_bf16_reading(bad, want, limit)
                del limit
                elementwise = (f"; element by element {ratio:.3e} of the limit, {100 * over:.4f} "
                               f"% over it (skip left out: {bad_ratio:.3e}, {100 * bad_over:.4f} % "
                               f"over, {100 * bad_share:.4f} % not bit-equal, holds {bad_holds})")
                holds = holds and not bad_holds
                row["over_limit"] = max(row["over_limit"], over)
                row["skip_left_out_over_limit"] = min(row["skip_left_out_over_limit"], bad_over)
                row["skip_left_out_not_bit_equal"] = min(row["skip_left_out_not_bit_equal"],
                                                         bad_share)
            print(f"mamba_scan {str(dtype)[6:]} B{case[0]} S{case[1]} din{case[2]} rank "
                  f"{case[4]} {'a state' if case[3] else 'from zeros'}: g max |diff| "
                  f"{diff.max().item():.3e}, over its largest magnitude {rel:.3e} (tol {tol:.3e}), "
                  f"{100 * share:.4f} % of elements not bit-equal{elementwise}; state "
                  f"{state_rel:.3e} (tol {SCAN_TOL}, written in place {in_place}); two calls equal "
                  f"{same}; launches {launches}", flush=True)
            if not (rel <= tol and holds and state_rel <= SCAN_TOL and same and in_place
                    and launches == 2):
                raise SystemExit(f"mamba_scan disagrees with its plain version at {case} {dtype}")
            row["max_abs_err"] = max(row["max_abs_err"], diff.max().item())
            row["max_rel_err"] = max(row["max_rel_err"], rel)
            row["state_max_rel_err"] = max(row["state_max_rel_err"], state_rel)
            row["not_bit_equal"] = max(row["not_bit_equal"], share)
        fused[str(dtype)[6:]] = row
    args = fused_inputs(2, 5, 70, True, 8, 1, dev, torch.bfloat16)
    must_refuse("an f32 dt_pre among bf16", lambda: ssk.mamba_scan(args[0].float(), *args[1:]),
                ssk.mamba_scan)
    must_refuse("a bf16 state", lambda: ssk.mamba_scan(*args[:8], args[8].bfloat16()),
                ssk.mamba_scan)
    must_refuse("an xc without unit stride", lambda: ssk.mamba_scan(
        args[0], args[1].transpose(1, 2).contiguous().transpose(1, 2), *args[2:]),
        ssk.mamba_scan)
    must_refuse("N 12", lambda: ssk.mamba_scan(
        *args[:3], args[3][..., :12], args[4][..., :12], args[5][:, :12], *args[6:8],
        args[8][..., :12].contiguous()), ssk.mamba_scan)
    must_refuse("a CPU state", lambda: ssk.mamba_scan(*args[:8], args[8].cpu()), ssk.mamba_scan)
    out["mamba_scan"] = fused
    return out


def mamba_step_check(dev, cfg):
    """One Mamba layer at ``cfg``'s widths, f32 weights (seed 3) on the
    card: ``mamba_apply`` over a B 4 x 64 sequence from the zero state
    against 64 decode steps through the state; y at every position within
    MAMBA_STEP_TOL of its largest magnitude. The same with a fault planted
    (``frozen``: the ssm or the conv state put back after each step) must
    read above it. Returns the gaps by run."""
    from repro_torch.models import mamba as mamba_mod

    kw = dict(expand=cfg.mamba_expand, d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv)
    params = mamba_mod.mamba_init(torch.Generator(device=dev).manual_seed(3), cfg.d_model,
                                  dtype=torch.float32, device=dev, **kw)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (SERVE_B, SERVE_PROMPT, cfg.d_model)), dtype=torch.float32, device=dev)
    with torch.inference_mode():
        full, _ = mamba_mod.mamba_apply(params, x, **kw)
        gaps = {}
        for name, keys in (("sound", ()), ("ssm frozen", ("ssm",)), ("conv frozen", ("conv",))):
            state = mamba_mod.mamba_state_init(SERVE_B, cfg.d_model, dtype=torch.float32,
                                               device=dev, **kw)
            with patched([(mamba_mod, "mamba_apply", frozen(keys))]):
                steps = torch.cat([mamba_mod.mamba_apply(params, x[:, t:t + 1], state=state,
                                                         **kw)[0]
                                   for t in range(SERVE_PROMPT)], 1)
            gaps[name] = ((steps - full).abs().max() / full.abs().max()).item()
    print(f"mamba_apply, one layer at d {cfg.d_model} (din {cfg.mamba_expand * cfg.d_model}, N "
          f"{cfg.mamba_d_state}), f32, B {SERVE_B} x {SERVE_PROMPT}: the full sequence against "
          f"{SERVE_PROMPT} decode steps, max |diff| over the largest |y|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()) + f" (tol {MAMBA_STEP_TOL}: the "
          "sound run within it, each planted fault above it)", flush=True)
    if not gaps["sound"] <= MAMBA_STEP_TOL < min(gaps["ssm frozen"], gaps["conv frozen"]):
        raise SystemExit(f"the Mamba decode steps and the full sequence: {gaps} against "
                         f"{MAMBA_STEP_TOL}")
    return gaps


def scan_timing(ssk, dev, din, N):
    """Both instantiations at the main path's prefill (B 4, S 2048) and
    decode step (S 1, a state) shapes: the fused scan in bf16 on jamba's
    views (its dt_rank din / 32), the path's, and the f32 scan. The
    kernel's ms per call (CUDA events around back-to-back calls), device ms
    (from a CUDA graph), the plain version's ms and the bound
    (``scan_bound``)."""
    from _scan_cases import fused_inputs, scan_inputs

    rows = {}
    for key, S, with_state in (("prefill", SERVE_PREFILL, False), ("decode", 1, True)):
        for name in ("mamba_scan", "selective_scan"):
            if name == "mamba_scan":
                args = fused_inputs(SERVE_B, S, din, with_state, din // 32, 7, dev,
                                    torch.bfloat16)
                kernel, plain = ssk.mamba_scan, ssk.mamba_scan_plain
                bound = scan_bound(SERVE_B, S, din, N, fused=True, esize=2, state=with_state)
                shape = f"B{SERVE_B} S{S} din{din} N{N} bf16{' state' if with_state else ''}"
            else:
                args = scan_inputs(SERVE_B, S, din, N, 7, dev, not with_state)
                kernel, plain = ssk.selective_scan, ssk.selective_scan_plain
                bound = scan_bound(SERVE_B, S, din, N)
                shape = f"B{SERVE_B} S{S} din{din} N{N} f32"
            ms = time_ms(lambda: kernel(*args), reps=20)
            device_ms = graph_ms(lambda: kernel(*args), reps=10)
            plain_ms = event_ms(lambda: plain(*args), reps=1 if S > 1 else 5)
            row = dict(shape=shape, ms=ms, device_ms=device_ms, plain_ms=plain_ms, **bound,
                       share_of_bound=bound["bound_ms"] / device_ms)
            rows[f"{name} {key}"] = row
            print(f"{name} {shape}: kernel {ms:.6f} ms per call ({device_ms:.6f} ms on the "
                  f"device, from a CUDA graph), plain {plain_ms:.6f} ms, bound "
                  f"{bound['bound_ms']:.6f} ms ({bound['bound_by']}: {bound['bytes']} bytes "
                  f"{bound['bytes_ms']:.6f} ms; operations {bound['ops_ms']:.6f} ms with "
                  f"{bound['exps_moved']:.3f} exponentials a (b, t, c) on the FMA pipe, else "
                  f"{bound['fma_ops']} FMA-pipe flop {bound['fma_ms']:.6f} ms and "
                  f"{bound['sfu_ops']} special-function operations {bound['sfu_ms']:.6f} ms), "
                  f"{100 * row['share_of_bound']:.2f} % of the bound, "
                  f"{100 * bound['sfu_ms'] / device_ms:.2f} % of the special-function time; "
                  f"no PyTorch call computes it", flush=True)
    return rows


class AtenOps(TorchDispatchMode):
    """Counts the ATen operations run inside it, by name. On a CUDA tensor
    each one but the views and the allocations is a kernel launch; a
    ctypes launch of the port's own kernels is no ATen operation."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def mamba_layer_kernels(ssk, mamba_mod, dev, cfg):
    """One Mamba layer at ``cfg``'s widths in bf16 (weights seed 5), at the
    prefill (B 4 x 2048) and a decode step: the ATen operations it runs
    (AtenOps) and its mamba_scan launches, and the same with ``mamba_scan``
    replaced by a stub that allocates ``g`` as the wrapper does and launches
    nothing. The two must run the same operations, and the layer exactly
    one mamba_scan launch: no softplus, skip, cast or gate kernel runs
    around the scan. (torch.profiler sessions this deep into the script lose
    kernel records now and then, so the count is taken at dispatch.)
    Returns the counts."""
    kw = dict(expand=cfg.mamba_expand, d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv)
    params = mamba_mod.mamba_init(torch.Generator(device=dev).manual_seed(5), cfg.d_model,
                                  dtype=torch.bfloat16, device=dev, **kw)
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((SERVE_B, SERVE_PREFILL, cfg.d_model)),
                        dtype=torch.bfloat16, device=dev)

    def stub(dt_pre, xc, *args, state=None):
        return torch.empty(xc.shape, dtype=xc.dtype, device=xc.device)

    def ops(fn):
        before = (ssk.mamba_scan.launches, ssk.selective_scan.launches)
        with AtenOps() as mode:
            fn()
        torch.cuda.synchronize()
        return mode.ops, (ssk.mamba_scan.launches - before[0],
                          ssk.selective_scan.launches - before[1])

    out = {}
    state = mamba_mod.mamba_state_init(SERVE_B, cfg.d_model, dtype=torch.bfloat16, device=dev,
                                       **kw)
    with torch.inference_mode():
        for key, call in (("prefill", lambda: mamba_mod.mamba_apply(params, x, **kw)),
                          ("decode", lambda: mamba_mod.mamba_apply(params, x[:, :1],
                                                                   state=state, **kw))):
            fused, launches = ops(call)
            with patched([(mamba_mod, "mamba_scan", lambda fn: stub)]):
                around, stub_launches = ops(call)
            print(f"one Mamba layer (d {cfg.d_model}, bf16), {key}: {sum(fused.values())} ATen "
                  f"operations and (mamba_scan, selective_scan) launches {launches}; with "
                  f"mamba_scan stubbed {sum(around.values())} and {stub_launches}", flush=True)
            if fused != around or launches != (1, 0) or stub_launches != (0, 0):
                raise SystemExit(f"a Mamba layer's {key} is not its projections and conv and one "
                                 f"mamba_scan launch: {dict(fused - around)} more, "
                                 f"{dict(around - fused)} fewer operations; launches {launches}")
            out[key] = dict(aten_ops=sum(fused.values()), mamba_scan_launches=launches[0])
    return out


def compare_cfg(cfg):
    """The config at which serve_phase compares the prefill's logits with
    the cache path's. Both must route alike: capacity depends on each call's
    tokens (a decode step's B never drops; a 64-token prompt at the config's
    factor drops whenever the random router is unbalanced), so under MoE the
    factor that drops nothing, E / K; the hybrid with every expert routed
    (HYBRID_LOGIT_TOL says why); a dense config as it is."""
    moe = cfg.moe
    if moe is None:
        return cfg
    if "mamba" in cfg.block_pattern:
        return cfg.scaled(moe=dataclasses.replace(moe, top_k=moe.n_experts, capacity_factor=1.0))
    return cfg.scaled(moe=dataclasses.replace(moe, capacity_factor=moe.n_experts / moe.top_k))


def serve_phase(fa, fd, dev, arch=SERVE_ARCH, smoke_archs=("chatglm3-6b", "granite-8b", "gemma-7b"),
                n_layers=None):
    """``arch`` served at full width on the card (chatglm3-6b; the mla phase:
    minicpm3-4b; the moe phase: grok-1-314b and kimi-k2-1t-a32b; the hybrid
    phase: jamba-v0.1-52b), at its full depth or at ``n_layers``, then
    ``smoke_archs`` at f32 on the card against the CPU; returns the main
    path's launch counts and rates."""
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.dist.sched_bridge import plan_expert_placement
    from repro_torch.kernels import selective_scan as ssk
    from repro_torch.launch.serve import prefill_into_cache
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import _is_moe_position, forward, init_params
    from repro_torch.serve.decode import make_prefill_step, make_serve_step

    cfg = get_config(arch)
    full_layers = cfg.n_layers
    if n_layers is not None:
        cfg = cfg.scaled(n_layers=n_layers)
    n_layers = cfg.n_layers
    moe = cfg.moe
    kinds = [cfg.block_pattern[i % cfg.period] for i in range(n_layers)]
    n_attn, n_mamba = kinds.count("attn"), kinds.count("mamba")
    n_moe = sum(_is_moe_position(cfg, i % cfg.period) for i in range(n_layers))
    hybrid = n_mamba > 0
    mamba_keys = [f"p{j}" for j, kind in enumerate(cfg.block_pattern) if kind == "mamba"]
    w0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    param_dtype = leaves[0].dtype
    del leaves  # the relabelling check replaces expert tensors: hold no old ones
    heads = (f"MLA {cfg.mla}" if cfg.mla is not None
             else f"{cfg.n_kv_heads} KV heads, hd {cfg.hd}")
    depth = f"{n_layers} of its {full_layers} layers" if n_layers != full_layers else f"{n_layers} layers"
    experts = ("" if moe is None else f", {moe.n_experts} experts top-{moe.top_k}, expert ff "
               f"{moe.d_ff}, capacity factor {moe.capacity_factor}, {n_moe} MoE layers")
    blocks = ("" if not hybrid else f", {n_mamba} Mamba layers (expand {cfg.mamba_expand}, "
              f"d_state {cfg.mamba_d_state}, conv {cfg.mamba_d_conv}) and {n_attn} attention "
              f"layers by the pattern {cfg.block_pattern}")
    print(f"{arch}: {depth}, d {cfg.d_model}, {cfg.n_heads} heads, {heads}, "
          f"ff {cfg.d_ff}, vocab {cfg.vocab}{experts}{blocks}; "
          f"{n_params} parameters ({n_bytes} bytes, {param_dtype}) made on the card in "
          f"{time.perf_counter() - w0:.3f} s (seed 0)", flush=True)
    # the config's analytic count leaves out the 2 L + 1 norm scales, under
    # MLA the two latent norms of each layer, under MoE the router of each
    # MoE layer, and in a Mamba layer a_log, dt_bias and d_skip: din (N + 2)
    want = int(cfg.params_count()) + (2 * n_layers + 1) * cfg.d_model
    if cfg.mla is not None:
        want += n_layers * (cfg.mla.q_lora_rank + cfg.mla.kv_lora_rank)
    if moe is not None:
        want += n_moe * cfg.d_model * moe.n_experts
    want += n_mamba * cfg.mamba_expand * cfg.d_model * (cfg.mamba_d_state + 2)
    if n_params != want:
        raise SystemExit(f"parameter count {n_params} != {want} (the config's)")
    rng = np.random.default_rng(0)
    long_prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (SERVE_B, SERVE_PREFILL)), device=dev)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (SERVE_B, SERVE_PROMPT)), device=dev)
    cache_len = SERVE_PROMPT + SERVE_STEPS
    prefill = make_prefill_step(cfg)
    serve = make_serve_step(cfg)
    check_cfg = compare_cfg(cfg)
    prefill_check = make_prefill_step(check_cfg)
    record = []
    probe = (patched([(moe_mod, "moe_apply", routing_probe(moe_mod, record))]) if moe is not None
             else contextlib.nullcontext())
    with torch.inference_mode():
        prefill(params, {"tokens": prompt})  # warm-up: library handles, the allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # ---- the main path, counted from here ----
        fa.flash_attention.launches = fa.flash_attention.launches_tc = 0
        fd.flash_decode.launches = fd.flash_decode.launches_split = 0
        ssk.selective_scan.launches = ssk.mamba_scan.launches = 0
        n_prefill = n_decode = 0
        prefill_walls = []
        for _ in range(2):
            w0 = time.perf_counter()
            logits_long = prefill(params, {"tokens": long_prompt})
            torch.cuda.synchronize()
            prefill_walls.append(time.perf_counter() - w0)
            n_prefill += 1
        with probe:
            if moe is not None:  # the timed prefill once more, its drops counted
                again = prefill(params, {"tokens": long_prompt})
                n_prefill += 1
                drops = [r[1] for r in record]
                routed = sum(r[2] for r in record)
                record.clear()
                rerun_equal = torch.equal(again, logits_long)
            logits_prefill = prefill_check(params, {"tokens": prompt})
            n_prefill += 1
            n_pre = len(record)
            # the decode path's logits at the prompt's last position. With
            # attention alone the whole prompt fills the cache and its last
            # token runs again at its own position, which rewrites the same
            # K/V; a Mamba state is advanced, not rewritten, so the hybrid
            # fills the first SERVE_PROMPT - 1 tokens and runs the last as
            # the compared step
            n_fill = SERVE_PROMPT - 1 if hybrid else SERVE_PROMPT
            w0 = time.perf_counter()
            last, cache = prefill_into_cache(params, check_cfg, prompt[:, :n_fill], cache_len)
            torch.cuda.synchronize()
            fill_wall = time.perf_counter() - w0
            n_decode += n_fill
            nxt, logits_dec, cache = make_serve_step(check_cfg)(params, cache, prompt[:, -1:],
                                                                SERVE_PROMPT - 1)
            check_next = nxt if hybrid else last
            n_decode += 1
        if hybrid:
            # every expert's routes filled the compared cache: the timed
            # steps start from one that the whole prompt filled at the
            # config's own top-2, as a user's would
            del cache
            w0 = time.perf_counter()
            last, cache = prefill_into_cache(params, cfg, prompt, cache_len)
            torch.cuda.synchronize()
            fill_wall = time.perf_counter() - w0
            n_fill = SERVE_PROMPT
            n_decode += SERVE_PROMPT
        toks = [last]
        w0 = time.perf_counter()
        for i in range(SERVE_STEPS):
            nxt, step_logits, cache = serve(params, cache, toks[-1][:, None], SERVE_PROMPT + i)
            toks.append(nxt)
        torch.cuda.synchronize()
        decode_wall = time.perf_counter() - w0
        n_decode += SERVE_STEPS
        fa_launches, fd_launches = fa.flash_attention.launches, fd.flash_decode.launches
        fa_tc, fd_split = fa.flash_attention.launches_tc, fd.flash_decode.launches_split
        ss_launches, ss_f32_launches = ssk.mamba_scan.launches, ssk.selective_scan.launches
        # ---- end of the main path ----
        peak = torch.cuda.max_memory_allocated()
        print(f"main path: {n_prefill} prefill forwards, {n_decode} decode forwards; "
              f"flash_attention launches {fa_launches} (tensor-core route {fa_tc}), "
              f"flash_decode launches {fd_launches} (split route {fd_split}), mamba_scan "
              f"launches {ss_launches} (selective_scan {ss_f32_launches}); peak device memory "
              f"{peak} bytes", flush=True)
        if (fa_launches != n_attn * n_prefill or fd_launches != n_attn * n_decode
                or ss_launches != n_mamba * (n_prefill + n_decode) or ss_f32_launches):
            raise SystemExit(f"launches per forward are not {n_attn} attention and {n_mamba} "
                             f"fused scans: flash_attention {fa_launches} over {n_prefill}, "
                             f"flash_decode {fd_launches} over {n_decode}, mamba_scan "
                             f"{ss_launches} over {n_prefill + n_decode}, selective_scan "
                             f"{ss_f32_launches}")
        if fa_tc != n_attn * n_prefill or fd_split != n_attn * n_decode:
            raise SystemExit(f"the serving path left the tensor-core routes: flash_attention "
                             f"tc {fa_tc} of {fa_launches}, flash_decode split {fd_split} of "
                             f"{fd_launches}")
        for name, t, shape in (("prefill B4x2048", logits_long, (SERVE_B, 1, cfg.vocab)),
                               ("prefill B4x64", logits_prefill, (SERVE_B, 1, cfg.vocab)),
                               ("decode", logits_dec, (SERVE_B, 1, cfg.vocab)),
                               ("last decode step", step_logits, (SERVE_B, 1, cfg.vocab))):
            if tuple(t.shape) != shape or t.dtype != torch.float32 or not torch.isfinite(t).all():
                raise SystemExit(f"{name} logits malformed: {tuple(t.shape)} {t.dtype}")
        tokens = torch.stack(toks, 1)
        if tokens.min() < 0 or tokens.max() >= cfg.vocab:
            raise SystemExit("decoded tokens out of the vocabulary")
        a, b = logits_prefill[:, 0], logits_dec[:, 0]
        gap = ((a - b).abs().max() / a.abs().max()).item()
        agree = (a.argmax(-1) == b.argmax(-1)).sum().item()
        tol = HYBRID_LOGIT_TOL if hybrid else SERVE_LOGIT_TOL if moe is None else MOE_LOGIT_TOL
        print(f"last-position logits, prefill vs prefill_into_cache + one step: max |diff| / "
              f"max |logit| = {gap:.6f} (tol {tol}); largest logit "
              f"{a.abs().max().item():.4f}; argmax agrees on {agree} of {SERVE_B}; greedy "
              f"next token from the cache path equals the prefill's argmax on "
              f"{(check_next.long() == a.argmax(-1)).sum().item()} of {SERVE_B}", flush=True)
        out_moe = {}
        if moe is not None:
            flips, last_flips = route_flips(record, n_pre, n_moe, SERVE_PROMPT)
            print(f"routes: the timed prefill ({SERVE_B} x {SERVE_PREFILL}, capacity factor "
                  f"{moe.capacity_factor}) drops {sum(drops)} of {routed} assignments (by layer "
                  f"{drops}; run again with the routes probed, logits equal: {rerun_equal}); "
                  f"no-drop check (top-{check_cfg.moe.top_k}, capacity factor "
                  f"{check_cfg.moe.capacity_factor}): "
                  f"{sum(r[1] for r in record)} dropped; tokens whose top-k set differs between "
                  f"the prefill and the cache path, by layer, {flips} of {SERVE_B * SERVE_PROMPT}; "
                  f"at the compared last positions {last_flips}", flush=True)
            if sum(r[1] for r in record):
                raise SystemExit("the no-drop check dropped assignments")
            out_moe = dict(dropped=sum(drops), dropped_by_layer=drops, routed=routed,
                           rerun_equal=rerun_equal,
                           route_flips_by_layer=flips, route_flips_last_position=last_flips)
        if not gap < tol:
            raise SystemExit(f"prefill and decode paths disagree: {gap} >= {tol}")
        prefill_tps = SERVE_B * SERVE_PREFILL / min(prefill_walls)
        decode_tps = SERVE_B * SERVE_STEPS / decode_wall
        print(f"prefill {SERVE_B} x {SERVE_PREFILL} tokens: wall_s {prefill_walls} -> "
              f"{prefill_tps:.1f} tokens/s; prefill_into_cache {SERVE_B} x {n_fill} tokens "
              f"(one decode step each{'; routes probed' if moe is not None and not hybrid else ''}) "
              f"{fill_wall:.3f} s; {SERVE_STEPS} decode steps x {SERVE_B} "
              f"in {decode_wall:.3f} s -> {decode_tps:.1f} tokens/s, "
              f"{1e3 * decode_wall / SERVE_STEPS:.3f} ms a step; sample {tokens[0, :12].tolist()}",
              flush=True)
        out = dict(arch=arch, n_layers=n_layers, fa_launches=fa_launches,
                   fd_launches=fd_launches, fa_launches_tc=fa_tc, ss_launches=ss_launches,
                   n_attention_layers=n_attn, n_mamba_layers=n_mamba, n_moe_layers=n_moe,
                   fd_launches_split=fd_split, prefill_forwards=n_prefill,
                   decode_forwards=n_decode, prefill_tps=prefill_tps,
                   decode_tps=decode_tps, logit_gap=gap, n_params=n_params, peak_bytes=peak,
                   peak_gb=peak / 1e9, prefill_walls=prefill_walls,
                   decode_step_ms=1e3 * decode_wall / SERVE_STEPS, sample=tokens[0, :12].tolist())
        ranges = ()
        if moe is not None:
            bounds = hybrid_bounds(cfg, n_bytes) if hybrid else moe_bounds(cfg, n_bytes)
            f32_ops = bounds["prefill_f32_ops" if hybrid else "prefill_router_f32_flop"]
            print(f"bounds (H100: {H100_HBM_BYTES_PER_S:.3g} B/s, {H100_BF16_FLOPS:.3g} bf16 "
                  f"flop/s, {H100_FP32_FLOPS:.3g} f32): prefill {bounds['prefill_bound_ms']:.3f} ms "
                  f"({bounds['prefill_flop']:.4g} bf16 flop, {f32_ops:.4g} f32 "
                  + (f"operations (conv, router), the fused scans "
                     f"{bounds['prefill_scan_ms']:.3f} ms" if hybrid else "router flop") + "; "
                  f"C {bounds['capacity_prefill']}) -> "
                  f"{bounds['prefill_bound_tps']:.1f} tokens/s, measured {prefill_tps:.1f} "
                  f"({100 * prefill_tps / bounds['prefill_bound_tps']:.2f} %); decode step "
                  f"{bounds['decode_bound_ms']:.3f} ms ({bounds['decode_bytes']} bytes), measured "
                  f"{out['decode_step_ms']:.3f}; with only the {bounds['decode_touched_experts']} "
                  f"experts a step can touch {bounds['decode_touched_bound_ms']:.3f} ms",
                  flush=True)
            out.update(out_moe, n_bytes=n_bytes, full_layers=full_layers, bounds=bounds,
                       fill_wall_s=fill_wall)
            # relabelling: an expert_perm from the placement planner, each
            # expert's weights moved to its new slot, gives the same logits
            placement = plan_expert_placement(
                np.random.default_rng(0).pareto(1.5, moe.n_experts) * 100, MOE_GROUPS)
            label = torch.as_tensor(placement.inv_perm, device=dev)  # expert e -> its slot
            slots = torch.as_tensor(placement.perm, device=dev)  # slot -> expert
            pos = SERVE_PROMPT + SERVE_STEPS - 1  # rewrites the last position with its own token
            # a Mamba state advances at each step: both compared steps start from this one
            states = {key: {n: t.clone() for n, t in cache[key].items()} for key in mamba_keys}
            _, base_step, cache = serve(params, cache, toks[-2][:, None], pos)
            for bp in params["blocks"]:
                if "moe" in bp:
                    for k in ("w_up", "w_gate", "w_down"):
                        bp["moe"][k] = bp["moe"][k][slots]
            relabelled = forward(params, cfg, long_prompt, expert_perm=label,
                                 last_logit_only=True)[0]
            for key, saved in states.items():
                for n, t in saved.items():
                    cache[key][n].copy_(t)
            del states
            step_relabelled = forward(params, cfg, toks[-2][:, None], cache=cache, cache_pos=pos,
                                      expert_perm=label)[0]
            same = (torch.equal(relabelled, logits_long), torch.equal(step_relabelled, base_step))
            print(f"relabelling by plan_expert_placement ({MOE_GROUPS} groups of "
                  f"{moe.n_experts // MOE_GROUPS}, group loads {placement.group_load.round(3).tolist()}): "
                  f"prefill logits equal {same[0]} (max |diff| "
                  f"{(relabelled - logits_long).abs().max().item()}), decode step equal {same[1]} "
                  f"(max |diff| {(step_relabelled - base_step).abs().max().item()})", flush=True)
            if not all(same):
                raise SystemExit("relabelled experts gave other logits")
            for bp in params["blocks"]:  # back to the original slots
                if "moe" in bp:
                    for k in ("w_up", "w_gate", "w_down"):
                        bp["moe"][k] = bp["moe"][k][label]
            out["relabel_equal"] = True
            ranges = ("moe", "moe.experts", "moe.router", "attention")
        if hybrid:  # the Mamba blocks in one range (the scan summed by name)
            ranges = ("mamba", "moe", "attention")
            annotate = patched([(mamba_mod, "mamba_apply", ranged("mamba")),
                                (moe_mod, "moe_apply", ranged("moe")),
                                (attn_mod, "attn_apply", ranged("attention"))])
        elif ranges:
            annotate = patched([(moe_mod, "moe_apply", ranged("moe")),
                                (moe_mod, "_experts", ranged("moe.experts")),
                                (moe_mod, "route", ranged("moe.router")),
                                (attn_mod, "attn_apply", ranged("attention"))])
        else:
            annotate = contextlib.nullcontext()
        pos = SERVE_PROMPT + SERVE_STEPS - 1  # rewrites the last position with its own token
        with annotate:
            windows = [profile_window(lambda: prefill(params, {"tokens": long_prompt}),
                                      f"prefill {SERVE_B} x {SERVE_PREFILL}", ranges),
                       profile_window(lambda: serve(params, cache, toks[-2][:, None], pos),
                                      f"decode step at {pos}", ranges)]
        if moe is not None:
            for key, win in zip(("prefill", "decode"), windows):
                sp, busy, own = win["spans_s"], win["device_busy_s"], win["own_kernels_s"]
                # the flash kernels belong to attention and the scan to Mamba,
                # though no range holds them (OWN_KERNELS)
                attention = sp["attention"] + own["flash"]
                if hybrid:
                    soft = [n for n in win["kernel_names"] if "softplus" in n.lower()]
                    if soft:
                        raise SystemExit(f"a softplus kernel ran in the hybrid's {key}: {soft}")
                    parts = {"mamba (scan apart)": sp["mamba"],
                             "mamba_scan": own["mamba_scan"],
                             "moe": sp["moe"], "attention": attention}
                else:
                    parts = {"expert products": sp["moe.experts"], "router": sp["moe.router"],
                             "dispatch and combine": sp["moe"] - sp["moe.experts"]
                             - sp["moe.router"],
                             "attention": attention}
                parts["other"] = busy - sum(parts.values())
                win["shares_of_wall"] = {k: v / win["wall_s"] for k, v in parts.items()}
                win["shares_of_wall"]["idle"] = win["device_idle_share"]
                print(f"profile {key} shares of the window's wall "
                      f"({'not measured: no device time under the ranges' if sp['moe'] == 0 else ''}"
                      f"): " + ", ".join(f"{k} {100 * v:.2f} %"
                                         for k, v in win["shares_of_wall"].items()), flush=True)
                out[f"profile_{key}"] = win
    del params, cache, logits_long
    torch.cuda.empty_cache()

    # the smoke configs on the card against the CPU (plain versions), f32
    torch.backends.cuda.matmul.allow_tf32 = False
    for small_arch in smoke_archs:
        small = smoke_config(small_arch).scaled(compute_dtype="float32")
        host = init_params(small, torch.Generator().manual_seed(1), "cpu")
        runs = []
        step = make_serve_step(small)
        for d, p in ((dev, _to(host, dev)), (torch.device("cpu"), host)):
            toks_in = prompt[:2, :16].remainder(small.vocab).to(d)
            with torch.inference_mode():
                lg = make_prefill_step(small)(p, {"tokens": toks_in})
                last, c = prefill_into_cache(p, small, toks_in, 24)
                seq = [last]
                for i in range(8):
                    nxt, _, c = step(p, c, seq[-1][:, None], 16 + i)
                    seq.append(nxt)
            runs.append((lg.cpu(), torch.stack(seq, 1).cpu()))
        (card_logits, card_tokens), (cpu_logits, cpu_tokens) = runs
        err = (card_logits - cpu_logits).abs().max().item()
        same = torch.equal(card_tokens, cpu_tokens)
        print(f"smoke {small_arch} f32: card vs CPU prefill logits max |diff| {err:.3e}; "
              f"greedy tokens equal: {same}")
        if not (err < 1e-4 and same):
            raise SystemExit(f"smoke {small_arch}: the card and the CPU disagree")
    return out


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# ---- the episode phase --------------------------------------------------------

# the figure sweep at the paper's shape: benchmarks/common.py's bench_settings()
# default (30 runs, seeds 1234 + i, GPU counts 1..8) over its five specs
EPISODE_NT, EPISODE_TILE, EPISODE_RUNS, EPISODE_GPUS = 16, 512, 30, tuple(range(1, 9))
# scale rows: (graph, NT), 132 configurations each (one an SM)
EPISODE_SCALE = (("cholesky", 32), ("lu", 32), ("qr", 32), ("cholesky", 64))
EPISODE_SCALE_CONFIGS = 132


def episode_outputs(res):
    """An episode result as a flat list of CPU tensors."""
    return [t.cpu() for t in (*res[:3], *(res[3] if len(res) > 3 else ()))]


def episode_compare(se, ep, plan, batch, dev, label, pad_to=None, extra=0, prio=None):
    """The kernel (reading the plan's tables, as run_episodes passes them)
    against the plain scan on the CPU and on the card: every output, the
    schedule's columns included, must be equal (torch.equal). ``prio``
    replaces the plan's priorities: the plan's tables must then be refused,
    and the kernel reads tables derived from the new inputs. Returns the
    largest |difference| seen."""
    use_cap = bool(np.isfinite(batch.cap).any())
    n_steps = plan.n + extra
    args = list(ep.episode_inputs(plan, batch, torch.device("cpu"), pad_to))
    dargs = list(ep.episode_inputs(plan, batch, dev, pad_to))
    tables = ep.episode_tables(plan, dev)
    if prio is not None:
        args[7] = torch.from_numpy(prio)
        dargs[7] = args[7].to(dev)
        try:
            se.episode_scan(*dargs, n_steps=n_steps, use_cap=use_cap, emit=True, tables=tables)
        except ValueError:
            pass
        else:
            raise SystemExit(f"episode_scan took the plan's tables with other priorities at {label}")
        tables = se.plan_tables(dargs)
    wants = [episode_outputs(se.episode_plain(*a, n_steps=n_steps, use_cap=use_cap, emit=True))
             for a in (args, dargs)]
    got = episode_outputs(se.episode_scan(*dargs, n_steps=n_steps, use_cap=use_cap, emit=True,
                                          tables=tables))
    torch.cuda.synchronize()
    err = 0.0
    names = ("makespan", "total_bytes", "n_placed") + se.SCHEDULE_COLUMNS
    for where, want in zip(("CPU", "card"), wants):
        for name, g, w in zip(names, got, want):
            if not torch.equal(g, w):
                raise SystemExit(f"episode_scan differs from its plain version on the {where} "
                                 f"in {name} at {label}")
            if g.is_floating_point():
                err = max(err, (g.double() - w.double()).abs().nan_to_num().max().item())
    if prio is None and not (got[2][:len(batch)] == plan.n).all():
        raise SystemExit(f"episode_scan left tasks unplaced at {label}")
    return err


def episode_bound(plan, args, tables):
    """(bound ms, bound_by, bytes, operations, heap bound ms) of one
    uncapped launch on the episode's inputs ``args`` and their ``tables``.
    Bytes: each input the function reads once (the plan's order in place
    of ``indeg0`` and ``prio``) and each output written once, at the HBM
    rate. Operations: what the function needs for this plan's tasks,
    counted from their real reads, writes and successors: per task and
    configuration, the transfer and affinity folds over the unique
    memories (2 n_u (reads + writes)), the scores and argmins over the
    resources (6 R), the hops of its reads (4 a read) and its successors'
    updates (2 each). Each is one f32 or integer instruction, at the f32
    instruction rate (an FMA counts as one). Selection is not counted: the
    order is an input, computed once per plan on the host. The heap bound
    is the definition used before the order was an input: the same plus,
    per task and configuration, a heap of the ready set (2 log2 n_pad
    compares), and every one of the 23 inputs read once."""
    n, n_pad, n_data = plan.n, plan.n_pad, plan.n_data
    reads = int((plan.read_ids[:n] < n_data).sum())
    writes = int((plan.write_ids[:n] < n_data).sum())
    succs = int((plan.succ_ids[:n] < n_pad).sum())
    per_config = (2 * plan.n_u * (reads + writes) + 6 * plan.n_res * n + 4 * reads + 2 * succs)
    B = args[13].shape[0]
    ops = B * per_config
    out_bytes = 12 * B

    def size(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    nbytes = size(a for i, a in enumerate(args) if i not in (6, 7)) + size([tables.order])
    nbytes += out_bytes
    bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    ops_ms = ops / H100_FP32_OPS * 1e3
    heap_ops = ops + B * 2 * math.ceil(math.log2(n_pad)) * n
    heap_ms = max((size(args) + out_bytes) / H100_HBM_BYTES_PER_S, heap_ops / H100_FP32_OPS) * 1e3
    return (max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), nbytes, ops,
            heap_ms)


def event_ms(fn, reps=3):
    """Mean ms of ``fn`` over ``reps`` calls after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def episode_phase(dev, se, ep, run_batch, cached_graph, paper_machine, graph_fns):
    """Kernel against its plain version on every case, then the
    full-width figure sweep through run_batch (the main path: its launch
    count is read from 0), then the scale rows. Returns the kernels-line
    entry."""
    from functools import partial

    from _episode_cases import FIGURE_SPECS, MIB, case_graph, cases, configs, plan_and_batch

    # 1. the kernel against its plain version -------------------------------
    checks = [(label, case_graph(graph_key), gpus, specs, seeds, caps, pad_to, extra)
              for label, graph_key, gpus, specs, seeds, caps, pad_to, extra in cases()]
    for kind, fn in graph_fns.items():
        for nt, seeds in ((4, (1234, 1235, 1236)), (8, (1234, 1235)), (16, (1234,))):
            g = cached_graph(partial(fn, nt, EPISODE_TILE, with_fns=False))
            checks.append((f"{kind}{nt}", g, EPISODE_GPUS, FIGURE_SPECS, seeds, (0,), None, 0))
        g = cached_graph(partial(fn, 8, EPISODE_TILE, with_fns=False))
        checks.append((f"{kind}8-caps", g, (2, 8), FIGURE_SPECS, (1234,), (0, 8 * MIB, 32 * MIB),
                       None, 0))
    g = cached_graph(partial(graph_fns["cholesky"], EPISODE_NT, EPISODE_TILE, with_fns=False))
    checks.append(("cholesky16-padded", g, (1, 8), FIGURE_SPECS, (77,), (0,), 16, 5))
    max_err = 0.0
    shapes = set()
    for label, g, gpus, specs, seeds, caps, pad_to, extra in checks:
        items = configs(g, gpus, specs, seeds, caps)
        plan, batch = plan_and_batch(items)
        shapes.add((plan.n_res, plan.r_pad, plan.w_pad, plan.s_pad))
        max_err = max(max_err, episode_compare(se, ep, plan, batch, dev, label, pad_to, extra))
    # priorities cut to three values (every selection a tie) with some -inf
    # (the order ends early; the later steps are inactive on task 0)
    g = cached_graph(partial(graph_fns["lu"], 8, EPISODE_TILE, with_fns=False))
    plan, batch = plan_and_batch(configs(g, (2, 8), FIGURE_SPECS, (5,)))
    for seed in range(3):
        rng = np.random.default_rng(seed)
        prio = rng.choice(np.array([1.0, 2.0, 3.0], np.float32), size=plan.n_pad)
        prio[rng.choice(np.arange(1, plan.n), size=seed, replace=False)] = -np.inf
        max_err = max(max_err, episode_compare(se, ep, plan, batch, dev, f"lu8-prio{seed}",
                                               extra=2, prio=prio))
    n_cases = len(checks) + 3
    for shape in sorted(shapes):
        if se.launcher_plan(*shape) != se.launch_plan(*shape):
            raise SystemExit(f"the launcher's plan {se.launcher_plan(*shape)} differs from "
                             f"launch_plan's at {shape}")
    print(f"episode_scan equal to its plain version (card and CPU, every output and schedule "
          f"column) on {n_cases} cases", flush=True)

    # 2. the figure sweep at full width: the main path ----------------------
    graphs = {k: cached_graph(partial(f, EPISODE_NT, EPISODE_TILE, with_fns=False))
              for k, f in graph_fns.items()}
    machines = {n: paper_machine(n) for n in EPISODE_GPUS}
    sweep = {
        k: [{"graph": g, "machine": machines[n], "strategy": s, "seed": 1234 + i, "noise": 0.03}
            for n in EPISODE_GPUS for s in FIGURE_SPECS for i in range(EPISODE_RUNS)]
        for k, g in graphs.items()
    }
    order_ms = {}
    for k in sweep:  # plans built and memoized before the clock
        plan, _ = plan_and_batch(sweep[k][:1])
        w0 = time.perf_counter()
        se.selection_order(plan.indeg0, plan.prio.astype(np.float32), plan.succ_ids)
        order_ms[k] = (time.perf_counter() - w0) * 1e3
    card, card_s = {}, {}
    se.episode_scan.launches = 0
    for k, items in sweep.items():
        w0 = time.perf_counter()
        card[k] = run_batch(items, device="cuda")
        torch.cuda.synchronize()
        card_s[k] = time.perf_counter() - w0
    sweep_launches = se.episode_scan.launches
    if sweep_launches != len(sweep):
        raise SystemExit(f"the sweep launched episode_scan {sweep_launches} times, want one per "
                         f"group ({len(sweep)})")
    cpu, cpu_s = {}, {}
    for k, items in sweep.items():
        w0 = time.perf_counter()
        cpu[k] = run_batch(items, device="cpu")
        cpu_s[k] = time.perf_counter() - w0
    if se.episode_scan.launches != sweep_launches:
        raise SystemExit("the CPU sweep launched the kernel")
    rows = []
    for k, items in sweep.items():
        n = len(graphs[k])
        for a, b in zip(card[k], cpu[k]):
            if a != b:
                raise SystemExit(f"{k}: the card's run_batch differs from the CPU's: {a} vs {b}")
            if a.n_placed != n or not math.isfinite(a.makespan) or a.makespan <= 0:
                raise SystemExit(f"{k}: a configuration placed {a.n_placed} of {n} tasks")
        plan, batch = plan_and_batch(items)
        args = ep.episode_inputs(plan, batch, dev)
        tables = ep.episode_tables(plan, dev)
        run = partial(se.episode_scan, *args, n_steps=plan.n, use_cap=False, emit=False,
                      tables=tables)
        # the launch alone (the wrapper's checks left out; the plan's tables
        # were built with the plan), back to back: the kernel's device time
        ms = event_ms(partial(se._launch, args, tables, n_steps=plan.n, use_cap=False,
                              emit=False))
        if not ms > 0:
            raise SystemExit(f"{k}: the kernel's device time read {ms} ms")
        w0 = time.perf_counter()
        plain_card = se.episode_plain(*args, n_steps=plan.n, use_cap=False, emit=False)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - w0) * 1e3
        if not all(torch.equal(x, y) for x, y in zip(run(), plain_card)):
            raise SystemExit(f"{k}: episode_scan differs from its plain version at full width")
        bound_ms, bound_by, nbytes, ops, heap_ms = episode_bound(plan, args, tables)
        state_b = 4 * se.state_words(plan.n_pad, plan.n_data + 1, plan.n_u, False)
        means = {}
        for s in FIGURE_SPECS:
            pick = [j for j, c in enumerate(items) if c["strategy"] == s
                    and c["machine"] is machines[8]]
            means[s] = {d: (float(np.mean([res[j].makespan for j in pick])),
                            float(np.mean([res[j].gbytes for j in pick])))
                        for d, res in (("card", card[k]), ("cpu", cpu[k]))}
        warps, smem = se.launch_plan(plan.n_res, plan.r_pad, plan.w_pad, plan.s_pad)
        row = dict(graph=k, nt=EPISODE_NT, tasks=n, configs=len(items), n_pad=plan.n_pad,
                   state_bytes=state_b, warps_a_block=warps, smem_a_block=smem,
                   order_ms=order_ms[k], wall_s=card_s[k], configs_per_s=len(items) / card_s[k],
                   tasks_per_s=len(items) * n / card_s[k], cpu_wall_s=cpu_s[k],
                   cpu_configs_per_s=len(items) / cpu_s[k], ms=ms,
                   plain_card_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   bytes=nbytes, operations=ops, share_of_bound=bound_ms / ms,
                   heap_bound_ms=heap_ms, share_of_heap_bound=heap_ms / ms,
                   means_8gpu=means)
        rows.append(row)
        print(f"episode sweep {k} NT {EPISODE_NT}: {len(items)} configs x {n} tasks, "
              f"state {state_b} B a config, {warps} configs a block ({smem} B shared), "
              f"order built in {order_ms[k]:.3f} ms, card wall {card_s[k]:.6f} s "
              f"({row['configs_per_s']:.1f} configs/s, {row['tasks_per_s']:.4g} tasks/s), "
              f"CPU plain wall {cpu_s[k]:.6f} s ({row['cpu_configs_per_s']:.2f} configs/s); "
              f"kernel {ms:.6f} ms, plain on the card {plain_ms:.3f} ms, bound {bound_ms:.6f} ms "
              f"({bound_by}; {nbytes} B, {ops} ops; {100 * bound_ms / ms:.3f} % of it; with a "
              f"heap of the ready set {heap_ms:.6f} ms, {100 * heap_ms / ms:.3f} %)", flush=True)
        for s, m in means.items():
            print(f"  8 GPUs {s:26s} mean makespan card {m['card'][0]:.9f} cpu {m['cpu'][0]:.9f}  "
                  f"mean GB card {m['card'][1]:.6f} cpu {m['cpu'][1]:.6f}", flush=True)

    # 3. scale rows ---------------------------------------------------------------
    scale = []
    order = [(n, s, 1234 + i) for i in range(4) for n in EPISODE_GPUS for s in FIGURE_SPECS]
    for kind, nt in EPISODE_SCALE:
        w0 = time.perf_counter()
        g = cached_graph(partial(graph_fns[kind], nt, EPISODE_TILE, with_fns=False))
        items = [{"graph": g, "machine": machines[n], "strategy": s, "seed": sd, "noise": 0.03}
                 for n, s, sd in order[:EPISODE_SCALE_CONFIGS]]
        plan, batch = plan_and_batch(items)
        setup_s = time.perf_counter() - w0
        w0 = time.perf_counter()
        se.selection_order(plan.indeg0, plan.prio.astype(np.float32), plan.succ_ids)
        scale_order_ms = (time.perf_counter() - w0) * 1e3
        before = se.episode_scan.launches
        w0 = time.perf_counter()
        res = run_batch(items, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        if se.episode_scan.launches != before + 1:
            raise SystemExit(f"{kind} NT {nt}: want one launch")
        if any(r.n_placed != len(g) or not math.isfinite(r.makespan) for r in res):
            raise SystemExit(f"{kind} NT {nt}: tasks left unplaced")
        args = ep.episode_inputs(plan, batch, dev)
        tables = ep.episode_tables(plan, dev)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = se._launch(args, tables, n_steps=plan.n, use_cap=False, emit=False)  # the launch alone
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        if not ms > 0:
            raise SystemExit(f"{kind} NT {nt}: the kernel's device time read {ms} ms")
        if not np.array_equal(out[0].cpu().numpy().astype(np.float64),
                              np.array([r.makespan for r in res])):
            raise SystemExit(f"{kind} NT {nt}: the kernel differs from run_batch")
        bound_ms, bound_by, _, _, heap_ms = episode_bound(plan, args, tables)
        row = dict(graph=kind, nt=nt, tasks=len(g), n_pad=plan.n_pad, configs=len(items),
                   state_bytes=4 * se.state_words(plan.n_pad, plan.n_data + 1, plan.n_u, False),
                   setup_s=setup_s, order_ms=scale_order_ms, wall_s=wall,
                   configs_per_s=len(items) / wall, tasks_per_s=len(items) * len(g) / wall,
                   ms=ms, bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms,
                   heap_bound_ms=heap_ms, share_of_heap_bound=heap_ms / ms)
        scale.append(row)
        print(f"episode scale {kind} NT {nt}: {len(items)} configs x {len(g)} tasks "
              f"(n_pad {plan.n_pad}, state {row['state_bytes']} B a config), graph and plan "
              f"{setup_s:.3f} s (the order {scale_order_ms:.3f} ms of it), run_batch wall "
              f"{wall:.6f} s ({row['tasks_per_s']:.4g} tasks/s), kernel {ms:.6f} ms, "
              f"bound {bound_ms:.6f} ms ({100 * bound_ms / ms:.4f} % of it; with a heap of the "
              f"ready set {100 * heap_ms / ms:.4f} %)", flush=True)

    head = next(r for r in rows if r["graph"] == "qr")  # the widest graph of the sweep
    return {
        "name": "episode_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sched_episode.cu",
        "replaces": "src/repro/kernels/sched_score.py:121",
        "replaces_with_it": "src/repro/core/episode.py:363 (_build_episode_fn, jitted scan :404-635)",
        "launches": sweep_launches,
        "launches_counted_in": "the NT 16 figure sweep through run_batch (one per group)",
        "exact": max_err == 0.0,
        "max_abs_err": max_err,
        "cases": n_cases,
        "ms": head["ms"],
        "plain_ms": head["plain_card_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": f"qr NT {EPISODE_NT} tile {EPISODE_TILE}: {head['configs']} configs x "
                 f"{head['tasks']} steps, n_pad {head['n_pad']}",
        "sweep": rows,
        "scale": scale,
    }


def paper_phase(ss, sp, se):
    """The paper's experiment through the port (``repro_torch.bench``):
    fig1-fig4 on the exact engine at the reference's fast depth and on the
    surrogate at the paper's, each engine's path driven with the kernels'
    counts set to 0 just before it and read just after; C1-C6 on both;
    fig2's card summaries against the CPU's. Returns the ``paper`` JSON
    entry and the launches by kernel."""
    from functools import partial

    from repro_torch.bench import common, figures
    from repro_torch.bench import paper_validation as pv

    counters = {"score_activation": ss.score_activation, "dada_place": sp.dada_place,
                "heft_select": sp.heft_select, "episode_scan": se.episode_scan}

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {name: fn.launches for name, fn in counters.items()}

    total = dict.fromkeys(counters, 0)
    depth = {"exact": (common.FAST_RUNS, common.FAST_GPUS),
             "surrogate": (common.PAPER_RUNS, common.PAPER_GPUS)}
    entry = {"card": card_line(), "nt": common.NT, "tile": common.TILE, "engines": {}}
    for engine, (n_runs, gpus) in depth.items():
        zero()
        figs = pv.run_figures(engine, n_runs, gpus, device="cuda")
        launches = read()
        rows = [f["rows"] for f in figs.values()]
        walls = {name: f["wall_s"] for name, f in figs.items()}
        for fig_rows in rows:
            for row in fig_rows:
                print(common.format_row(row), flush=True)
        zero()
        w0 = time.perf_counter()
        checks = pv.validate(*rows, device="cuda")  # C1-C5 on the rows, C6 through run_many
        c6_s = time.perf_counter() - w0
        c6_launches = read()
        for name in total:
            total[name] += launches[name] + c6_launches[name]
        ok = pv.print_checks(checks)
        n_items = sum(r["n_runs"] for fig_rows in rows for r in fig_rows)
        unit = "runs/s" if engine == "exact" else "configs/s"
        rate = pv.rate(figs)
        print(f"paper {engine}: {n_runs} runs x gpus {list(gpus)}, NT {common.NT}: walls "
              + ", ".join(f"{k} {v:.6f} s" for k, v in walls.items())
              + f"; {rate:.3f} {unit}; C1-C6 {c6_s:.6f} s; launches {launches}, C6 {c6_launches}",
              flush=True)
        if engine == "exact":
            placed = launches["dada_place"] + launches["heft_select"]
            if not (launches["dada_place"] and launches["heft_select"]
                    and launches["score_activation"] == placed and not launches["episode_scan"]):
                raise SystemExit(f"paper exact: launches {launches}, want one scoring and one "
                                 f"placement launch per activation and no episode_scan")
        elif launches != {"score_activation": 0, "dada_place": 0, "heft_select": 0,
                          "episode_scan": len(figures.FIGURES)}:
            raise SystemExit(f"paper surrogate: launches {launches}, want one episode_scan "
                             f"per figure and nothing else")
        if not (c6_launches["dada_place"] and c6_launches["score_activation"]
                == c6_launches["dada_place"]):
            raise SystemExit(f"paper {engine}: C6 launches {c6_launches}")
        entry["engines"][engine] = dict(
            runs=n_runs, gpus=list(gpus), items=n_items, wall_s=walls, rate=rate, unit=unit,
            launches=launches, c1_c6_wall_s=c6_s, c6_launches=c6_launches,
            claims=[dict(claim=c["claim"], measured=c["measured"], passed=bool(c["passed"]))
                    for c in checks],
            c6_ws_steals=checks[-1]["ws"].steals_mean)
        if not ok:
            raise SystemExit(f"paper {engine}: a claim failed")
        if engine == "exact":
            # the surrogate has no steals: only the exact engine's ws rows count them
            ws_steals = {name: {r["n_gpus"]: r["steals"] for r in f["rows"] if r["strategy"] == "ws"}
                         for name, f in figs.items() if name != "fig1_alpha_sweep"}
            entry["engines"][engine]["ws_steals"] = ws_steals
            if not all(x > 0 for v in ws_steals.values() for x in v.values()):
                raise SystemExit("paper exact: a ws row stole nothing")
        # fig2 at the fast depth on the card and with device="cpu", timed
        # alike: every Summary field must be equal
        fig2 = partial(common.sweep_summaries, "cholesky", common.STRATEGIES, common.FAST_RUNS,
                       gpus, engine=engine)
        w0 = time.perf_counter()
        card_rows = fig2(device="cuda")
        card_s = time.perf_counter() - w0
        w0 = time.perf_counter()
        cpu_rows = fig2(device="cpu")
        cpu_s = time.perf_counter() - w0
        if card_rows != cpu_rows:
            raise SystemExit(f"paper {engine}: fig2's card rows differ from the CPU's")
        entry["engines"][engine]["fig2_card_vs_cpu"] = dict(
            runs=common.FAST_RUNS, gpus=list(gpus), summaries=len(card_rows), equal=True,
            card_wall_s=card_s, cpu_wall_s=cpu_s)
        print(f"paper {engine}: fig2's {len(card_rows)} card summaries ({common.FAST_RUNS} runs) "
              f"equal the CPU's; wall card {card_s:.6f} s, CPU {cpu_s:.6f} s", flush=True)
    entry["launches"] = total
    return entry, total


AUDIT_LISTS = ("execs", "hops", "landings", "evictions", "faults", "notices", "retries",
               "timeouts", "arrivals", "admits", "rejects")


def same_log(a, b) -> bool:
    """Two audit logs hold the same records, field for field (floats ==)."""
    return (a.engine, a.machine, a.graphs, a.result) == (b.engine, b.machine, b.graphs, b.result) and all(
        getattr(a, k) == getattr(b, k) for k in AUDIT_LISTS)


def n_records(log) -> int:
    return sum(len(getattr(log, k)) for k in AUDIT_LISTS)


def verify_phase(ss, sp, se):
    """The main path under audit (exact engine and surrogate), every log
    re-checked by repro_torch.verify and held against the CPU's. Returns
    the ``verify`` JSON entry and the launches by kernel."""
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.core import Simulator
    from repro_torch.core import episode as ep
    from repro_torch.linalg.cholesky import cholesky_graph
    from repro_torch.linalg.lu import lu_graph
    from repro_torch.linalg.qr import qr_graph
    from repro_torch.sched import resolve
    from repro_torch.verify import errors, verify_audit

    from _episode_cases import configs, plan_and_batch

    counters = {"score_activation": ss.score_activation, "dada_place": sp.dada_place,
                "heft_select": sp.heft_select, "episode_scan": se.episode_scan}
    builders = {"cholesky": cholesky_graph, "lu": lu_graph, "qr": qr_graph}
    machine = paper_machine(8)
    out_dir = ROOT / "build" / "verify"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in out_dir.glob("*.jsonl"):
        old.unlink()

    def strategy(spec, device):
        return resolve(spec) if spec == "ws" else resolve(spec, device=device)

    def run(gname, spec, device, audit):
        sim = Simulator(builders[gname](16, 512), machine, strategy(spec, device), seed=0,
                        audit=audit)
        w0 = time.perf_counter()
        res = sim.run()
        torch.cuda.synchronize()
        return sim, res, time.perf_counter() - w0

    for fn in counters.values():
        fn.launches = 0
    exact, card_logs = [], []
    for gname in builders:
        for spec in ("heft", "dada?alpha=0.5&use_cp=1", "ws"):
            walls = {False: [], True: []}
            plain0 = sp.dada_place_plain.calls + sp.heft_select_plain.calls
            run(gname, spec, "cuda", False)  # warm-up: first-use costs, not timed
            for audit in (False, True, True, False, False, True):  # A B B A A B on the card
                sim, res, wall = run(gname, spec, "cuda", audit)
                walls[audit].append(wall)
                if audit:
                    card, card_res = sim, res
                else:
                    off_res = res
            if sp.dada_place_plain.calls + sp.heft_select_plain.calls != plain0:
                raise SystemExit(f"verify {gname} {spec}: a plain search ran in a card run")
            cpu, _, _ = run(gname, spec, "cpu", True)
            log = card.audit
            v0 = time.perf_counter()
            findings = verify_audit(log)
            verify_s = time.perf_counter() - v0
            errs = errors(findings)
            path = out_dir / f"{gname}-{card_res.strategy}.jsonl"
            log.to_jsonl(str(path))
            card_logs.append(path)
            row = dict(graph=gname, nt=16, strategy=card_res.strategy, tasks=len(card.graph),
                       records=n_records(log), execs=len(log.execs), hops=len(log.hops),
                       landings=len(log.landings), errors=len(errs),
                       warnings=len(findings) - len(errs), verify_s=verify_s,
                       wall_off_s=float(np.median(walls[False])),
                       wall_on_s=float(np.median(walls[True])),
                       walls_off_s=walls[False], walls_on_s=walls[True],
                       jsonl_bytes=path.stat().st_size)
            row["audit_overhead"] = row["wall_on_s"] / row["wall_off_s"]
            exact.append(row)
            print(f"verify exact graph={gname} NT=16 strategy={card_res.strategy} "
                  f"tasks={row['tasks']} records={row['records']} (execs {row['execs']}, hops "
                  f"{row['hops']}, landings {row['landings']}) errors={len(errs)} "
                  f"warnings={row['warnings']} verify_s={verify_s:.6f} wall off "
                  f"{row['wall_off_s']:.6f} s, on {row['wall_on_s']:.6f} s "
                  f"(x{row['audit_overhead']:.3f}; runs off {walls[False]}, on {walls[True]})",
                  flush=True)
            for f in errs[:5]:
                print(f"  {f}")
            if errs:
                raise SystemExit(f"verify {gname} {spec}: {len(errs)} verifier errors on the card's log")
            if not same_log(log, cpu.audit):
                raise SystemExit(f"verify {gname} {spec}: the card's audit log differs from the CPU's")
            if fingerprint(card_res) != fingerprint(off_res):
                raise SystemExit(f"verify {gname} {spec}: the audited result differs from audit off")
            if len(log.execs) != len(card.graph) or not log.hops:
                raise SystemExit(f"verify {gname} {spec}: log malformed")
    exact_launches = {name: fn.launches for name, fn in counters.items()}
    print(f"verify exact: launches {exact_launches}", flush=True)
    if not (exact_launches["dada_place"] and exact_launches["heft_select"]
            and exact_launches["score_activation"]
            == exact_launches["dada_place"] + exact_launches["heft_select"]
            and not exact_launches["episode_scan"]):
        raise SystemExit(f"verify exact: launches {exact_launches}")
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.verify", "schedule", *map(str, card_logs)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    summary = [line for line in cli.stdout.splitlines() if "error(s)" in line]
    clean = sum(" 0 error(s)" in line for line in summary)
    print(f"verify CLI (python -m repro_torch.verify schedule) over the card's {len(card_logs)} "
          f"logs: exit {cli.returncode}, {clean} with 0 errors", flush=True)
    if cli.returncode != 0 or clean != len(card_logs):
        raise SystemExit(f"python -m repro_torch.verify failed:\n{cli.stdout[-2000:]}{cli.stderr[-2000:]}")

    for fn in counters.values():
        fn.launches = 0
    surrogate = []
    for gname, build in builders.items():
        items = configs(build(16, 512, with_fns=False), (2, 4, 6, 8),
                        ("heft", "dada?alpha=0.5&use_cp=1"), tuple(range(1234, 1242)))
        plan, batch = plan_and_batch(items)
        w0 = time.perf_counter()
        out = ep.run_episodes(plan, batch, device="cuda", emit_schedule=True)
        card_s = time.perf_counter() - w0
        want = ep.run_episodes(plan, batch, device="cpu", emit_schedule=True)
        graph = items[0]["graph"]
        w0 = time.perf_counter()
        logs = ep.episode_audit_logs(graph, batch, out)
        logs_s = time.perf_counter() - w0
        cpu_logs = ep.episode_audit_logs(graph, batch, want)
        w0 = time.perf_counter()
        n_errs = [len(errors(verify_audit(log))) for log in logs]
        verify_s = time.perf_counter() - w0
        equal = sum(same_log(a, b) for a, b in zip(logs, cpu_logs))
        records = [n_records(log) for log in logs]
        row = dict(graph=gname, nt=16, configs=len(logs), records_min=min(records),
                   records_max=max(records), errors=sum(n_errs), equal_cpu=equal,
                   scan_s=card_s, logs_s=logs_s, verify_s=verify_s,
                   verify_s_per_log=verify_s / len(logs))
        surrogate.append(row)
        print(f"verify surrogate graph={gname} NT=16: {len(logs)} configs, records a log "
              f"{min(records)}..{max(records)}, errors {sum(n_errs)}, logs equal to the CPU's "
              f"{equal}/{len(logs)}; scan {card_s:.6f} s, logs {logs_s:.6f} s, verify "
              f"{verify_s:.6f} s ({row['verify_s_per_log']:.6f} s a log)", flush=True)
        if len(logs) != 64 or sum(n_errs) or equal != len(logs):
            raise SystemExit(f"verify surrogate {gname}: {sum(n_errs)} errors, {equal} of "
                             f"{len(logs)} logs equal to the CPU's")
        if not all(len(log.execs) == len(graph) for log in logs):
            raise SystemExit(f"verify surrogate {gname}: not every task placed")
    surrogate_launches = {name: fn.launches for name, fn in counters.items()}
    print(f"verify surrogate: launches {surrogate_launches}", flush=True)
    if surrogate_launches != {"score_activation": 0, "dada_place": 0, "heft_select": 0,
                              "episode_scan": len(builders)}:
        raise SystemExit(f"verify surrogate: launches {surrogate_launches}, want one "
                         f"episode_scan per graph")
    launches = {k: exact_launches[k] + surrogate_launches[k] for k in counters}
    entry = dict(card=card_line(), exact=exact, surrogate=surrogate, launches=launches,
                 exact_launches=exact_launches, surrogate_launches=surrogate_launches,
                 cli_exit=cli.returncode)
    return entry, launches


MB = 1024 * 1024
# the memory phase: the score-matrix policies (unbounded and at 64 MB) and
# the paper's two strategies under capacities, every run audited
MEMORY_POLICIES = ("locality", "priority", "wfq", "random")
MEMORY_CAPS = (128 * MB, 64 * MB, 32 * MB)


def memory_fingerprint(sim, res):
    """A run's fingerprint plus the memory's counters."""
    m = sim.metrics
    return fingerprint(res) + (m.n_evictions, m.n_writebacks, m.writeback_bytes,
                               tuple(sorted(sim.memory.max_resident.items())))


def memory_phase(ss, sp, se):
    """The score-matrix policies and the capacity-bounded memories on the
    card, the kernels' counts set to 0 just before and read just after,
    every run audited, verified and held against its device="cpu" twin;
    two tenants at priorities 1 and 2; C7's sweep on the card against the
    CPU's. Returns the ``memory`` JSON entry and the launches by kernel."""
    from repro_torch.bench import paper_validation as pv
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.core import Simulator
    from repro_torch.linalg.cholesky import cholesky_graph
    from repro_torch.linalg.lu import lu_graph
    from repro_torch.linalg.qr import qr_graph
    from repro_torch.runtime import Engine
    from repro_torch.sched import resolve
    from repro_torch.verify import errors, verify_audit

    counters = {"score_activation": ss.score_activation, "dada_place": sp.dada_place,
                "heft_select": sp.heft_select, "episode_scan": se.episode_scan}
    builders = {"cholesky": cholesky_graph, "lu": lu_graph, "qr": qr_graph}
    machine = paper_machine(8)

    def read():
        return {name: fn.launches for name, fn in counters.items()}

    def strategy(spec, device):
        # the device goes to every factory that declares one (random takes none)
        return resolve(spec) if spec == "random" else resolve(spec, device=device)

    def counted(strat, method):
        """Count ``strat``'s activations and time its backend calls."""
        acts, calls, call_s = [0], [0], [0.0]
        place = strat.place

        def counted_place(sim, ready, src):
            acts[0] += 1
            place(sim, ready, src)

        strat.place = counted_place
        if method is not None:
            fn = getattr(strat.backend, method)

            def timed(*args, **kwargs):
                s0 = time.perf_counter()
                out = fn(*args, **kwargs)
                call_s[0] += time.perf_counter() - s0
                calls[0] += 1
                return out

            setattr(strat.backend, method, timed)
        return acts, calls, call_s

    method_of = {"heft": "place_heft", "dada?alpha=0.5&use_cp=1": "place_dada",
                 "random": None}
    cases = [(g, spec, 0, "lru") for g in builders for spec in MEMORY_POLICIES]
    cases += [(g, spec, 64 * MB, "affinity") for g in builders for spec in MEMORY_POLICIES]
    cases += [(g, spec, cap, ev) for g in builders for spec in ("heft", "dada?alpha=0.5&use_cp=1")
              for cap in MEMORY_CAPS for ev in ("affinity", "lru")]
    for fn in counters.values():
        fn.launches = 0
    rows = []
    for gname, spec, cap, eviction in cases:
        out = {}
        for device in ("cuda", "cpu"):
            strat = strategy(spec, device)
            acts, calls, call_s = counted(strat, method_of.get(spec, "score_matrices"))
            sim = Simulator(builders[gname](16, 512), machine, strat, seed=0, audit=True,
                            mem_capacity=cap, eviction=eviction)
            before = read()
            w0 = time.perf_counter()
            res = sim.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - w0
            launches = {k: v - before[k] for k, v in read().items()}
            out[device] = dict(sim=sim, res=res, wall=wall, acts=acts[0], calls=calls[0],
                               call_s=call_s[0], launches=launches)
        card, cpu = out["cuda"], out["cpu"]
        sim, res, n = card["sim"], card["res"], len(card["sim"].graph)
        v0 = time.perf_counter()
        errs = errors(verify_audit(sim.audit))
        verify_s = time.perf_counter() - v0
        launches = card["launches"]
        placed = card["calls"]
        row = dict(graph=gname, nt=16, strategy=res.strategy, capacity=cap, eviction=eviction,
                   tasks=n, activations=card["acts"], placed=placed, launches=launches,
                   makespan=res.makespan, total_bytes=res.total_bytes,
                   evictions=sim.metrics.n_evictions, writebacks=sim.metrics.n_writebacks,
                   writeback_bytes=sim.metrics.writeback_bytes,
                   max_resident=max(sim.memory.max_resident.values(), default=0),
                   wall_s=card["wall"], ms_per_placed=card["call_s"] / max(placed, 1) * 1e3,
                   cpu_wall_s=cpu["wall"],
                   cpu_ms_per_placed=cpu["call_s"] / max(cpu["calls"], 1) * 1e3,
                   verify_errors=len(errs), verify_s=verify_s)
        rows.append(row)
        print(f"memory graph={gname} NT=16 strategy={res.strategy} capacity={cap // MB}MB "
              f"eviction={eviction} tasks={n} activations={card['acts']} placed={placed} "
              f"launches={launches} makespan={res.makespan!r} total_bytes={res.total_bytes} "
              f"evictions={row['evictions']} writebacks={row['writebacks']} "
              f"writeback_bytes={row['writeback_bytes']} max_resident={row['max_resident']} "
              f"wall_s={card['wall']:.6f} ms_per_placed={row['ms_per_placed']:.6f} "
              f"cpu_wall_s={cpu['wall']:.6f} cpu_ms_per_placed={row['cpu_ms_per_placed']:.6f} "
              f"verify_errors={len(errs)} verify_s={verify_s:.6f}", flush=True)
        label = f"memory {gname} {spec} {cap // MB}MB {eviction}"
        if memory_fingerprint(sim, res) != memory_fingerprint(cpu["sim"], cpu["res"]):
            raise SystemExit(f"{label}: the card run differs from the CPU run")
        if not same_log(sim.audit, cpu["sim"].audit):
            raise SystemExit(f"{label}: the card's audit log differs from the CPU's")
        if errs or sim.audit.machine["capacity"] != cap:
            raise SystemExit(f"{label}: {len(errs)} verifier errors, capacity "
                             f"{sim.audit.machine['capacity']} in the log")
        if sorted(iv.tid for iv in res.intervals) != list(range(n)):
            raise SystemExit(f"{label}: not every task ran exactly once")
        if cap and row["max_resident"] > cap:
            raise SystemExit(f"{label}: {row['max_resident']} B resident over {cap}")
        if any(cpu["launches"].values()):
            raise SystemExit(f"{label}: the CPU run launched a kernel")
        n_place = launches["dada_place"] + launches["heft_select"]
        if spec == "random":
            ok = not any(launches.values()) and placed == 0
        elif spec in MEMORY_POLICIES:
            ok = launches["score_activation"] == placed == card["acts"] and not n_place
        else:
            ok = launches["score_activation"] == n_place == placed == card["acts"]
        if not ok or launches["episode_scan"]:
            raise SystemExit(f"{label}: launches {launches} for {card['acts']} activations "
                             f"({placed} placed on the card)")
    if not any(r["evictions"] for r in rows):
        raise SystemExit("memory: no run evicted anything")
    runs_launches = read()

    # two Cholesky NT 16 tenants at priorities 1 and 2
    tenants = []
    for spec in ("priority", "wfq"):
        got = {}
        for device in ("cuda", "cpu"):
            eng = Engine(machine, resolve(spec, device=device), seed=0, audit=True)
            for prio in (1.0, 2.0):
                eng.submit(cholesky_graph(16, 512), priority=prio)
            w0 = time.perf_counter()
            results = eng.run()
            torch.cuda.synchronize()
            got[device] = (eng, results, time.perf_counter() - w0)
        (eng, results, wall), (cpu_eng, cpu_results, cpu_wall) = got["cuda"], got["cpu"]
        errs = errors(verify_audit(eng.audit))
        vt = list(getattr(eng.strategy, "_vt", {}).items())
        row = dict(strategy=spec, priorities=[1.0, 2.0], makespans=[r.makespan for r in results],
                   wall_s=wall, cpu_wall_s=cpu_wall, verify_errors=len(errs), virtual_times=vt)
        tenants.append(row)
        print(f"memory tenants strategy={spec} priorities 1, 2: makespans "
              f"{row['makespans']} wall_s={wall:.6f} cpu_wall_s={cpu_wall:.6f} "
              f"verify_errors={len(errs)} virtual times {vt}", flush=True)
        if [fingerprint(r) for r in results] != [fingerprint(r) for r in cpu_results] or (
                vt != list(getattr(cpu_eng.strategy, "_vt", {}).items())):
            raise SystemExit(f"memory tenants {spec}: the card run differs from the CPU run")
        if errs or not same_log(eng.audit, cpu_eng.audit):
            raise SystemExit(f"memory tenants {spec}: {len(errs)} verifier errors or logs differ")
    tenant_launches = {k: v - runs_launches[k] for k, v in read().items()}

    # C7: the capacity sweep on the card, its rows against the CPU's
    before = read()
    w0 = time.perf_counter()
    c7_rows = pv.capacity_sweep(device="cuda")
    c7_s = time.perf_counter() - w0
    c7_launches = {k: v - before[k] for k, v in read().items()}
    w0 = time.perf_counter()
    cpu_rows = pv.capacity_sweep(device="cpu")
    c7_cpu_s = time.perf_counter() - w0
    c7 = pv.check_c7(rows=c7_rows)
    pv.print_checks([c7])
    print(f"memory C7: wall card {c7_s:.6f} s, CPU {c7_cpu_s:.6f} s; launches {c7_launches}",
          flush=True)
    if c7_rows != cpu_rows:
        raise SystemExit("memory C7: the card's rows differ from the CPU's")
    if not c7["passed"]:
        raise SystemExit("memory C7: the claim failed")
    if not (c7_launches["dada_place"] and c7_launches["heft_select"]
            and c7_launches["score_activation"]
            == c7_launches["dada_place"] + c7_launches["heft_select"]):
        raise SystemExit(f"memory C7: launches {c7_launches}")
    launches = read()
    print(f"memory: launches {launches} (runs {runs_launches}, tenants {tenant_launches}, "
          f"C7 {c7_launches})", flush=True)
    entry = dict(card=card_line(), runs=rows, tenants=tenants, c7=dict(
        passed=True, measured=c7["measured"], rows=c7_rows, wall_s=c7_s, cpu_wall_s=c7_cpu_s,
        launches=c7_launches), launches=launches)
    return entry, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))  # _place_cases, _scan_cases: seeded kernel cases
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.configs.registry import get_config
    from repro_torch.core import Simulator, cached_graph, run_batch
    from repro_torch.core import episode as episode_mod
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import sched_episode as se
    from repro_torch.kernels import sched_place as sp
    from repro_torch.kernels import sched_score as ss
    from repro_torch.kernels import selective_scan as ssk
    from repro_torch.kernels import tile_gemm as tg
    from repro_torch.kernels._build import build_library
    from repro_torch.linalg import tiles
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.linalg.cholesky import cholesky_graph
    from repro_torch.linalg.execute import execute_graph, execute_schedule
    from repro_torch.linalg.lu import lu_graph
    from repro_torch.linalg.qr import qr_graph
    from repro_torch.sched import resolve

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    gc.callbacks.append(_on_gc)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # ---- 1. build ----------------------------------------------------------
    t0 = phase("build")
    card = card_line()
    print(card)
    kernel_modules = (ss, sp, tg, fa, fd, se, ssk)
    sources = [src for mod in kernel_modules for src in mod.SOURCES]
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, started together
        reports = list(pool.map(lambda src: build_library(src)[1], sources))
    for src, report in zip(sources, reports):
        print(f"{src.name}:")
        for line in report.splitlines():
            print(f"  {line.strip()}")
    for mod in kernel_modules:  # loads the libraries just built
        mod.build()
    gemm_ptxas = ptxas_table(reports[sources.index(tg._SRC)])
    if not gemm_ptxas:
        raise SystemExit("no ptxas report for tile_gemm.cu")
    for row in gemm_ptxas:
        print(f"gemm ptxas: {row}")
    place_ptxas = ptxas_table(reports[sources.index(sp._SRC)])
    if not place_ptxas:
        raise SystemExit("no ptxas report for sched_place.cu")
    for row in place_ptxas:
        print(f"place ptxas: {row}")
    scan_ptxas = ptxas_table(reports[sources.index(ssk._SRC)])
    if not scan_ptxas:
        raise SystemExit("no ptxas report for selective_scan.cu")
    for row in scan_ptxas:
        print(f"selective_scan ptxas: {row}")
    scan_plans = {name: ssk.scan_plan(name, dev) for name in ssk.PLAN_KINDS}
    for name, plan in scan_plans.items():
        print(f"selective_scan.cu plan, {name}: {plan}")
    done("build", t0)

    # ---- 2. kernels against their plain versions -----------------------------
    t0 = phase("kernel")
    machine = paper_machine(8)
    score_max_err, n_score = 0.0, 0
    rng = np.random.default_rng(0)
    for n in (1, 37, 128, 256):
        for n_u, n_res, host in ((9, 14, True), (25, 29, False), (30, 34, True), (40, 47, True)):
            for flags in flag_combinations():
                layout, packed, mach = activation_case(ss, rng, n, n_u, n_res, host, flags)
                cpu_args = (torch.from_numpy(packed), layout, torch.from_numpy(mach))
                card_args = (cpu_args[0].to(dev), layout, cpu_args[2].to(dev))
                got = ss.score_activation(*card_args)
                plain_card = ss.score_activation_plain(*card_args)
                plain_cpu = ss.score_activation_plain(*cpu_args)
                torch.cuda.synchronize()
                g = got.cpu()
                if g.shape != (layout.n_out,) or not torch.isfinite(g).all():
                    raise SystemExit(f"score_activation output malformed at {layout.spec}")
                for want in (plain_card.cpu(), plain_cpu):
                    if not torch.equal(g, want):
                        raise SystemExit(f"score_activation disagrees with its plain version at "
                                         f"{layout.spec}: max |diff| {(g - want).abs().max().item()}")
                score_max_err = max(score_max_err, (g - plain_cpu).abs().max().item())
                n_score += 1
    print(f"score_activation exactly equal to its plain version (card and CPU) on {n_score} cases "
          f"(max |err| {score_max_err})")
    # liveness: x_bias with +inf (detached) and finite notice columns
    n_score_live = 0
    for n in (1, 37, 128):
        for n_u, n_res, host in ((9, 14, True), (9, 12, True), (25, 29, False)):
            for flags in flag_combinations():
                if not flags["want_bias"]:
                    continue
                layout, packed, mach = activation_case(ss, rng, n, n_u, n_res, host, flags,
                                                       fault_bias=True)
                cpu_args = (torch.from_numpy(packed), layout, torch.from_numpy(mach))
                card_args = (cpu_args[0].to(dev), layout, cpu_args[2].to(dev))
                g = ss.score_activation(*card_args).cpu()
                plain_card = ss.score_activation_plain(*card_args).cpu()
                plain_cpu = ss.score_activation_plain(*cpu_args)
                if torch.isnan(g).any() or not torch.isinf(g).any():
                    raise SystemExit(f"score_activation with +inf x_bias: NaN, or no +inf, at "
                                     f"{layout.spec}")
                for want in (plain_card, plain_cpu):
                    if not torch.equal(g, want):
                        raise SystemExit(f"score_activation disagrees with its plain version on "
                                         f"+inf / notice x_bias at {layout.spec}")
                n_score_live += 1
    print(f"score_activation exactly equal to its plain version (card and CPU) on {n_score_live} "
          f"cases with +inf and notice-penalty x_bias columns")
    # the main path's widest activation: n 128 ready tasks of LU NT 64 on
    # paper_machine(8), every third datum moved to a GPU, DADA+CP's call
    lu_sim = Simulator(lu_graph(64, 512), machine, resolve("dada?alpha=0.5&use_cp=1"), seed=0)
    for k, name in enumerate(lu_sim.arrays.data_names):
        if k % 3 == 0:
            lu_sim.residency.write(name, k % 8)
        elif k % 3 == 1:
            lu_sim.residency.add_copy(name, (k + 1) % 8)
    tids = list(range(128))
    score_kwargs = dict(
        p_cpu=lu_sim.predictor(machine.cpus[0].cls).times(np.asarray(tids)).tolist(),
        p_gpu=lu_sim.predictor(machine.gpus[0].cls).times(np.asarray(tids)).tolist(),
        use_cp=True, affinity="accel_write",
    )
    backends = {"cuda": lu_sim.strategy.backend, "cpu": resolve("dada?alpha=0.5&use_cp=1", device="cpu").backend}
    calls = {d: be.score_matrices(lu_sim, tids, machine.resources, **score_kwargs) for d, be in backends.items()}
    for key, want in calls["cpu"].items():
        got = calls["cuda"][key]
        same = np.array_equal(got, want) if isinstance(want, np.ndarray) else got == want
        if not same:
            raise SystemExit(f"score_matrices on the card differs from the CPU in {key}")
    call_ms = {}
    for d, be in backends.items():
        for _ in range(20):
            be.score_matrices(lu_sim, tids, machine.resources, **score_kwargs)
        reps = 500 if d == "cuda" else 100
        w0 = time.perf_counter()
        for _ in range(reps):
            be.score_matrices(lu_sim, tids, machine.resources, **score_kwargs)
        call_ms[d] = (time.perf_counter() - w0) / reps * 1e3
    w0 = time.perf_counter()  # the host part alone: gathers and packing
    for _ in range(500):
        backends["cuda"].pack(lu_sim, tids, machine.resources, **score_kwargs)
    pack_ms = (time.perf_counter() - w0) / 500 * 1e3
    layout, packed, mach = backends["cuda"].pack(lu_sim, tids, machine.resources, **score_kwargs)
    d_in = packed.to(dev)
    d_out = torch.empty(layout.n_out, dtype=torch.float64, device=dev)
    score_ms = time_ms(lambda: ss.score_activation(d_in, layout, mach, out=d_out))
    score_plain_ms = time_ms(lambda: ss.score_activation_plain(d_in, layout, mach), reps=50)
    score_device_ms = graph_ms(lambda: ss.score_activation(d_in, layout, mach, out=d_out))
    if not torch.equal(d_out, ss.score_activation_plain(d_in, layout, mach)):
        raise SystemExit("score_activation disagrees with its plain version at the widest activation")
    spec = layout.spec
    score_shape = dict(n=spec.n, nnz_r=spec.nnz_r, nnz_w=spec.nnz_w, n_u=spec.n_u, n_res=spec.n_res)
    score_bytes = 8 * (layout.n_in + layout.n_mach + layout.n_out)
    # f64 operations: per read and memory a division, two additions and a
    # product; per access and memory an addition; per entry a bias and C
    score_ops = 4 * spec.nnz_r * spec.n_u + spec.nnz_w * spec.n_u + 2 * spec.n * spec.n_res
    score_bytes_ms = score_bytes / H100_HBM_BYTES_PER_S * 1e3
    score_ops_ms = score_ops / H100_FP64_FLOPS * 1e3
    score_bound_ms = max(score_bytes_ms, score_ops_ms)
    print(
        f"score_activation at {score_shape}: score_matrices {call_ms['cuda']:.6f} ms per call on the "
        f"card (copies and sync included; of which gathering and packing on the host "
        f"{pack_ms:.6f} ms; CPU backend {call_ms['cpu']:.6f} ms); kernel "
        f"{score_ms:.6f} ms per launch ({score_device_ms:.6f} ms on the device, from a CUDA graph), "
        f"plain {score_plain_ms:.6f} ms, bound {score_bound_ms:.3e} ms ({score_bytes} bytes, "
        f"{score_ops} flop)"
    )
    del backends, calls
    max_err = 0.0
    n_cases = 0
    for n_pad in (8, 64, 128, 256):
        for r_pad in (1, 2, 4):
            for n_u in (9, 25, 30):
                host_args = [torch.from_numpy(a) for a in full_case(rng, n_pad, r_pad, n_u)]
                masks, per_read, shift, host = [a.to(dev) for a in host_args]
                got = ss.transfer_matrix(masks, per_read, shift, host)
                plain_full = ss.transfer_matrix_from_full(masks, per_read, shift, host)
                col_bits = torch.tensor([1 << (u + 1) for u in range(n_u)], dtype=torch.int32, device=dev)
                plain_compact = ss.transfer_matrix_compact(
                    ss.compact_masks(masks, shift), per_read, col_bits, host
                )
                plain_cpu = ss.transfer_matrix_from_full(*host_args)
                torch.cuda.synchronize()
                g = got.cpu()
                if got.shape != (n_pad, n_u) or not torch.isfinite(g).all():
                    raise SystemExit(f"kernel output malformed at {(n_pad, r_pad, n_u)}")
                for want in (plain_full.cpu(), plain_compact.cpu(), plain_cpu):
                    if not torch.equal(g, want):
                        raise SystemExit(
                            f"kernel disagrees with its plain version at n_pad={n_pad} "
                            f"r_pad={r_pad} n_u={n_u}: max |diff| "
                            f"{(g - want).abs().max().item()}"
                        )
                max_err = max(max_err, (g - plain_cpu).abs().max().item())
                n_cases += 1
    print(f"kernel exactly equal to both plain versions on {n_cases} cases (max |err| {max_err})")
    # the main path's widest shape: n_pad 128 (LU NT 64), r_pad 4, n_u 9
    shape = (128, 4, 9)
    masks, per_read, shift, host = [
        torch.from_numpy(a).to(dev) for a in full_case(np.random.default_rng(1), *shape)
    ]
    kernel_ms = time_ms(lambda: ss.transfer_matrix(masks, per_read, shift, host))
    plain_ms = time_ms(lambda: ss.transfer_matrix_from_full(masks, per_read, shift, host))
    device_ms = graph_ms(lambda: ss.transfer_matrix(masks, per_read, shift, host))
    n, r, n_u = shape
    nbytes = n * r * 8 * 2 + n_u * (8 + 1) + n * n_u * 8
    flops = 2 * n * r * n_u
    bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    ops_ms = flops / H100_FP64_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(
        f"transfer_matrix at n_pad={n} r_pad={r} n_u={n_u}: kernel {kernel_ms:.6f} ms "
        f"per call ({device_ms:.6f} ms on the device, from a CUDA graph), "
        f"plain {plain_ms:.6f} ms, bound {bound_ms:.3e} ms ({nbytes} bytes, {flops} flop)"
    )
    xfer_kernel_phase_launches = ss.transfer_matrix.launches
    done("kernel", t0)

    # ---- 3. placement kernels against their plain versions, and their times --
    t0 = phase("place")
    place_cases, place_max_err = place_check(sp, dev)
    print(f"dada_place and heft_select exactly equal to their plain versions on {place_cases} cases "
          f"(max |err| {place_max_err})")
    place_plan = place_plan_check(sp)
    for row in place_ptxas:  # registers and spills of each instantiation
        print(f"place ptxas: {row}")
    place_rows, place_by_width = {}, {"dada_place": [], "heft_select": []}
    for width in PLACE_WIDTHS:
        for name, spec in (("dada_place", "dada?alpha=0.5&use_cp=1"), ("heft_select", "heft")):
            # LU NT 64's first `width` ready tasks, with the strategy's own
            # host preamble; n 128 is the main path's widest activation
            row = place_timing(sp, ss, name, spec, lu_sim, list(range(width)), machine, resolve,
                               dev, place_ptxas)
            place_by_width[name].append(row)
            if width == 128:
                place_rows[name] = row
    # n 128 again on a machine that lost a GPU and has another noticed:
    # DADA with recover takes the liveness inputs, HEFT the +inf and the
    # penalty through x_bias
    lu_sim.faults.active = True
    lu_sim.faults._mark(machine.gpus[0].rid, False)
    lu_sim.faults.noticed[machine.gpus[1].rid] = (0.0, 0.25)
    place_live = {}
    for name, spec in (("dada_place", "dada?alpha=0.5&use_cp=1&recover=1"),
                       ("heft_select", "heft")):
        place_live[name] = place_timing(sp, ss, name, spec, lu_sim, list(range(128)), machine,
                                        resolve, dev, place_ptxas)
        if not place_live[name]["live"]:
            raise SystemExit(f"{name}: the live timing took no liveness input")
    del lu_sim, tids
    missing_rows, missing_launches = missing_bytes_runs(
        ss, sp, resolve, Simulator, {"cholesky": cholesky_graph, "lu": lu_graph, "qr": qr_graph},
        machine)
    done("place", t0)

    # ---- 4. main path -------------------------------------------------------
    t0 = phase("main")
    builders = {"cholesky": cholesky_graph, "lu": lu_graph, "qr": qr_graph}
    specs = ("heft", "dada?alpha=0.5&use_cp=1")
    runs = [(g, nt, s, 1) for nt in (16, 64) for g in builders for s in specs]
    runs += [("cholesky", 64, s, 32) for s in specs]
    total_launches = 0
    place_launches = {"dada_place": 0, "heft_select": 0}
    main_rows = []
    for gname, nt, spec, min_wide in runs:
        results = {}
        for device in ("cuda", "cpu"):
            graph = builders[gname](nt, 512)
            strategy = resolve(spec, device=device, min_wide=min_wide)
            # activations, activations placed on the device and host time
            # spent in those calls, counted here only
            activations, placed, place_s = [0], [0], [0.0]
            place = strategy.place
            method = "place_heft" if spec == "heft" else "place_dada"
            backend_place = getattr(strategy.backend, method)

            def counted(sim, ready, src, place=place, activations=activations):
                activations[0] += 1
                place(sim, ready, src)

            def timed(*args, fn=backend_place, place_s=place_s, placed=placed, **kwargs):
                s0 = time.perf_counter()
                out = fn(*args, **kwargs)
                place_s[0] += time.perf_counter() - s0
                placed[0] += 1
                return out

            strategy.place = counted
            setattr(strategy.backend, method, timed)
            sim = Simulator(graph, machine, strategy, seed=0)
            ss.score_activation.launches = ss.transfer_matrix.launches = 0
            sp.dada_place.launches = sp.heft_select.launches = 0
            plain0 = sp.dada_place_plain.calls + sp.heft_select_plain.calls
            gc0 = dict(GC_FULL)
            w0 = time.perf_counter()
            res = sim.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - w0
            results[device] = dict(
                res=res, acts=activations[0], placed=placed[0], wall=wall, place_s=place_s[0],
                score_launches=ss.score_activation.launches, xfer=ss.transfer_matrix.launches,
                dada=sp.dada_place.launches, heft=sp.heft_select.launches,
                plain=sp.dada_place_plain.calls + sp.heft_select_plain.calls - plain0,
                gc_full=GC_FULL["count"] - gc0["count"], gc_full_s=GC_FULL["s"] - gc0["s"],
            )
        card, cpu = results["cuda"], results["cpu"]
        res, n_placed = card["res"], card["placed"]
        n_tasks = len(builders[gname](nt, 512))
        launches = card["dada"] + card["heft"]
        row = dict(graph=gname, nt=nt, strategy=res.strategy, min_wide=min_wide,
                   activations=card["acts"], placed=n_placed, score_launches=card["score_launches"],
                   place_launches=launches, plain_calls=card["plain"], wall_s=card["wall"],
                   place_s=card["place_s"], place_ms_per_act=card["place_s"] / max(n_placed, 1) * 1e3,
                   gc_full=card["gc_full"], gc_full_s=card["gc_full_s"], cpu_wall_s=cpu["wall"],
                   cpu_place_s=cpu["place_s"],
                   cpu_place_ms_per_act=cpu["place_s"] / max(cpu["placed"], 1) * 1e3,
                   cpu_gc_full=cpu["gc_full"], cpu_gc_full_s=cpu["gc_full_s"])
        main_rows.append(row)
        pr18 = PR18_WALL_S.get((gname, nt, res.strategy, min_wide))
        pr25 = PR25_WALL_S.get((gname, nt, res.strategy, min_wide))
        print(
            f"run graph={gname} NT={nt} strategy={res.strategy} min_wide={min_wide} "
            f"tasks={n_tasks} activations={card['acts']} placed={n_placed} "
            f"score_launches={card['score_launches']} place_launches={launches} "
            f"plain_calls={card['plain']} makespan={res.makespan!r} total_bytes={res.total_bytes} "
            f"wall_s={card['wall']:.6f} (PR 18: {pr18}, PR 25: {pr25}) place_s={card['place_s']:.6f} "
            f"place_ms_per_act={row['place_ms_per_act']:.6f} gc_full={card['gc_full']} "
            f"gc_full_s={card['gc_full_s']:.6f} cpu_wall_s={cpu['wall']:.6f} "
            f"cpu_place_ms_per_act={row['cpu_place_ms_per_act']:.6f} cpu_gc_full={cpu['gc_full']} "
            f"cpu_gc_full_s={cpu['gc_full_s']:.6f}",
            flush=True,
        )
        if sorted(iv.tid for iv in res.intervals) != list(range(n_tasks)):
            raise SystemExit("not every task ran exactly once")
        if not (math.isfinite(res.makespan) and res.makespan > 0 and res.total_bytes > 0):
            raise SystemExit("makespan or bytes out of range")
        if fingerprint(res) != fingerprint(cpu["res"]) or (card["acts"], n_placed) != (
                cpu["acts"], cpu["placed"]):
            raise SystemExit(f"{gname} NT={nt} {spec}: card run differs from the CPU run")
        if cpu["score_launches"] or cpu["xfer"] or cpu["dada"] or cpu["heft"]:
            raise SystemExit("the CPU run launched a kernel")
        if n_placed == 0 or not card["score_launches"] == launches == n_placed:
            raise SystemExit(f"{gname} NT={nt} {spec}: {card['score_launches']} scoring and "
                             f"{launches} placement launches for {n_placed} activations placed on "
                             f"the card")
        if card["plain"] != card["acts"] - n_placed:
            raise SystemExit(f"{gname} NT={nt} {spec}: {card['plain']} plain searches for "
                             f"{card['acts'] - n_placed} activations narrower than min_wide")
        if card["xfer"]:
            raise SystemExit(f"{gname} NT={nt} {spec}: the standalone transfer kernel ran on the main path")
        total_launches += card["score_launches"]
        place_launches["dada_place"] += card["dada"]
        place_launches["heft_select"] += card["heft"]
    print(f"main path: {total_launches} fused scoring launches and {sum(place_launches.values())} "
          f"placement launches ({place_launches}), one of each per activation placed on the card")
    done("main", t0)

    # ---- 5. gemm kernel against its plain version, and its times ------------
    t0 = phase("gemm")
    gemm_max_err = gemm_check(tg, dev)
    gemm_rows = gemm_timing(tg, dev)
    done("gemm", t0)

    # ---- 6. linalg: the tile factorizations executed on the card -------------
    t0 = phase("linalg")
    gens = {"cholesky": tiles.random_spd, "lu": tiles.random_dd, "qr": tiles.random_dense}
    nt = LINALG_N // LINALG_TILE
    for gname, build in builders.items():  # warm-up: library handles, first-use costs
        execute_graph(build(2, LINALG_TILE), tiles.split_tiles(gens[gname](2 * LINALG_TILE), LINALG_TILE))
    torch.cuda.synchronize()
    gemm_launches = {}  # per execution, by factorization
    gemm_total = 0  # over every execution of the phase
    gemm_split_total = 0  # of those, the calls whose plan split k
    for gname, build in builders.items():
        graph = build(nt, LINALG_TILE)
        n_gemm = sum(t.kind in GEMM_KINDS[gname] for t in graph.tasks)
        gemm_flops = sum(
            KERNEL_FLOPS_B3[t.kind] * LINALG_TILE ** 3
            for t in graph.tasks if t.kind in GEMM_KINDS[gname]
        )
        w0 = time.perf_counter()
        a = gens[gname](LINALG_N, seed=0)
        torch.cuda.synchronize()
        print(f"linalg {gname}: {LINALG_N}^2 f32 matrix made in {time.perf_counter() - w0:.3f} s "
              f"(numpy, seed 0); {len(graph)} tasks, {n_gemm} GEMM-shaped ({gemm_flops:.4e} flop)")
        schedules = {}
        for spec in specs:
            ss.score_activation.launches = 0
            w0 = time.perf_counter()
            schedules[spec] = Simulator(build(nt, LINALG_TILE), machine, resolve(spec), seed=0).run()
            torch.cuda.synchronize()
            print(f"  schedule {schedules[spec].strategy}: makespan={schedules[spec].makespan!r} "
                  f"score_activation launches={ss.score_activation.launches} "
                  f"wall_s={time.perf_counter() - w0:.3f}")
            if ss.score_activation.launches == 0:
                raise SystemExit(f"{gname} {spec}: no score_activation launch while scheduling")
        runs = [("program order", None)] + [(schedules[s].strategy, schedules[s]) for s in specs]
        reference = None
        for label, res in runs:
            tg.gemm_update.launches = 0
            tg.gemm_update.launches_split = 0
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            if res is None:
                store = execute_graph(graph, tiles.split_tiles(a, LINALG_TILE))
            else:
                store = execute_schedule(graph, tiles.split_tiles(a, LINALG_TILE), res)
            torch.cuda.synchronize()
            wall = time.perf_counter() - w0
            launches = tg.gemm_update.launches
            m = tiles.join_tiles(store, nt, LINALG_TILE)
            del store
            if m.shape != a.shape or not torch.isfinite(m).all():
                raise SystemExit(f"{gname} {label}: result malformed")
            if launches != n_gemm:
                raise SystemExit(f"{gname} {label}: {launches} gemm_update launches, want {n_gemm}")
            print(f"  execute {label}: wall_s={wall:.3f} gemm launches={launches} "
                  f"(split k: {tg.gemm_update.launches_split}) "
                  f"gemm GFLOP/s over the wall={gemm_flops / wall / 1e9:.1f}", flush=True)
            if reference is None:
                reference = m
            elif not torch.equal(m, reference):
                raise SystemExit(f"{gname} {label}: the replay differs from program order "
                                 f"(max |diff| {(m - reference).abs().max().item()})")
            gemm_launches[gname] = launches
            gemm_total += launches
            gemm_split_total += tg.gemm_update.launches_split
        err = residual(gname, a, reference)
        dense = dense_residual(gname, a)
        bound = RESIDUAL_BOUND[gname] if dense < RESIDUAL_BOUND[gname] else 4 * dense
        print(f"  residual {err:.3e} (bound {bound:.0e}); the card's dense factorization "
              f"{dense:.3e}; replays equal program order", flush=True)
        if not err < bound:
            raise SystemExit(f"{gname}: residual {err} over its bound {bound}")
        del a, reference, m
    # card against CPU at full tile width and a smaller depth
    for gname, build in builders.items():
        host = gens[gname](4 * LINALG_TILE, seed=1, device="cpu")
        got = tiles.join_tiles(
            execute_graph(build(4, LINALG_TILE), tiles.split_tiles(host.to(dev), LINALG_TILE)),
            4, LINALG_TILE).cpu()
        want = tiles.join_tiles(
            execute_graph(build(4, LINALG_TILE), tiles.split_tiles(host, LINALG_TILE)),
            4, LINALG_TILE)
        if gname == "qr":  # compared up to the signs of R's rows
            got, want = r_rows_signed(got), r_rows_signed(want)
        err = rel_err(got, want)
        print(f"linalg {gname} NT=4 tile={LINALG_TILE}: card vs CPU rel {err:.3e}"
              + (" (R up to row signs)" if gname == "qr" else ""))
        if not err < 1e-5:
            raise SystemExit(f"{gname}: card and CPU disagree (rel {err})")
    # gemm_update's share of each factorization's device time, profiled
    gemm_share = {}
    for gname, build in builders.items():
        graph = build(nt, LINALG_TILE)
        a = gens[gname](LINALG_N, seed=0)
        for _ in range(2):  # the first run warms the profiler up; the last is read
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                w0 = time.perf_counter()
                execute_graph(graph, tiles.split_tiles(a, LINALG_TILE))
                torch.cuda.synchronize()
                wall = time.perf_counter() - w0
        busy_us, top = device_time(prof)
        gemm_us = sum(us for name, us in top if "gemm_update" in name)
        gemm_share[gname] = {"device_busy_s": busy_us / 1e6, "gemm_update_s": gemm_us / 1e6,
                             "gemm_update_share": gemm_us / busy_us, "wall_s": wall}
        print(
            f"profile execute {gname} NT={nt} program order wall_s={wall:.3f} "
            f"device_busy_s={busy_us / 1e6:.6f} device_idle_share="
            f"{1.0 - busy_us / 1e6 / wall:.4f} gemm_update_s={gemm_us / 1e6:.6f} "
            f"gemm_update_share={gemm_us / busy_us:.4f}",
            flush=True,
        )
        for name, us in top[:6]:
            print(f"  {us / 1e6:.6f} s  {100 * us / busy_us:.1f} %  {name[:110]}")
        del a
    done("linalg", t0)

    # ---- 7. attention kernels against their plain versions, and their times --
    t0 = phase("attention")
    fa_err, fd_err, fa_err_dv, fd_err_dv = attention_check(fa, fd, dev)
    attn_rows = attention_timing(fa, fd, dev)
    torch.cuda.empty_cache()
    done("attention", t0)

    # ---- 8. serve: chatglm3-6b at full width and depth ----------------------
    t0 = phase("serve")
    served = serve_phase(fa, fd, dev)
    done("serve", t0)

    # ---- 8b. mla: minicpm3-4b at full width and depth --------------------------
    t0 = phase("mla")
    served_mla = serve_phase(fa, fd, dev, MLA_ARCH, smoke_archs=(MLA_ARCH,))
    done("mla", t0)

    # ---- 8c. moe: grok-1-314b and kimi-k2-1t-a32b at full width, depth cut -----
    t0 = phase("moe")
    served_moe = {}
    for arch, layers in MOE_ARCHS:
        w0 = time.perf_counter()
        served_moe[arch] = serve_phase(fa, fd, dev, arch, smoke_archs=(arch,), n_layers=layers)
        served_moe[arch]["wall_s"] = time.perf_counter() - w0
        print(f"moe {arch}: {served_moe[arch]['wall_s']:.3f} s", flush=True)
    done("moe", t0)

    # ---- 8d. hybrid: jamba-v0.1-52b at full width, 16 of its 32 layers --------
    t0 = phase("hybrid")
    scan_errs = scan_check(ssk, dev)
    hybrid_cfg = get_config(HYBRID_ARCH)
    mamba_step_gaps = mamba_step_check(dev, hybrid_cfg)
    mamba_layer = mamba_layer_kernels(ssk, mamba_mod, dev, hybrid_cfg)
    torch.cuda.empty_cache()
    served_hybrid = serve_phase(fa, fd, dev, HYBRID_ARCH, smoke_archs=(HYBRID_ARCH,),
                                n_layers=HYBRID_LAYERS)
    served_hybrid["mamba_step_gaps"] = mamba_step_gaps
    served_hybrid["mamba_layer_kernels"] = mamba_layer
    scan_rows = scan_timing(ssk, dev, hybrid_cfg.mamba_expand * hybrid_cfg.d_model,
                            hybrid_cfg.mamba_d_state)
    torch.cuda.empty_cache()
    served_hybrid["wall_s"] = time.perf_counter() - t0
    print(f"hybrid {HYBRID_ARCH}: {served_hybrid['wall_s']:.3f} s", flush=True)
    done("hybrid", t0)

    # ---- 9. profile ---------------------------------------------------------
    t0 = phase("profile")
    launch_structure = {}
    for spec in specs:
        strategy = resolve(spec)  # one object for both runs: its buffers are warm in the second
        method = "place_heft" if spec == "heft" else "place_dada"
        fn = getattr(strategy.backend, method)
        placed = [0]

        def counted(*args, fn=fn, placed=placed, **kwargs):
            placed[0] += 1
            return fn(*args, **kwargs)

        setattr(strategy.backend, method, counted)
        for _ in range(2):  # the first run warms the profiler up; the last is read
            placed[0] = 0
            sim = Simulator(cholesky_graph(16, 512), machine, strategy, seed=0)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                w0 = time.perf_counter()
                res = sim.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - w0
        busy_us, by_kernel = device_time(prof)
        counts = launch_counts(prof)
        per_act = {k: v / placed[0] for k, v in counts.items()}
        # each placement kernel's device time summed over the run
        place_sums = {k: sum(us for key, us in by_kernel if f"{k}_kernel" in key) / 1e3
                      for k in ("dada_place", "heft_select")}
        launch_structure[res.strategy] = dict(
            placed=placed[0], wall_s=wall, device_busy_s=busy_us / 1e6,
            device_idle_share=1.0 - busy_us / 1e6 / wall, counts=counts, per_activation=per_act,
            place_kernel_device_ms=place_sums)
        print(
            f"profile graph=cholesky NT=16 strategy={res.strategy} wall_s={wall:.6f} "
            f"device_busy_s={busy_us / 1e6:.6f} device_idle_share="
            f"{1.0 - busy_us / 1e6 / wall:.4f} placed={placed[0]} counts={counts} "
            f"per_activation={ {k: round(v, 4) for k, v in per_act.items()} } "
            f"placement kernel device ms summed over the run: {place_sums} "
            f"({sum(place_sums.values()) / placed[0] * 1e3:.3f} us a placed activation)",
            flush=True,
        )
        # the runtime calls are counted exactly; the device-side trace may
        # drop a few records, but must show no other device work
        n2 = 2 * placed[0]
        if (counts["launch_calls"], counts["memcpy_calls"]) != (n2, n2) or not (
                counts["kernels"] <= n2 and counts["memcpy"] <= n2 and counts["memset"] == 0):
            raise SystemExit(f"{res.strategy}: want two kernels and two memcpys per placed "
                             f"activation, got {counts} over {placed[0]}")
    done("profile", t0)

    # ---- 10. episode ---------------------------------------------------------
    t0 = phase("episode")
    episode_ptxas = ptxas_table(reports[sources.index(se._SRC)])
    if not episode_ptxas:
        raise SystemExit("no ptxas report for sched_episode.cu")
    for row in episode_ptxas:
        print(f"episode ptxas: {row}")
    episode_entry = episode_phase(
        dev, se, episode_mod, run_batch, cached_graph, paper_machine,
        {"cholesky": cholesky_graph, "lu": lu_graph, "qr": qr_graph})
    episode_entry["ptxas"] = episode_ptxas
    done("episode", t0)

    # ---- 11. paper -----------------------------------------------------------
    t0 = phase("paper")
    paper, paper_launches = paper_phase(ss, sp, se)
    done("paper", t0)

    # ---- 12. verify ----------------------------------------------------------
    t0 = phase("verify")
    verified, verify_launches = verify_phase(ss, sp, se)
    done("verify", t0)

    # ---- 13. memory ----------------------------------------------------------
    t0 = phase("memory")
    memory, memory_launches = memory_phase(ss, sp, se)
    done("memory", t0)

    # ---- 14. faults ----------------------------------------------------------
    t0 = phase("faults")
    faults, fault_launches = faults_phase(ss, sp, se)
    done("faults", t0)

    # ---- 15. serving ---------------------------------------------------------
    t0 = phase("serving")
    serving, serving_launches = serving_phase(ss, sp, se)
    done("serving", t0)

    # ---- 16. report ----------------------------------------------------------
    kernels = [{
        "name": "score_activation",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sched_score.cu",
        "replaces": "src/repro/kernels/sched_score.py:121",
        "replaces_with_it": "src/repro/core/backend.py:446 (_build_matrix_fn)",
        "launches": total_launches,
        "exact": score_max_err == 0.0,
        "max_abs_err": score_max_err,
        "cases": n_score,
        "ms": score_ms,
        "device_ms": score_device_ms,
        "score_matrices_ms": call_ms["cuda"],
        "pack_ms": pack_ms,
        "cpu_score_matrices_ms": call_ms["cpu"],
        "plain_ms": score_plain_ms,
        "bound_ms": score_bound_ms,
        "bound_by": "bytes" if score_bytes_ms >= score_ops_ms else "operations",
        "library_ms": None,
        "shape": score_shape,
        "launch_structure_cholesky_nt16": launch_structure,
        "launches_paper": paper_launches["score_activation"],
        "launches_verify": verify_launches["score_activation"],
        "launches_memory": memory_launches["score_activation"],
        "launches_faults": fault_launches["score_activation"],
        "launches_serving": serving_launches["score_activation"],
        "launches_missing_bytes": missing_launches["score_activation"],
        "cases_live_x_bias": n_score_live,
    }, {
        "name": "place",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sched_place.cu",
        "replaces": "src/repro/core/backend.py:633 / :877 (jitted, not Pallas)",
        "replaces_with_it": "src/repro/core/dada.py:452-490 (try_build at the searched λ)",
        "launches": sum(place_launches.values()),
        "launches_by_kernel": place_launches,
        "launches_paper": paper_launches["dada_place"] + paper_launches["heft_select"],
        "launches_paper_by_kernel": {k: paper_launches[k] for k in ("dada_place", "heft_select")},
        "launches_verify": verify_launches["dada_place"] + verify_launches["heft_select"],
        "launches_memory": memory_launches["dada_place"] + memory_launches["heft_select"],
        "launches_memory_by_kernel": {k: memory_launches[k] for k in ("dada_place", "heft_select")},
        "launches_faults": fault_launches["dada_place"] + fault_launches["heft_select"],
        "launches_faults_by_kernel": {k: fault_launches[k] for k in ("dada_place", "heft_select")},
        "launches_serving": serving_launches["dada_place"] + serving_launches["heft_select"],
        "launches_serving_by_kernel": {k: serving_launches[k]
                                       for k in ("dada_place", "heft_select")},
        "launches_missing_bytes": missing_launches["dada_place"],
        "missing_bytes_runs": missing_rows,
        "live_n128": place_live,
        "exact": place_max_err == 0.0,
        "max_abs_err": place_max_err,
        "cases": place_cases,
        "ms": place_rows["dada_place"]["ms"],
        "device_ms": place_rows["dada_place"]["device_ms"],
        "plain_ms": place_rows["dada_place"]["plain_ms"],
        "bound_ms": place_rows["dada_place"]["bound_ms"],
        "bound_by": place_rows["dada_place"]["bound_by"],
        "library_ms": None,
        "shape": "n 128, LU NT 64, DADA(0.5)+CP's call (heft_select: HEFT's call)",
        "redesigned": 22,
        "plan": place_plan,
        "by_kernel": place_rows,
        "by_width": place_by_width,
        "profile_device_ms": {k: v["place_kernel_device_ms"] for k, v in launch_structure.items()},
        "main_runs": main_rows,
    }, {
        "name": "transfer_matrix",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sched_score.cu",
        "replaces": "src/repro/kernels/sched_score.py:121",
        "launches": xfer_kernel_phase_launches,
        "launches_counted_in": "kernel phase (the main path runs score_activation)",
        "exact": max_err == 0.0,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "device_ms": device_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "shape": list(shape),
    }]
    head = gemm_rows[0]  # (512, 512, 512) f32 with trans_b: the syrk / gemm call
    kernels.append({
        "name": "gemm_update",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tile_gemm.cu",
        "replaces": "src/repro/kernels/tile_gemm.py:53",
        "launches": gemm_total,
        "launches_split": gemm_split_total,
        "launches_per_execution": gemm_launches,
        "max_abs_err": max(gemm_max_err.values()),
        "max_abs_err_by_dtype": gemm_max_err,
        "ms": head["ms"],
        "device_ms": head["device_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library_device_ms": head["library_device_ms"],
        "shape": head["shape"],
        "plan": head["plan"],
        "timings": gemm_rows,
        "ptxas": gemm_ptxas,
        "device_share_nt16": gemm_share,
    })
    for name, launches, err, err_dv, kernel_route, source, key in (
            ("flash_attention", served["fa_launches"], fa_err, fa_err_dv, "tc",
             "flash_attention_sm90.cu", "fa"),
            ("flash_decode", served["fd_launches"], fd_err, fd_err_dv, "split",
             "flash_decode_split.cu", "fd")):
        rows = [r for r in attn_rows if r["name"] == name]
        head = rows[0]  # the serving path's shape
        mla_row = next(r for r in rows if r.get("mla"))
        kernels.append({
            "name": name,
            "route": "cuda",
            "kernel_route": kernel_route,
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "simt_source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": {"flash_attention": "src/repro/kernels/flash_attention.py:71",
                         "flash_decode": "src/repro/kernels/flash_decode.py:65"}[name],
            "launches": launches,
            f"launches_{kernel_route}": served[f"{key}_launches_{kernel_route}"],
            "launches_mla": served_mla[f"{key}_launches"],
            f"launches_mla_{kernel_route}": served_mla[f"{key}_launches_{kernel_route}"],
            "launches_moe": sum(r[f"{key}_launches"] for r in served_moe.values()),
            f"launches_moe_{kernel_route}": sum(r[f"{key}_launches_{kernel_route}"]
                                                for r in served_moe.values()),
            "launches_moe_by_arch": {a: r[f"{key}_launches"] for a, r in served_moe.items()},
            "launches_hybrid": served_hybrid[f"{key}_launches"],
            f"launches_hybrid_{kernel_route}": served_hybrid[f"{key}_launches_{kernel_route}"],
            "max_abs_err": max(err.values()),
            "max_abs_err_by_route": err,
            "max_abs_err_dv_by_route": err_dv,
            "ms": head["ms"],
            "device_ms": head["device_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": head["label"],
            **{k: head[k] for k in ("n_split", "chunk") if k in head},
            "mla": {k: mla_row[k] for k in ("label", "ms", "device_ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms", "route")},
            "timings": rows,
        })
    episode_entry["launches_paper"] = paper_launches["episode_scan"]
    episode_entry["launches_verify"] = verify_launches["episode_scan"]
    episode_entry["launches_memory"] = memory_launches["episode_scan"]
    episode_entry["launches_faults"] = fault_launches["episode_scan"]
    episode_entry["launches_serving"] = serving_launches["episode_scan"]
    kernels.append(episode_entry)
    fused_bf16 = scan_errs["mamba_scan"]["bfloat16"]
    kernels.append({
        "name": "selective_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
        "replaces": "src/repro/models/mamba.py:82 (lax.scan; no Pallas kernel) with :79-80 and "
                    ":99-100 around it",
        "wrapper": "mamba_scan (the path); selective_scan (the f32 instantiation)",
        "launches": served_hybrid["ss_launches"],
        "launches_by_phase": {"hybrid": served_hybrid["ss_launches"]},
        "max_abs_err": fused_bf16["max_abs_err"],
        "max_rel_err": fused_bf16["max_rel_err"],
        "tol_rel": fused_bf16["tol_rel"],
        "errors": scan_errs,
        "ms": scan_rows["mamba_scan prefill"]["ms"],
        "device_ms": scan_rows["mamba_scan prefill"]["device_ms"],
        "plain_ms": scan_rows["mamba_scan prefill"]["plain_ms"],
        "bound_ms": scan_rows["mamba_scan prefill"]["bound_ms"],
        "bound_by": scan_rows["mamba_scan prefill"]["bound_by"],
        "sfu_only_ms": scan_rows["mamba_scan prefill"]["sfu_ms"],
        "library_ms": None,
        "shape": scan_rows["mamba_scan prefill"]["shape"],
        "decode_step": scan_rows["mamba_scan decode"],
        "f32_instantiation": {k: scan_rows[f"selective_scan {k}"] for k in ("prefill", "decode")},
        "mamba_layer_kernels": mamba_layer,
        "ptxas": scan_ptxas,
        "plans": scan_plans,
    })
    print(json.dumps({"serve": served}))
    print(json.dumps({"mla": served_mla}))
    print(json.dumps({"moe": served_moe}))
    print(json.dumps({"hybrid": served_hybrid}))
    print(json.dumps({"paper": paper}))
    print(json.dumps({"verify": verified}))
    print(json.dumps({"memory": memory}))
    print(json.dumps({"faults": faults}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
