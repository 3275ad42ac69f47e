#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of the repository:  python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device — the card's name and power limit (nvidia-smi) and
   ``torch.cuda.get_device_name``; exits 1 without CUDA.
2. build  — compiles ``src/repro_torch/kernels/csrc/blasx_gemm.cu``,
   ``flash_attention.cu``, ``mla_decode.cu`` and ``moe_experts.cu`` with
   nvcc, one process each, all at once, and
   prints the build seconds and ptxas's register report.
3. kernel — the hand-written batched long-K GEMM against its plain
   PyTorch version on the card, in f64/f32/bf16/f16, at the runtime's
   shape (G,S,M,K,N) = (4,16,1024,1024,1024), ragged shapes and small
   odd shapes, by normwise relative error.  Each call's path
   (``kernel_path``: wgmma for f16/bf16, dmma for f64, simt for f32) is
   printed; the shapes cover each tensor-core path's hazards (one
   64-tile, ragged M/N across item boundaries, M = 1, K = 8) and the
   16-bit shapes TMA cannot read in place, which are staged into a
   zero-padded copy first.  f32 is also held on every compiled simt
   block in both copy variants (16-byte; 4-byte at K % 4, N % 4 and an
   A base 4 bytes off 16), each launch's variant read from its tag in
   the launch ledger (``"16-byte"``, ``"4-byte"``).  At the runtime's
   shape it times the kernel on each compiled block of its path, the
   plain version and ``torch.matmul`` on the folded shape (a yardstick
   only), beside the least time the card could take (``bound_ms``); at
   an unaligned shape of the same size (K = 1020) it times the staged
   16-bit route (the staging copy and the kernel apart) and f32's 4-byte
   variant on every block (A one element past an aligned base), beside
   the 16-byte variant at the same shape from an aligned A.
4. main path — ``BlasxContext(backend="cuda", device="cuda")`` runs the
   paper's Fig. 7/10 regime (N=16384, tile 1024, 2 simulated devices)
   for DGEMM, SGEMM and a bf16 GEMM, an f16 GEMM at N=8192, SYRK/SYMM/
   TRMM/TRSM at N=8192 in f32 and a 2-device threads-mode DGEMM at
   N=4096, each checked against an f64 oracle on the card, with the
   kernel's launch counter held against the ledger; every bf16/f16
   launch must take the wgmma path and every f64 launch the dmma path
   (the launch ledger, ``build.launches``).  No phase may launch a
   16-bit GEMM on simt.
5. epilogue — the same GEMM kernel with a bias row and each activation
   (the reference's fused epilogue) against its plain version in f32,
   bf16 and f16, at the MLP's shape (M,K,N) = (1024,1024,3072) (the
   wgmma path in 16 bits) and ragged shapes (staged onto wgmma in 16
   bits, simt in f32); timed in bf16 at
   the MLP shape beside its bound and ``torch.addmm`` plus the
   activation (a yardstick only), by CUDA events, and for information
   by the device time ``torch.profiler`` records (these calls are about
   as short as their host side, which the events include).
6. attention — the flash-attention kernel against its plain version on
   the reference's test cases, the serving path's prefill shape (B=1,
   S=1024, H=16, Hkv=8, D=128) and the hazards (D = 8 and 16, Sq = 1,
   Sk = 65, non-causal Sq != Sk, a bhsd view), in f32 (max abs) and
   bf16/f16 (max abs and normwise), on the path ``flash_path`` names
   (mma for 16-bit, simt for f32), each launch checked in
   the launch ledger; then each dtype with a seq stride off the
   16-byte copies (one element of padding a row), staged into contiguous
   copies (the ``"staged"`` tag).  Timed at the prefill shape on each
   (path, dtype), and staged (the staging copies and the kernel apart),
   beside its bound and ``scaled_dot_product_attention`` (a yardstick
   only: the port never calls it), by CUDA events and by the device time
   ``torch.profiler`` records.  The other families' prefill attention
   is held and timed the same way in each dtype: Zamba2-2.7B's shared
   block (B 1, S 1024, H 32, Hkv 32, D 80, causal) and SeamlessM4T's
   encoder (H 16, D 64, non-causal).
7. serve — ``repro_torch.launch.serve.run`` at Qwen3-0.6B's full width in
   bf16 (random weights from a seed): 16 requests of 1024-token prompts,
   32 new tokens each, 8 slots.  Checks every request and token, every
   logit finite, the flash kernel launched once per layer and prefill
   (28 x 16), every launch bf16 on the mma path, and one prompt's last
   logits through the kernel against
   the plain "sdpa" attention backend on the card.

8. api — runs right after phase 4, on the card: all 12 CBLAS routines
   at N=4096 (the d family in f64, the s family in f32) from col-major
   flat buffers with ld = N + 64 and beta != 0, each normwise against an
   f64 oracle (1e-12 DGEMM, 1e-5 SGEMM, 1e-8 DTRSM, 1e-10 the other f64
   routines, 1e-4 the other f32 ones) with the padding between columns
   checked untouched; ``cblas_dgemm`` row-major at N=16384 (padded ld)
   timed beside ``ctx.gemm`` at the same N; four chained f32 GEMMs at
   N=8192 through ``ctx.submit`` (an error future first, then the
   chain); ``gemm_batched`` of 8 f32 4096^2 GEMMs on one weight handle,
   twice (the second moves fewer H2D bytes); ``BlasxContext(auto_tune=
   True)`` tuning an f32 GEMM at N=8192 (``tile="auto"``); and a
   ``BlasxServer`` of 2 contexts x 2 simulated devices serving an
   interactive f32 tenant (16 GEMMs), a quota'd bf16 flood (32) and an
   f64 tenant (8) at 4096^2, every result against its oracle, per-tenant
   latency, throughput and quota evictions printed, the server's launches
   on wgmma (bf16), dmma (f64) and simt (f32).  Its numbers go on a
   ``{"api": ...}`` JSON line.

9. analysis — runs after phase 7, on the card: the port's static
   gate (``python -m repro_torch.analysis --strict src/repro_torch``)
   and its lock-witness smoke (``--witness-smoke``: GEMM, SYRK and TRSM
   on a 2-device threads-mode context, then a 2-lane server, all on the
   card), each a subprocess that must exit 0, with its report line
   printed; then, in this process under ``LockWitness().activate()``, a
   fresh 2-device threads-mode ``BlasxContext(backend="cuda",
   device="cuda", work_centric=True)`` runs DGEMM and SGEMM at N=2048
   (4 owner tasks under 2 devices x 4 streams: every task splits) and
   N=4608 (the ragged edge tiles split), tile 1024.  Each result must be
   ``torch.equal`` to an owner-mode sim run of the same inputs on the
   card and normwise within phase 8's GEMM limits (1e-12 f64, 1e-5 f32)
   of the f64 product on the card, each call's ledger must show partial
   tasks, every f64 launch
   must take dmma and every f32 launch simt, and the witness must
   report 0 inversions over more than 0 witnessed locks.  Its numbers go
   on an ``{"analysis": ...}`` JSON line.

10. families — runs after phase 9, bf16 at full width, random weights
   from a seed, one model at a time (each freed, its peak memory
   printed): OLMoE-1B-7B, Zamba2-2.7B and Mamba2-780M through
   ``launch.serve.run`` (4 requests of 1024-token prompts, 16 new tokens
   each, 4 slots); SeamlessM4T-medium through ``Model.prefill`` (128
   tokens, 1024 encoder frames: the audio frontend is a stub in the
   reference too) and 16 ``Model.decode`` steps; DeepSeek-V3 at full
   width with its depth cut to 4 layers (3 dense, 1 MoE of 256 experts)
   and the MTP block, through ``Server.admit`` / ``step`` (2 requests of
   1024 tokens, 16 new tokens).  Each checks every request and token,
   every logit finite, K5's launches exactly self-attention layers x
   prefills on the mma path in bf16, by shape tag (``"d80,causal"``),
   and, where it reaches K5, one prompt's last logits against the plain
   "sdpa" backend; DeepSeek-V3's MLA decode kernel launched once a layer
   and decode step, each launch's output held against the plain version
   on that call's own operands (the layer's cache views, ``idx``, q_c,
   q_rope: B 2, Skv 1056, several splits of the positions merged).  Its
   numbers go on a ``{"families": ...}`` JSON line.

11. train — runs after phase 10: the multi-device slice and the
   training path at world size 1.  An NCCL process group of one rank
   (``file://`` store in a temp dir) and the (1, 1) (data, model) mesh;
   ``distributed_gemm`` in ring and gspmd modes at 8192^3 and a ragged
   8191 x 8190 x 8192, f32 and bf16, each within the reference's limit
   (1e-3 / 1.0 max abs) scaled by sqrt(K / 128) of an f64 oracle on the
   card, its collectives counted (a one-card ring makes no hop: the hop
   schedule is held by the gloo twins); ``tp_matmul`` column then row at
   Qwen3-0.6B's MLP (B 8, S 1024, 1024 -> 3072 -> 1024) in bf16 against
   the unsharded product (2e-2 normwise); then ``launch.train.run`` at
   Qwen3-0.6B's full width (28 layers, bf16 parameters, f32 moments,
   random weights from a seed) on the mesh: 6 steps of 8 x 1024 tokens
   with a checkpoint every 3, then again to 9 steps, which must resume
   at 6 and train 3; every loss finite, the checkpoint's keys and shapes
   the live tree's, the first loss within 1e-6 of a run without the
   mesh, no hand kernel launched (neither has a backward); the bytes
   rank 0 holds for parameters, gradients and moments on the mesh must
   equal the reference's placed bytes for the config's shapes.  The
   loop's step is donated: every step must return the parameters and
   moments it was given, in their storage (``kept_storage``); one
   donated and one undonated step from fresh weights are measured for
   their peak, the donated one no higher.  Median step ms, tokens/s, the
   run's peak allocated GiB beside the two steps', and the held and
   placed bytes go on a ``{"train": ...}`` JSON line.

12. dryrun — runs after phase 11: the dry-run slice.  (a) At world size
   1 (an NCCL group of one rank, the (1, 1) mesh), the dry-run's trace
   on fake tensors (``launch.dryrun.trace_step``) predicts the FLOPs and
   the peak allocated bytes of one Qwen3-0.6B training step at full
   width (8 x 1024 tokens, bf16 parameters, f32 moments) and of one
   1024-token prefill; one real step of each on the card, under
   ``FlopCounterMode`` after ``reset_peak_memory_stats``, must count
   the same FLOPs and peak within 10% of the prediction; the prefill's
   K5 launches must be 28 on mma in bf16 (it counts K5 through the
   operator's registered flop formula); the step's time is printed
   beside ``Roofline.bound_s``.  (b) ``python -m
   repro_torch.launch.dryrun`` in subprocesses, 8 at a time, at full
   depth on the (16, 16) mesh over a fake 256-rank group for every
   architecture at train_4k and prefill_32k, Qwen3-0.6B at decode_32k,
   and ``--multi-pod --no-costs`` for Qwen3-0.6B and DeepSeek-V3 at
   train_4k; each must exit 0 and hold its arguments at their
   placements (``argument_size_in_bytes`` equal to
   ``argument_size_placed_in_bytes``).  Its numbers go on a
   ``{"dryrun": ...}`` JSON line.

13. mla_decode — runs after phase 12: MLA's absorbed-decode kernel
   (``src/repro_torch/kernels/csrc/mla_decode.cu``) at the benchmark
   cell's shape, one layer (256 slots, 128 heads, a bf16 latent cache of
   8192 positions, live lengths the cell's stratified prompts plus 400
   steps), against its plain version (the f32 decode over the padded
   cache it replaced) normwise by slot; timed by CUDA events and
   profiler device time beside the cell's ``Counts`` bound and the
   kernel's own, the plain version and one batched bf16 decode padded
   to the longest live length (``library_ms``, a yardstick only); and
   one ``Server.step`` of a small bf16 MLA model (H 4, one split) must
   launch the kernel once a layer on wgmma, each launch held against the
   plain version on its own operands.  Its numbers go on a
   ``{"mla_decode": ...}`` JSON line.  Phases 1, 2 and 13 alone:
   ``python3 -c 'import chip_smoke as s; c = s.phase_device();
   s.warm_profiler(); s.phase_build(); s.phase_mla_decode(c)'``.

14. moe_experts — runs after phase 13: the held experts' grouped kernels
   (``src/repro_torch/kernels/csrc/moe_experts.cu``) at the benchmark
   cell's decode shape (256 tokens, top 8 of 256 by the published router
   on seeded inputs, experts 0-7 held, d 7168, ff 2048, bf16) and at its
   longest prefill (4096 tokens), one layer, against their plain version
   (the per-expert loop with the kernels' numerics) by the worst token's
   normwise error; each call must launch ``moe_experts`` twice (tags
   ``gate_up`` and ``down``) and ``moe_layout`` once.  Timed by CUDA
   events and profiler device time (each kernel apart) beside the
   cell's ``Counts`` bound (the used experts' weights read once), the
   plain version and, as ``library_ms``, the layer's loop before the
   kernels (one ``torch.matmul`` an expert and weight, its counts read
   to the host; a yardstick the port no longer calls).  Its numbers go
   on a ``{"moe_experts": ...}`` JSON line.  Phases 1, 2 and 14 alone:
   ``python3 -c 'import chip_smoke as s; c = s.phase_device();
   s.warm_profiler(); s.phase_build(); s.phase_moe_experts(c)'``.

Phases 4, 8, 7, 9, each model of 10, 11 and 12's prefill are the main
paths, in that order: each kernel's launch count is set to 0 just before each and read
just after it (in phase 9 before the owner-mode comparison runs, in
phase 10 before the sdpa comparison).
The last two lines are a
JSON object describing each kernel and then
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/blasx_gemm.cu"
# the Pallas kernel it replaces: matmul_pallas, which reaches
# pl.pallas_call (body _matmul_kernel at :37, wrapper ops.matmul at
# ops.py:50, batched by pallas_backend._batched_pallas_contract at :47)
REPLACES = "src/repro/kernels/matmul.py:74"
# the epilogue variant replaces the bias body _matmul_bias_kernel
EPILOGUE_REPLACES = "src/repro/kernels/matmul.py:56"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
# flash_attention_bhsd, which reaches pl.pallas_call (body _flash_kernel
# at :29, layout wrapper flash_attention at :132)
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:78"
MLA_SOURCE = "src/repro_torch/kernels/csrc/mla_decode.cu"
# replaces no TPU kernel: the reference's absorbed decode is plain jnp
MLA_REPLACES = ("none: the reference's absorbed decode is plain jnp "
                "(src/repro/models/attention.py)")
MOE_SOURCE = "src/repro_torch/kernels/csrc/moe_experts.cu"
# replaces no TPU kernel: the reference's MoE is einsums
MOE_REPLACES = ("none: the reference's MoE is einsums over capacity "
                "buffers (src/repro/models/moe.py)")
SOURCES = ("blasx_gemm", "flash_attention", "mla_decode", "moe_experts")

# least-time model: the H100 SXM data sheet's peaks, from the port's
# roofline module (FP64 on the tensor cores, FP32 outside them, bf16/
# fp16 on the tensor cores; HBM3 at 3.35 TB/s)
from repro_torch.launch.roofline import PEAK_NAME, least_time  # noqa: E402
# the hand kernels' launch ledger (``build.launches``, ``build.snapshot``)
from repro_torch.kernels import build  # noqa: E402

# kernel vs plain version, normwise relative error: f64 and f32 are
# FMA sums in another order (f32 never takes TF32); bf16/f16 round the
# f32 sums to 8/11 bits
KERNEL_TOL = {"float64": 1e-12, "float32": 1e-4, "bfloat16": 2e-2,
              "float16": 2e-2}
# epilogue vs plain version, normwise: the GEMM's tolerances
EPI_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-2}
EPI_MAIN = (1024, 1024, 3072)   # Qwen3-0.6B's MLP up/gate projection
EPI_SHAPES = [EPI_MAIN, (100, 70, 130), (1, 200, 300), (513, 129, 257)]
ACTIVATIONS = (None, "relu", "gelu", "silu", "tanh")
# flash vs plain version, max abs: the reference's test tolerances
# (f32 sums in another order; bf16 rounds the output to 8 bits); f16 is
# held to bf16's limits, which its longer mantissa makes stricter for it
FLASH_TOL = {"float32": 2e-5, "bfloat16": 5e-2, "float16": 5e-2}
# 16-bit also normwise: at the prefill shape a typical |o| is ~0.076, so
# 5e-2 max abs is loose.  On an H100 the sound kernel read <= 4.5e-5 and
# the subtlest fault planted by tools/flash_fault_margin.py (the output
# rounded toward zero) 3.9e-3 (PERF.md); P rounded once to bf16 before
# PV (the FA-2/3 shortcut) reads ~2e-3 on the CPU
FLASH_NORMWISE_TOL = {"bfloat16": 1e-3, "float16": 1e-3}
FLASH_DTYPES = ("float32", "bfloat16", "float16")
# (B, Sq, Sk, H, Hkv, D, causal): test_kernels.py's FLASH_CASES, then
# the serving path's prefill shape
FLASH_MAIN = (1, 1024, 1024, 16, 8, 128, True)
FLASH_CASES = [(2, 256, 256, 4, 4, 64, True), (1, 200, 200, 4, 2, 32, True),
               (2, 128, 384, 8, 2, 64, False), (1, 130, 130, 2, 1, 16, True),
               (1, 64, 64, 1, 1, 128, True), FLASH_MAIN]
# the mma path's hazards: D = 8 and 16 across blocks, Sq = 1, one key
# past a block, non-causal Sq != Sk, causal Sq < Sk
FLASH_HAZARDS = [(2, 37, 37, 4, 2, 8, True), (2, 130, 130, 4, 1, 8, True),
                 (1, 300, 170, 4, 2, 16, True), (1, 1, 1, 4, 2, 128, True),
                 (1, 1, 200, 4, 2, 64, False), (1, 65, 65, 4, 2, 128, True),
                 (1, 100, 65, 4, 2, 32, False), (1, 70, 200, 2, 1, 64, True)]
# the other families' prefill attention (phase 6): Zamba2-2.7B's shared
# block (d_model 2560 / 32 heads = D 80, causal) and SeamlessM4T-medium's
# encoder (D 64, non-causal), at a 1024-token prompt
FLASH_FAMILY = [(1, 1024, 1024, 32, 32, 80, True),
                (1, 1024, 1024, 16, 16, 64, False)]
# the serve phase: Qwen3-0.6B, 28 layers, bf16
SERVE = dict(arch="qwen3_0_6b", smoke=False, batch_slots=8, prompt_len=1024,
             max_len=1088, requests=16, max_new=32, seed=0, device="cuda")
# the families phase (10), bf16 at full width, random weights from a
# seed: (arch, route, config changes).  "serve" goes through
# launch.serve.run; "model" through Model.prefill / decode with encoder
# states (the audio frontend is a stub in the reference too; run serves
# no encdec model); "server" through Server.admit / step at a cut depth
# (DeepSeek-V3's 3 dense layers, 1 MoE layer of 256 experts and the MTP
# block: 61 layers do not fit one card)
FAMILIES = [("olmoe_1b_7b", "serve", {}), ("zamba2_2_7b", "serve", {}),
            ("mamba2_780m", "serve", {}),
            ("seamless_m4t_medium", "model", {}),
            ("deepseek_v3_671b", "server", {"n_layers": 4})]
FAMILY_SERVE = dict(smoke=False, batch_slots=4, prompt_len=1024,
                    max_len=1056, requests=4, max_new=16, seed=0,
                    device="cuda")
FAMILY_MODEL = {"prompt_len": 128, "enc_len": 1024, "steps": 16}
FAMILY_SERVER = {"requests": 2, "slots": 2, "prompt_len": 1024,
                 "max_new": 16}
# the reference's bf16 flash tolerance; on an H100 the sound kernel read
# 1.6e-2 and a planted 16-key drop on the last q-block 1.3e-1 (PERF.md)
SERVE_LOGIT_TOL = 5e-2
MAIN_SHAPE = (4, 16, 1024, 1024, 1024)
# the tensor-core paths' hazards: one 64-tile, ragged M/N with aligned
# strides across item boundaries, M = 1 with K = N = 8, and an uneven
# 200 x 96 x 136; then unaligned shapes (simt in 16 bits)
SHAPES = [MAIN_SHAPE, (1, 1, 64, 64, 64), (2, 3, 1000, 64, 1000),
          (1, 1, 1, 8, 8), (3, 2, 200, 96, 136), (3, 2, 1000, 997, 1003),
          (1, 1, 1024, 1024, 1024), (1, 1, 1, 7, 5), (2, 3, 65, 33, 129),
          (5, 1, 17, 300, 31), (1, 4, 128, 64, 64)]
# the runtime's size with K off the 8 TMA needs: timed with 16-bit
# operands staged onto wgmma, and in f32 with A SIMT_A_OFFSET elements
# past an aligned base, which takes the 4-byte copy variant (K and N
# are multiples of 4: from an aligned base it is 16-byte)
SIMT_SHAPE = (4, 16, 1024, 1020, 1024)
SIMT_A_OFFSET = 1
# f32 shapes for the simt copy variants, (shape, A's offset in elements,
# variant): 16-byte at aligned K, N and bases; 4-byte at K % 4, N % 4
# and an A base 4 bytes past 16
SIMT_VARIANTS = [((2, 3, 200, 96, 136), 0, "16-byte"),
                 ((2, 3, 65, 33, 128), 0, "4-byte"),
                 ((1, 2, 100, 64, 130), 0, "4-byte"),
                 ((2, 2, 96, 64, 128), 1, "4-byte")]
DTYPES = ("float64", "float32", "bfloat16", "float16")
HALF = ("bfloat16", "float16")
# the path the BLAS main path's launches must take, by dtype
MAIN_PATH = {"float64": "dmma", "float32": "simt", "bfloat16": "wgmma",
             "float16": "wgmma"}
# profiler device times an entry may carry beside its CUDA-event times
DEVICE_KEYS = ("device_ms", "plain_device_ms", "library_device_ms")
# the api phase: CBLAS at cblas_n (col-major, ld = n + pad) and the
# row-major DGEMM timed at cblas_time_n; the async chain, the batch, the
# tuned GEMM and the server's GEMMs; the contexts' tile; the server's
# cache per simulated device and the flood's quota per device
API = {"cblas_n": 4096, "pad": 64, "cblas_time_n": 16384, "chain_n": 8192,
       "batch_n": 4096, "batch": 8, "tune_n": 8192, "serve_n": 4096,
       "tile": 1024, "serve_cache": 1 << 30, "quota": 32 << 20,
       "requests": {"app": 16, "flood": 32, "f64": 8}}
# CBLAS limits, normwise against an f64 oracle: the GEMMs at the main
# path's limits, TRSM at the reference's oracle limit, every other
# routine at 1e-10 (f64, the reference's oracle limit) and 1e-4 (f32,
# PERF.md's limit for f32 SYRK/SYMM/TRMM/TRSM)
CBLAS_TOL = {("d", "gemm"): 1e-12, ("s", "gemm"): 1e-5,
             ("d", "trsm"): 1e-8}
CBLAS_OTHER_TOL = {"d": 1e-10, "s": 1e-4}
# four chained f32 products: the f32 limit of a composite routine
CHAIN_TOL = 1e-4
# the analysis phase: work-centric GEMMs at the paper's tile, one size
# where every owner task splits (4 tasks < 2 devices x 4 streams) and
# one where only the ragged edge tiles do
ANALYSIS = {"sizes": (2048, 4608), "tile": 1024}

# the distributed-and-training phase (11): distributed_gemm at DIST_GEMM
# (M, K, N) and the ragged DIST_RAGGED, each mode, f32 and bf16; the
# tp_matmul column-then-row at Qwen3-0.6B's MLP (B, S, d, ff) in bf16;
# then Qwen3-0.6B trained at full width (TRAIN), resumed to
# TRAIN_RESUME_STEPS
DIST_GEMM = (8192, 8192, 8192)
DIST_RAGGED = (8191, 8190, 8192)
TP_MLP = (8, 1024, 1024, 3072)
# the reference's limits (test_distributed.py) hold at its K = 128 with
# N(0, 1) entries, where a product's magnitude is sqrt(128); here both
# scale with the products' magnitude, sqrt(K / 128) (8 at K = 8192):
# bf16 rounds |C| up to ~500 to a spacing of 2, 1.0 by itself
DIST_TOL = {"float32": 1e-3, "bfloat16": 1.0}
# tp_matmul in bf16 vs the unsharded bf16 product: normwise, the GEMM's
# bf16 limit (the sums run in f32 in both, in another order)
TP_TOL = 2e-2
TRAIN = dict(arch="qwen3_0_6b", smoke=False, seq_len=1024, global_batch=8,
             use_mesh=True, steps=6, ckpt_every=3, log_every=1, seed=0,
             device="cuda")
TRAIN_RESUME_STEPS = 9
# first step's loss through the (1, 1) mesh vs no mesh: the same
# arithmetic at world size 1 (no collective runs), so equal but for
# cuBLAS's run-to-run order
TRAIN_LOSS_RTOL = 1e-6


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def normwise(got, want) -> float:
    import torch
    g, w = got.to(torch.float64), want.to(torch.float64)
    return float(torch.linalg.norm(g - w) / torch.linalg.norm(w))


def time_ms(fn, reps: int) -> float:
    """Mean device time of one call, by CUDA events over ``reps`` calls
    after one warm-up call."""
    import torch
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


def device_ms(fn, reps: int):
    """Mean device time of one call: the kernels' time that
    ``torch.profiler`` records over ``reps`` calls after one warm-up
    call, gaps between kernels excluded; None when the profile holds no
    device time.  Informational beside :func:`time_ms`, for calls about
    as short as their host side."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(_device_us(e) for e in _kernel_events(prof))
    return busy_us / reps / 1e3 if busy_us > 0 else None


def warm_profiler() -> None:
    """One short profiler session, so that the tracer is set up before
    any session whose numbers are kept (a first session taken after much
    unprofiled work once came back empty on an H100)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1024, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]):
        (x * 2).sum().item()


def bound(shape, dtype: str):
    """The batched GEMM's least time at (G, S, M, K, N)."""
    from repro_torch.core.dtypes import canonical_dtype
    g, s, m, k, n = shape
    itemsize = canonical_dtype(dtype).itemsize
    return least_time(2 * g * s * m * k * n,
                      (g * s * (m * k + k * n) + g * m * n) * itemsize, dtype)


# ------------------------------------------------------------------ phases
def phase_device():
    import torch
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[device] nvidia-smi: {card} | torch: {name} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"devices {torch.cuda.device_count()}", flush=True)
    return card


def _timed_build(name):
    t0 = time.perf_counter()
    path = build.build(name)
    return path, time.perf_counter() - t0


def _kernel_label(mangled: str) -> str:
    """``wgmma_gemm bf16 128`` from a mangled template kernel's name."""
    t = re.search(r"(sgemm|wgmma_gemm|dmma_gemm|flash_simt|flash_mma|"
                  r"mla_wgmma|mla_simt|mla_combine|moe_layout|"
                  r"moe_gather|moe_grouped)"
                  r"_kernelI"
                  r"((?:\d+\w+?|[df])?)((?:L[ib]\d+E)+)", mangled)
    if not t:
        return mangled[:40]
    name, typ, ints = t.groups()
    typ = {"d": "f64", "f": "f32", "6__half": "f16",
           "13__nv_bfloat16": "bf16"}.get(typ, typ)
    return " ".join(x for x in (name, typ, "x".join(
        re.findall(r"L[ib](\d+)E", ints))) if x)


def phase_build():
    """One nvcc per source, all started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(_timed_build, SOURCES))
    secs = time.perf_counter() - t0
    for path, one in built:
        print(f"[build] {path.name} in {one:.1f} s", flush=True)
        report = path.with_suffix(".ptxas.txt")
        if not report.is_file():
            continue
        fn = None
        for line in report.read_text().splitlines():
            m = re.search(r"entry function '([^']+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                print(f"[build] ptxas {_kernel_label(fn)}: "
                      f"{line.split(':', 1)[1].strip()}")
            if "spill" in line and not re.search(r"\b0 bytes spill stores", line):
                print(f"[build] ptxas spill "
                      f"{_kernel_label(fn) if fn else ''}: {line.strip()}")
    print(f"[build] all sources in {secs:.1f} s", flush=True)
    return secs


def phase_kernel(card: str):
    import torch
    from repro_torch.core.dtypes import accumulator_dtype, canonical_dtype
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels.matmul import batched_contract
    from repro_torch.kernels.ref import batched_contract_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = {}

    def operands(shape, dt, a_offset=0):
        """Random (G,S,M,K) and (G,S,K,N) operands; A ``a_offset``
        elements past an allocation's (aligned) base."""
        g, s, m, k, n = shape
        buf = torch.randn(g * s * m * k + a_offset, generator=gen,
                          device="cuda", dtype=torch.float32).to(dt)
        return (buf[a_offset:].view(g, s, m, k),
                torch.randn((g, s, k, n), generator=gen, device="cuda",
                            dtype=torch.float32).to(dt))

    def timed(name, label, shape, a, b):
        """Time the kernel on every compiled block of its path (the
        default's time is the entry's), the plain version and the
        library call, at ``shape``; for staged operands also the
        staging copy and the kernel on the staged copies apart.
        ``label`` is the path, or the path and the route's variant."""
        path = label.split()[0]
        g, s, m, k, n = shape
        flops = 2 * g * s * m * k * n
        default = kmm.default_blocks(m, n, k, a.element_size(), path)
        per_block = {}
        for blocks in kmm.compiled_blocks(path):
            per_block[blocks] = time_ms(
                lambda: batched_contract(a, b, blocks=blocks), 20)
            print(f"[kernel] {name} {label} {shape} blocks {blocks}: "
                  f"{per_block[blocks]:.4f} ms "
                  f"({flops / per_block[blocks] / 1e9:.1f} TFLOP/s)"
                  f"{' (default)' if blocks == default else ''} | {card}",
                  flush=True)
        ms = per_block[default]
        a2 = a.transpose(1, 2).reshape(g, m, s * k).contiguous()
        b2 = b.reshape(g, s * k, n)
        plain_ms = time_ms(lambda: batched_contract_ref(a, b), 5)
        lib_ms = time_ms(lambda: torch.matmul(a2, b2), 20)
        bound_ms, bound_by = bound(shape, name)
        out = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bound_ms, bound_by=bound_by, shape=shape,
                   blocks={"x".join(map(str, k)): v
                           for k, v in per_block.items()})
        staged = ""
        if any(kmm.operand_staging(a, b)):
            ops = kmm.stage_operands(a, b)
            out["stage_ms"] = time_ms(lambda: kmm.stage_operands(a, b), 20)
            out["kernel_ms"] = time_ms(lambda: kmm._launch(ops), 20)
            staged = (f" (staging copy {out['stage_ms']:.4f} ms + kernel "
                      f"{out['kernel_ms']:.4f} ms)")
        print(f"[kernel] {name} {label} {shape}: kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s){staged}, plain "
              f"{plain_ms:.3f} ms, torch.matmul folded {lib_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}; {PEAK_NAME[name]}) "
              f"acc {accumulator_dtype(a.dtype)} | {card}", flush=True)
        return out

    def copies_of(fn):
        """Run ``fn`` (one simt launch); the copy variants whose count
        it raised."""
        before = {v: build.launches("gemm", tag=v)
                  for v in kmm.SIMT_COPIES.values()}
        out = fn()
        return out, sorted(v for v, n in before.items()
                           if build.launches("gemm", tag=v) > n)

    def held(name, shape, a, b, label=""):
        got, copies = copies_of(lambda: batched_contract(a, b))
        torch.cuda.synchronize()
        if name == "float32":
            label += f" {'/'.join(copies)}"
        want = batched_contract_ref(a, b)
        err = normwise(got, want)
        abs_err = float((got.to(torch.float64)
                         - want.to(torch.float64)).abs().max())
        path = kmm.operand_path(a, b)
        print(f"[kernel] {name} {path}{label} {shape}: normwise {err:.3e} "
              f"max_abs {abs_err:.3e} (tol {KERNEL_TOL[name]:.0e})",
              flush=True)
        check(err <= KERNEL_TOL[name],
              f"kernel {name} {path}{label} {shape} normwise {err:.3e} > "
              f"{KERNEL_TOL[name]:.0e}")
        return err, abs_err, copies

    for name in DTYPES:
        dt = canonical_dtype(name)
        worst = {}
        for shape in SHAPES:
            g, s, m, k, n = shape
            path = kmm.kernel_path(dt)
            a, b = operands(shape, dt)
            err, abs_err, copies = held(name, shape, a, b)
            if shape == MAIN_SHAPE and name == "float32":
                check(copies == ["16-byte"], f"f32 {shape}: simt copy "
                      f"variant {copies}, want 16-byte")
            worst[path] = max(worst.get(path, 0.0), err)
            if name in HALF and shape in (MAIN_SHAPE, (3, 2, 1000, 997, 1003)):
                # the unrounded f32 sums (out_acc) on each 16-bit route
                wide = batched_contract(a, b, torch.float32)
                torch.cuda.synchronize()
                err = normwise(wide, batched_contract_ref(a, b,
                                                          torch.float32))
                print(f"[kernel] {name} {path} {shape} f32 out: normwise "
                      f"{err:.3e} (tol {KERNEL_TOL['float32']:.0e})",
                      flush=True)
                check(err <= KERNEL_TOL["float32"],
                      f"kernel {name} {path} {shape} f32 out normwise "
                      f"{err:.3e}")
                del wide
            if shape == MAIN_SHAPE:
                results[(name, path)] = timed(name, path, shape, a, b)
                results[(name, path)]["max_abs_err"] = abs_err
            del a, b
        if name == "float32":
            # both copy variants on every compiled block: 16-byte at
            # aligned shapes, 4-byte at K % 4, N % 4 and an A base 4
            # bytes off 16
            for shape, offset, variant in SIMT_VARIANTS:
                a, b = operands(shape, dt, offset)
                for blocks in kmm.compiled_blocks("simt"):
                    got, copies = copies_of(
                        lambda: batched_contract(a, b, blocks=blocks))
                    torch.cuda.synchronize()
                    err = normwise(got, batched_contract_ref(a, b))
                    check(err <= KERNEL_TOL[name] and copies == [variant],
                          f"simt {variant} {shape} +{offset} {blocks} "
                          f"normwise {err:.3e}, copies {copies}")
                    worst["simt"] = max(worst["simt"], err)
                print(f"[kernel] float32 simt {variant} {shape} A +{offset}"
                      f": every block within {KERNEL_TOL[name]:.0e}, every "
                      f"launch counted {variant}", flush=True)
                del a, b
        if name in HALF or name == "float32":
            # the runtime's size with K off the 8 TMA needs: 16-bit
            # operands staged onto wgmma; f32 from A one element past an
            # aligned base on the 4-byte variant, and from an aligned A
            # on the 16-byte one
            f32 = name == "float32"
            a, b = operands(SIMT_SHAPE, dt, SIMT_A_OFFSET if f32 else 0)
            path = kmm.kernel_path(dt)
            staged = any(kmm.operand_staging(a, b))
            check(path == ("simt" if f32 else "wgmma")
                  and staged == (name in HALF),
                  f"{name} {SIMT_SHAPE}: path {path}, staged {staged}")
            _, abs_err, copies = held(name, SIMT_SHAPE, a, b,
                                      "" if f32 else " staged")
            check(copies == (["4-byte"] if f32 else []),
                  f"{name} {SIMT_SHAPE} A +{SIMT_A_OFFSET}: simt copy "
                  f"variant {copies}")
            label = path + (" 4-byte" if f32 else " staged")
            key = (name, label)
            results[key] = timed(name, label, SIMT_SHAPE, a, b)
            results[key]["max_abs_err"] = abs_err
            if f32:
                a16, b16 = operands(SIMT_SHAPE, dt)
                _, copies = copies_of(lambda: batched_contract(a16, b16))
                check(copies == ["16-byte"], f"f32 {SIMT_SHAPE} aligned: "
                      f"simt copy variant {copies}")
                ms16 = time_ms(lambda: batched_contract(a16, b16), 20)
                results[key]["ms_16byte"] = ms16
                print(f"[kernel] float32 simt 16-byte {SIMT_SHAPE} A +0: "
                      f"kernel {ms16:.4f} ms against the 4-byte variant's "
                      f"{results[key]['ms']:.4f} ms | {card}", flush=True)
                del a16, b16
            del a, b
        for path, w in worst.items():
            print(f"[kernel] {name} {path}: worst normwise {w:.3e} over "
                  f"its shapes", flush=True)
    return results


def _rand(gen, n, m, dtype, scale=1.0):
    import torch
    return (torch.randn((n, m), generator=gen, device="cuda",
                        dtype=torch.float64 if dtype == torch.float64
                        else torch.float32) * scale).to(dtype)


def phase_main_path(card: str, n_gemm: int):
    import torch
    from repro_torch.api import BlasxContext
    from repro_torch.core import blas3
    from repro_torch.core.runtime import RuntimeConfig

    gen = torch.Generator(device="cuda").manual_seed(7)
    launches_by_ledger = {}

    def ctx_for(mode="sim"):
        return BlasxContext(RuntimeConfig(
            n_devices=2, backend="cuda", device="cuda",
            cache_bytes=8 << 30, mode=mode), tile=1024)

    def report(label, n, flops, wall, err, tol, ctx):
        ls = ctx.stats()["launch"]
        print(f"[main] {label} N={n}: {wall:.3f} s wall, "
              f"{flops / wall / 1e9:.1f} GFLOP/s, normwise {err:.3e} "
              f"(tol {tol:.0e}), launches {ls['kernel_launches']}, "
              f"engines {sorted(ls['engine_flops'])} | {card}", flush=True)
        check(err <= tol, f"{label} normwise {err:.3e} > {tol:.0e}")
        return ls

    def gemm(label, n, dtype, tol, mode="sim"):
        a_dev, b_dev = _rand(gen, n, n, dtype), _rand(gen, n, n, dtype)
        a_host, b_host = a_dev.cpu(), b_dev.cpu()
        ctx = ctx_for(mode)
        before = build.launches("gemm")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ctx.gemm(a_host, b_host)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = out.tiled.data.to("cuda")
        acc = torch.float64 if dtype == torch.float64 else torch.float32
        want = torch.matmul(a_dev.to(acc), b_dev.to(acc))
        ls = report(label, n, 2 * n ** 3, wall, normwise(got, want), tol,
                    ctx)
        check(set(ls["engine_flops"]) == {"cuda"},
              f"{label}: engines {ls['engine_flops']} (want only cuda)")
        counted = build.launches("gemm") - before
        check(counted == ls["kernel_launches"],
              f"{label}: kernel counted {counted} launches, "
              f"ledger {ls['kernel_launches']}")
        launches_by_ledger[label] = ls["kernel_launches"]
        ctx.close()

    # the paper's DGEMM/SGEMM regime; then the half precisions
    gemm("dgemm", n_gemm, torch.float64, 1e-12)
    gemm("sgemm", n_gemm, torch.float32, 1e-5)
    gemm("bf16 gemm", n_gemm, torch.bfloat16, 2e-2)
    gemm("f16 gemm", 8192, torch.float16, 2e-2)

    # the other routines at N=8192 in f32, against the f64 oracle on the
    # card; tolerance 1e-4 normwise (f32 sums of 8192 terms, and TRSM's
    # chained tile solves)
    n = 8192
    a = _rand(gen, n, n, torch.float32)
    b = _rand(gen, n, n, torch.float32)
    a_tri = torch.triu(a) + n * torch.eye(n, device="cuda")
    cases = [
        ("syrk", lambda c: c.syrk(a.cpu()),
         lambda: blas3.ref_syrk(a), n ** 3),
        ("symm", lambda c: c.symm(a.cpu(), b.cpu()),
         lambda: blas3.ref_symm(a, b), 2 * n ** 3),
        ("trmm", lambda c: c.trmm(a.cpu(), b.cpu()),
         lambda: blas3.ref_trmm(a, b), n ** 3),
        ("trsm", lambda c: c.trsm(a_tri.cpu(), b.cpu()),
         lambda: blas3.ref_trsm(a_tri, b), n ** 3),
    ]
    for label, run, oracle, flops in cases:
        ctx = ctx_for()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(ctx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ls = report(f"{label} f32", n, flops, wall,
                    normwise(out.tiled.data.to("cuda"), oracle()), 1e-4, ctx)
        engines = set(ls["engine_flops"])
        if label == "symm":
            # full-fill off-diagonal blocks on the kernel, sym-fill
            # diagonal blocks on the torch fallback
            check(engines == {"cuda", "torch"}, f"symm engines {engines}")
        elif label == "syrk":
            # every SYRK step multiplies full tiles: all on the kernel
            check(engines == {"cuda"}, f"syrk engines {engines}")
        else:
            check(engines == {"torch"}, f"{label} engines {engines}")
        ctx.close()

    # the faithful threaded engine: one host thread per simulated device
    gemm("threads dgemm", 4096, torch.float64, 1e-12, mode="threads")
    return launches_by_ledger


def phase_api(card: str, device: str = "cuda", sizes=None):
    """The library's other front doors, each through the GEMM kernel:
    the 12 CBLAS routines, async futures, batched GEMM, the autotuner
    and the multi-tenant server.  Returns the phase's numbers and the
    kernel launches the server made, by path and dtype."""
    import numpy as np
    import torch
    import repro_torch.api as api
    from repro_torch.api import BlasxContext
    from repro_torch.core import blas3
    from repro_torch.core.runtime import RuntimeConfig
    from repro_torch.serve import BATCH, INTERACTIVE, BlasxServer

    t_phase = time.perf_counter()
    sz = dict(API, **(sizes or {}))
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(15)
    tile = sz["tile"]
    out = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def cfg(cache=8 << 30):
        return RuntimeConfig(n_devices=2, backend="cuda", device=device,
                             cache_bytes=cache)

    def randn(n, m, dtype=torch.float64, scale=1.0):
        return torch.randn((n, m), generator=gen, device=dev,
                           dtype=torch.float64).mul_(scale).to(dtype)

    def on_dev(x):
        return torch.as_tensor(x).to(dev, torch.float64)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        return r, time.perf_counter() - t0

    # ---- CBLAS: all 12 routines, col-major flat buffers, ld = n + pad
    n = sz["cblas_n"]
    ld = n + sz["pad"]
    CM, NT, L, U = (api.CblasColMajor, api.CblasNoTrans, api.CblasLower,
                    api.CblasUpper)
    LEFT, NONUNIT = api.CblasLeft, api.CblasNonUnit

    def flat(M, dt):
        """M (n x n) in a col-major buffer; NaN between the columns."""
        buf = np.full(n * ld, np.nan, dtype=dt)
        torch.from_numpy(buf.reshape(n, ld).T)[:n, :].copy_(M)
        return buf

    def logical(buf):
        return buf.reshape(n, ld).T[:n, :]

    a, b, c = randn(n, n), randn(n, n), randn(n, n)
    tri = torch.triu(a) + n * torch.eye(n, device=dev, dtype=torch.float64)
    # routine -> (call, output operand, oracle, flops); operands are
    # A, B, C and T (well-conditioned upper triangle)
    routines = {
        "gemm": (lambda f, o: f(CM, NT, NT, n, n, n, 1.0, o["A"], ld,
                                o["B"], ld, 0.5, o["C"], ld),
                 "C", lambda o: blas3.ref_gemm(o["A"], o["B"], o["C"],
                                               beta=0.5), 2 * n ** 3),
        "symm": (lambda f, o: f(CM, LEFT, U, n, n, 1.0, o["A"], ld, o["B"],
                                ld, 0.5, o["C"], ld),
                 "C", lambda o: blas3.ref_symm(o["A"], o["B"], o["C"],
                                               beta=0.5), 2 * n ** 3),
        "syrk": (lambda f, o: f(CM, L, NT, n, n, 1.0, o["A"], ld, 0.5,
                                o["C"], ld),
                 "C", lambda o: blas3.ref_syrk(o["A"], o["C"], beta=0.5,
                                               uplo="L"), n ** 3),
        "syr2k": (lambda f, o: f(CM, U, NT, n, n, 0.5, o["A"], ld, o["B"],
                                 ld, 0.5, o["C"], ld),
                  "C", lambda o: blas3.ref_syr2k(o["A"], o["B"], o["C"],
                                                 alpha=0.5, beta=0.5),
                  2 * n ** 3),
        "trmm": (lambda f, o: f(CM, LEFT, U, NT, NONUNIT, n, n, 1.0, o["T"],
                                ld, o["B"], ld),
                 "B", lambda o: blas3.ref_trmm(o["T"], o["B"]), n ** 3),
        "trsm": (lambda f, o: f(CM, LEFT, U, NT, NONUNIT, n, n, 1.0, o["T"],
                                ld, o["B"], ld),
                 "B", lambda o: blas3.ref_trsm(o["T"], o["B"]), n ** 3),
    }
    cblas = {}
    for fam, dt in (("d", np.float64), ("s", np.float32)):
        tdt = torch.float64 if fam == "d" else torch.float32
        mats = {k: v.to(tdt) for k, v in
                (("A", a), ("B", b), ("C", c), ("T", tri))}
        inputs = {k: flat(v, dt) for k, v in mats.items()}
        with BlasxContext(cfg(), tile=tile) as ctx:
            for name, (call, out_name, oracle, flops) in routines.items():
                # inputs are only read; the output gets a buffer of its own
                bufs = dict(inputs, **{out_name: inputs[out_name].copy()})
                fn = getattr(api, f"cblas_{fam}{name}")
                before = ctx.stats()["launch"]["kernel_launches"]
                _, wall = timed(lambda: call(
                    lambda *args: fn(*args, ctx=ctx), bufs))
                launches = ctx.stats()["launch"]["kernel_launches"] - before
                want = oracle({k: v.to(torch.float64)
                               for k, v in mats.items()})
                err = normwise(on_dev(logical(bufs[out_name])), want)
                tol = CBLAS_TOL.get((fam, name), CBLAS_OTHER_TOL[fam])
                padding = bufs[out_name].reshape(n, ld)[:, n:]
                label = f"cblas_{fam}{name}"
                print(f"[api] {label} N={n} ld={ld}: {wall:.3f} s wall, "
                      f"{flops / wall / 1e9:.1f} GFLOP/s, normwise "
                      f"{err:.3e} (tol {tol:.0e}), launches {launches} | "
                      f"{card}", flush=True)
                check(err <= tol, f"{label} normwise {err:.3e} > {tol:.0e}")
                check(bool(np.isnan(padding).all()),
                      f"{label} wrote into the padding between columns")
                cblas[label] = {"wall_s": wall, "normwise": err,
                                "launches": launches}
    out["cblas"] = cblas
    del a, b, c, tri, mats, inputs, bufs

    # ---- cblas_dgemm row-major at cblas_time_n beside ctx.gemm
    N = sz["cblas_time_n"]
    ldN = N + sz["pad"]

    def rowmajor(t):
        buf = np.full(N * ldN, np.nan)
        torch.from_numpy(buf.reshape(N, ldN))[:, :N].copy_(t)
        return buf

    A, B, C = randn(N, N), randn(N, N), randn(N, N)
    want = torch.addmm(C, A, B, beta=0.5)
    Af, Bf, Cf = rowmajor(A), rowmajor(B), rowmajor(C)
    with BlasxContext(cfg(), tile=tile) as ctx:
        _, t_cblas = timed(lambda: api.cblas_dgemm(
            api.CblasRowMajor, NT, NT, N, N, N, 1.0, Af, ldN, Bf, ldN, 0.5,
            Cf, ldN, ctx=ctx))
    err_cblas = normwise(on_dev(Cf.reshape(N, ldN)[:, :N]), want)
    check(bool(np.isnan(Cf.reshape(N, ldN)[:, N:]).all()),
          "cblas_dgemm wrote into the padding between rows")
    del Af, Bf, Cf
    hosts = [x.cpu() for x in (A, B, C)]
    with BlasxContext(cfg(), tile=tile) as ctx:
        res, t_ctx = timed(lambda: ctx.gemm(*hosts, beta=0.5))
        err_ctx = normwise(on_dev(res.tiled.data), want)
    del A, B, C, want, hosts, res
    print(f"[api] dgemm N={N}: cblas row-major ld={ldN} {t_cblas:.3f} s "
          f"(normwise {err_cblas:.3e}), ctx.gemm {t_ctx:.3f} s (normwise "
          f"{err_ctx:.3e}) | {card}", flush=True)
    for label, err in (("cblas", err_cblas), ("ctx", err_ctx)):
        check(err <= 1e-12, f"{label} DGEMM N={N} normwise {err:.3e}")
    out["dgemm_cblas_vs_ctx"] = {"n": N, "ld": ldN, "cblas_s": t_cblas,
                                 "ctx_s": t_ctx, "cblas_normwise": err_cblas,
                                 "ctx_normwise": err_ctx}

    # ---- async: four chained f32 GEMMs through ctx.submit
    n = sz["chain_n"]
    x = randn(n, n, torch.float32)
    w = randn(n, n, torch.float32, scale=n ** -0.5)
    with BlasxContext(cfg(), tile=tile) as ctx:
        xh, wh = ctx.tile(x.cpu()), ctx.tile(w.cpu())
        try:
            ctx.submit("no_such_routine")
            check(False, "a bad routine name was accepted")
        except ValueError:
            pass
        bad = ctx.submit("gemm", xh, ctx.tile(torch.zeros((5, 7))))
        check(isinstance(bad.exception(timeout=600), ValueError),
              "a failing call did not return an error future")

        def chain():
            h = xh
            for _ in range(4):
                h = ctx.submit("gemm", h, wh).result(timeout=600)
            return h
        h, wall = timed(chain)
        w64 = w.double()
        err = normwise(on_dev(h.tiled.data),
                       x.double() @ w64 @ w64 @ w64 @ w64)
    print(f"[api] submit: 4 chained f32 GEMMs N={n} {wall:.3f} s, normwise "
          f"{err:.3e} (tol {CHAIN_TOL:.0e}); error future ValueError, next "
          f"submit ran | {card}", flush=True)
    check(err <= CHAIN_TOL, f"chained GEMMs normwise {err:.3e}")
    out["async"] = {"n": n, "chain": 4, "wall_s": wall, "normwise": err}
    del x, w, h

    # ---- batched: 8 f32 GEMMs sharing one weight handle, twice
    n, nb = sz["batch_n"], sz["batch"]
    W = randn(n, n, torch.float32, scale=n ** -0.5)
    xs = [randn(n, n, torch.float32) for _ in range(nb)]
    walls, h2d = [], []
    with BlasxContext(cfg(), tile=tile) as ctx:
        Wh = ctx.tile(W.cpu())
        xs_h = [x.cpu() for x in xs]
        for _ in range(2):
            outs, wall = timed(lambda: ctx.gemm_batched(xs_h, [Wh] * nb))
            walls.append(wall)
            h2d.append(sum(r.h2d_bytes for r in ctx.calls[-nb:]))
        err = max(normwise(on_dev(o.tiled.data), x.double() @ W.double())
                  for o, x in zip(outs, xs))
    print(f"[api] gemm_batched {nb} x f32 N={n}, shared weight: walls "
          f"{walls[0]:.3f} / {walls[1]:.3f} s, h2d {h2d[0]} / {h2d[1]} B, "
          f"normwise {err:.3e} | {card}", flush=True)
    check(err <= 1e-5, f"batched GEMM normwise {err:.3e}")
    check(h2d[1] < h2d[0], f"second batch moved {h2d[1]} B, first {h2d[0]}")
    out["batched"] = {"n": n, "batch": nb, "walls_s": walls,
                      "h2d_bytes": h2d, "normwise": err}
    del W, xs, xs_h, outs

    # ---- tuned: auto_tune=True, tile="auto"
    n = sz["tune_n"]
    a32, b32 = randn(n, n, torch.float32), randn(n, n, torch.float32)
    with BlasxContext(cfg(), tile=tile, auto_tune=True,
                      tuning_cache="") as ctx:
        picked, t_tune = timed(lambda: ctx.auto_tile("gemm", n, n, n,
                                                     dtype="float32"))
        res, wall = timed(lambda: ctx.gemm(a32.cpu(), b32.cpu(),
                                           tile="auto"))
        err = normwise(on_dev(res.tiled.data), a32.double() @ b32.double())
        rep = ctx.tuning_report()
    entry = rep["entries"][0]
    pick = {"tile": entry["tile"], "n_streams": entry["n_streams"],
            "policy": entry["policy"], "work_centric": entry["work_centric"]}
    counters = {k: rep[k] for k in ("sweeps", "bucket_sweeps",
                                    "confirmations", "cache_hits",
                                    "model_adoptions", "model_fallbacks")}
    print(f"[api] tuned f32 GEMM N={n}: pick {pick} (tile {picked}, "
          f"applied {rep['applied']}), tuning {t_tune:.3f} s, GEMM "
          f"{wall:.3f} s, normwise {err:.3e}, report {counters} | {card}",
          flush=True)
    check(err <= 1e-5, f"tuned GEMM normwise {err:.3e}")
    check(res.tile == picked == pick["tile"], "tuned tile not applied")
    out["tuned"] = {"n": n, "pick": pick, "tune_s": t_tune, "gemm_s": wall,
                    "normwise": err, "report": counters}
    del a32, b32, res

    # ---- the multi-tenant server: 2 contexts x 2 simulated devices
    n = sz["serve_n"]
    rng = np.random.default_rng(16)
    x_app = rng.standard_normal((n, n)).astype(np.float32)
    w_app = (rng.standard_normal((n, n)) / np.sqrt(n)).astype(np.float32)
    f_a = rng.standard_normal((n, n)).astype(np.float32)
    f_b = rng.standard_normal((n, n)).astype(np.float32)
    d_a, d_b = rng.standard_normal((n, n)), rng.standard_normal((n, n))
    want = {"app": on_dev(x_app) @ on_dev(w_app),
            "flood": on_dev(f_a) @ on_dev(f_b),
            "f64": on_dev(d_a) @ on_dev(d_b)}
    tol = {"app": 1e-5, "flood": 2e-2, "f64": 1e-12}
    before = _read_counts()["gemm_path"]
    reqs = sz["requests"]
    with BlasxServer(cfg(sz["serve_cache"]), pool_size=2, tile=tile,
                     quotas={"flood": sz["quota"]}) as srv:
        xh, wh = srv.tile("app", x_app), srv.tile("app", w_app)
        sync()
        t0 = time.perf_counter()
        futs = [("flood", srv.submit("flood", "gemm", f_a, f_b,
                                     dtype="bfloat16", priority=BATCH))
                for _ in range(reqs["flood"])]
        futs += [("app", srv.submit("app", "gemm", xh, wh,
                                    priority=INTERACTIVE))
                 for _ in range(reqs["app"])]
        futs += [("f64", srv.submit("f64", "gemm", d_a, d_b,
                                    priority=BATCH))
                 for _ in range(reqs["f64"])]
        errs = {t: 0.0 for t in reqs}
        for tenant, f in futs:
            got = f.result(timeout=600)
            errs[tenant] = max(errs[tenant],
                               normwise(on_dev(got.array()), want[tenant]))
        sync()
        wall = time.perf_counter() - t0
        st = srv.stats()
    delta = {p: {dt: k - before.get(p, {}).get(dt, 0)
                 for dt, k in d.items()
                 if k - before.get(p, {}).get(dt, 0)}
             for p, d in _read_counts()["gemm_path"].items()}
    delta = {p: d for p, d in delta.items() if d}
    server = {"n": n, "wall_s": wall, "launches": delta,
              "affinity": st["affinity"], "tenants": {}}
    for tenant, count in reqs.items():
        row = st["tenants"][tenant]
        flops = 2 * n ** 3 * row["completed"]
        server["tenants"][tenant] = {
            "completed": row["completed"],
            "p50_ms": row["latency_p50_ms"], "p99_ms": row["latency_p99_ms"],
            "gemm_per_s": row["completed"] / wall,
            "gflop_per_s": flops / wall / 1e9,
            "quota_evictions": row["quota_evictions"],
            "normwise": errs[tenant]}
        print(f"[api] server {tenant}: {row['completed']}/{count} done, "
              f"p50 {row['latency_p50_ms']:.1f} ms, p99 "
              f"{row['latency_p99_ms']:.1f} ms, "
              f"{row['completed'] / wall:.2f} GEMM/s, quota_evictions "
              f"{row['quota_evictions']}, normwise {errs[tenant]:.3e} "
              f"(tol {tol[tenant]:.0e}) | {card}", flush=True)
        check(row["completed"] == count, f"{tenant}: {row['completed']} of "
              f"{count} requests completed")
        check(errs[tenant] <= tol[tenant],
              f"{tenant}: normwise {errs[tenant]:.3e}")
    print(f"[api] server wall {wall:.3f} s, launches by path {delta}, "
          f"affinity {st['affinity']} | {card}", flush=True)
    check(server["tenants"]["flood"]["quota_evictions"] > 0,
          "the quota'd flood evicted none of its own blocks")
    for victim in ("app", "f64"):
        check(server["tenants"][victim]["quota_evictions"] == 0,
              f"{victim} lost blocks to quota evictions")
    out["server"] = server
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[api] phase {out['phase_s']:.1f} s | {card}", flush=True)
    print(json.dumps({"api": out}), flush=True)
    return out, delta


def phase_analysis(card: str, device: str = "cuda", sizes=None,
                   tile=None):
    """The port's static gate and lock-witness smoke as subprocesses,
    then work-centric (Stream-K) GEMMs in threads mode under the
    lock-witness, each bitwise against owner mode.  Returns the phase's
    numbers and the kernel launch counts of the work-centric runs (read
    before the owner-mode comparison runs)."""
    import torch
    from repro_torch.analysis.witness import LockWitness
    from repro_torch.api import BlasxContext
    from repro_torch.core.runtime import RuntimeConfig

    t_phase = time.perf_counter()
    sizes = sizes or ANALYSIS["sizes"]
    tile = tile or ANALYSIS["tile"]
    dev = torch.device(device)
    out = {"device": device, "tile": tile}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # ---- 9a: the CLI on the card, each in a process of its own
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    smoke = ["--witness-smoke"] + ([] if dev.type == "cuda"
                                   else ["--device", device])
    for key, args in (("gate", ["--strict", "src/repro_torch"]),
                      ("witness_smoke", smoke)):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", *args],
            cwd=str(ROOT), env=env, capture_output=True, text=True,
            timeout=600)
        lines = proc.stdout.strip().splitlines()
        line = lines[-1] if lines else ""
        print(f"[analysis] {' '.join(args)}: rc {proc.returncode}, "
              f"{time.perf_counter() - t0:.1f} s | {line} | {card}",
              flush=True)
        check(proc.returncode == 0, f"repro_torch.analysis {' '.join(args)} "
              f"exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
        out[key] = line

    # ---- 9b: Stream-K in threads mode under the witness
    gen = torch.Generator(device=dev).manual_seed(9)
    dtypes = (torch.float64, torch.float32)
    inputs = {(n, dt): tuple(torch.randn((n, n), generator=gen, device=dev,
                                         dtype=torch.float64).to(dt).cpu()
                             for _ in range(2))
              for n in sizes for dt in dtypes}
    results, runs = {}, []
    witness = LockWitness()
    with witness.activate():
        ctx = BlasxContext(RuntimeConfig(
            n_devices=2, mode="threads", backend="cuda", device=device,
            work_centric=True, cache_bytes=8 << 30), tile=tile)
        rt = ctx.runtime
        try:
            for (n, dt), (a, b) in inputs.items():
                parts = sum(d.ledger.partial_tasks for d in rt.devices)
                fixups = sum(d.ledger.fixup_tasks for d in rt.devices)
                sync()
                t0 = time.perf_counter()
                c = ctx.gemm(a, b)
                sync()
                wall = time.perf_counter() - t0
                results[(n, dt)] = c.tiled.data.clone()
                c.invalidate()
                run = {"n": n, "dtype": str(dt).replace("torch.", ""),
                       "wall_s": wall,
                       "partial_tasks": sum(d.ledger.partial_tasks
                                            for d in rt.devices) - parts,
                       "fixup_tasks": sum(d.ledger.fixup_tasks
                                          for d in rt.devices) - fixups}
                runs.append(run)
                print(f"[analysis] work-centric {run['dtype']} gemm N={n}: "
                      f"{wall:.3f} s wall, {run['partial_tasks']} partial "
                      f"and {run['fixup_tasks']} fix-up tasks | {card}",
                      flush=True)
                check(run["partial_tasks"] > 0,
                      f"work-centric {run['dtype']} N={n}: no partial task")
        finally:
            ctx.close()
    counts = _read_counts() if dev.type == "cuda" else None
    report = witness.report().splitlines()[0]
    print(f"[analysis] {report} | {card}", flush=True)
    check(not witness.inversions(), witness.report())
    check(witness.witnessed_locks > 0, "the witness wrapped no lock")
    out.update(runs=runs, witness=report,
               witnessed_locks=witness.witnessed_locks)

    # owner mode, sim, same inputs on the same card: the reference
    # schedule every work-centric result must equal bit for bit.  Both
    # run the same K4, so each result is also held against the f64
    # product at phase 4's GEMM limits (the ragged N=4608 edges and the
    # fix-ups' group sizes run nowhere else in this script)
    owner = BlasxContext(RuntimeConfig(
        n_devices=2, mode="sim", backend="cuda", device=device,
        cache_bytes=8 << 30), tile=tile)
    errs = {}
    try:
        for (n, dt), (a, b) in inputs.items():
            want = owner.gemm(a, b)
            same = torch.equal(results[(n, dt)], want.tiled.data)
            want.invalidate()
            check(same, f"work-centric {dt} N={n} is not bitwise equal to "
                  "owner mode")
            fam = "d" if dt == torch.float64 else "s"
            tol = CBLAS_TOL[(fam, "gemm")]
            exact = a.to(dev, torch.float64) @ b.to(dev, torch.float64)
            err = normwise(results[(n, dt)].to(dev), exact)
            del exact
            label = f"{str(dt).replace('torch.', '')} N={n}"
            errs[label] = err
            print(f"[analysis] work-centric {label} against the f64 product:"
                  f" normwise {err:.3e} (tol {tol:.0e}) | {card}", flush=True)
            check(err <= tol, f"work-centric {label} normwise {err:.3e} > "
                  f"{tol:.0e}")
    finally:
        owner.close()
    out["normwise"] = errs
    print(f"[analysis] work-centric == owner mode bitwise at N={sizes} "
          f"f64/f32", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[analysis] phase {out['phase_s']:.1f} s | {card}", flush=True)
    print(json.dumps({"analysis": out}), flush=True)
    return out, counts


def phase_epilogue(card: str):
    """The GEMM kernel's fused epilogue (bias row + activation) against
    its plain version; timed in bf16 with bias + silu at the MLP shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import matmul_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4321)
    out = {}
    for name in ("float32", "bfloat16", "float16"):
        dt = getattr(torch, name)
        worst = 0.0
        for m, k, n in EPI_SHAPES:
            a = torch.randn((m, k), generator=gen, device="cuda").to(dt)
            b = torch.randn((k, n), generator=gen, device="cuda").to(dt)
            bias = torch.randn((n,), generator=gen, device="cuda")
            for act in ACTIVATIONS:
                got = ops.matmul(a, b, bias, activation=act)
                torch.cuda.synchronize()
                want = matmul_ref(a, b, bias, act)
                err = normwise(got, want)
                check(err <= EPI_TOL[name],
                      f"epilogue {name} {(m, k, n)} {act}: normwise "
                      f"{err:.3e} > {EPI_TOL[name]:.0e}")
                worst = max(worst, err)
                if (m, k, n) == EPI_MAIN and act == "silu" and \
                        name == "bfloat16":
                    max_abs = float((got.float() - want.float()).abs().max())
                    reps = 20
                    ms = time_ms(lambda: ops.matmul(a, b, bias,
                                                    activation="silu"), reps)
                    plain_ms = time_ms(lambda: matmul_ref(a, b, bias, "silu"),
                                       reps)
                    bias_t = bias.to(dt)
                    lib_ms = time_ms(lambda: F.silu(torch.addmm(bias_t, a, b)),
                                     reps)
                    flops = 2 * m * k * n
                    # a, b and c in bf16, the bias row in f32
                    bound_ms, bound_by = least_time(
                        flops, (m * k + k * n + m * n) * 2 + n * 4, name)
                    path = kmm.kernel_path(dt)
                    print(f"[epilogue] bf16 {path} {(m, k, n)} bias+silu, "
                          f"CUDA events: kernel {ms:.4f} ms "
                          f"({flops / ms / 1e9:.1f} TFLOP/s), plain "
                          f"{plain_ms:.4f} ms, torch.addmm+silu {lib_ms:.4f}"
                          f" ms, bound {bound_ms:.4f} ms ({bound_by}) | "
                          f"{card}", flush=True)
                    # the same calls' device time, gaps and host excluded
                    # (information only: the entry's times are the events')
                    dev = dict(
                        device_ms=device_ms(lambda: ops.matmul(
                            a, b, bias, activation="silu"), reps),
                        plain_device_ms=device_ms(
                            lambda: matmul_ref(a, b, bias, "silu"), reps),
                        library_device_ms=device_ms(
                            lambda: F.silu(torch.addmm(bias_t, a, b)), reps))
                    shown = {key: "not measured" if v is None
                             else f"{v:.4f} ms" for key, v in dev.items()}
                    print(f"[epilogue] bf16 {path} {(m, k, n)} bias+silu, "
                          f"device time: kernel {shown['device_ms']}, plain "
                          f"{shown['plain_device_ms']}, torch.addmm+silu "
                          f"{shown['library_device_ms']} | {card}",
                          flush=True)
                    out = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
                               max_abs_err=max_abs, path=path, **dev)
        print(f"[epilogue] {name}: {len(EPI_SHAPES)} shapes x "
              f"{len(ACTIVATIONS)} activations, bias, worst normwise "
              f"{worst:.3e} (tol {EPI_TOL[name]:.0e})", flush=True)
    return out


def flash_bound(case, dtype: str):
    """(bound_ms, bound_by, flops) for one flash call: 4*D flops for
    every (q, k) pair the mask keeps (QK^T and PV), q, k, v read once and
    o written once."""
    b, sq, sk, h, hkv, d, causal = case
    itemsize = 4 if dtype == "float32" else 2
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    flops = 4 * b * h * d * pairs
    nbytes = (2 * b * sq * h * d + 2 * b * sk * hkv * d) * itemsize
    return (*least_time(flops, nbytes, dtype), flops)


def _flash_qkv(gen, case, dt, pad=0):
    """q, k, v of ``case`` in ``dt``; ``pad`` > 0 widens each seq row by
    that many elements (a seq stride off the 8 the mma path reads)."""
    import torch
    b, sq, sk, h, hkv, d, _ = case

    def one(s, heads):
        x = torch.randn((b, s, heads * d + pad), generator=gen,
                        device="cuda").to(dt)
        return x[..., :heads * d].unflatten(-1, (heads, d))
    return one(sq, h), one(sk, hkv), one(sk, hkv)


def phase_attention(card: str):
    """The flash kernel against its plain version in f32, bf16 and f16
    on the reference's cases, the hazards, a bhsd view and a layout off
    the 16-byte copies (staged), each on the path ``flash_path`` names;
    timed at the serving path's prefill shape on each (path, dtype) and
    staged route beside its bound and SDPA (a yardstick: the port never
    calls it), by CUDA events and by profiler device time."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels.ref import flash_attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(99)
    results, family = {}, {}

    def held(label, name, path, fn, want, staged=False):
        """Run ``fn()``, check its launch landed on ``path``, staged or
        not as ``staged`` says, and its error; returns (max abs,
        normwise)."""
        before = build.launches("flash", path=path, dtype=name)
        staged_before = build.launches("flash", dtype=name, tag="staged")
        got = fn()
        torch.cuda.synchronize()
        counts = _read_counts()
        check(build.launches("flash", path=path, dtype=name) == before + 1,
              f"flash {name} {label}: launch not on the {path} path "
              f"({counts['flash_path']})")
        check(build.launches("flash", dtype=name, tag="staged")
              == staged_before + int(staged), f"flash {name} {label}: "
              f"staged {counts['flash_staged']}, want "
              f"{'one' if staged else 'none'}")
        max_abs = float((got.float() - want.float()).abs().max())
        check(max_abs <= FLASH_TOL[name], f"flash {name} {path} {label}: "
              f"max abs {max_abs:.3e} > {FLASH_TOL[name]:.0e}")
        err = 0.0
        if name in FLASH_NORMWISE_TOL:
            err = normwise(got, want)
            check(err <= FLASH_NORMWISE_TOL[name],
                  f"flash {name} {path} {label}: normwise {err:.3e} > "
                  f"{FLASH_NORMWISE_TOL[name]:.0e}")
        return max_abs, err

    def timed(name, path, case, q, k, v, max_abs, err):
        """The entry of ``path`` (with " staged" where q, k and v are
        staged: then also the staging copies and the kernel on the
        staged copies apart)."""
        b, sq, sk, h, hkv, d, causal = case
        reps = 20
        kern = lambda: kfa.flash_attention(q, k, v, causal=causal)
        ms = time_ms(kern, reps)
        apart = {}
        if path.endswith("staged"):
            copies = lambda: [kfa.stage(x) for x in (q, k, v)]
            qs, ks, vs = copies()
            on_copies = lambda: kfa.flash_attention(qs, ks, vs,
                                                    causal=causal)
            apart = dict(stage_ms=time_ms(copies, reps),
                         kernel_ms=time_ms(on_copies, reps),
                         stage_device_ms=device_ms(copies, reps),
                         kernel_device_ms=device_ms(on_copies, reps))
        plain = lambda: flash_attention_ref(q, k, v, causal=causal)
        plain_ms = time_ms(plain, 5)
        # SDPA wants (B, H, S, D) and as many kv heads as q heads
        g = h // hkv
        qs = q.transpose(1, 2).contiguous()
        ks = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
        vs = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
        sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                      is_causal=causal)
        lib_ms = time_ms(sdpa, reps)
        dev = dict(device_ms=device_ms(kern, reps),
                   plain_device_ms=device_ms(plain, 5),
                   library_device_ms=device_ms(sdpa, reps))
        bound_ms, bound_by, flops = flash_bound(case, name)
        shown = {key: "not measured" if x is None else f"{x:.4f} ms"
                 for key, x in {**dev, **apart}.items()}
        staged = (f" = staging copies {shown['stage_ms']} + kernel "
                  f"{shown['kernel_ms']}" if apart else "")
        staged_dev = (f" = staging copies {shown['stage_device_ms']} + "
                      f"kernel {shown['kernel_device_ms']}" if apart else "")
        print(f"[attention] {name} {path} {case}: CUDA events: kernel "
              f"{ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s){staged}, "
              f"plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms; device "
              f"time: kernel {shown['device_ms']}{staged_dev}, plain "
              f"{shown['plain_device_ms']}, SDPA "
              f"{shown['library_device_ms']}; bound {bound_ms:.4f} ms "
              f"({bound_by}; {PEAK_NAME[name]}); max abs {max_abs:.3e}, "
              f"normwise {err:.3e} | {card}", flush=True)
        return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=bound_ms, bound_by=bound_by, max_abs_err=max_abs,
                    **dev, **apart)

    def layouts(name, dt, worst):
        """The reference kernel's bhsd layout (permuted views, read in
        place), then a seq stride off the 16-byte copies (staged), checked
        on a hazard and timed at the prefill shape."""
        path = kfa.flash_path(dt)
        view = lambda x: x.permute(1, 0, 2)[None]
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                   for shape in ((8, 150, 64), (2, 150, 64), (2, 150, 64)))
        check(not any(kfa.operand_staging(view(q), view(k), view(v))),
              "the bhsd views should be read in place")
        want = flash_attention_ref(view(q), view(k), view(v))[0]
        w = held("bhsd (8,150,64)/(2,150,64)", name, path,
                 lambda: kfa.flash_attention_bhsd(q, k, v),
                 want.permute(1, 0, 2))
        worst[path] = tuple(map(max, zip(worst[path], w)))
        route = f"{path} staged"
        for case in ((1, 200, 200, 4, 2, 64, True), FLASH_MAIN):
            q, k, v = _flash_qkv(gen, case, dt, pad=1)
            check(kfa.operand_staging(q, k, v) == (True,) * 3,
                  f"{case} with a ragged seq stride should be staged")
            want = flash_attention_ref(q, k, v, causal=case[6])
            w = held(f"{case} seq stride {q.stride(1)}", name, path,
                     lambda: kfa.flash_attention(q, k, v, causal=case[6]),
                     want, staged=True)
            worst[route] = tuple(map(max, zip(worst.get(route, (0, 0)), w)))
            if case == FLASH_MAIN:
                results[(name, route)] = timed(name, route, case, q, k, v,
                                               *w)

    for name in FLASH_DTYPES:
        dt = getattr(torch, name)
        worst = {}
        for case in FLASH_CASES + FLASH_HAZARDS:
            causal, d = case[6], case[5]
            q, k, v = _flash_qkv(gen, case, dt)
            path = kfa.flash_path(dt)
            check(path == ("simt" if name == "float32" else "mma")
                  and not any(kfa.operand_staging(q, k, v)),
                  f"flash {name} {case} takes {path}, staging "
                  f"{kfa.operand_staging(q, k, v)}")
            want = flash_attention_ref(q, k, v, causal=causal)
            w = held(str(case), name, path, lambda: kfa.flash_attention(
                q, k, v, causal=causal), want)
            worst[path] = tuple(map(max, zip(worst.get(path, (0, 0)), w)))
            if case == FLASH_MAIN:
                results[(name, path)] = timed(name, path, case, q, k, v, *w)
            del q, k, v, want
        layouts(name, dt, worst)
        # the other families' shapes: D 80 causal, D 64 full, each timed
        for case in FLASH_FAMILY:
            causal, d = case[6], case[5]
            q, k, v = _flash_qkv(gen, case, dt)
            path = kfa.flash_path(dt)
            want = flash_attention_ref(q, k, v, causal=causal)
            w = held(str(case), name, path, lambda: kfa.flash_attention(
                q, k, v, causal=causal), want)
            worst[path] = tuple(map(max, zip(worst[path], w)))
            family[(name, kfa.shape_key(d, causal))] = dict(
                timed(name, path, case, q, k, v, *w), path=path,
                case=list(case))
            del q, k, v, want
        for path, (max_abs, err) in sorted(worst.items()):
            nw = (f", worst normwise {err:.3e} (tol "
                  f"{FLASH_NORMWISE_TOL[name]:.0e})"
                  if name in FLASH_NORMWISE_TOL else "")
            print(f"[attention] {name} {path}: worst max abs {max_abs:.3e} "
                  f"(tol {FLASH_TOL[name]:.0e}){nw}", flush=True)
    return results, family


def phase_serve(card: str):
    """The serving main path at Qwen3-0.6B's full width, bf16, on the
    card; its flash launches counted from 0 around ``run``.  Returns the
    kernels' launch counts by name."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServeConfig, run
    from repro_torch.models import Model
    from repro_torch.models import attention as attn

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(SERVE["arch"])
    check(attn.ATTENTION_BACKEND == "flash", "the default backend is flash")
    torch.cuda.reset_peak_memory_stats()
    build.reset()
    out = run(ServeConfig(**SERVE))
    torch.cuda.synchronize()
    launches = _read_counts()
    n_tok = SERVE["requests"] * SERVE["max_new"]
    print(f"[serve] {cfg.name} {cfg.dtype} x{cfg.n_layers} layers: "
          f"{out['requests']} requests, {out['tokens']} tokens, "
          f"{out['steps']} decode steps in {out['wall_s']:.3f} s wall "
          f"(prefill {out['prefill_s']:.3f} s, decode {out['decode_s']:.3f}"
          f" s, {out['tok_per_s']:.1f} tok/s), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, flash "
          f"launches {launches['flash_path']} | {card}", flush=True)
    check(out["device"].startswith("cuda"), f"served on {out['device']}")
    check(out["requests"] == SERVE["requests"], "not every request finished")
    check(out["tokens"] == n_tok and all(
        len(t) == SERVE["max_new"] for t in out["outputs"].values()),
        f"{out['tokens']} tokens, want {n_tok}")
    check(out["nonfinite_logits"] == 0,
          f"{out['nonfinite_logits']} prefills/steps had non-finite logits")
    want = cfg.n_layers * SERVE["requests"]
    check(launches["flash_path"] == {"mma": {"bfloat16": want}},
          f"flash launches {launches['flash_path']}, want {want} bf16 on "
          f"the mma path (layers x prefills)")

    # one prompt's last logits through the kernel against the plain
    # "sdpa" backend, on the same weights (same seed) on the card
    model = Model(cfg)
    params = model.init(SERVE["seed"], device="cuda")
    rng = np.random.default_rng(SERVE["seed"])
    prompt = rng.integers(0, cfg.vocab_size, (SERVE["prompt_len"],))
    tokens = torch.from_numpy(prompt[None]).to(params["embed"].device)
    logits = {}
    try:
        for backend in ("flash", "sdpa"):
            attn.ATTENTION_BACKEND = backend
            logits[backend], _ = model.prefill(params, tokens=tokens)
    finally:
        attn.ATTENTION_BACKEND = "flash"
    err = normwise(logits["flash"], logits["sdpa"])
    same = int(torch.argmax(logits["flash"])) == int(
        torch.argmax(logits["sdpa"]))
    print(f"[serve] prefill logits, flash vs sdpa backend: normwise "
          f"{err:.3e} (tol {SERVE_LOGIT_TOL:.0e}), same greedy token "
          f"{same}; first request's greedy token {out['outputs'][0][0]}",
          flush=True)
    check(bool(torch.isfinite(logits["flash"]).all()), "non-finite logits")
    check(err <= SERVE_LOGIT_TOL,
          f"flash vs sdpa logits normwise {err:.3e} > {SERVE_LOGIT_TOL:.0e}")
    profile_serving(card, model, params, tokens)
    del model, params
    return out, launches


def family_flash_launches(cfg, prefills: int):
    """K5's launches on a model's main path by shape key: one a
    self-attention layer and prefill (the hybrid's shared block once a
    segment; the encoder's non-causal); none for MLA or a pure SSM."""
    from repro_torch.kernels.flash_attention import shape_key
    hd = cfg.resolved_head_dim
    if cfg.use_mla or cfg.family == "ssm":
        return {}
    if cfg.family == "hybrid":
        return {shape_key(hd, True): cfg.n_layers // cfg.attn_every
                * prefills}
    if cfg.family == "encdec":
        return {shape_key(hd, False): cfg.n_encoder_layers * prefills,
                shape_key(hd, True): cfg.n_layers * prefills}
    return {shape_key(hd, True): cfg.n_layers * prefills}


def _drive_model(cfg, model, params, rng, sizes):
    """The encdec route: one prompt through Model.prefill with encoder
    states, then ``sizes["steps"]`` greedy Model.decode steps."""
    import numpy as np
    import torch
    n, steps = sizes["prompt_len"], sizes["steps"]
    device = params["embed"].device
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n))
                              ).to(device)
    enc = torch.from_numpy(rng.standard_normal(
        (1, sizes["enc_len"], cfg.d_model)).astype(np.float32)).to(device)
    nonfinite = 0
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, tokens=tokens, enc_embeds=enc)
    cache = model.pad_cache(cache, n + steps + 1)
    out = [int(torch.argmax(logits[0, -1]))]
    nonfinite += int(not torch.isfinite(logits).all())
    prefill_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    for i in range(steps):
        tok = torch.tensor([out[-1]], device=device)
        pos = torch.tensor([n + i], device=device)
        logits, cache = model.decode(params, cache, tok, pos)
        out.append(int(torch.argmax(logits[0])))
        nonfinite += int(not torch.isfinite(logits).all())
    decode_s = time.perf_counter() - t1
    wall = time.perf_counter() - t0
    return dict(requests=1, tokens=len(out), steps=steps, wall_s=wall,
                prefill_s=prefill_s, decode_s=decode_s,
                tok_per_s=len(out) / wall, nonfinite_logits=nonfinite,
                outputs={0: out}), dict(tokens=tokens, enc_embeds=enc)


def _drive_server(cfg, model, params, rng, fs):
    """The cut-depth route: launch.serve.run's loop over a Server built
    here (run builds its config from the arch alone)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import Request, Server
    queue = [Request(i, rng.integers(0, cfg.vocab_size, (fs["prompt_len"],)
                                     ).astype(np.int32), fs["max_new"])
             for i in range(fs["requests"])]
    first = torch.from_numpy(queue[0].prompt[None].astype(np.int64)
                             ).to(params["embed"].device)
    server = Server(cfg, model, params, fs["slots"],
                    fs["prompt_len"] + fs["max_new"] + 16)
    finished, steps = [], 0
    prefill_s = decode_s = 0.0
    t0 = time.perf_counter()
    while queue or any(r is not None for r in server.active):
        for s in range(server.slots):
            if server.active[s] is None and queue:
                t = time.perf_counter()
                server.admit(queue.pop(0), s)
                prefill_s += time.perf_counter() - t
        t = time.perf_counter()
        finished.extend(server.step())
        decode_s += time.perf_counter() - t
        steps += 1
        check(steps < 1000, "the server loop did not converge")
    wall = time.perf_counter() - t0
    toks = sum(len(r.out) for r in finished)
    return dict(requests=len(finished), tokens=toks, steps=steps,
                wall_s=wall, prefill_s=prefill_s, decode_s=decode_s,
                tok_per_s=toks / wall,
                nonfinite_logits=server.nonfinite_logits,
                decode_drops=server.decode_drops,
                outputs={r.rid: r.out for r in finished}), dict(tokens=first)


def _family_logits(card, cfg, route, model, params, prompt, out, device,
                   seed):
    """One prompt's last logits through the kernel against the plain
    "sdpa" backend, same weights (same seed): in the model's bf16 and in
    f32 copies of the same weights (f32 takes the kernel's simt path).
    The f32 pair is always held to SERVE_LOGIT_TOL; the bf16 pair is
    where bf16 itself keeps the model within that limit of f32 (the
    sdpa pair), and otherwise only printed: a bf16 model that amplifies
    its own rounding past the limit cannot tell a sound kernel from a
    faulty one.  Returns the normwise errors."""
    import dataclasses

    import torch
    from repro_torch.models import Model
    from repro_torch.models import attention as attn
    if route == "serve":
        model = Model(cfg)
        params = model.init(seed, device=device)

    def both(m, p):
        got = {}
        try:
            for backend in ("flash", "sdpa"):
                attn.ATTENTION_BACKEND = backend
                got[backend], _ = m.prefill(p, **prompt)
        finally:
            attn.ATTENTION_BACKEND = "flash"
        return got

    bf = both(model, params)
    f32 = lambda t: {k: f32(v) if isinstance(v, dict) else v.float()
                     for k, v in t.items()}
    wide = f32(params)
    del params
    fl = both(Model(dataclasses.replace(cfg, dtype="float32")), wide)
    del wide
    err = {"bf16": normwise(bf["flash"], bf["sdpa"]),
           "f32": normwise(fl["flash"], fl["sdpa"]),
           "bf16_sdpa_vs_f32": normwise(bf["sdpa"], fl["sdpa"]),
           "bf16_flash_vs_f32": normwise(bf["flash"], fl["sdpa"])}
    resolves = err["bf16_sdpa_vs_f32"] <= SERVE_LOGIT_TOL
    same = int(torch.argmax(bf["flash"])) == int(torch.argmax(bf["sdpa"]))
    print(f"[families] {cfg.name} prefill logits, flash vs sdpa backend: "
          f"bf16 normwise {err['bf16']:.3e}, f32 {err['f32']:.3e} (tol "
          f"{SERVE_LOGIT_TOL:.0e}); against the f32 sdpa logits, bf16 "
          f"sdpa {err['bf16_sdpa_vs_f32']:.3e}, bf16 flash "
          f"{err['bf16_flash_vs_f32']:.3e} (bf16 "
          f"{'resolves' if resolves else 'does not resolve'} the limit); "
          f"same greedy token {same}; first request's greedy token "
          f"{out['outputs'][0][0]} | {card}", flush=True)
    for name, logits in (("bf16", bf["flash"]), ("f32", fl["flash"])):
        check(bool(torch.isfinite(logits).all()),
              f"{cfg.name}: non-finite {name} logits")
    check(err["f32"] <= SERVE_LOGIT_TOL, f"{cfg.name}: f32 flash vs sdpa "
          f"logits normwise {err['f32']:.3e} > {SERVE_LOGIT_TOL:.0e}")
    check(not resolves or err["bf16"] <= SERVE_LOGIT_TOL,
          f"{cfg.name}: bf16 flash vs sdpa logits normwise "
          f"{err['bf16']:.3e} > {SERVE_LOGIT_TOL:.0e}")
    return err


def phase_families(card: str, device: str = "cuda", smoke: bool = False):
    """Phase 10: the moe, ssm, hybrid and encdec families and MLA at full
    width in bf16, one model at a time, each freed before the next.  Each
    model's K5 launches are counted from 0 around its run and must be
    exactly its self-attention layers x prefills on the mma path, by
    shape; where it reaches K5, one prompt's last logits through the
    kernel are held against the plain "sdpa" backend
    (:func:`_family_logits`).  Returns the phase's numbers and each
    model's counts.  ``device="cpu",
    smoke=True`` rehearses it here: the reduced configs (f32), 32-token
    prompts, and no launch checks (the plain versions run)."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServeConfig, run
    from repro_torch.models import Model
    from repro_torch.models import attention as attn

    on_card = device == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    check(attn.ATTENTION_BACKEND == "flash", "the default backend is flash")
    short = {"prompt_len": 32, "max_len": 64} if smoke else {}
    serve_kw = dict(FAMILY_SERVE, smoke=smoke, device=device, **short)
    model_sizes = dict(FAMILY_MODEL, **{"prompt_len": 16, "enc_len": 32}
                       if smoke else {})
    server_sizes = dict(FAMILY_SERVER, **{"prompt_len": 32} if smoke
                        else {})
    t_phase = time.perf_counter()
    numbers, counts = {}, {}
    for arch, route, cut in FAMILIES:
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg.reduced() if smoke else cfg, **(
            {} if smoke else cut))
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        seed = FAMILY_SERVE["seed"]
        model = params = None
        if route != "serve":
            model = Model(cfg)
            params = model.init(seed, device=device)
        rng = np.random.default_rng(seed)
        build.reset()
        # MLA's decodes, each held against its plain version on its own
        # operands
        mla_errors = []
        with (mla_checked(mla_errors) if cfg.use_mla
              else contextlib.nullcontext()):
            if route == "serve":
                sc = ServeConfig(arch=arch, **serve_kw)
                out = run(sc)
                prefills, want_req, want_new = sc.requests, sc.requests, \
                    sc.max_new
                prompt = dict(tokens=torch.from_numpy(
                    np.random.default_rng(seed).integers(
                        0, cfg.vocab_size, (1, sc.prompt_len))).to(device))
            elif route == "model":
                out, prompt = _drive_model(cfg, model, params, rng,
                                           model_sizes)
                prefills, want_req, want_new = 1, 1, \
                    model_sizes["steps"] + 1
            else:
                out, prompt = _drive_server(cfg, model, params, rng,
                                            server_sizes)
                prefills = want_req = server_sizes["requests"]
                want_new = server_sizes["max_new"]
        if on_card:
            torch.cuda.synchronize()
        run_counts = _read_counts()
        peak = (torch.cuda.max_memory_allocated() / 2 ** 30 if on_card
                else None)
        want = family_flash_launches(cfg, prefills)
        total = sum(want.values())
        reduced = (f"n_layers {get_config(arch).n_layers} -> "
                   f"{cfg.n_layers}" if cut and not smoke else None)
        print(f"[families] {cfg.name} {cfg.dtype} x{cfg.n_layers} layers "
              f"({cfg.param_count() / 1e9:.2f} B params; {route}"
              f"{'; reduced ' + reduced if reduced else ''}): "
              f"{out['requests']} requests, {out['tokens']} tokens, "
              f"{out['steps']} decode steps in {out['wall_s']:.3f} s wall "
              f"(prefill {out['prefill_s']:.3f} s, decode "
              f"{out['decode_s']:.3f} s, {out['tok_per_s']:.1f} tok/s), "
              f"peak memory {peak if peak is None else round(peak, 2)} "
              f"GiB, flash launches "
              f"{run_counts['flash_shape']} {run_counts['flash_path']} "
              f"| {card}", flush=True)
        if cfg.family == "moe":
            # each decode step's expert slots dropped at the config's
            # capacity factor (models.moe.count_drops, exact), of its
            # batch (the server's slots) x top-k x MoE layers
            batch = (serve_kw["batch_slots"] if route == "serve"
                     else server_sizes["slots"])
            slots = batch * cfg.top_k * (cfg.n_layers - cfg.n_dense_layers)
            print(f"[families] {cfg.name} capacity factor "
                  f"{cfg.capacity_factor}: dropped slots each decode "
                  f"{out['decode_drops']} of {slots} | {card}", flush=True)
            check(len(out["decode_drops"]) == out["steps"],
                  f"{arch}: {len(out['decode_drops'])} decode drop counts "
                  f"for {out['steps']} steps")
        check(out["requests"] == want_req, f"{arch}: {out['requests']} of "
              f"{want_req} requests finished")
        check(all(len(t) == want_new for t in out["outputs"].values())
              and out["tokens"] == want_req * want_new,
              f"{arch}: {out['tokens']} tokens, want {want_req * want_new}")
        check(out["nonfinite_logits"] == 0,
              f"{arch}: {out['nonfinite_logits']} prefills/steps had "
              f"non-finite logits")
        check(not on_card or run_counts["flash_shape"] == want,
              f"{arch}: flash launches by shape {run_counts['flash_shape']}"
              f", want {want} (self-attention layers x prefills)")
        check(not on_card or run_counts["flash_path"] == (
            {"mma": {"bfloat16": total}} if total else {}),
              f"{arch}: flash launches by path {run_counts['flash_path']}, "
              f"want {total} bf16 on mma")
        check(not any(run_counts["gemm"].values()),
              f"{arch}: the model ran the BLAS GEMM {run_counts['gemm']}")
        # MLA's decode: one kernel launch a layer and decode step, bf16
        # on wgmma
        want_mla = ({"wgmma": {"bfloat16": cfg.n_layers * out["steps"]}}
                    if cfg.use_mla else {})
        check(not on_card or run_counts["mla_path"] == want_mla,
              f"{arch}: MLA decode launches by path "
              f"{run_counts['mla_path']}, want {want_mla}")
        mla_worst = max(mla_errors, default=None)
        if cfg.use_mla:
            print(f"[families] {cfg.name} MLA decode, kernel vs plain on "
                  f"each call's operands: {len(mla_errors)} calls, "
                  f"normwise worst slot {mla_worst:.3e} (limit {MLA_TOL}) "
                  f"| {card}", flush=True)
            check(len(mla_errors) == cfg.n_layers * out["steps"]
                  and mla_worst <= MLA_TOL,
                  f"{arch}: MLA decode against its plain version: "
                  f"{len(mla_errors)} calls, normwise worst {mla_worst} "
                  f"(limit {MLA_TOL})")
        err = None
        if total:
            err = _family_logits(card, cfg, route, model, params, prompt,
                                 out, device, seed)
        numbers[arch] = dict(
            route=route, layers=cfg.n_layers, reduced=reduced,
            params=cfg.param_count(), requests=out["requests"],
            tokens=out["tokens"], steps=out["steps"], wall_s=out["wall_s"],
            prefill_s=out["prefill_s"], decode_s=out["decode_s"],
            tok_per_s=out["tok_per_s"], peak_gib=peak,
            launches=run_counts["flash_shape"], flash_vs_sdpa=err,
            mla_vs_plain=mla_worst,
            decode_drops=out.get("decode_drops"), card=card)
        counts[arch] = run_counts
        del model, params, out, prompt
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    print(f"[families] phase {time.perf_counter() - t_phase:.1f} s | {card}",
          flush=True)
    print(json.dumps({"families": numbers}), flush=True)
    return numbers, counts


def phase_train(card: str, device: str = "cuda", smoke: bool = False):
    """Phase 11: the multi-device slice and the training path at world
    size 1.  Joins a process group of one rank (NCCL on the card, gloo on
    the CPU) through a ``file://`` store in a temp dir and builds the
    (data, model) = (1, 1) mesh; runs ``distributed_gemm`` in ring and
    gspmd modes at DIST_GEMM and DIST_RAGGED in f32 and bf16 against an
    f64 oracle, and ``tp_matmul`` column then row at TP_MLP against the
    unsharded product; then ``launch.train.run`` at Qwen3-0.6B's full
    width (TRAIN: 6 steps, a checkpoint every 3), again to
    TRAIN_RESUME_STEPS (resumes at 6, trains 3), every step keeping the
    storage of its parameters and moments (the loop donates them), and
    one step without the mesh, whose loss must equal the first; on the
    card the peak of one donated and one undonated step.  Returns the
    phase's numbers and the kernels' launch counts of the two training
    runs.
    ``device="cpu", smoke=True`` rehearses it here: gloo, small GEMMs,
    the reduced config at 32 tokens."""
    import gc
    import math
    import statistics
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.launch.mesh import init_process_group, \
        make_mesh_for_devices
    from repro_torch.launch.steps import make_grad_step
    from tools.fsdp_train import held_and_placed
    from repro_torch.launch.train import TrainConfig, run
    from repro_torch.models import Model
    from repro_torch.models.sharding import rules_for_mesh
    from repro_torch.optim import adamw
    from repro_torch.tree import keystr, tree_flatten

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    gemm, ragged = ((256, 256, 256), (255, 254, 256)) if smoke else \
        (DIST_GEMM, DIST_RAGGED)
    tp = (2, 64, 64, 192) if smoke else TP_MLP
    train = dict(TRAIN, device=device, **(
        {"smoke": True, "seq_len": 32, "global_batch": 4} if smoke else {}))
    numbers = {"card": card, "world_size": 1}
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    with tempfile.TemporaryDirectory() as tmp:
        init_process_group(device, init_method=f"file://{tmp}/store",
                           rank=0, world_size=1)
        try:
            mesh = make_mesh_for_devices(1, 1, device=device)
            gen = torch.Generator(device=device).manual_seed(0)
            rows = []
            for (m, k, n) in (gemm, ragged):
                a32 = torch.randn((m, k), generator=gen, device=device)
                b32 = torch.randn((k, n), generator=gen, device=device)
                for name in ("float32", "bfloat16"):
                    a, b = (a32.to(getattr(torch, name)),
                            b32.to(getattr(torch, name)))
                    want = a.double() @ b.double()
                    tol = DIST_TOL[name] * math.sqrt(k / 128)
                    for mode in ("ring", "gspmd"):
                        D.reset_collectives()
                        sync()
                        t0 = time.perf_counter()
                        c = D.distributed_gemm(a, b, mesh, mode=mode)
                        sync()
                        ms = (time.perf_counter() - t0) * 1e3
                        err = float((c.double() - want).abs().max())
                        rows.append(dict(shape=[m, k, n], dtype=name,
                                         mode=mode, max_abs_err=err,
                                         tol=tol, ms=ms,
                                         collectives=dict(D.COLLECTIVES)))
                        print(f"[train] distributed_gemm {mode} {name} "
                              f"{m}x{k}x{n}: max abs {err:.3e} (tol "
                              f"{tol:.3e}), {ms:.2f} ms host clock, "
                              f"collectives {dict(D.COLLECTIVES)} | {card}",
                              flush=True)
                        check(tuple(c.shape) == (m, n) and c.dtype == a.dtype,
                              f"distributed_gemm {mode} {name}: "
                              f"{tuple(c.shape)} {c.dtype}")
                        check(err <= tol, f"distributed_gemm {mode} {name} "
                              f"{m}x{k}x{n}: max abs {err:.3e} > {tol:.3e}")
                    del a, b, want, c
                del a32, b32
            numbers["distributed_gemm"] = rows
            bsz, seq, d, ff = tp
            x = torch.randn((bsz, seq, d), generator=gen,
                            device=device).to(torch.bfloat16)
            w1 = (torch.randn((d, ff), generator=gen, device=device)
                  / math.sqrt(d)).to(torch.bfloat16)
            w2 = (torch.randn((ff, d), generator=gen, device=device)
                  / math.sqrt(ff)).to(torch.bfloat16)
            want = (x @ w1) @ w2
            for mode in ("ring", "gspmd"):
                y = D.tp_matmul(x, w1, mesh, kind="column", mode=mode)
                z = D.tp_matmul(y, w2, mesh, kind="row", mode=mode)
                err = normwise(z, want)
                numbers[f"tp_matmul_{mode}_normwise"] = err
                print(f"[train] tp_matmul {mode} column+row bf16 "
                      f"({bsz},{seq},{d})->{ff}->{d}: normwise {err:.3e} vs "
                      f"the unsharded product (tol {TP_TOL:.0e}) | {card}",
                      flush=True)
                check(tuple(z.shape) == tuple(want.shape)
                      and err <= TP_TOL, f"tp_matmul {mode}: {err:.3e}")
            del x, w1, w2, want, y, z
            print("[train] a one-card ring makes no hop: every ring above "
                  "ran its single panel locally (0 P2P hops); the hop "
                  "schedule and the overlap are held by the gloo twins "
                  "(tests/test_torch_distributed.py), not on the card",
                  flush=True)

            # training at full width, resumed from its checkpoint
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            ck = os.path.join(tmp, "ckpt")
            build.reset()
            with kept_storage() as kept:
                first = run(TrainConfig(ckpt_dir=ck, **train))
                resumed = run(TrainConfig(ckpt_dir=ck, **dict(
                    train, steps=TRAIN_RESUME_STEPS)))
            sync()
            counts = _read_counts()
            peak = (torch.cuda.max_memory_allocated() / 2 ** 30 if on_card
                    else None)
            losses = first["losses"] + resumed["losses"]
            check(first["final_step"] == train["steps"]
                  and len(first["losses"]) == train["steps"],
                  f"first run: {first['final_step']} steps")
            check(resumed["final_step"] == TRAIN_RESUME_STEPS
                  and len(resumed["losses"]) == TRAIN_RESUME_STEPS
                  - train["steps"], f"resumed run trained "
                  f"{len(resumed['losses'])} steps to {resumed['final_step']}")
            check(all(np.isfinite(v) for v in losses),
                  f"non-finite loss in {losses}")
            check(kept["steps"] == TRAIN_RESUME_STEPS and not kept["moved"],
                  f"the donated steps: {kept['steps']} steps, "
                  f"{kept['moved']} parameters and moments returned in "
                  f"other storage than they were given")
            print(f"[train] the loop's {kept['steps']} donated steps kept "
                  f"the storage of every parameter and moment | {card}",
                  flush=True)
            check(not any(counts["gemm"].values())
                  and not counts["flash_path"],
                  f"training launched a hand kernel: {counts}")
            # the checkpoint holds the live tree's keys and shapes
            cfg = get_config(train["arch"])
            cfg = cfg.reduced() if train["smoke"] else cfg
            live = Model(cfg).init(train["seed"], device=device)
            paths, leaves = tree_flatten({"params": live,
                                          "opt": adamw.init_state(live)})
            step_dir = os.path.join(ck, f"step_{TRAIN_RESUME_STEPS}")
            with np.load(os.path.join(step_dir, "arrays.npz")) as data:
                saved = {k: data[k].shape for k in data.files}
            check(saved == {keystr(q): tuple(t.shape)
                            for q, t in zip(paths, leaves)},
                  "the checkpoint's keys or shapes differ from the live tree")
            del live, leaves
            # the bytes each rank holds for parameters, gradients and
            # moments under the mesh, beside the reference's placements
            gc.collect()
            rules = rules_for_mesh(mesh)
            grad_step, model = make_grad_step(cfg, rules)
            live = model.init(train["seed"], device=device)
            state = adamw.init_state(live)
            gen = torch.Generator(device=device).manual_seed(0)
            tokens = torch.randint(0, cfg.vocab_size, (train["global_batch"],
                                                       train["seq_len"]),
                                   generator=gen, device=device)
            grads, _, _ = grad_step(live, {"tokens": tokens,
                                           "labels": tokens})
            # one card's (1, 1) mesh splits nothing, so the two agree
            # trivially here: the gloo twins and tools/fsdp_train.py on
            # four cards are what show the blocks
            storage = held_and_placed(cfg, rules, {
                "params": [live], "grads": [grads],
                "moments": [state["m"], state["v"]]}, device)
            del live, state, grads, tokens
            for name, (held, placed) in storage.items():
                print(f"[train] {name}: held {held} bytes, placed {placed} "
                      f"bytes on rank 0 of the {tuple(mesh.shape)} mesh "
                      f"| {card}", flush=True)
                check(held == placed, f"{name}: held {held} bytes, placed "
                      f"{placed}")
            numbers["held_and_placed_bytes"] = storage
            # the first step's loss without the mesh, from the same seed
            gc.collect()
            plain = run(TrainConfig(**dict(train, use_mesh=False, steps=1,
                                           log_every=0)))
            rel = abs(plain["losses"][0] - first["losses"][0]) / abs(
                first["losses"][0])
            check(rel <= TRAIN_LOSS_RTOL, f"first loss {first['losses'][0]}"
                  f" with the mesh, {plain['losses'][0]} without "
                  f"(rel {rel:.2e} > {TRAIN_LOSS_RTOL:.0e})")
            step_peaks = None
            if on_card:
                profile_training(card, cfg, train)
                step_peaks = {("donated" if donate else "undonated"):
                              one_step_peak(cfg, train, donate)
                              for donate in (False, True)}
                print(f"[train] peak allocated: the donated run "
                      f"{peak:.3f} GiB; one step from fresh weights "
                      f"(GiB, less the GiB held before it): "
                      f"{step_peaks} | {card}", flush=True)
                check(step_peaks["donated"][0]
                      <= step_peaks["undonated"][0],
                      f"a donated step's peak {step_peaks}")
            # the first step of each run builds cuBLAS's and autograd's
            # state: the median is over the others
            times = first["step_times"][1:] + resumed["step_times"][1:]
            med = statistics.median(times)
            tokens = train["global_batch"] * train["seq_len"]
            numbers.update(
                arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
                vocab=cfg.vocab_size, params=cfg.param_count(),
                dtype=cfg.dtype, seq_len=train["seq_len"],
                global_batch=train["global_batch"], losses=losses,
                first_loss_no_mesh=plain["losses"][0],
                first_loss_rel_diff=rel, step_ms=[t * 1e3 for t in
                                                  first["step_times"]
                                                  + resumed["step_times"]],
                median_step_ms=med * 1e3, tokens_per_s=tokens / med,
                peak_gib=peak, step_peak_gib=step_peaks,
                storage_kept_steps=kept["steps"], launches=counts,
                checkpoint_keys=len(saved))
            print(f"[train] {cfg.name} {cfg.dtype} x{cfg.n_layers} layers "
                  f"({cfg.param_count() / 1e9:.2f} B params), batch "
                  f"{train['global_batch']} x {train['seq_len']}: steps 1-"
                  f"{train['steps']}, resumed {train['steps'] + 1}-"
                  f"{TRAIN_RESUME_STEPS}, losses "
                  f"{[round(v, 4) for v in losses]}; median step "
                  f"{med * 1e3:.1f} ms ({tokens / med:.0f} tokens/s), peak "
                  f"allocated {peak if peak is None else round(peak, 2)} "
                  f"GiB; first loss without the mesh rel diff {rel:.1e}; "
                  f"{len(saved)} checkpoint arrays | {card}", flush=True)
        finally:
            dist.destroy_process_group()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers["phase_s"] = time.perf_counter() - t_phase
    print(f"[train] phase {numbers['phase_s']:.1f} s | {card}", flush=True)
    print(json.dumps({"train": numbers}), flush=True)
    return numbers, counts


# phase 13: MLA's absorbed decode at the benchmark cell's shape
# (chipbench's dsv3-ep32-decode8k, one layer): 256 slots, 128 heads,
# latent 512 + RoPE key 64 in bf16, 8192 positions a slot; each slot's
# live length its prompt (log-uniform over [1024, 4096], stratified as
# the cell draws them) plus MLA_DECODED decode steps
MLA_CELL = dict(slots=256, heads=128, max_len=8192, prompt_min=1024,
                prompt_max=4096, decoded=400, seed=13)
MLA_SCALE = 192 ** -0.5
# kernel vs plain version, normwise, the worst slot: q_c and P enter the
# products as two 16-bit terms each (~2^-17 relative), exp2 is the 2^-22
# approximation, the f32 sums run in another order (tests/
# test_torch_mla_decode.py WGMMA_TOL, whose note says what it fails)
MLA_TOL = 1e-4
# one Server.step of a small MLA model in bf16 at the kernel's widths
# (the reduced DeepSeek-V3 with its latent and RoPE key at 512 and 64):
# MLA_SMALL slots, prompts of 40 tokens
MLA_SMALL = dict(slots=2, prompt_len=40, max_len=96)


# phase 12: the dry-run's prediction against one real step at world
# size 1 (phase 11's mesh and training shape; one prefill of 1024
# tokens), then the production meshes' sweep in subprocesses
DRYRUN_TRAIN = (8, 1024)
DRYRUN_PREFILL = (1, 1024)
# predicted peak (arguments + the trace's live-byte peak) vs
# max_memory_allocated over the step: the trace sees every storage an
# operator returns, not cuBLAS's workspace nor the allocator's rounding
DRYRUN_PEAK_RTOL = 0.10
DRYRUN_SHAPES = ("train_4k", "prefill_32k")
DRYRUN_EXTRA = (("qwen3_0_6b", "decode_32k", ()),
                ("qwen3_0_6b", "train_4k", ("--multi-pod", "--no-costs")),
                ("deepseek_v3_671b", "train_4k",
                 ("--multi-pod", "--no-costs")))
DRYRUN_WORKERS = 8
DRYRUN_TIMEOUT_S = 420
# each cell's figures a rank before the SSM mixer and MLA computed by
# heads, this phase's (b) on an NVIDIA H100 80GB HBM3 at 700 W: (FLOPs,
# temp bytes); the multi-pod cells run without costs
EARLIER_DRYRUN = {
    ("qwen3_0_6b", "train_4k", "single"): (63063004807168, 8334735376),
    ("qwen3_0_6b", "prefill_32k", "single"): (10823356481536, 2470580224),
    ("olmo_1b", "train_4k", "single"): (45157286150144, 11086956552),
    ("olmo_1b", "prefill_32k", "single"): (8796118777856, 3490578432),
    ("olmoe_1b_7b", "train_4k", "single"): (55052890800128, 27103718936),
    ("olmoe_1b_7b", "prefill_32k", "single"): (10720264126464, 11462119448),
    ("glm4_9b", "train_4k", "single"): (354489420742656, 35609436176),
    ("glm4_9b", "prefill_32k", "single"): (77137767825408, 6207717376),
    ("internvl2_26b", "train_4k", "single"): (1248112127508480, 58875824912),
    ("internvl2_26b", "prefill_32k", "single"): (227601181532160, 9403785216),
    ("seamless_m4t_medium", "train_4k", "single"): (161463926784000,
                                                    19272933388),
    ("seamless_m4t_medium", "prefill_32k", "single"): (10308970930176,
                                                       2147618816),
    ("phi3_medium_14b", "train_4k", "single"): (2086151515013120,
                                                135951693832),
    ("phi3_medium_14b", "prefill_32k", "single"): (304942806466560,
                                                   8949747712),
    ("zamba2_2_7b", "train_4k", "single"): (1122201940000768, 111512227720),
    ("zamba2_2_7b", "prefill_32k", "single"): (303845334351872, 30867312608),
    ("deepseek_v3_671b", "train_4k", "single"): (9007293744021504,
                                                 325020493840),
    ("deepseek_v3_671b", "prefill_32k", "single"): (11600784207577088,
                                                    100125769752),
    ("mamba2_780m", "train_4k", "single"): (419203840475136, 34653154696),
    ("mamba2_780m", "prefill_32k", "single"): (102100271480832, 18272607296),
    ("qwen3_0_6b", "decode_32k", "single"): (5234884608, 2684387328),
    ("qwen3_0_6b", "train_4k", "multi"): (None, 4172249104),
    ("deepseek_v3_671b", "train_4k", "multi"): (None, 162616223760),
}
# the archs whose mixer (Mamba2, Zamba2) or MLA (DeepSeek-V3) a rank
# computes by heads: below EARLIER_DRYRUN's FLOPs and temp at train_4k
# and prefill_32k, and at train_4k the FLOPs of the CPU trace (exact)
BY_HEADS_TRAIN_FLOPS = {"mamba2_780m": 74210592423936,
                        "zamba2_2_7b": 107878304186368,
                        "deepseek_v3_671b": 2260243719389184}


# the single-pod production mesh (data, model)
DRYRUN_MESH = (16, 16)
K5_OP = "repro_torch.flash_attention_fwd"


def k5_prefill_flops(cfg, shape) -> int:
    """K5's FLOPs by its registered formula (4 b h Sq Sk D,
    ``kernels/flash_attention._flash_flops``) that a rank of the
    single-pod mesh counts in a prefill cell: a launch for each
    self-attention layer (the hybrid's shared block once a segment, the
    encoder's layers too; none for MLA or the SSM), on its B / data rows
    and its H / model q heads (every head where the model axis does not
    divide them), over the cell's whole sequence."""
    data, model = DRYRUN_MESH
    layers = {"dense": cfg.n_layers, "moe": cfg.n_layers,
              "hybrid": cfg.n_layers // max(1, cfg.attn_every),
              "encdec": cfg.n_layers + cfg.n_encoder_layers}.get(
        cfg.family, 0)
    if cfg.use_mla or not layers:
        return 0
    heads = cfg.n_heads // model if cfg.n_heads % model == 0 \
        else cfg.n_heads
    return (layers * 4 * (shape.global_batch // data) * heads
            * shape.seq_len ** 2 * cfg.resolved_head_dim)


def _check_k5_flops(rec: dict) -> None:
    """A prefill cell traced on fake CUDA tensors counts K5's operator
    by its formula at the cell's local shapes: nonzero for every arch
    with self-attention layers."""
    from repro_torch.configs import SHAPES, get_config
    if rec["status"] != "ok" or rec.get("device") != "cuda" \
            or SHAPES[rec["shape"]].kind != "prefill":
        return
    want = k5_prefill_flops(get_config(rec["arch"]), SHAPES[rec["shape"]])
    got = (rec.get("flops_by_operator_per_rank") or {}).get(K5_OP, 0)
    check(got == want, f"dryrun {rec['arch']} {rec['shape']}: K5 FLOPs a "
          f"rank {got}, the formula's {want}")


def _check_against_earlier(rec: dict) -> None:
    """A sweep cell's FLOPs and temp a rank against EARLIER_DRYRUN: lower
    for the archs computed by heads (and at train_4k the CPU trace's
    FLOPs), the same FLOPs to the digit for the others, less K5's in a
    prefill cell (which EARLIER_DRYRUN's card runs did not count)."""
    key = (rec["arch"], rec["shape"], rec["mesh"])
    if rec["status"] != "ok" or key not in EARLIER_DRYRUN:
        return
    flops = rec.get("flops_per_rank")
    temp = rec["memory"]["temp_size_in_bytes"]
    old_flops, old_temp = EARLIER_DRYRUN[key]
    name = " ".join(key)
    if rec["arch"] in BY_HEADS_TRAIN_FLOPS and rec["shape"] in DRYRUN_SHAPES \
            and rec["mesh"] == "single":
        check(flops < old_flops and temp < old_temp, f"dryrun {name}: "
              f"FLOPs {flops:.6e} and temp {temp} bytes a rank are not "
              f"both below {old_flops:.6e} and {old_temp}")
        if rec["shape"] == "train_4k":
            want = BY_HEADS_TRAIN_FLOPS[rec["arch"]]
            check(flops == want, f"dryrun {name}: FLOPs {flops} a rank, the "
                  f"CPU trace's {want}")
    elif old_flops is not None:
        k5 = (rec.get("flops_by_operator_per_rank") or {}).get(K5_OP, 0)
        check(flops - k5 == old_flops, f"dryrun {name}: FLOPs {flops} a "
              f"rank less K5's {k5} changed from {old_flops}")


def _dryrun_sweep(card: str, smoke: bool):
    """Phase 12 (b): ``python -m repro_torch.launch.dryrun`` for every
    cell of the sweep, one process a cell, DRYRUN_WORKERS at a time (a
    fake process group must not meet this process's NCCL one); every
    process must exit 0 and hold its arguments at their placements.
    Each cell's FLOPs and temp bytes a rank are printed beside
    EARLIER_DRYRUN's, with its model-axis all-gather bytes, and held
    against them (:func:`_check_against_earlier`).  Returns the cells'
    records."""
    import tempfile
    from repro_torch.configs import ARCH_IDS
    archs = ["qwen3_0_6b"] if smoke else [a for a in ARCH_IDS
                                          if a != "blasx_gemm"]
    shapes = ("prefill_32k",) if smoke else DRYRUN_SHAPES
    cells = [(a, sh, ()) for a in archs for sh in shapes]
    cells += [] if smoke else list(DRYRUN_EXTRA)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    records = []
    with tempfile.TemporaryDirectory() as tmp:
        def one(i):
            arch, shape, flags = cells[i]
            out = os.path.join(tmp, f"{i}.json")
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, *flags, "--out", out],
                capture_output=True, text=True, env=env, cwd=str(ROOT),
                timeout=DRYRUN_TIMEOUT_S)
            return proc, out
        t0 = time.perf_counter()
        with ThreadPoolExecutor(DRYRUN_WORKERS) as pool:
            done = list(pool.map(one, range(len(cells))))
        wall = time.perf_counter() - t0
        for (arch, shape, flags), (proc, out) in zip(cells, done):
            check(proc.returncode == 0, f"dryrun {arch} {shape} {flags} "
                  f"exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
                  f"{proc.stderr[-3000:]}")
            with open(out) as f:
                (rec,) = json.load(f)
            check(rec["status"] in ("ok", "skipped"), f"dryrun {rec}")
            records.append(rec)
            mem = rec.get("memory", {})
            # every rank holds its arguments at their placements
            check(mem.get("argument_size_in_bytes")
                  == mem.get("argument_size_placed_in_bytes"),
                  f"dryrun {arch} {shape} {flags}: held "
                  f"{mem.get('argument_size_in_bytes')} bytes, placed "
                  f"{mem.get('argument_size_placed_in_bytes')}")
            roof = rec.get("roofline")
            terms = ("" if roof is None else
                     f"; compute {roof['compute_s']:.4f} s, memory "
                     f"{roof['memory_s']:.4f} s, collective "
                     f"{roof['collective_s']:.4f} s -> {roof['dominant']}, "
                     f"useful {roof['useful_flops_frac']:.2%}")
            held, placed, temp = (mem.get(k, 0) / 2 ** 30 for k in (
                "argument_size_in_bytes", "argument_size_placed_in_bytes",
                "temp_size_in_bytes"))
            flops = rec.get("flops_per_rank")
            old_flops, old_temp = EARLIER_DRYRUN.get(
                (arch, shape, rec["mesh"]), (None, None))
            gathers = rec.get("collectives_by_axis", {}).get(
                "model", {}).get("all-gather", 0)
            vs = (f"; a rank: FLOPs "
                  f"{'n/a' if flops is None else f'{flops:.6e}'} (earlier "
                  f"{'n/a' if old_flops is None else f'{old_flops:.4e}'}"
                  f"), temp {temp:.2f} GiB (earlier "
                  f"{'n/a' if old_temp is None else f'{old_temp / 2**30:.2f}'}"
                  f"), model-axis all-gather {gathers} bytes")
            print(f"[dryrun] {arch} x {shape} x {rec['mesh']} "
                  f"({rec['status']}, {rec.get('device')}): held "
                  f"{held:.2f} GiB, placed {placed:.3f} GiB, temp "
                  f"{temp:.2f} GiB, trace {rec.get('compile_s', 0):.1f} s"
                  f"{terms}{vs} | {card}", flush=True)
            if rec.get("flops_by_operator_per_rank"):
                print(f"[dryrun] {arch} x {shape}: FLOPs a rank by "
                      f"operator {rec['flops_by_operator_per_rank']} | "
                      f"{card}", flush=True)
            _check_k5_flops(rec)
            if not smoke:
                _check_against_earlier(rec)
    return records, wall


def phase_dryrun(card: str, device: str = "cuda", smoke: bool = False):
    """Phase 12: the dry-run slice.  (a) At world size 1 (an NCCL group
    of one rank and the (1, 1) mesh, as phase 11's), the dry-run's trace
    on fake tensors predicts the FLOPs and the peak bytes of one
    Qwen3-0.6B training step at DRYRUN_TRAIN (bf16 parameters, f32
    moments) and of one prefill at DRYRUN_PREFILL; one real step of each
    on the card, under ``FlopCounterMode`` after
    ``reset_peak_memory_stats``, must count the same FLOPs and peak
    within DRYRUN_PEAK_RTOL of the prediction; the prefill is a main
    path of K5 (28 launches on mma in bf16); the training step's time
    is printed beside ``Roofline.bound_s``.  (b) The production meshes'
    sweep (:func:`_dryrun_sweep`).  ``device="cpu", smoke=True``
    rehearses it here (reduced config; FLOPs held, no memory check, one
    sweep cell)."""
    import gc
    import statistics
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rf
    from repro_torch.launch.mesh import init_process_group, \
        make_mesh_for_devices
    from repro_torch.launch.steps import make_prefill_step, \
        make_train_step, serving_rules
    from repro_torch.models.sharding import rules_for_mesh
    from repro_torch.optim import adamw

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = get_config("qwen3_0_6b")
    cfg = cfg.reduced() if smoke else cfg
    (tb, ts), (pb, ps) = ((2, 32), (1, 32)) if smoke else (DRYRUN_TRAIN,
                                                           DRYRUN_PREFILL)
    train_shape = ShapeConfig("train", ts, tb, "train")
    prefill_shape = ShapeConfig("prefill", ps, pb, "prefill")
    numbers = {"card": card, "world_size": 1, "arch": cfg.name}
    counts = None

    def measure(run, args):
        """One real call under FlopCounterMode: (flops, peak bytes
        beyond what the process held besides ``args``, seconds)."""
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        sync()
        other = (torch.cuda.memory_allocated()
                 - dryrun.storage_bytes(args) if on_card else 0)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        with FlopCounterMode(display=False) as fc:
            t0 = time.perf_counter()
            out = run()
            sync()
            secs = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - other if on_card
                else None)
        return out, fc.get_total_flops(), peak, other, secs

    def compare(name, pred, flops, peak, other):
        mem = pred["memory"]
        want = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        rel = None if peak is None else (want - peak) / peak
        numbers[name] = dict(
            predicted_flops=pred["flops"], measured_flops=flops,
            predicted_peak_bytes=want, measured_peak_bytes=peak,
            peak_rel_diff=rel, other_bytes=other,
            argument_bytes=mem["argument_size_in_bytes"],
            temp_bytes=mem["temp_size_in_bytes"], trace_s=pred["seconds"],
            predicted_bytes_accessed=pred["bytes"])
        print(f"[dryrun] {name}: FLOPs predicted {pred['flops']:.6e}, "
              f"measured {flops:.6e}; peak predicted "
              f"{want / 2**30:.3f} GiB (arguments "
              f"{mem['argument_size_in_bytes'] / 2**30:.3f} + temp "
              f"{mem['temp_size_in_bytes'] / 2**30:.3f}), measured "
              f"{'n/a' if peak is None else f'{peak / 2**30:.3f}'} GiB "
              f"(max_memory_allocated less {other / 2**30:.3f} GiB held "
              f"before besides the arguments), rel "
              f"{'n/a' if rel is None else f'{rel:+.4f}'}; trace "
              f"{pred['seconds']:.1f} s ({pred['device']}) | {card}",
              flush=True)
        check(pred["flops"] == flops, f"{name}: predicted FLOPs "
              f"{pred['flops']} != measured {flops}")
        if peak is not None:
            check(abs(rel) <= DRYRUN_PEAK_RTOL, f"{name}: predicted peak "
                  f"{want} vs measured {peak} (rel {rel:+.4f})")

    with tempfile.TemporaryDirectory() as tmp:
        init_process_group(device, init_method=f"file://{tmp}/store",
                           rank=0, world_size=1)
        try:
            rules = rules_for_mesh(make_mesh_for_devices(1, 1,
                                                         device=device))
            # (a) training: the prediction, then the card
            pred = dryrun.trace_step(cfg, train_shape, rules, device=device)
            step, model = make_train_step(cfg, rules)
            params = model.init(0, device=device)
            state = adamw.init_state(params)
            gen = torch.Generator(device=device).manual_seed(0)
            batch = {k: torch.randint(0, cfg.vocab_size, (tb, ts),
                                      generator=gen, device=device,
                                      dtype=torch.int32)
                     for k in ("tokens", "labels")}
            build.reset()
            (params, state, metrics), flops, peak, other, _ = measure(
                lambda: step(params, state, batch), (params, state, batch))
            check(not any(_read_counts()["gemm"].values())
                  and not _read_counts()["flash_path"],
                  "the training step launched a hand kernel")
            compare("train_step", pred, flops, peak, other)
            times = []
            for _ in range(3):
                sync()
                t0 = time.perf_counter()
                params, state, metrics = step(params, state, batch)
                float(metrics["loss"])
                times.append(time.perf_counter() - t0)
            roof = rf.Roofline(
                arch=cfg.name, shape="train", mesh="1x1", chips=1,
                hlo_flops=pred["flops"], hlo_bytes=pred["bytes"],
                coll_bytes=float(sum(pred["coll"].values())),
                coll_breakdown=pred["coll"],
                model_flops=rf.model_flops_for(cfg, train_shape))
            med = statistics.median(times)
            numbers["train_step"].update(
                step_ms=[t * 1e3 for t in times], median_step_ms=med * 1e3,
                bound_ms=roof.bound_s * 1e3, compute_ms=roof.compute_s * 1e3,
                memory_ms=roof.memory_s * 1e3, dominant=roof.dominant,
                useful_flops_frac=roof.useful_flops_frac)
            print(f"[dryrun] train step {tb} x {ts}: median "
                  f"{med * 1e3:.1f} ms host clock over {len(times)} steps "
                  f"vs Roofline.bound_s {roof.bound_s * 1e3:.1f} ms "
                  f"(compute {roof.compute_s * 1e3:.1f}, memory "
                  f"{roof.memory_s * 1e3:.1f} unfused, -> "
                  f"{roof.dominant}), useful {roof.useful_flops_frac:.2%} "
                  f"| {card}", flush=True)
            del state, metrics
            # (a) prefill: a main path of K5, counted from 0
            pred = dryrun.trace_step(cfg, prefill_shape, rules,
                                     device=device)
            prefill, _ = make_prefill_step(cfg, serving_rules(cfg, rules))
            tokens = torch.randint(0, cfg.vocab_size, (pb, ps),
                                   generator=gen, device=device,
                                   dtype=torch.int32)
            build.reset()
            (logits, cache), flops, peak, other, secs = measure(
                lambda: prefill(params, {"tokens": tokens}),
                (params, tokens))
            counts = _read_counts()
            check(bool(torch.isfinite(logits).all()),
                  "prefill logits not finite")
            compare("prefill", pred, flops, peak, other)
            numbers["prefill"].update(ms=secs * 1e3, launches=counts)
            if on_card:
                want = {"mma": {"bfloat16": cfg.n_layers * pb}}
                check(counts["flash_path"] == want
                      and counts["flash_shape"] == {
                          "d128,causal": cfg.n_layers * pb},
                      f"prefill K5 launches {counts['flash_path']} "
                      f"{counts['flash_shape']}, want {want}")
            print(f"[dryrun] prefill {pb} x {ps}: {secs * 1e3:.1f} ms, K5 "
                  f"launches {counts['flash_path']} | {card}", flush=True)
            del params, logits, cache
        finally:
            dist.destroy_process_group()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    # (b) the production meshes
    records, wall = _dryrun_sweep(card, smoke)
    numbers["sweep_wall_s"] = wall
    numbers["sweep"] = [
        {k: r.get(k) for k in ("arch", "shape", "mesh", "status", "device",
                               "compile_s", "memory", "reason",
                               "flops_per_rank", "flops_by_operator_per_rank",
                               "collectives_by_axis")}
        | dict(zip(("earlier_flops_per_rank", "earlier_temp_bytes"),
                   EARLIER_DRYRUN.get((r["arch"], r["shape"], r["mesh"]),
                                      (None, None))))
        | ({} if "roofline" not in r else {"roofline": {
            k: r["roofline"][k] for k in (
                "hlo_flops", "hlo_bytes", "coll_bytes", "compute_s",
                "memory_s", "collective_s", "dominant", "model_flops",
                "useful_flops_frac", "roofline_frac")}})
        for r in records]
    numbers["phase_s"] = time.perf_counter() - t_phase
    print(f"[dryrun] sweep of {len(records)} cells {wall:.1f} s wall; phase "
          f"{numbers['phase_s']:.1f} s | {card}", flush=True)
    print(json.dumps({"dryrun": numbers}), flush=True)
    return numbers, counts


def mla_cell_lengths(c=MLA_CELL):
    """Each slot's live length at the cell: a prompt drawn as the cell
    draws a batch of them (chipbench ``dsv3_serve._requests``: one length
    from each of ``slots`` equal strata of the log scale) plus
    ``decoded`` steps."""
    import math

    import numpy as np
    rng = np.random.default_rng(c["seed"])
    k, lo, hi = c["slots"], c["prompt_min"], c["prompt_max"]
    u = (rng.permutation(k) + rng.uniform(size=k)) / k
    lens = np.minimum(np.exp(math.log(lo) + u * math.log((hi + 1) / lo))
                      .astype(np.int64), hi)
    return np.minimum(lens + c["decoded"], c["max_len"])


def mla_counts_bound(live, heads: int) -> tuple:
    """One layer's least time of the whole absorbed decode as the cell's
    ``Counts`` gives it (W_uk into q, the scores over latent and RoPE
    key, the latent sum, W_uv; the live cache, W_uk and W_uv, q and the
    output in bf16), and the kernel's own (its products at the live
    lengths; the live cache read once, q in and o out in f32)."""
    r, rope, nope, vd = 512, 64, 128, 128
    b, n = len(live), int(live.sum())
    flops = 2 * heads * (nope * r * b + n * (2 * r + rope) + r * vd * b)
    nbytes = 2 * (n * (r + rope) + r * heads * (nope + vd)
                  + b * heads * (nope + rope) + b * heads * vd)
    kflops = 2 * heads * n * (2 * r + rope)
    kbytes = 2 * n * (r + rope) + 4 * b * heads * (2 * r + rope)
    return (least_time(flops, nbytes, "bfloat16"),
            least_time(kflops, kbytes, "bfloat16"))


def mla_normwise(got, want):
    """Each slot's normwise error ||got - want||_F / ||want||_F, in f64
    (the bare norm of the difference where ``want`` is 0)."""
    import torch
    num = torch.linalg.norm((got - want).double().flatten(1), dim=1)
    den = torch.linalg.norm(want.double().flatten(1), dim=1)
    return torch.where(den > 0, num / den.clamp_min(1e-300), num)


@contextlib.contextmanager
def mla_checked(errors: list):
    """Hold every MLA decode a model launches inside against its plain
    version.  The kernel runs on the operands as the layer passes them
    (its cache views, idx, q_c, q_rope); device copies of them are kept
    beside its output, so the run gains no host sync, and on leaving the
    plain version computes each call's output from the copies: each
    call's worst-slot normwise error is appended to ``errors``."""
    from repro_torch.kernels import mla_decode as kmla
    from repro_torch.kernels.ref import mla_decode_ref
    launch, kept = kmla.mla_decode, []

    def checked(q_c, q_rope, ckv, k_rope, idx, scale):
        o = launch(q_c, q_rope, ckv, k_rope, idx, scale)
        kept.append((o, q_c.clone(), q_rope.clone(), ckv.clone(),
                     k_rope.clone(), idx.clone(), scale))
        return o
    kmla.mla_decode = checked
    try:
        yield
    finally:
        kmla.mla_decode = launch
    for o, *ops in kept:
        errors.append(float(mla_normwise(o, mla_decode_ref(*ops)).max()))


def _mla_small_server_step(card: str) -> tuple:
    """One Server.step of a small bf16 MLA model at the kernel's widths:
    each of its layers' decodes is one kernel launch on wgmma, held
    against the plain version on its own operands (:func:`mla_checked`).
    Returns the launches by path and the worst slot's normwise error."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import mla_decode as kmla
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config("deepseek_v3_671b").reduced(),
                              kv_lora_rank=kmla.R,
                              qk_rope_head_dim=kmla.ROPE, dtype="bfloat16")
    model = Model(cfg)
    params = model.init(0, device="cuda")
    rng = np.random.default_rng(0)
    server = Server(cfg, model, params, MLA_SMALL["slots"],
                    MLA_SMALL["max_len"])
    for s in range(MLA_SMALL["slots"]):
        server.admit(Request(s, rng.integers(
            0, cfg.vocab_size, (MLA_SMALL["prompt_len"] + s,)).astype(
                np.int32), 4), s)
    build.reset()
    errors = []
    with mla_checked(errors):
        server.step()
    torch.cuda.synchronize()
    counts = _read_counts()["mla_path"]
    want = {"wgmma": {"bfloat16": cfg.n_layers}}
    worst = max(errors)
    print(f"[mla] Server.step of {cfg.name} x{cfg.n_layers} layers, "
          f"{cfg.n_heads} heads, bf16: MLA decode launches {counts}; "
          f"kernel vs plain normwise worst slot {worst:.3e} (limit "
          f"{MLA_TOL}) | {card}", flush=True)
    check(counts == want, f"MLA decode launches on one Server.step "
          f"{counts}, want {want}")
    check(len(errors) == cfg.n_layers and worst <= MLA_TOL,
          f"MLA decode on one Server.step: normwise {errors} (limit "
          f"{MLA_TOL})")
    check(server.nonfinite_logits == 0, "non-finite logits")
    return counts, worst


def phase_mla_decode(card: str):
    """Phase 13: MLA's absorbed decode at the cell's shape, one layer.
    The kernel against its plain version (the f32 decode over the padded
    cache it replaced) on the card, normwise by slot; then timed, by
    CUDA events and by the device time ``torch.profiler`` records,
    beside the cell's ``Counts`` bound and the kernel's own, the plain
    version and, as ``library_ms``, the same decode as one batched
    PyTorch bf16 decode padded to the longest live length (a yardstick
    the port never calls); one Server.step of a small MLA model counted
    and checked.  Returns the phase's numbers."""
    import torch
    from repro_torch.kernels import mla_decode as kmla
    from repro_torch.kernels.ref import mla_decode_ref
    c = MLA_CELL
    t_phase = time.perf_counter()
    b, h, skv = c["slots"], c["heads"], c["max_len"]
    live = mla_cell_lengths()
    gen = torch.Generator(device="cuda").manual_seed(c["seed"])
    bf16 = torch.bfloat16
    q_c = torch.randn((b, h, kmla.R), generator=gen, device="cuda")
    q_rope = torch.randn((b, h, kmla.ROPE), generator=gen, device="cuda")
    ckv = torch.randn((b, skv, kmla.R), generator=gen, device="cuda").to(bf16)
    kr = torch.randn((b, skv, kmla.ROPE), generator=gen,
                     device="cuda").to(bf16)
    idx = torch.from_numpy(live - 1).to("cuda")
    ops = (q_c, q_rope, ckv, kr, idx, MLA_SCALE)

    build.reset()
    got = kmla.mla_decode(*ops)
    torch.cuda.synchronize()
    check(_read_counts()["mla_path"] == {"wgmma": {"bfloat16": 1}},
          "the cell's decode did not take the wgmma path")
    want = mla_decode_ref(*ops)
    err = mla_normwise(got, want)
    worst = float(err.max())
    max_abs = float((got - want).abs().max())
    print(f"[mla] kernel vs plain at B {b}, H {h}, Skv {skv}, live "
          f"{int(live.min())}-{int(live.max())} (mean {live.mean():.0f}): "
          f"normwise worst slot {worst:.3e}, median "
          f"{float(err.median()):.3e} (limit {MLA_TOL}) | {card}",
          flush=True)
    check(worst <= MLA_TOL, f"MLA decode normwise {worst:.3e} > {MLA_TOL}")
    del got, want

    (bound_ms, bound_by), (kbound_ms, kbound_by) = mla_counts_bound(live, h)
    kernel = lambda: kmla.mla_decode(*ops)  # noqa: E731
    ms, dev = time_ms(kernel, 20), device_ms(kernel, 10)
    plain = lambda: mla_decode_ref(*ops)  # noqa: E731
    plain_ms, plain_dev = time_ms(plain, 3), device_ms(plain, 2)
    # the yardstick: one batched bf16 decode padded to the longest live
    # length, the positions past each slot's masked
    qcb, qrb = q_c.to(bf16), q_rope.to(bf16)
    n = int(live.max())
    ck, krn = ckv[:, :n], kr[:, :n]
    dead = (torch.arange(n, device="cuda")[None] > idx[:, None])[:, None]

    def library():
        s_ = (torch.bmm(qcb, ck.transpose(1, 2))
              + torch.bmm(qrb, krn.transpose(1, 2))) * MLA_SCALE
        w = torch.softmax(s_.float().masked_fill_(dead, -torch.inf), dim=-1)
        return torch.bmm(w.to(bf16), ck)
    lib_ms, lib_dev = time_ms(library, 5), device_ms(library, 3)
    print(f"[mla] kernel {ms:.4f} ms (device {dev}), plain {plain_ms:.3f} "
          f"ms (device {plain_dev}), library batched bf16 {lib_ms:.3f} ms "
          f"(device {lib_dev}); bound: the cell's Counts {bound_ms:.4f} ms "
          f"({bound_by}), the kernel's own {kbound_ms:.4f} ms "
          f"({kbound_by}) | {card}", flush=True)
    small, small_worst = _mla_small_server_step(card)
    numbers = dict(
        shape=dict(c, live_mean=float(live.mean()), live_sum=int(live.sum())),
        normwise_worst=worst, ms=ms, device_ms=dev, plain_ms=plain_ms,
        plain_device_ms=plain_dev, library_ms=lib_ms,
        library_device_ms=lib_dev, bound_ms=bound_ms, bound_by=bound_by,
        kernel_bound_ms=kbound_ms, kernel_bound_by=kbound_by,
        small_server_step=small, small_normwise_worst=small_worst,
        max_abs_err=max_abs,
        phase_s=time.perf_counter() - t_phase)
    print(f"[mla] phase {numbers['phase_s']:.1f} s | {card}", flush=True)
    print(json.dumps({"mla_decode": numbers}), flush=True)
    return numbers


# phase 14: the benchmark cell's MoE layer (chipbench's
# dsv3-ep32-decode8k): its config file, the tokens of a decode step and
# of the longest prompt, a seed
MOE_CONFIG = "chipbench/configs/deepseek_v3_ep32_l9.json"
MOE_TOKENS = (256, 4096)
MOE_SEED = 14
# kernels vs plain version, the worst token's normwise error
# (tests/test_torch_moe_experts.py TOL): the tensor cores' f32 sums run
# in another order and round otherwise than the plain version's, so h
# lands on the other bf16 neighbour in a share of its elements (H100:
# 0.65e-3 at decode, 2.4e-3 at N 4096); a k16 slice of x lost from the
# gate and up products reads 0.10-0.11
MOE_TOL = 1e-2


def moe_layer(device: str = "cuda", seed: int = MOE_SEED):
    """The cell's config and one MoE layer's router, selection bias and
    held experts' weights, N(0, 1/fan_in) from ``seed`` (bf16 experts)."""
    import torch
    from repro_torch.configs.deepseek_v3_ep import DeepSeekV3Config
    hf = json.loads((ROOT / MOE_CONFIG).read_text())
    cfg = DeepSeekV3Config.from_hf(hf, dtype=hf["dtype"])
    g = torch.Generator(device=device).manual_seed(seed)
    d, ff, held = cfg.d_model, cfg.moe_d_ff, len(cfg.held_experts())

    def mat(*shape, dt=torch.bfloat16):
        w = torch.randn(shape, generator=g, device=device)
        return (w * shape[-2] ** -0.5).to(dt)

    p = {"router": mat(d, cfg.n_experts, dt=torch.float32),
         "bias": 0.1 * torch.randn((cfg.n_experts,), generator=g,
                                   device=device),
         "w_gate": mat(held, d, ff), "w_up": mat(held, d, ff),
         "w_down": mat(held, ff, d)}
    return cfg, p


def moe_loop_before(xt, experts, weights, w_gate, w_up, w_down, first):
    """The held experts as the layer computed them before the kernels:
    the counts read to the host, one ``torch.matmul`` an expert and
    weight in bf16 (a yardstick only)."""
    import torch
    import torch.nn.functional as F
    k, held = experts.shape[1], w_gate.shape[0]
    flat = experts.reshape(-1) - first
    local = torch.where((flat >= 0) & (flat < held), flat, held)
    order = torch.argsort(local, stable=True)
    counts = torch.bincount(local, minlength=held + 1)[:held].tolist()
    y = torch.zeros(xt.shape, dtype=torch.float32, device=xt.device)
    start = 0
    for e, c in enumerate(counts):
        if c:
            slots = order[start:start + c]
            tokens = slots // k
            xe = xt[tokens]
            h = F.silu(xe @ w_gate[e]) * (xe @ w_up[e])
            y.index_add_(0, tokens, (h @ w_down[e]).float()
                         * weights.reshape(-1)[slots, None])
        start += c
    return y


def moe_bound(counts, d: int, ff: int) -> tuple:
    """One layer call's least time as the cell's ``Counts`` gives it:
    the slots' operations; each used expert's weights read once, the
    token rows in and out, in bf16."""
    n, used = sum(counts), sum(1 for c in counts if c)
    return least_time(n * 6 * d * ff, 2 * (used * 3 * d * ff + 2 * n * d),
                      "bfloat16")


def _moe_kernel_ms(fn, reps: int) -> dict:
    """Device ms a call of each of the layer's kernels (the profiler's
    kernel time, by name), None where the profile is empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {"layout": 0.0, "gather": 0.0, "gate_up": 0.0, "down": 0.0}
    for e in _kernel_events(prof):
        name = e.key
        if "moe_grouped" in name:
            gated = "true" in name or "Lb1E" in name
            out["gate_up" if gated else "down"] += _device_us(e)
        elif "moe_layout" in name:
            out["layout"] += _device_us(e)
        elif "moe_gather" in name:
            out["gather"] += _device_us(e)
    if not any(out.values()):
        return {k: None for k in out}
    return {k: v / reps / 1e3 for k, v in out.items()}


def phase_moe_experts(card: str):
    """Phase 14: the held experts' grouped kernels at the cell's decode
    shape and its longest prefill, one layer each: against their plain
    version on the card, the launch ledger checked, then timed beside
    the cell's bound, the plain version and the loop they replaced.
    Returns the phase's numbers, by token count."""
    import torch
    from repro_torch.kernels import moe_experts as kme
    from repro_torch.kernels.ref import moe_experts_ref
    from repro_torch.models.moe import published_router
    t_phase = time.perf_counter()
    cfg, p = moe_layer()
    first, d, ff = cfg.held_experts().start, cfg.d_model, cfg.moe_d_ff
    ws = (p["w_gate"], p["w_up"], p["w_down"])
    g = torch.Generator(device="cuda").manual_seed(MOE_SEED + 1)
    by_n = {}
    for n in MOE_TOKENS:
        xt = torch.randn((n, d), generator=g, device="cuda"
                         ).to(torch.bfloat16)
        weights, experts = published_router(cfg, p, xt)
        ops = (xt, experts, weights, *ws)
        build.reset()
        y, offsets = kme.moe_experts(*ops, first, cfg.n_experts)
        torch.cuda.synchronize()
        ledger = {f"{k.kernel}:{k.path}:{k.dtype}:{','.join(k.tags)}": v
                  for k, v in build.snapshot().items()}
        want = {"moe_layout:wgmma:bfloat16:": 1,
                "moe_experts:wgmma:bfloat16:gate_up": 1,
                "moe_experts:wgmma:bfloat16:down": 1}
        check(ledger == want, f"MoE launches at N {n}: {ledger}, want "
              f"{want}")
        ref, ref_off = moe_experts_ref(*ops, first)
        check(offsets.tolist() == ref_off.tolist(),
              f"MoE offsets at N {n}: {offsets.tolist()} against "
              f"{ref_off.tolist()}")
        counts = [b - a for a, b in zip(ref_off.tolist(),
                                        ref_off.tolist()[1:])]
        num = torch.linalg.norm((y - ref).double(), dim=1)
        den = torch.linalg.norm(ref.double(), dim=1)
        live = den > 0
        check(not y[~live].any(), f"MoE at N {n}: output on a token "
              f"with no held slot")
        worst = float((num[live] / den[live]).max())
        median = float((num[live] / den[live]).median())
        max_abs = float((y - ref).abs().max())
        # what the limit separates: the loop before the kernels (bf16
        # products, g and u rounded), and a planted fault, the plain
        # version with the first k16 slice of x lost
        lost = xt.clone()
        lost[:, :16] = 0
        readings = {}
        for name, other in (("loop_before", moe_loop_before(*ops, first)),
                            ("lost_k16", moe_experts_ref(
                                lost, *ops[1:], first)[0])):
            e_ = torch.linalg.norm((other - ref).double(), dim=1)
            readings[name] = float((e_[live] / den[live]).max())
        del y, ref, lost
        call = lambda: kme.moe_experts(*ops, first, cfg.n_experts)  # noqa
        plain = lambda: moe_experts_ref(*ops, first)  # noqa: E731
        before = lambda: moe_loop_before(*ops, first)  # noqa: E731
        ms, dev = time_ms(call, 20), device_ms(call, 10)
        parts = _moe_kernel_ms(call, 10)
        plain_ms, plain_dev = time_ms(plain, 5), device_ms(plain, 3)
        lib_ms, lib_dev = time_ms(before, 5), device_ms(before, 3)
        bound_ms, bound_by = moe_bound(counts, d, ff)
        tile = kme.token_tile(n * cfg.top_k, cfg.n_experts)
        print(f"[moe] N {n} (top {cfg.top_k} of {cfg.n_experts}, held "
              f"{len(counts)}, slots {counts}, tile {tile}): kernels "
              f"{ms:.4f} ms (device {dev}; layout {parts['layout']}, "
              f"gather {parts['gather']}, gate_up {parts['gate_up']}, down "
              f"{parts['down']}), plain {plain_ms:.3f} ms (device "
              f"{plain_dev}), loop before {lib_ms:.3f} ms (device "
              f"{lib_dev}); bound {bound_ms:.4f} ms ({bound_by}); normwise "
              f"worst token {worst:.3e}, median {median:.3e} (limit "
              f"{MOE_TOL}; loop before {readings['loop_before']:.3e}, a "
              f"lost k16 slice {readings['lost_k16']:.3e}) | {card}",
              flush=True)
        check(worst <= MOE_TOL, f"MoE kernels vs plain at N {n}: "
              f"normwise {worst:.3e} > {MOE_TOL}")
        by_n[n] = dict(
            slots=counts, tile=tile, normwise_worst=worst,
            normwise_median=median, readings=readings, max_abs_err=max_abs, ms=ms, device_ms=dev,
            kernel_device_ms=parts, plain_ms=plain_ms,
            plain_device_ms=plain_dev, library_ms=lib_ms,
            library_device_ms=lib_dev, bound_ms=bound_ms,
            bound_by=bound_by, ledger=ledger)
    numbers = dict(by_tokens=by_n, phase_s=time.perf_counter() - t_phase)
    print(f"[moe] phase {numbers['phase_s']:.1f} s | {card}", flush=True)
    print(json.dumps({"moe_experts": numbers}), flush=True)
    return numbers


def _device_us(event) -> float:
    return float(getattr(event, "self_device_time_total",
                         getattr(event, "self_cuda_time_total", 0.0)))


def _kernel_events(prof):
    """The profile's device-side events (kernels, copies) with device
    time.  A host-side op carries its kernels' time too, so summing
    every event would count each kernel twice."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _device_us(e) > 0]


def profile_serving(card: str, model, params, tokens):
    """Where one prefill and one 8-slot decode step spend the card's
    time: ``torch.profiler`` over each, device time by kernel, and the
    device's busy share of the host-clock wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _, cache = model.prefill(params, tokens=tokens)
    cache = model.pad_cache(cache, SERVE["max_len"])
    slots = SERVE["batch_slots"]
    cache = {"blocks": {k: torch.repeat_interleave(a, slots, dim=1)
                        for k, a in cache["blocks"].items()}}
    tok = tokens[0, -slots:].clone()
    pos = torch.full((slots,), SERVE["prompt_len"], dtype=torch.int64,
                     device=tokens.device)
    runs = {"prefill": lambda: model.prefill(params, tokens=tokens),
            "decode step": lambda: model.decode(params, cache, tok, pos)}
    for label, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = _kernel_events(prof)
        busy_us = sum(_device_us(e) for e in events)
        if busy_us == 0:
            print(f"[profile] {label}: the profiler saw no device time; "
                  f"device busy share not measured | {card}", flush=True)
            continue
        top = sorted(events, key=_device_us, reverse=True)[:6]
        print(f"[profile] {label}: wall {wall_us / 1e3:.3f} ms, device busy "
              f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%), "
              f"{sum(e.count for e in events)} device ops | {card}",
              flush=True)
        for e in top:
            print(f"[profile]   {_device_us(e) / 1e3:8.3f} ms "
                  f"{100 * _device_us(e) / busy_us:5.1f}% x{e.count:<5d} "
                  f"{e.key[:90]}", flush=True)


def profile_training(card: str, cfg, train: dict):
    """Where one train step at phase 11's size spends the card's time:
    ``torch.profiler`` over one step after a warm-up step, device time by
    kernel and the device's busy share of the host-clock wall."""
    import gc

    import torch
    from repro_torch.data import DataConfig, batch_at_step
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import NO_MESH
    from repro_torch.optim import adamw
    from torch.profiler import ProfilerActivity, profile

    step, model = make_train_step(cfg, NO_MESH)
    params = model.init(train["seed"], device="cuda")
    state = adamw.init_state(params)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_at_step(
        DataConfig(cfg.vocab_size, train["seq_len"], train["global_batch"],
                   seed=train["seed"]), 0).items()}
    params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        float(m["loss"])
        wall_us = (time.perf_counter() - t0) * 1e6
    events = _kernel_events(prof)
    busy_us = sum(_device_us(e) for e in events)
    if busy_us == 0:
        print(f"[profile] train step: the profiler saw no device time; "
              f"device busy share not measured | {card}", flush=True)
    else:
        print(f"[profile] train step: wall {wall_us / 1e3:.1f} ms, device "
              f"busy {busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%)"
              f", {sum(e.count for e in events)} device ops | {card}",
              flush=True)
        for e in sorted(events, key=_device_us, reverse=True)[:10]:
            print(f"[profile]   {_device_us(e) / 1e3:8.3f} ms "
                  f"{100 * _device_us(e) / busy_us:5.1f}% x{e.count:<5d} "
                  f"{e.key[:90]}", flush=True)
    del params, state, batch
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def kept_storage():
    """Within it, each train step that ``launch.train.run`` builds is
    watched: yields {"steps": the calls, "moved": the parameters,
    moments and step counts that a call returned in other tensors or
    storage than it was given}."""
    from repro_torch.launch import train as T
    from repro_torch.tree import tree_flatten
    make = T.make_train_step
    seen = {"steps": 0, "moved": 0}

    def leaves(params, state):
        return tree_flatten({"params": params, "opt": state})[1]

    def watched_make(*args, **kw):
        step, model = make(*args, **kw)

        def watched(params, state, *a, **k):
            given = [(t, t.data_ptr()) for t in leaves(params, state)]
            out = step(params, state, *a, **k)
            seen["steps"] += 1
            seen["moved"] += sum(t is not o or o.data_ptr() != ptr for
                                 (t, ptr), o in zip(given,
                                                    leaves(*out[:2])))
            return out
        return watched, model

    T.make_train_step = watched_make
    try:
        yield seen
    finally:
        T.make_train_step = make


def one_step_peak(cfg, train: dict, donate: bool):
    """(peak allocated GiB, GiB held before) of one train step at phase
    11's size from fresh weights with no mesh, its update donated or
    not, the weights, moments and batch made after the peak's reset."""
    import gc

    import torch
    from repro_torch.data import DataConfig, batch_at_step
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import NO_MESH
    from repro_torch.optim import adamw

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step, model = make_train_step(cfg, NO_MESH, donate=donate)
    params = model.init(train["seed"], device="cuda")
    state = adamw.init_state(params)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_at_step(
        DataConfig(cfg.vocab_size, train["seq_len"], train["global_batch"],
                   seed=train["seed"]), 0).items()}
    params, state, m = step(params, state, batch)
    float(m["loss"])
    peak = torch.cuda.max_memory_allocated()
    del params, state, m, batch
    gc.collect()
    torch.cuda.empty_cache()
    return peak / 2 ** 30, held / 2 ** 30


def _read_counts():
    """One snapshot of the launch ledger as the JSON lines report it:
    each kernel's launches by path and dtype, the GEMM's by dtype, staged
    by dtype, by simt copy and with an epilogue, and flash's by shape and
    staged by dtype."""
    counts = {"gemm": {}, "gemm_path": {}, "staged": {}, "simt_copy": {},
              "epilogue": 0, "flash_path": {}, "flash_shape": {},
              "flash_staged": {}, "mla_path": {}, "moe_path": {}}

    def bump(table, key, n):
        table[key] = table.get(key, 0) + n

    for k, n in build.snapshot().items():
        kind = {"gemm": "gemm", "flash": "flash", "mla_decode": "mla",
                "moe_layout": "moe", "moe_experts": "moe"}[k.kernel]
        bump(counts[f"{kind}_path"].setdefault(k.path, {}), k.dtype, n)
        if kind == "moe":
            continue
        if kind == "gemm":
            bump(counts["gemm"], k.dtype, n)
        for tag in k.tags:
            if tag == "staged":
                bump(counts["staged" if kind == "gemm" else "flash_staged"],
                     k.dtype, n)
            elif tag == "epilogue":
                counts["epilogue"] += n
            elif kind == "flash":
                bump(counts["flash_shape"], tag, n)
            else:
                bump(counts["simt_copy"], tag, n)
    return counts


def _check_simt_is_f32(where: str, counts) -> None:
    """The simt paths are f32's alone: no 16-bit GEMM or flash launch
    takes one."""
    simt = counts["gemm_path"].get("simt", {})
    check(set(simt) <= {"float32"},
          f"{where}: simt launches by dtype {simt}; 16-bit must take wgmma")
    simt = counts["flash_path"].get("simt", {})
    check(set(simt) <= {"float32"}, f"{where}: flash simt launches by "
          f"dtype {simt}; 16-bit must take mma")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = phase_device()
    warm_profiler()
    build_s = phase_build()
    kern = phase_kernel(card)
    epi = phase_epilogue(card)
    flash, flash_family = phase_attention(card)
    # every launch so far (phases 3, 5 and 6) counted since start-up
    _check_simt_is_f32("phases 3, 5, 6", _read_counts())
    # main path 1, the BLAS library: the counts start at 0; the
    # comparison phases' launches do not count
    build.reset()
    phase_main_path(card, 16384)
    blas = _read_counts()
    print(f"[main] GEMM launches by path: {blas['gemm_path']}, staged "
          f"{blas['staged']}, simt copies {blas['simt_copy']} | {card}",
          flush=True)
    _check_simt_is_f32("BLAS main path", blas)
    for name in DTYPES:
        n = blas["gemm"].get(name, 0)
        check(n > 0, f"kernel for {name} never launched on the BLAS main path")
        on_path = blas["gemm_path"].get(MAIN_PATH[name], {}).get(name, 0)
        check(on_path == n, f"{name}: {on_path} of {n} BLAS main-path "
              f"launches took the {MAIN_PATH[name]} path")
    # main path 2, the library's other front doors: CBLAS, async
    # futures, batched GEMM, the autotuner and the multi-tenant server
    build.reset()
    _, server_launches = phase_api(card)
    api = _read_counts()
    print(f"[api] GEMM launches by path: {api['gemm_path']}, staged "
          f"{api['staged']}, simt copies {api['simt_copy']} | {card}",
          flush=True)
    _check_simt_is_f32("api path", api)
    for name in ("float64", "float32", "bfloat16"):
        n = api["gemm"].get(name, 0)
        check(n > 0, f"kernel for {name} never launched on the api path")
        on_path = api["gemm_path"].get(MAIN_PATH[name], {}).get(name, 0)
        check(on_path == n, f"{name}: {on_path} of {n} api-path launches "
              f"took the {MAIN_PATH[name]} path")
    check(set(server_launches) == {"wgmma", "dmma", "simt"}
          and set(server_launches["wgmma"]) == {"bfloat16"}
          and set(server_launches["dmma"]) == {"float64"}
          and set(server_launches["simt"]) == {"float32"},
          f"server launches by path {server_launches}: want bf16 on "
          "wgmma, f64 on dmma, f32 on simt, each non-zero")
    # main path 3, serving (counted from 0 inside)
    _, serve = phase_serve(card)
    _check_simt_is_f32("serving path", serve)
    # main path 4, the analysis phase's work-centric GEMMs
    build.reset()
    _, analysis = phase_analysis(card)
    print(f"[analysis] GEMM launches by path: {analysis['gemm_path']}, "
          f"staged {analysis['staged']} | {card}", flush=True)
    _check_simt_is_f32("analysis path", analysis)
    for name in ("float64", "float32"):
        n = analysis["gemm"].get(name, 0)
        check(n > 0, f"kernel for {name} never launched on the analysis path")
        on_path = analysis["gemm_path"].get(MAIN_PATH[name], {}).get(name, 0)
        check(on_path == n, f"{name}: {on_path} of {n} analysis-path "
              f"launches took the {MAIN_PATH[name]} path")
    # main paths 5-9, the other families, one model each (counted from 0
    # inside)
    family_numbers, families = phase_families(card)
    for arch, run in families.items():
        _check_simt_is_f32(f"{arch} path", run)
    # main path 10, training (counted from 0 inside; it reaches no hand
    # kernel: neither has a backward, so train-mode attention and the
    # GEMMs are plain torch, as the reference's are XLA)
    _, train = phase_train(card)
    # main path 11, the dry-run's prefill on the card (counted from 0
    # inside); its training step reaches no hand kernel
    _, dry = phase_dryrun(card)
    _check_simt_is_f32("dry-run prefill", dry)
    mla = phase_mla_decode(card)
    moe = phase_moe_experts(card)
    main_runs = (blas, api, serve, analysis, *families.values(), train, dry)
    # every main-path flash launch is bf16 (phases 7 and 10 check it),
    # so the by-shape counts are bf16's
    check(all(set(d) <= {"bfloat16"} for run in main_runs
              for d in run["flash_path"].values()),
          "a main path launched flash in another dtype than bf16")
    print(f"[done] build {build_s:.1f} s, total "
          f"{time.perf_counter() - t_start:.1f} s | {card}")

    def launches(label, name):
        """Main-path launches of a phase-3 entry: staged 16-bit launches
        for "wgmma staged", the others for "wgmma"."""
        path = label.split()[0]
        n = sum(run["gemm_path"].get(path, {}).get(name, 0)
                for run in main_runs)
        staged = sum(run["staged"].get(name, 0) for run in main_runs)
        if path == "wgmma":
            return staged if label.endswith("staged") else n - staged
        return n

    def entry(name, path, source, replaces, launches, r):
        e = {"name": name, "route": "cuda", "path": path,
             "source": source, "replaces": replaces, "launches": launches,
             "max_abs_err": r["max_abs_err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        e.update({k: r[k] for k in DEVICE_KEYS if k in r})
        return e

    # one GEMM entry per route and dtype: f32 simt keeps its first
    # name and carries its 4-byte variant's times at SIMT_SHAPE (and
    # the 16-byte one's there) and its main-path launches by variant;
    # the tensor-core paths add theirs, the staged 16-bit route its own
    four = kern.pop(("float32", "simt 4-byte"))
    kernels = [entry(f"blasx_batched_gemm<{name}>" if label == "simt"
                     else f"blasx_batched_gemm<{name},"
                          f"{label.replace(' ', ',')}>", label.split()[0],
                     KERNEL_SOURCE, REPLACES, launches(label, name),
                     kern[(name, label)]) for name, label in kern]
    for e, (name, label) in zip(kernels, kern):
        r = kern[(name, label)]
        if label == "simt":
            e.update(ms_by_block=r["blocks"], ms_4byte=four["ms"],
                     ms_by_block_4byte=four["blocks"],
                     ms_16byte_at_shape_4byte=four["ms_16byte"],
                     shape_4byte=list(four["shape"]),
                     a_offset_4byte=SIMT_A_OFFSET,
                     launches_by_copy={
                         v: sum(run["simt_copy"].get(v, 0)
                                for run in main_runs)
                         for v in ("16-byte", "4-byte")})
        if "stage_ms" in r:
            e.update(stage_ms=r["stage_ms"], kernel_ms=r["kernel_ms"])
    kernels.append(entry("blasx_gemm_epilogue<bfloat16>", epi["path"],
                         KERNEL_SOURCE, EPILOGUE_REPLACES,
                         sum(run["epilogue"] for run in main_runs), epi))
    def flash_launches(route, name):
        """Main-path launches of a flash route: the staged launches of
        the dtype for "<path> staged", the others for "<path>"."""
        path = route.split()[0]
        n = sum(run["flash_path"].get(path, {}).get(name, 0)
                for run in main_runs)
        staged = sum(run["flash_staged"].get(name, 0)
                     for run in main_runs)
        return staged if route.endswith("staged") else n - staged

    # one flash entry per route and dtype; f32 simt keeps its first
    # name, the mma path and the staged routes add theirs
    kernels += [entry(f"flash_attention<{name}>" if route == "simt"
                      else f"flash_attention<{name},"
                           f"{route.replace(' ', ',')}>", route.split()[0],
                      FLASH_SOURCE, FLASH_REPLACES,
                      flash_launches(route, name), flash[(name, route)])
                for name, route in flash]
    for e, r in zip(kernels[-len(flash):], flash.values()):
        e.update({k: r[k] for k in ("stage_ms", "kernel_ms",
                                    "stage_device_ms", "kernel_device_ms")
                  if k in r})
    # the other families' shapes (phase 6), their main-path launches by
    # shape key from phase 10
    for (name, key), r in flash_family.items():
        n = sum(run["flash_shape"].get(key, 0) for run in main_runs)
        e = entry(f"flash_attention<{name},{r['path']},{key}>", r["path"],
                  FLASH_SOURCE, FLASH_REPLACES,
                  n if name == "bfloat16" else 0, r)
        e.update(shape=key, case=r["case"])
        kernels.append(e)
    # MLA's decode kernel: its main-path launches (the families' MLA
    # model's decode steps) and the worst slot's normwise error against
    # the plain version of every check (the cell's shape, the families'
    # MLA decodes, the small Server.step)
    e = entry("mla_decode<bfloat16,wgmma>", "wgmma", MLA_SOURCE,
              MLA_REPLACES, sum(run["mla_path"].get("wgmma", {}).get(
                  "bfloat16", 0) for run in main_runs), mla)
    e["normwise_worst"] = max(
        [mla["normwise_worst"], mla["small_normwise_worst"]]
        + [r["mla_vs_plain"] for r in family_numbers.values()
           if r["mla_vs_plain"] is not None])
    kernels.append(e)
    # the held experts' kernels, at the cell's decode shape; no phase's
    # main path holds experts (the cell's config runs in chipbench)
    decode = moe["by_tokens"][MOE_TOKENS[0]]
    e = entry("moe_experts<bfloat16,wgmma>", "wgmma", MOE_SOURCE,
              MOE_REPLACES, sum(sum(run["moe_path"].get("wgmma", {})
                                    .values()) for run in main_runs),
              decode)
    e.update(normwise_worst=max(r["normwise_worst"]
                                for r in moe["by_tokens"].values()),
             kernel_device_ms=decode["kernel_device_ms"])
    kernels.append(e)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
