"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases (any failure raises and the exit code is non-zero):
  1. device: the card's name, count, and power limit (nvidia-smi), and that
     its SM count and shared-memory opt-in are at least what the planner's
     H100 hierarchy (``h100_sm``) assumes;
  2. build: every CUDA kernel of the port with nvcc for sm_90a, one process
     per source, printing each instance's registers, shared memory and
     spills (ptxas -v); a bf16 flash-attention instance or a wgmma matmul
     instance that spills fails;
  plan: every tile the later phases launch, planned by ``codesign.plan`` on
     the H100 hierarchy before any timed window (a cold search takes tenths
     of a second on the host), printed with its source; each space's
     shared-memory formula is held against the compiled kernel's;
  3. kernels: each kernel against its plain PyTorch version on the card:
     flash attention's split decode at the serving shape in bf16 and f32
     (kv_len 0, 1, 37, bk - 1, bk, 300, 512; slots past kv_len unread), the
     causal prefill and the zamba2 training shape (D = 80, causal, bf16),
     f32 (FMA) and bf16 (tensor-core) sweeps at D = 128-and-less and D = 80,
     the D = 192 instances (MLA's d = 192, dv = 128 zero-padded to them;
     prefill, GQA rows, decode), bf16 with many keys also within a
     row-scaled limit that fails with a KV tile dropped; the families
     phase's shapes (hubert's ragged non-causal 8 x 1499 at D = 80,
     llava's causal 3008 at GQA group 7, group 7 in the split decode); the
     train_ft, train_moe and distributed (d) shapes (qwen3 4 x 2048 at
     16/8 heads of 128, MLA 2 x 2048 at d 192, dv 128, qwen3 2 x 2048 at
     8/4 heads of 128), all row-scaled too; its autograd
     wrapper's grads; the SSD kernel at the test_ssd_sweep shapes, the
     zamba2 training shape and hp = n = 128 with B/C materialised and
     expanded over heads with stride 0, and ``ssd_chunked`` against the
     token-by-token recurrence; the matmul kernel's two instances (bf16
     wgmma + TMA; f32 FMA, which also takes bf16 that TMA cannot read):
     every wgmma tile and operand orientation first at a tiny shape under a
     host-side time limit, then test_matmul_sweep's shapes in f32 and bf16
     with the planned tile on the routed instance (counted per instance),
     every wgmma tile in all four orientations with f32 and bf16 outputs and
     1 to the most stages, every compiled FMA tile and K slice with aligned,
     unaligned and transposed operands, leading dims, and the autograd
     grads in f32 and bf16; f32 products are held to a float64 evaluation
     within sqrt(K) u (|a| |b|), which TF32-rounded operands fail;
  4. codesign: the co-design loop (``repro_torch.launch.quickstart``): plan
     quickstart step 4's 512x3072x768 GEMM in each dtype's space, launch it
     with the planned tile in f32 and bf16 and check it, then calibrate
     every kernel space on the card (``calibrate_kernel``: the planned tile,
     CUDA-event time next to the model's prediction; both matmul spaces)
     and print the calibration table; every kernel must have launched in
     it, every bf16 matmul launch on the wgmma instance (per-instance counts
     and the kernel name in a profiler window over bf16 calibration
     launches, the process's first profiler window);
  mappers: for every calibration row, each of Union's five mappers
     (heuristic, exhaustive, random, genetic, decoupled) searches the
     space's problem on its H100 hierarchy without the space's tile
     constraints; each tile is decoded, legalized, predicted under the
     calibration scale just measured, held against its plain version on
     three input draws and timed like the calibration rows beside the plain
     version and the PyTorch call, next to the row's ``codesign.plan`` tile
     and its default; every kernel and both matmul instances must have
     launched in the timed windows; the table is printed, the full record
     written to ``chiprun_out/mappers.json``, and each (row, tile) is a
     record of its own in the kernels' JSON line;
  whole_model: Union's whole-model layer (``core/opstream.py``): the
     operator streams of three full-width steps (the serve phase's
     qwen3-0.6b decode at 8 slots x max_len 512, a prefill of the same
     slots, the train phase's zamba2-2.7b step at 2 x 2048), each within
     the MODEL_FLOPS reconciliation band; one ``union_opt_sweep`` over
     their mappable entries on ``h100_sm()`` (heuristic mapper, timeloop
     model) serially, on 8 spawned processes with a journal, and replayed
     from the journal: the same mappings and costs bit for bit, no pool
     fallen back to serial, nothing re-searched on replay (host times
     printed); every unique GEMM entry planned in ``matmul_bf16_h100``,
     launched through the op's routing (wgmma), held against its plain
     version and timed beside ``torch.matmul`` and its bound, next to
     Union's prediction for it, with multiplicity-weighted sums per step;
     each (entry, tile) is a record of the kernels' JSON line;
  search_engine: Union's search on the card -- the engine's torch backend
     (float64/int64 array programs on CUDA, one fused admit+score dispatch
     per miss-batch, the device-resident loops) held bit for bit against
     the numpy engine, no fallback allowed: (a) the whole_model phase's
     sweep again on torch; (b) benchmarks/mappers_bench.py's matrix outside
     smoke mode (BERT-2 on cloud_accelerator(), timeloop, EDP: random,
     exhaustive at 3000, genetic, heuristic) and the exhaustive mapper at
     its 50,000 cap on the prefill head GEMM on h100_sm() (device loop on
     and off), each on numpy and on torch cold and warm, with evals/s
     (host clock, card synchronised), programs first dispatched, device
     syncs and dispatches; (c) the mapping service on torch: 24 Poisson
     queries over 4 shapes through its HTTP front on 127.0.0.1 (p50/p99
     ms), each answer equal to a numpy service's, 120 cold queries of
     distinct shapes on each in turns (cold p50/p99), a burst of 8 against
     queue cap 2 that must shed, and the breaker walk under injected
     jaxfail:0;jaxfail:1; the record goes to chiprun_out/search_engine.json
     (no kernel of the port runs in it: the kernels line is unchanged);
  5. serve: qwen3-0.6b at full width (random weights from a seeded
     generator on the card), 16 requests through ``WaveServer`` with the
     kernels on; the kernel launch counts must match the steps run, and one
     wave's first decode-step logits are checked against the kernels-off
     (chunked attention) decode and against the full forward pass;
  serve_moe: deepseek-v2-lite-16b (15.7 B parameters; MLA at d = 192,
     dv = 128 on the flash kernel's D = 192 instance; one dense prefix
     layer, 26 MoE layers of 64 experts top-6 + 2 shared) with 8 requests
     (one wave) of 32 new tokens, then qwen2-moe-a2.7b (14.3 B; GQA, 24 MoE layers of
     60 top-4 + 4 shared) with 8 of 16, at full width and depth with random
     weights, 8 slots, max_len 512, kernels on, each freed before the next.
     Each must serve every request with flash-attention launches equal to
     n_layers x steps, all on one compiled D (192 for deepseek). After a
     prefill of the first wave, the first decode step's logits with the
     kernels on are held against kernels off and against the full forward
     (kernels off, capacity raised to E so nothing is dropped), at full
     depth in bf16 and on the first 4 layers in float32; the kernels-on
     decode and the forward follow the kernels-off decode's routes (a
     near-tie of two experts flips with any rounding; the share each would
     move is printed), and each tolerance must fail the kernels-off step
     with its first KV tile dropped or with one expert's output zeroed.
     Then tokens/s, the decode step on and off, the busy share at KV ~512
     and peak memory; last, Union's predicted deepseek decode step (8 x
     512, h100_sm()) by role beside the measured one;
  families: the configs whose blocks and frontends were ported last, at
     full width, each freed before the next. xlstm-1.3b (3.49 B; 8 units of
     5 mLSTM + 1 sLSTM; no attention, so no kernel) serves the serve
     phase's load through ``WaveServer``; its decode is held against the
     chunked forward on one unit cut from it in float32 over 512 positions
     (two mLSTM chunks; 2e-3) and on the full model in bf16 after a
     prefill of one wave, each tolerance failing with the first mLSTM
     layer's stabiliser m reset to 0; tokens/s, the decode step on and off,
     the busy share, the step's byte bound (weights + twice the recurrent
     state), peak memory and Union's predicted step. hubert-xlarge
     (0.95 B, encoder-only) encodes 8 x 1499 frames (forward and loss):
     48 flash-attention launches a forward, all non-causal and many-row at
     D = 80; logits kernels on vs off (the plain attention in one
     1499-row chunk), failing with the partial last KV tile dropped; the
     last frame must move the first position, which a mask forced causal
     cannot; frames/s, busy share, peak memory, the loss. llava-next-34b
     (34.45 B) prefills 2880 patch embeddings and 128 text tokens at full
     depth (cut, and said so, only if the card cannot hold it): 60 causal
     many-row launches at GQA group 7; time to the first token; the text
     logits kernels on vs off at full depth in bf16 and on the first 4
     layers in float32 (2e-3), each failing with the last KV tile dropped;
     zeroed patch embeddings must move them; busy share, peak memory and
     Union's predicted prefill and encode;
  6. train: zamba2-2.7b at full width (2.90 B parameters, random weights
     from a seeded generator) through ``repro_torch.launch.train.main``:
     batch 2 x 2048 tokens of ``SyntheticLM``, 8 AdamW steps, remat on,
     kernels on. Losses must be finite and fall, and the kernels must have
     launched exactly as the model's layers say (forward + remat recompute).
     On one batch, loss and grads with kernels on are checked against
     kernels off, and one train step is profiled (device busy share,
     flash attention's share, the plain attention backward's device time,
     top kernels);
  train_ft: qwen3-0.6b at full width and depth (0.596 B parameters, 4 x
     2048, AdamW, remat, kernels on, ``--deterministic``, checkpoints of
     8.35 GB keeping 3, under ``chiprun_out/train_ft``, which is checked for
     free space first and deleted at the end) through ``python -m
     repro_torch.launch.train`` in processes of its own: 12 steps straight,
     a checkpoint every 4, with ``--mesh 1,1`` through ``python -m
     torch.distributed.run --nproc-per-node 1`` (NCCL, world size 1; rank
     0 writes the checkpoints); a run without a mesh with a fault before
     step 5 and a failure after half of step 7's update, each retried once,
     killed with SIGKILL once ``latest_step`` reads 8; and a new process
     without a mesh that resumes it to step 12. The faulted run's step-8
     checkpoint and the resumed run's losses and step-12 checkpoint must
     equal the straight run's bit for bit (so the 1x1 mesh step is the
     unmeshed one), and flash attention must launch exactly 28 x 2 times a
     step (a retry runs no grads again). Prints the step time (the meshed
     straight run's beside the unmeshed resumed run's), tokens/s, peak
     memory, each checkpoint's bytes, snapshot seconds, async write seconds
     and how far the write overlapped training, the restore time, and one
     step under the profiler;
  train_moe: deepseek-v2-lite-16b at full width cut to 6 layers (1 dense
     MLA layer + 5 MLA + MoE; 3.43 B parameters, 55 GB with AdamW) through
     ``repro_torch.launch.train.main``: 6 steps of 2 x 2048, losses finite
     and falling, flash attention (1 + 2 x 5) times a step on the D = 192
     instance; then on one batch ``save_block_outputs`` against ``full``
     (loss and grads bit for bit under deterministic algorithms, a step's
     time and peak memory under each) and, on the first 3 layers in
     float32, kernels on against off with the MoE routes forced to the
     kernels-off ones (loss within 1e-4, grads within 1e-3 relative L2);
  distributed: one ``python -m torch.distributed.run --nproc-per-node 4``
     launch of gloo ranks sharing the card: (b) the expert-parallel MoE
     layer at qwen2-moe-a2.7b's width in float32, mesh (1, 4), 15 experts a
     rank, against the port's MoE (y 2e-4, aux 1e-5, grads 2e-3), with its
     all-to-all bytes and forward time; (c) the int8 compressed all-reduce
     over (b)'s grads, within the int8 bound, with its wire bytes against
     raw; (d) the training entry point with train_ft's arguments and
     ``--mesh 2,2`` (qwen3-0.6b at full width and depth, the partitioned
     step: FSDP per unit over "data", tensor and sequence parallelism over
     "model"), one step: its loss within 2e-2 of the straight run's,
     flash attention 28 x 2 at one rank's heads, every rank's parameters,
     grads and moments of its spec slice's shape, each rank's peak memory
     and the step time; then train_ft's straight-run step-4 checkpoint
     restored with ``shardings=`` onto the 2x2 mesh as cuda DTensors, each
     rank's slice of every leaf the file's bit for bit; (e) the entry point
     on ``--mesh 2,2`` for zamba2-2.7b cut to one unit (meshed only) and
     deepseek-v2-lite cut to 2 layers, and (f) for xlstm-1.3b cut to one
     unit (5 mLSTM + 1 sLSTM, each on 2 of its 4 heads a rank), 2 x 2048 ((f): 1024),
     one step each: loss and the grads' global norm within 2e-2 of the
     unmeshed step of the same cut on rank 0, the flash and SSD calls at
     every rank's local shapes ((e)), the partition's modes and the
     compute shapes of ``wq``, ``w_i``, ``up``, ``r``, ``wx`` and
     ``ffn_up`` ((f)), peak memory, step time and the bytes staged through the host; (g)
     partitioned serving on ``--mesh 2,2`` against the unmeshed steps:
     qwen3-0.6b (4 layers; bf16 and f32; the cache by head and by
     sequence), deepseek-v2-lite (3 layers, f32), and (h2) qwen3 under
     ``fsdp_only`` (2 rows: the prompt's sequence over "model", the
     cache's over both dims) and (h3) xlstm-1.3b (one unit, its states by
     head), in f32 within 1e-4 of the largest logit; (h1) one
     ``fsdp_only`` step each of qwen3-0.6b (4 layers) and deepseek-v2-lite
     (2 layers: MLA and the MoE), 2 x 2048, the sequence over "model",
     attention context parallel on the flash kernel with ``q_offset``,
     against the unmeshed step in bf16: loss, grad norm and the key
     leaves' grads' norm within 2e-2, a skipped key-gather reduce-scatter
     caught (qwen3);
  dryrun: the dry-run (``repro_torch.launch.dryrun``), shapes only, on the
     host: (a) one step of train_ft's straight run (qwen3-0.6b, 4 x 2048,
     AdamW, remat full) traced for a (1, 1) mesh on ``meta`` tensors with
     the kernels off, its traced peak within 20% of the peak that run
     measured (``max_memory_allocated``), beside the reference's analytic
     estimate and the H100 roofline terms (FLOPs at 989 TFLOP/s, bytes at
     3.35 TB/s) next to the measured step; the distributed phase's (d)
     step traced for rank 0 of a fake group of 4, its peak within 20% of
     rank 0's measured one; (b) ``python -m
     repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k`` on the
     16x16 and 2x16x16 fake meshes, writing under ``chiprun_out/dryrun``:
     FLOPs per device fall with the pod axis, the step all-gathers and
     reduce-scatters, and ``model_flops`` is ``formula_model_flops``;
  7. times: each kernel at its main-path shapes beside its bound, its plain
     version and, where one exists, the PyTorch call computing the same
     function (a yardstick only: the port never calls it): flash attention
     at decode (eager calls, as serving pays them, and device time by
     CUDA-graph replay; GB/s, n_split), at the MLA decode shape (b = 8,
     16/16 heads, d 192, dv 128, kv_len 512), at hubert's encode and
     llava's prefill shapes (the families path's launches), at the
     train_ft and train_moe shapes (qwen3 4 x 2048, 16/8 heads of 128;
     MLA 2 x 2048, 16/16 heads, d 192, dv 128), at the distributed
     phase's (d) one-rank shape (2 x 2048, 8/4 heads of 128) and at
     zamba2's
     training shape (TFLOP/s; the
     planned tile and the earlier fixed 128-key tile, interleaved), the SSD kernel, the matmul kernel at the
     four calibration shapes in both dtypes beside ``torch.matmul`` (bf16:
     the plain version without its last 64 of K must fail the tolerance);
     serving tokens/s, decode-step time,
     train step time, tokens/s and peak memory. Every time is stamped with
     the card and its power limit. Then Union's whole-model predictions
     beside what this run measured: each step's predicted latency by role
     beside the measured decode and train steps (prefill: predicted only),
     by device busy time under the profiler (the decode step profiled at
     the stream's KV length, 512) and by wall time, and the stream entries
     each fused kernel computes (chosen by role and einsum) beside its time.
The line before the last is the kernels' JSON record: the main paths'
records (each with its own path's launches), then the mappers phase's, one
per (row, tile), then the whole_model phase's, one per GEMM entry; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import hashlib
import json
import math
import os
import random
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))

import engine_ab  # noqa: E402  (the search engine's measurements)

from repro_torch import codesign, kernels  # noqa: E402
from repro_torch.configs import SHAPES, ShapeConfig, get_config, register  # noqa: E402
from repro_torch.core.architecture import H100_SXM, cloud_accelerator, h100_sm  # noqa: E402
from repro_torch.core.cost.analysis import (  # noqa: E402
    get_context,
    global_trace_count,
    graph_count,
    graph_pool_bytes,
    reset_trace_registry,
)
from repro_torch.core.opstream import (  # noqa: E402
    RECONCILE_BAND,
    aggregate_stream_costs,
    build_opstream,
    formula_model_flops,
    reconcile_model_flops,
    stream_sweep_tasks,
)
from repro_torch.core.optimizer import union_opt, union_opt_sweep  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    MAX_BK,
    flash_attention_cuda,
    live_keys,
    n_split,
    smem_bytes,
)
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    reset_launches as reset_fa_launches,
)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    BACKWARD_RANGE,
    FLASH_ATTENTION_H100,
    plan_blocks,
)
from repro_torch.kernels.flash_attention.flash_attention import compiled_dim  # noqa: E402
from repro_torch.kernels.flash_attention.ops import smem_bytes as fa_smem_formula  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.matmul import instance_for, matmul, plan_for, plan_tiles  # noqa: E402
from repro_torch.kernels.matmul.matmul import (  # noqa: E402
    TC_BK,
    TC_BM,
    TC_BN,
    encode_ns,
    fma_tiles,
    lib_smem_bytes,
    lib_tc_smem_bytes,
    matmul_cuda,
    reset_launches,
    tc_smem_bytes,
)
from repro_torch.kernels.matmul.matmul import smem_bytes as mm_smem_formula  # noqa: E402
from repro_torch.kernels.matmul.ops import MATMUL_BF16_H100, MATMUL_H100, planned_shape  # noqa: E402
from repro_torch.kernels.matmul.ref import (  # noqa: E402
    BF16_TOL,
    f32_product_ratio,
    matmul_ref,
    product_check,
)
from repro_torch.kernels.ssd_scan import ssd_chunked  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as ssd_launcher  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import SSD_SCAN_H100, plan_chunk  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import BACKWARD_RANGE as SSD_BACKWARD_RANGE  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import smem_formula as ssd_smem_formula  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_chunked_ref,
    ssd_intra_chunk_ref,
    ssd_recurrent_ref,
)
from repro_torch.kernels.ssd_scan.ssd_scan import shares_scores, ssd_intra_chunk_cuda  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch import quickstart  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.launch.serve import Request, WaveServer  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.models import decode_step, forward, init_cache, init_params, loss_fn  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models.model import Model, n_units  # noqa: E402
from repro_torch.models.moe import MoE  # noqa: E402
from repro_torch.models.ssm import _heads  # noqa: E402
from repro_torch.optim import adamw, cosine_schedule  # noqa: E402
from repro_torch.serve.mapping_service import MappingService  # noqa: E402
from repro_torch.serve.mapping_service import serve as serve_mapping  # noqa: E402

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak, H100 SXM
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores, H100 SXM
TF32_FLOP_PER_S = 495e12  # dense TF32 tensor-core peak, H100 SXM
TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}  # tests/test_kernels.py's bounds
# tests/test_kernels.py's bound for the SSD scan, rtol = atol = 1e-4 (all
# f32): L = exp(cum_i - cum_j) inherits the rounding of a cumsum that reaches
# ~-180 over a 256-step chunk (f32 ulp there ~1.5e-5), so the error scales
# with the output
SSD_TOL = 1e-4
# test_ssd_sweep's shapes, then zamba2-2.7b's training shape: b=2, 2048
# steps, 80 heads of 64, state 64, chunk 256. (b, l, nh, hp, n, chunk)
SSD_SHAPES = [(2, 128, 3, 16, 8, 32), (1, 64, 2, 8, 4, 64), (2, 96, 1, 32, 16, 16),
              (2, 2048, 80, 64, 64, 256)]
SSD_TRAIN = SSD_SHAPES[-1]
# distributed (e)'s: zamba2-2.7b under train --mesh 2,2, one rank's row and
# its 40 of 80 heads over the whole sequence, B/C shared (stride 0)
SSD_MESH = (1, 2048, 40, 64, 64, 256)
# head and state dims of 128, the kernel's widest (two 64-column hp slices)
SSD_WIDE = (2, 512, 8, 128, 128, 256)
FA_SWEEP = [  # (b, sq, skv, hq, hkv, d, causal): test_flash_attention_sweep's shapes
    (2, 128, 128, 4, 4, 64, True),
    (2, 128, 128, 8, 2, 64, True),
    (1, 256, 256, 4, 1, 32, True),
    (2, 64, 192, 4, 2, 64, False),
    (1, 100, 100, 2, 2, 16, True),
]
# zamba2-2.7b's attention at the training shape: b=2, 2048 tokens, 32/32 heads of 80
FA_TRAIN = dict(b=2, s=2048, hq=32, hkv=32, d=80)
TRAIN = dict(arch="zamba2-2.7b", batch=2, seq=2048, steps=8, warmup=2, lr=3e-4)
# Kernels on vs off on one zamba2 batch. In float32 weights the paths differ
# only in the order of f32 sums (kernel vs plain SSD and attention; both
# backwards recompute through the same plain formulas): loss within 1e-4 and
# grads within 1e-3 relative L2. In bf16, the main path, the two paths round
# the attention probabilities to bf16 at different points (the kernel before
# normalising, the chunked reference after), and 54 bf16 layers at random
# init amplify one-ulp differences (on the H100: grads 6.7% apart, loss
# 3e-4). So in bf16 each path is held against the float32
# kernels-off grads, and the kernels' error may be at most 1.5x the plain
# path's; the loss within 2e-2 (~10.9 at init).
TRAIN_F32_LOSS_TOL = 1e-4
TRAIN_F32_GRAD_REL_L2 = 1e-3
TRAIN_BF16_LOSS_TOL = 2e-2
TRAIN_BF16_ERR_RATIO = 1.5
# Serving decode shape of qwen3-0.6b: 8 slots, 16 q-heads over 8 KV heads of 128, cache 512.
DECODE = dict(b=8, hq=16, hkv=8, d=128, cache=512)
# deepseek-v2-lite-16b's MLA decode shape at the same slots and cache: 16/16
# heads, q and k of d = 192 (nope 128 + rope 64), v of dv = 128
MLA_DECODE = dict(b=8, hq=16, hkv=16, dn=128, dr=64, dv=128, cache=512)
ARCH, SLOTS, MAX_LEN, N_REQ, MAX_NEW = "qwen3-0.6b", 8, 512, 16, 32
# the served prompts' lengths (32-192 until the script's time limit cut
# them): every wave is prefilled token by token, by the server and again by
# each logit check, at 60-130 ms a host-bound step; the long-KV decode is
# timed and profiled apart (positions 200-219 and 507-511)
PROMPT_TOKENS = (32, 96)
# Kernels-on decode logits of the full model after a ~200-token prefill, vs
# the kernels-off decode and the full forward pass: the paths round P and the
# attention output to bf16 at different points, and 28 layers carry that;
# logits reach ~3, where a bf16 ulp is 2^-6.
MODEL_LOGIT_TOL = 0.25
# The bf16 matmul against its plain version: tests/test_kernels.py's bound
# (numpy's allclose rule), one bf16 rounding of the output. The f32 matmul
# (IEEE FMA, no TF32) is held to a float64 evaluation within its rounding
# estimate sqrt(K) u (|a| |b|) (f32_product_ratio): against another f32 sum
# order at rtol = atol = 2e-5 it passed or failed with the draw (6.1e-5 at
# 256x128x384 on one), where outputs cancel to near 0
MM_TOL = {torch.bfloat16: BF16_TOL}
MM_SWEEP = [(128, 128, 128), (256, 128, 384), (300, 200, 100), (64, 512, 256), (1, 257, 33)]
# (M, N, K, dtype) timed: the co-design loop's four calibration shapes
# (quickstart step 4's GEMM, a cube, qwen3-0.6b's gate/up projection at 4096
# tokens, zamba2-2.7b's FFN up projection at 2 x 2048 tokens), each in both
# dtypes: f32 on the FMA instance, bf16 on the wgmma instance
MM_TIMED = [(*shape, dtype) for dtype in (torch.float32, torch.bfloat16)
            for shape in quickstart.MATMUL_SHAPES]
MM_SPACES = {torch.float32: MATMUL_H100, torch.bfloat16: MATMUL_BF16_H100}
# every operand orientation the op and its backward give the wgmma instance:
# (A M-major, B N-major); the forward is (False, True)
MM_ORIENTS = [(False, True), (False, False), (True, True), (True, False)]
MM_HANG_S = 30.0  # a first launch not done by then has hung: fail with its tile
FA_FIXED_RULE = (64, 128)  # the earlier fixed rule's tile, timed beside the planned one
# head dims up to 192 through the op: the D = 192 instances of the three
# kernel families, and deepseek-v2-lite's MLA dims (d = 192 for q and k, dv =
# 128 for v; 16 heads) padded to them. (name, (b, sq, skv, hq, hkv, d, dv),
# causal, q_offset, kv_len)
FA_D192 = [
    ("MLA prefill d=192 dv=128", (2, 1024, 1024, 16, 16, 192, 128), True, 0, None),
    ("D=192 many rows, GQA 2:1", (2, 300, 300, 8, 4, 192, 192), True, 0, None),
    ("MLA decode d=192 dv=128", (8, 1, 512, 16, 16, 192, 128), False, 399, 400),
    ("MLA decode d=192 dv=128 full cache", (8, 1, 512, 16, 16, 192, 128), False, 511, 512),
    ("D=192 decode, GQA 2:1", (8, 1, 512, 16, 8, 192, 192), False, 511, 512),
]

# the families phase's attention: hubert-xlarge's non-causal encode (8 x
# 1499 frames, 16/16 heads of 80: the last 64-row tile holds 27 rows and the
# last KV tile is partial) and llava-next-34b's causal prefill (2880 + 128
# positions, 56/8 heads of 128: GQA group 7), then group 7 in the split
# decode (bq = 1). (name, (b, sq, skv, hq, hkv, d), causal, q_offset,
# kv_len, dtypes)
FA_FAMILIES = [
    ("hubert encode", (8, 1499, 1499, 16, 16, 80), False, 0, None, (torch.bfloat16,)),
    ("llava prefill", (1, 3008, 3008, 56, 8, 128), True, 0, None, (torch.bfloat16,)),
    ("group 7 decode kv_len=3009", (1, 1, 3072, 56, 8, 128), False, 3008, 3009,
     (torch.bfloat16, torch.float32)),
    ("group 7 decode kv_len=1", (2, 1, 512, 56, 8, 128), False, 0, 1,
     (torch.bfloat16, torch.float32)),
]
FAMILY_ERRS = {"hubert encode": "fa_hubert", "llava prefill": "fa_llava"}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    props = torch.cuda.get_device_properties(0)
    sms, optin = props.multi_processor_count, props.shared_memory_per_block_optin
    print(f"device properties: {sms} SMs, {optin} B shared memory opt-in per block; the planner's "
          f"h100_sm() assumes {H100_SXM['sms']} SMs and {H100_SXM['smem_optin_bytes']} B")
    check(sms >= H100_SXM["sms"] and optin >= H100_SXM["smem_optin_bytes"],
          f"the card has {sms} SMs and a {optin} B opt-in: less than h100_sm() plans for")
    print(smi)
    return smi


def _ptxas_report(log: str):
    """(kernel, registers, spill bytes, static smem bytes) per compiled
    instance, from nvcc -Xptxas -v."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            rows.append([name, None, 0, 0])
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            rows[-1][2] = int(m.group(1)) + int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            rows[-1][1] = int(m.group(1))
            if (m := re.search(r"(\d+) bytes smem", line)):
                rows[-1][3] = int(m.group(1))
    if shutil.which("c++filt") and rows:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows), text=True,
                               capture_output=True, check=True, timeout=60).stdout.split("\n")
        for r, n in zip(rows, names):
            r[0] = n.replace("(anonymous namespace)::", "")
    return rows


def _fa_instance(kernel: str):
    """(what the instance is and its dynamic shared memory, whether it runs
    bf16) from a demangled flash-attention kernel name; None for another
    kernel."""
    if (m := re.search(r"fa_mma_kernel<(\d+), (\d+)>", kernel)):
        d, bk = int(m.group(1)), int(m.group(2))
        return (f"bf16 tensor cores D={d} bk={bk}, "
                f"{smem_bytes(64, bk, d, torch.bfloat16)} B dynamic smem", True)
    if (m := re.search(r"fa_decode_kernel<(\w+), (\d+)>", kernel)):
        dtype = torch.bfloat16 if "bfloat16" in m.group(1) else torch.float32
        return (f"decode {str(dtype)[6:]} D={m.group(2)}, "
                f"{smem_bytes(1, MAX_BK, int(m.group(2)), dtype)} B dynamic smem at bk={MAX_BK}",
                dtype == torch.bfloat16)
    if (m := re.search(r"fa_fwd_kernel<float, (\d+), (\d+)>", kernel)):
        d, bq = int(m.group(1)), int(m.group(2))
        return (f"f32 FMA D={d}, {smem_bytes(bq, MAX_BK, d, torch.float32)} B dynamic smem "
                f"at bk={MAX_BK}", False)
    return None


SSD_PTXAS = {}  # (instance, largest n) -> (registers, spill bytes) of each SSD kernel


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, one process "
          f"per source)")
    spilled, n_wgmma = [], 0
    for name, log in logs.items():
        for kernel, regs, spill, smem in _ptxas_report(log):
            line = f"  {name}: {kernel}: {regs} registers, {spill} bytes spilled, {smem} B static smem"
            if name == "flash_attention" and (fa := _fa_instance(kernel)):
                what, is_bf16 = fa
                line += f" [{what}]"
                if is_bf16 and spill:
                    spilled.append(kernel)
            if name == "ssd_scan" and (m := re.search(r"ssd_chunk_kernel<(\w+), (\d+)>", kernel)):
                shared, nmax = m.group(1) == "true", int(m.group(2))
                SSD_PTXAS[("shared" if shared else "per-head", nmax)] = (regs, spill)
                cl = SSD_TRAIN[5]
                line += (f" [{'scores from the score kernel' if shared else 'scores built per CTA'}"
                         f", n up to {nmax}; {ssd_launcher.smem_bytes(cl, nmax, shared)} B dynamic "
                         f"smem at cl={cl}]")
            if name == "ssd_scan" and (m := re.search(r"ssd_scores_kernel<(\d+)>", kernel)):
                SSD_PTXAS[("scores", int(m.group(1)))] = (regs, spill)
                line += f" [the score block C B^T once per chunk, n up to {m.group(1)}]"
            if name == "matmul" and (m := re.search(r"matmul_fma_kernel<(\w+), (\d+), (\d+), (\d+)>",
                                                    kernel)):
                bm, bn, bk = (int(g) for g in m.groups()[1:])
                line += (f", {lib_smem_bytes(bm, bn, bk)} B dynamic smem [FMA instance, "
                         f"{m.group(1)} in]")
            if name == "matmul_wgmma":  # every instance, whatever its name demangles to
                n_wgmma += 1
                if spill:
                    spilled.append(kernel)
                if (m := re.search(r"matmul_wgmma_kernel<(\d+), (\d+), (\d+), (\d+)>", kernel)):
                    bm, bn, ta, tb = (int(g) for g in m.groups())
                    bk = MATMUL_BF16_H100.legalize((bm, bn, 1 << 20), (1 << 20,) * 3)[2]
                    line += (f" [bf16 wgmma instance, A {'M' if ta else 'K'}-major, B "
                             f"{'N' if tb else 'K'}-major; {lib_tc_smem_bytes(bm, bn, bk)} B "
                             f"dynamic smem at its deepest ring, {bk // TC_BK} stages]")
            print(line)
    want = sorted((inst, nmax) for inst in ("per-head", "scores", "shared") for nmax in (64, 128))
    check(sorted(SSD_PTXAS) == want, f"ssd_scan compiled {sorted(SSD_PTXAS)}, want {want}")
    n_tiles = len(TC_BM) * len(TC_BN) * len(MM_ORIENTS)
    check(n_wgmma == n_tiles, f"matmul_wgmma compiled {n_wgmma} instances, want {n_tiles}")
    check(not spilled, f"bf16 flash-attention or wgmma matmul instances spill registers: {spilled}")
    print(f"build: no bf16 flash-attention instance and none of the {n_wgmma} wgmma matmul "
          f"instances spills")


def phase_plan() -> dict:
    """Plan every tile the later phases launch, before any timed window,
    and hold each space's shared-memory formula (which its legalize binds)
    against the compiled kernel's."""
    codesign.reset_planner_stats()
    t0 = time.perf_counter()
    plans = {}
    d, cache = DECODE["d"], DECODE["cache"]
    S, dt = FA_TRAIN["s"], FA_TRAIN["d"]
    for label, space, shape in (
            ("flash_attention decode (qwen3-0.6b)", FLASH_ATTENTION_H100, (1, cache, d)),
            ("flash_attention train (zamba2-2.7b)", FLASH_ATTENTION_H100, (S, S, dt)),
            ("ssd_scan (zamba2-2.7b hp, n)", SSD_SCAN_H100, SSD_TRAIN[3:5]),
            *((f"matmul {str(dtype)[6:]} {M}x{N}x{K}", MM_SPACES[dtype], (M, N, K))
              for M, N, K, dtype in MM_TIMED)):
        if (space.name, tuple(shape)) in plans:
            continue
        t1 = time.perf_counter()
        p = codesign.plan(space, shape)
        plans[(space.name, tuple(shape))] = p
        print(f"plan {label} {tuple(shape)}: {space.name} tile {p.config} ({p.source}, "
              f"{time.perf_counter() - t1:.2f} s), predicted {p.cost.latency_s * 1e3:.4f} ms "
              f"before calibration")
    # the ops' cached entry points answer from these plans from now on
    check(plan_blocks(1, cache, d) == plans[(FLASH_ATTENTION_H100.name, (1, cache, d))].config
          and plan_blocks(S, S, dt) == plans[(FLASH_ATTENTION_H100.name, (S, S, dt))].config
          and plan_chunk(*SSD_TRAIN[3:5]) == plans[(SSD_SCAN_H100.name, SSD_TRAIN[3:5])].config[0]
          and plan_tiles(*quickstart.GEMM) == plans[(MATMUL_H100.name, quickstart.GEMM)].config
          and plan_tiles(*quickstart.GEMM, dtype=torch.bfloat16)
          == plans[(MATMUL_BF16_H100.name, quickstart.GEMM)].config,
          "the ops' planned tiles differ from codesign.plan's")
    for (name, shape), p in plans.items():
        space = codesign.get_space(name)
        if name == MATMUL_H100.name:
            got, want = lib_smem_bytes(*p.config), mm_smem_formula(*p.config)
        elif name == MATMUL_BF16_H100.name:  # the whole opt-in: one CTA an SM
            got, want = lib_tc_smem_bytes(*p.config), tc_smem_bytes(*p.config)
        elif name == FLASH_ATTENTION_H100.name:  # each dtype's instance; legalize binds the larger
            got, want = ([f(*p.config, shape[2], t) for t in (torch.float32, torch.bfloat16)]
                         for f in (smem_bytes, fa_smem_formula))
            check(got == want, f"{name} {p.config}: kernel smem {got} B != the space's formula "
                               f"{want} B (f32, bf16)")
            got = want = max(got)
        else:  # the larger instance, as legalize binds it
            got, want = (max(f(p.config[0], shape[1], s) for s in (False, True))
                         for f in (ssd_launcher.smem_bytes, ssd_smem_formula))
        check(got == want, f"{name} {p.config}: kernel smem {got} B != the space's formula {want} B")
        check(got <= space.smem_budget, f"{name} {p.config}: {got} B over the space's budget "
                                        f"{space.smem_budget} B")
    for shared in (False, True):  # both SSD instances, at chunk lengths on and off its tiles
        for n in (8, 64, 100, 128):
            for cl in (1, 100, 256, 1024):
                got, want = ssd_launcher.smem_bytes(cl, n, shared), ssd_smem_formula(cl, n, shared)
                check(got == want, f"ssd_scan cl={cl} n={n} shared={shared}: kernel smem {got} B "
                                   f"!= the formula's {want} B")
    print(f"plan: {len(plans)} tiles in {time.perf_counter() - t0:.2f} s on the host; shared "
          f"memory of each planned CTA (flash attention: in f32 and bf16) equals its space's "
          f"formula and fits the space's budget ({codesign.H100_SMEM_BUDGET} B; "
          f"{MATMUL_BF16_H100.name}: the {MATMUL_BF16_H100.smem_budget} B opt-in); planner "
          f"{codesign.planner_stats()}")
    return plans


def _qkv(gen, b, sq, skv, hq, hkv, d, dtype, dv=None):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)
    return randn(b, sq, hq, d), randn(b, skv, hkv, d), randn(b, skv, hkv, dv or d)


def _plain(q, k, v, **kw):
    return attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw).transpose(1, 2)


def _fa_row_ratio(got, want) -> float:
    """Worst |got - want| / limit over a bf16 attention output, the limit
    scaled to each output row: 2^-7 max_row |want| + 1e-3. One bf16 ulp of
    an element is at most 2^-7 of it, and the kernel and its plain version
    differ by the rounding of P and of the output to bf16, about one ulp;
    a lost KV tile moves a row by a share of its own size. At most 1 passes."""
    w = want.float()
    limit = w.abs().amax(dim=-1, keepdim=True) * 2.0 ** -7 + 1e-3
    return ((got.float() - w).abs() / limit).max().item()


def _fa_check_rows(name, got, want, q, k, v, bk, **kw):
    """Hold a bf16 many-key output to _fa_row_ratio, and show that the limit
    is sharp: the plain version with the last KV tile dropped must fail it."""
    ratio = _fa_row_ratio(got, want)
    skv = k.shape[1] if kw.get("kv_len") is None else kw["kv_len"]
    dropped = _plain(q, k, v, **{**kw, "kv_len": skv - (skv % bk or bk)})
    planted = _fa_row_ratio(dropped, want)
    check(math.isfinite(ratio) and ratio <= 1.0,
          f"flash_attention {name}: |err| / (2^-7 max_row |want| + 1e-3) = {ratio:.3f} > 1")
    check(planted > 1.0, f"flash_attention {name}: the row-scaled limit passes the plain version "
                         f"with its last KV tile dropped ({planted:.3f})")
    return ratio, planted


def phase_kernels() -> dict:
    """Each kernel vs its plain version on the card; returns the max abs
    error at each main-path shape: flash attention at the serving decode
    shape and at the training shape, the SSD kernel at the training shape."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b, hq, hkv, d, cache = DECODE.values()
    bk = plan_blocks(1, cache, d)[1]
    # the split decode (a CTA per batch x kv-head x split over both q-heads
    # of the kv-head) in both dtypes, at the kv_len edges of its planned tile
    cases = [(f"decode kv_len={n}", (b, 1, cache, hq, hkv, d), False, max(n - 1, 0), n, dtype)
             for dtype in (torch.bfloat16, torch.float32)
             for n in (0, 1, 37, bk - 1, bk, 300, cache)]
    cases.append(("causal prefill", (2, 1024, 1024, 16, 8, 128), True, 0, None, torch.bfloat16))
    t = FA_TRAIN
    cases.append(("train (zamba2)", (t["b"], t["s"], t["s"], t["hq"], t["hkv"], t["d"]), True, 0,
                  None, torch.bfloat16))
    # many rows: the f32 FMA instance and the bf16 tensor-core instance
    cases += [(f"sweep {shape}", shape[:6], shape[6], 0, None, dtype)
              for dtype in (torch.float32, torch.bfloat16) for shape in FA_SWEEP]
    cases += [(f"sweep D=80 {shape[:5] + (80,)}", shape[:5] + (80,), shape[6], 0, None, dtype)
              for dtype in (torch.float32, torch.bfloat16) for shape in FA_SWEEP]
    # head dims up to 192 (MLA's d = 192, dv = 128 padded to the D = 192 instances)
    cases += [(name, shape, causal, q_offset, kv_len, dtype)
              for dtype in (torch.bfloat16, torch.float32)
              for name, shape, causal, q_offset, kv_len in FA_D192]
    # the families phase's shapes: hubert's ragged non-causal encode, llava's
    # group-7 prefill, and group 7 in the split decode
    cases += [(name, shape, causal, q_offset, kv_len, dtype)
              for name, shape, causal, q_offset, kv_len, dtypes in FA_FAMILIES for dtype in dtypes]
    # the train_ft and train_moe phases' shapes (qwen3 at 4 x 2048; MLA at 2 x 2048)
    cases += [(name, shape, True, 0, None, torch.bfloat16) for name, shape, _ in FA_TRAIN_NEW]
    # (h)'s context-parallel shapes: a shard's queries against every key, q_offset its start
    cases += [(name, shape, True, start, None, dtype) for name, shape, start, _ in FA_CONTEXT
              for dtype in (torch.bfloat16, torch.float32)]
    # bf16 with many keys: also held to the row-scaled limit, whose teeth are shown
    rows_checked = ({"causal prefill", "train (zamba2)"} | {c[0] for c in FA_D192 if c[4] is None}
                    | {c[0] for c in FA_FAMILIES if c[4] is None} | {c[0] for c in FA_TRAIN_NEW}
                    # a shard whose queries reach the last key (the first shard's causal
                    # rows never read the tail that the planted fault drops)
                    | {c[0] for c in FA_CONTEXT if c[2] + c[1][1] == c[1][2]})
    errs = {"fa_decode": 0.0}
    for name, shape, causal, q_offset, kv_len, dtype in cases:
        b_, sq, skv, _, hkv_, d_ = shape[:6]
        dv = shape[6] if len(shape) > 6 else d_
        D = compiled_dim(d_, dv)
        q, k, v = _qkv(gen, *shape[:6], dtype, dv)
        kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
        before = flash_attention_cuda.launches
        got = flash_attention(q, k, v, **kw)
        want = _plain(q, k, v, scale=1.0 / math.sqrt(d_), **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(flash_attention_cuda.launches == before + 1 and got.shape == want.shape
              and math.isfinite(err) and err <= TOL[dtype],
              f"flash_attention {name} {dtype}: max abs err {err} > {TOL[dtype]}")
        line = f"kernel flash_attention {name} {str(dtype)[6:]}: max abs err {err:.3g} (tol {TOL[dtype]})"
        if (d_, dv) != (D, D):
            line += f"; the D={D} instance, q/k/v zero-padded to it"
        bk_case = plan_blocks(sq, skv, D)[1]
        if name in rows_checked and dtype == torch.bfloat16:
            ratio, planted = _fa_check_rows(name, got, want, q, k, v, bk_case,
                                            scale=1.0 / math.sqrt(d_), **kw)
            line += (f"; worst |err| / (2^-7 max_row |want| + 1e-3) {ratio:.3f} (limit 1; the "
                     f"plain version without its last KV tile: {planted:.3f})")
        if kv_len is not None:
            k[:, kv_len:] = 99.0
            v[:, kv_len:] = 99.0
            check(torch.equal(flash_attention(q, k, v, **kw), got),
                  f"flash_attention {name}: slots past kv_len changed the output")
            if name.startswith("decode") and dtype == torch.bfloat16:
                errs["fa_decode"] = max(errs["fa_decode"], err)
            if name.startswith("MLA decode") and dtype == torch.bfloat16:
                errs["fa_mla_decode"] = max(errs.get("fa_mla_decode", 0.0), err)
            parts = n_split(b_, hkv_, live_keys(1, kv_len, q_offset, causal), bk_case)
            line += f"; n_split {parts}; slots past kv_len unread"
        if name.startswith("train"):
            errs["fa_train"] = err
        if name in FAMILY_ERRS and dtype == torch.bfloat16:
            errs[FAMILY_ERRS[name]] = err
        if name in {c[0] for c in FA_TRAIN_NEW} or (
                name in {c[0] for c in FA_CONTEXT} and dtype == torch.bfloat16):
            errs[name] = err
        print(line)

    # the decode instance's log-sum-exp at distributed (g)'s local shapes,
    # at the planned tile and at bk = 32 (the keys split where more than 32
    # are live), with an empty shard
    splits = set()
    for name, shape, kv_lens in G_LSE:
        b_, _, skv, hq_, hkv_, d_ = shape[:6]
        dv = shape[6] if len(shape) > 6 else d_
        D, worst = compiled_dim(d_, dv), {}
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _qkv(gen, *shape[:6], dtype, dv)
            for kv_len in kv_lens:
                for blocks in (None, (1, 32)):
                    kw = dict(causal=False, q_offset=0, kv_len=kv_len, sm_scale=1.0 / math.sqrt(d_))
                    before = flash_attention_cuda.launches
                    got, lse = flash_attention(q, k, v, blocks=blocks, return_lse=True, **kw)
                    want, want_lse = fa_ops._plain(q, k, v, False, kw["sm_scale"], 0, kv_len, True)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    ok = flash_attention_cuda.launches == before + 1 and err <= TOL[dtype]
                    if kv_len == 0:
                        lse_err = 0.0
                        ok &= bool(torch.all(lse == -torch.inf)) and not torch.count_nonzero(got)
                    else:
                        lse_err = (lse - want_lse).abs().max().item()
                        ok &= math.isfinite(lse_err) and lse_err <= G_LSE_TOL
                    ok &= not (torch.isnan(got).any() or torch.isnan(lse).any())
                    bk = (blocks or plan_blocks(1, skv, D))[1]
                    parts = n_split(b_, hkv_, kv_len, bk)
                    splits.add(parts > 1)
                    check(ok, f"flash_attention {name} {dtype} kv_len={kv_len} bk={bk}: out err "
                              f"{err}, lse err {lse_err} (tol {TOL[dtype]}, {G_LSE_TOL}), "
                              f"-inf and zeros where empty")
                    worst[dtype] = max(worst.get(dtype, 0.0), err)
                    print(f"kernel flash_attention {name} {shape} kv_len={kv_len} "
                          f"{str(dtype)[6:]} with its log-sum-exp, bk {bk}, n_split {parts}: out "
                          f"max abs err {err:.3g} (tol {TOL[dtype]}), lse max abs err "
                          f"{lse_err:.3g} (tol {G_LSE_TOL})"
                          + ("; no live key: zeros and -inf" if kv_len == 0 else ""))
        errs[name] = worst
    check(splits == {True, False}, f"the log-sum-exp checks: splits seen {splits}")

    # the autograd wrapper: kernel forward, backward by recompute through the plain version
    q, k, v = (t_.requires_grad_() for t_ in _qkv(gen, 2, 64, 64, 4, 2, 80, torch.float32))
    g = torch.randn((2, 64, 4, 80), generator=gen, device="cuda")
    got = torch.autograd.grad(flash_attention(q, k, v, causal=True), (q, k, v), g)
    want = torch.autograd.grad(_plain(q, k, v, causal=True, scale=1.0 / math.sqrt(80)), (q, k, v), g)
    err = max((a - w).abs().max().item() for a, w in zip(got, want))
    check(math.isfinite(err) and err <= TOL[torch.float32],
          f"flash_attention grads: max abs err {err} > {TOL[torch.float32]}")
    print(f"kernel flash_attention grads (2, 64, 64, 4, 2, 80) float32: max abs err {err:.3g} "
          f"(tol {TOL[torch.float32]})")

    for shape in SSD_SHAPES + [SSD_WIDE, SSD_MESH]:
        for shared in (False, True):
            x, dA, B, C = _ssd_inputs(gen, *shape[:5], shared)
            got = ssd_intra_chunk_cuda(x, dA, B, C, shape[5])
            want = ssd_intra_chunk_ref(x, dA, B, C, shape[5])
            torch.cuda.synchronize()
            err, ok = _allclose(got, want, SSD_TOL)
            if shape == SSD_MESH and shared:
                errs["ssd_mesh"] = err
            if shape == SSD_TRAIN:
                errs["ssd_train"] = max(errs.get("ssd_train", 0.0), err)
                # both f32 versions against the exact answer: how much of the
                # difference between them is each one's rounding
                exact = ssd_intra_chunk_ref(x, dA, B, C, shape[5], dtype=torch.float64)
                print(f"kernel ssd_scan {shape} shared={shared} against a float64 evaluation: "
                      f"kernel max abs err {_allclose(got, exact, SSD_TOL)[0]:.3g} (worst "
                      f"|d| / (tol + tol |exact|) {_allclose_ratio(got, exact, SSD_TOL):.3f}), "
                      f"plain f32 version {_allclose(want, exact, SSD_TOL)[0]:.3g} "
                      f"({_allclose_ratio(want, exact, SSD_TOL):.3f})")
                del exact
            check(ok, f"ssd_scan {shape} shared={shared}: max abs err {err}, not within "
                      f"rtol = atol = {SSD_TOL}")
            bc = "B/C expanded over heads, stride 0" if shared else "B/C materialised"
            print(f"kernel ssd_scan {shape} float32, {bc}: max abs err {err:.3g}, max |out| "
                  f"{max(w.abs().max().item() for w in want):.3g} (rtol = atol = {SSD_TOL})")
    x, dA, B, C = _ssd_inputs(gen, 2, 128, 3, 16, 8, False)
    err, ok = _allclose(ssd_chunked(x, dA, B, C, chunk=32), ssd_recurrent_ref(x, dA, B, C), SSD_TOL)
    check(ok, f"ssd_chunked vs recurrence: max abs err {err}, not within {SSD_TOL}")
    print(f"kernel ssd_chunked (2, 128, 3, 16, 8, 32) vs the token-by-token recurrence: "
          f"max abs err {err:.3g} (rtol = atol = {SSD_TOL})")
    _check_matmul(gen)
    return errs


def _mm_inputs(gen, M, N, K, dtype):
    return (torch.randn((M, K), generator=gen, device="cuda").to(dtype),
            torch.randn((K, N), generator=gen, device="cuda").to(dtype))


def _mm_orient(x, y, a_mn, b_mn):
    """The same matrices laid out M-major (A) or K-major (B) where asked:
    the layouts of x^T and y^T that the backward hands the kernel."""
    return (x.t().contiguous().t() if a_mn else x), (y if b_mn else y.t().contiguous().t())


def _tf32(t):
    """t with its mantissa cut to TF32's 10 bits."""
    return (t.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _check_mm(label, got, a, b, out_dtype=None):
    """Hold got = a b to its plain version (``product_check``: f32 operands
    to a float64 evaluation within sqrt(K) u |a||b|, bf16 ones to
    matmul_ref within MM_TOL). Returns the max abs error."""
    torch.cuda.synchronize()
    err, ratio, rule = product_check(got, a, b, out_dtype)
    check(math.isfinite(ratio) and ratio <= 1.0,
          f"matmul {label}: max abs err {err}, worst |err| / limit {ratio:.3f}, not within {rule}")
    return err


def _sync_within(label: str) -> None:
    """Wait for the card under a host-side time limit: a launch that has not
    finished by then has hung (a wrong mbarrier parity, say); report its
    label and end the process, whose exit tears the context down. (The
    kernel itself traps after 10 s in any wait.)"""
    done = torch.cuda.Event()
    done.record()
    t0 = time.monotonic()
    while True:
        try:
            if done.query():
                return
        except Exception as e:  # noqa: BLE001 - the CUDA error of a faulted launch
            raise RuntimeError(f"{label}: the launch faulted: {e}") from e
        if time.monotonic() - t0 > MM_HANG_S:
            print(f"chip_smoke: {label} did not finish within {MM_HANG_S} s: hung", flush=True)
            os._exit(3)
        time.sleep(1e-3)


def _check_matmul(gen) -> None:
    """Both matmul instances against their plain version. First every wgmma
    tile and orientation at a tiny shape, each under a host-side time limit;
    then test_matmul_sweep's shapes with the planned tile, each on the
    instance the rule routes it to; every wgmma tile in every operand
    orientation with f32 and bf16 outputs at a ragged TMA-legal shape, with
    the shallowest and deepest ring; every compiled FMA tile and K slice
    with aligned, unaligned and transposed operands in both dtypes; leading
    dims; the autograd grads in f32 and bf16, dx and dy on the kernel."""
    for bm in TC_BM:
        for bn in TC_BN:
            for a_mn, b_mn in MM_ORIENTS:
                x, y = _mm_orient(*_mm_inputs(gen, 64, 64, 64, torch.bfloat16), a_mn, b_mn)
                got = matmul_cuda(x, y, bm=bm, bn=bn, bk=TC_BK, out_dtype=torch.float32)
                label = f"wgmma tile ({bm}, {bn}, {TC_BK}) A M-major {a_mn} B N-major {b_mn}"
                _sync_within(f"matmul {label} at 64x64x64")
                _check_mm(label, got, x, y, torch.float32)
    print(f"kernel matmul wgmma: every tile {TC_BM} x {TC_BN} in all four operand orientations "
          f"finished at 64x64x64 within {MM_HANG_S} s and matches")
    for M, N, K in MM_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            x, y = _mm_inputs(gen, M, N, K, dtype)
            inst, tiles = instance_for(x, y), plan_for(x, y)
            before = dict(matmul_cuda.launches_by_instance)
            got = matmul(x, y)
            err = _check_mm(f"{M}x{N}x{K}", got, x, y)
            check(matmul_cuda.launches_by_instance[inst] == before[inst] + 1,
                  f"matmul {M}x{N}x{K} {dtype} did not launch on the {inst} instance")
            if dtype == torch.float32:
                ratio, planted = (f32_product_ratio(got, x, y),
                                  f32_product_ratio(matmul_ref(_tf32(x), _tf32(y)), x, y))
                check(planted > 1.0, f"matmul {M}x{N}x{K}: the rounding limit passes a product "
                                     f"of TF32-rounded operands ({planted:.3f})")
                rule = (f"vs float64; worst |err| / (sqrt(K) u |a||b|) {ratio:.3f} (limit 1; "
                        f"TF32-rounded operands: {planted:.1f})")
            else:
                rule = f"rtol = atol = {MM_TOL[dtype]}"
            print(f"kernel matmul {M}x{N}x{K} {str(dtype)[6:]} on {inst}, planned tile {tiles}: max "
                  f"abs err {err:.3g} ({rule})")
    worst = 0.0
    for bm in TC_BM:
        for bn in TC_BN:
            deepest = MATMUL_BF16_H100.legalize((bm, bn, 1 << 20), (1 << 20,) * 3)[2]
            for a_mn, b_mn in MM_ORIENTS:
                x, y = _mm_orient(*_mm_inputs(gen, 304, 200, 360, torch.bfloat16), a_mn, b_mn)
                check(instance_for(x, y) == "wgmma", f"304x200x360 {x.stride()} {y.stride()}: not "
                                                     f"routed to wgmma")
                for out in (torch.float32, torch.bfloat16):
                    for bk in (TC_BK, 2 * TC_BK, deepest):
                        got = matmul_cuda(x, y, bm=bm, bn=bn, bk=bk, out_dtype=out)
                        worst = max(worst, _check_mm(
                            f"wgmma tile ({bm}, {bn}, {bk}) A M-major {a_mn} B N-major {b_mn} "
                            f"-> {out}", got, x, y, out))
    print(f"kernel matmul wgmma every tile {TC_BM} x {TC_BN}, rings of 1, 2 and the most stages, "
          f"all four operand orientations, f32 and bf16 out, at 304x200x360 (ragged M, N, K): "
          f"max abs err {worst:.3g}")
    worst = {}
    for bm, bn, bk in fma_tiles():
        for dtype in (torch.float32, torch.bfloat16):
            for M, N, K in ((300, 200, 100), (257, 130, 77)):
                for a_mn, b_mn in MM_ORIENTS:
                    x, y = _mm_orient(*_mm_inputs(gen, M, N, K, dtype), a_mn, b_mn)
                    check(instance_for(x, y) == "fma", f"{M}x{N}x{K} {dtype}: not routed to fma")
                    got = matmul_cuda(x, y, bm=bm, bn=bn, bk=bk, out_dtype=dtype)
                    err = _check_mm(f"fma tile ({bm}, {bn}, {bk}) {dtype} {M}x{N}x{K} A M-major "
                                    f"{a_mn} B N-major {b_mn}", got, x, y, dtype)
                    worst[dtype] = max(worst.get(dtype, 0.0), err)
    print(f"kernel matmul fma every compiled tile and K slice {fma_tiles()} at 300x200x100 (f32: "
          f"16-byte loads) and 257x130x77 (odd strides: element loads), all four orientations "
          f"(bf16 rows not 16-byte aligned, so routed to fma): max abs err f32 "
          f"{worst[torch.float32]:.3g}, bf16 {worst[torch.bfloat16]:.3g}")
    x = torch.randn((2, 3, 64, 32), generator=gen, device="cuda")
    y = torch.randn((32, 48), generator=gen, device="cuda")
    err = _check_mm("leading dims", matmul(x, y), x, y)
    print(f"kernel matmul (2, 3, 64, 32) x (32, 48) f32: max abs err {err:.3g} vs float64")
    for dtype in (torch.float32, torch.bfloat16):
        x, y = (a.requires_grad_() for a in _mm_inputs(gen, 128, 128, 64, dtype))
        g = torch.randn((128, 128), generator=gen, device="cuda").to(dtype)
        inst = instance_for(x, y)
        before = dict(matmul_cuda.launches_by_instance)
        got = torch.autograd.grad(matmul(x, y), (x, y), g)
        check(matmul_cuda.launches_by_instance[inst] == before[inst] + 3,
              f"the matmul grads ({dtype}) did not run on the {inst} instance")
        x, y = x.detach(), y.detach()
        err = max(_check_mm(f"grads {dtype} {name}", grad, a, b_)
                  for name, grad, a, b_ in (("dx", got[0], g, y.t()), ("dy", got[1], x.t(), g)))
        print(f"kernel matmul grads (128x64 . 64x128, {str(dtype)[6:]}; forward, dx = g . y^T and "
              f"dy = x^T . g on the {inst} instance): max abs err {err:.3g} ("
              + ("vs float64, within sqrt(K) u |a||b|" if dtype == torch.float32
                 else f"rtol = atol = {MM_TOL[dtype]}") + ")")


def _allclose(got, want, tol):
    """(max abs error, whether every element is within numpy's allclose
    rule |got - want| <= tol + tol * |want|) over paired tensors."""
    err, ok = 0.0, True
    for a, w in zip(got, want):
        d = (a.float() - w.float()).abs()
        err = max(err, d.max().item())
        ok = ok and a.shape == w.shape and bool((d <= tol + tol * w.float().abs()).all())
    return err, ok and math.isfinite(err)


def _allclose_ratio(got, want, tol):
    """The largest |got - want| / (tol + tol * |want|) over paired tensors:
    numpy's allclose rule holds where it is at most 1."""
    return max(((a.double() - w.double()).abs() / (tol + tol * w.double().abs())).max().item()
               for a, w in zip(got, want))


def _ssd_inputs(gen, b, l, nh, hp, n, shared):
    """dt-scaled x, dA = -softplus(N(0,1)), B and C; with ``shared`` one
    group's B/C expanded over the heads with stride 0, as the model passes
    them (``models.ssm._heads``)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = randn(b, l, nh, hp) * 0.5
    dA = -torch.nn.functional.softplus(randn(b, l, nh))
    if shared:
        return x, dA, _heads(randn(b, l, n) * 0.5, 1, nh), _heads(randn(b, l, n) * 0.5, 1, nh)
    return x, dA, randn(b, l, nh, n) * 0.5, randn(b, l, nh, n) * 0.5


def _wave_tokens(prompts):
    L = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), L), np.int64)
    for i, p in enumerate(prompts):
        toks[i, L - len(p):] = p
    return torch.from_numpy(toks).cuda()


def _first_decode_logits(cfg, model, prompts, first_tokens, kernels_on):
    """Prefill one wave token by token, then one decode step fed the served
    first tokens; returns that step's logits."""
    kernels.enable_kernels(kernels_on)
    toks = _wave_tokens(prompts)
    cache = init_cache(cfg, len(prompts), MAX_LEN, "cuda")
    for t in range(toks.shape[1]):
        _, cache = decode_step(cfg, model, cache, toks[:, t:t + 1], t)
    logits, _ = decode_step(cfg, model, cache, first_tokens[:, None], toks.shape[1])
    return logits.float()


def _served(cfg, model, n_req, max_new) -> dict:
    """n_req seeded prompts of PROMPT_TOKENS tokens served through ``WaveServer``
    (SLOTS slots, MAX_LEN, kernels on; the flash-attention counts and the
    peak memory reset first), each request checked for max_new tokens in
    the vocab. Returns the prompts, waves, steps run, finished requests
    (by rid), seconds and peak bytes."""
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(PROMPT_TOKENS[0], PROMPT_TOKENS[1] + 1))).tolist()
               for _ in range(n_req)]
    waves = [prompts[i:i + SLOTS] for i in range(0, n_req, SLOTS)]
    kernels.enable_kernels(True)
    server = WaveServer(cfg, model, batch_slots=SLOTS, max_len=MAX_LEN)
    for rid, p in enumerate(prompts):
        server.submit(Request(rid, p, max_new))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_fa_launches()
    t0 = time.perf_counter()
    done = server.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(sorted(r.rid for r in done) == list(range(n_req)), f"{cfg.name}: not every request served")
    for r in done:
        check(len(r.out) == max_new and all(0 <= t < cfg.vocab for t in r.out),
              f"{cfg.name} request {r.rid}: {len(r.out)} tokens, want {max_new} in "
              f"[0, {cfg.vocab})")
    return {"prompts": prompts, "waves": waves,
            # each wave: one step per prefill token, then max_new - 1 decode steps
            "steps": sum(max(len(p) for p in w) + max_new - 1 for w in waves),
            "done": sorted(done, key=lambda r: r.rid), "dt": dt,
            "peak": torch.cuda.max_memory_allocated()}


def _decode_ms(cfg, model, toks, pos, n) -> dict:
    """The eager decode step's ms with the kernels on and off in turns (on,
    off, on, off): each turn 3 warm-up steps at ``pos``, then n timed from
    ``pos`` on a fresh cache. Returns {on: [ms of each turn]}."""
    step_ms = {}
    for on in (True, False, True, False):
        kernels.enable_kernels(on)
        cache = init_cache(cfg, SLOTS, MAX_LEN, "cuda")
        for _ in range(3):
            decode_step(cfg, model, cache, toks, pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            decode_step(cfg, model, cache, toks, pos + i)
        torch.cuda.synchronize()
        step_ms.setdefault(on, []).append((time.perf_counter() - t0) / n * 1e3)
        del cache
    kernels.enable_kernels(True)
    return step_ms


def phase_serve(stamp):
    cfg = get_config(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = init_params(cfg, gen, "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    run = _served(cfg, model, N_REQ, MAX_NEW)
    prompts, waves, steps, done, dt, peak = (run[k] for k in ("prompts", "waves", "steps", "done",
                                                               "dt", "peak"))
    launches = flash_attention_cuda.launches
    check(launches == cfg.n_layers * steps,
          f"flash_attention launches {launches} != n_layers {cfg.n_layers} x steps {steps}")
    new_tokens = sum(len(r.out) for r in done)
    print(f"serve {ARCH}: {n_params / 1e9:.3f} B params bf16, {N_REQ} requests, slots {SLOTS}, "
          f"max_len {MAX_LEN}, prompts {min(map(len, prompts))}-{max(map(len, prompts))} tokens, "
          f"{steps} steps, flash_attention launches {launches} = {cfg.n_layers} x {steps}")

    wave0 = done[:SLOTS]
    first = torch.tensor([r.out[0] for r in wave0], device="cuda")
    on = _first_decode_logits(cfg, model, waves[0], first, True)
    off = _first_decode_logits(cfg, model, waves[0], first, False)
    # the same tokens through the full forward pass, no cache, no kernels
    with torch.no_grad():
        full = forward(cfg, model, {"tokens": torch.cat([_wave_tokens(waves[0]), first[:, None]], 1)})
    full = full[0][:, -1].float()
    kernels.enable_kernels(True)
    check(bool(torch.isfinite(on).all()) and on.shape == (SLOTS, cfg.vocab),
          "kernels-on logits are not finite or have the wrong shape")
    for name, ref in (("kernels off (chunked attention, cache)", off),
                      ("full forward (chunked attention, no cache)", full)):
        diff = (on - ref).abs().max().item()
        agree = (on.argmax(-1) == ref.argmax(-1)).float().mean().item()
        print(f"model logits, first decode step, kernels on vs {name}: max abs diff {diff:.4g} "
              f"(tol {MODEL_LOGIT_TOL}), |logit| max {ref.abs().max().item():.3g}, "
              f"argmax agreement {agree:.3f}")
        check(diff <= MODEL_LOGIT_TOL, f"model logits vs {name}: {diff} > {MODEL_LOGIT_TOL}")

    toks = torch.tensor([[r.out[-1]] for r in wave0], device="cuda")
    step_ms = _decode_ms(cfg, model, toks, 200, 20)
    _profile_decode(stamp, cfg, model, toks, 200)
    # at the last positions too, where the whole_model phase's decode stream
    # (KV = MAX_LEN) sits
    busy = _profile_decode(stamp, cfg, model, toks, MAX_LEN - PROFILE_STEPS - 1)
    print(f"time [{stamp}] serve: {new_tokens} new tokens in {dt:.3f} s = {new_tokens / dt:.1f} "
          f"tok/s ({steps * SLOTS / dt:.1f} tok/s incl. prefill); peak memory "
          f"{peak / 2**30:.3f} GiB")
    print(f"time [{stamp}] decode step (b={SLOTS}, pos 200-219): kernels on "
          f"{min(step_ms[True]):.3f} ms, kernels off {min(step_ms[False]):.3f} ms")
    return launches, {"wall_ms": min(step_ms[True]), "device_ms": busy}


# serve_moe: the two MoE configs at full width and depth through WaveServer,
# at the serve phase's slots and max_len, one wave each (deepseek served two
# before: the script's time limit): (arch, requests, new tokens)
SERVE_MOE = [("deepseek-v2-lite-16b", SLOTS, MAX_NEW), ("qwen2-moe-a2.7b", SLOTS, 16)]
MOE_TIMED_STEPS = 10  # decode steps in each timed turn, kernels on and off in turns
MOE_TIMED_POS = 200  # the first timed step's position, as the serve phase times
# Kernels-on first-step logits against kernels off and the full forward,
# every path routed to the kernels-off decode's experts (_moe_logit_checks).
# Full depth in bf16: the kernels' rounding moved them by 0.10-0.13 (logits
# up to ~4.8; 27 and 24 layers), while a KV tile dropped moved them by
# 3.4-4.3 and one expert's output zeroed in every MoE layer by 0.30-0.58
# (this phase on an H100, PERF.md): 0.2 lies between. The first
# MOE_CUT_LAYERS layers in float32 weights and cache: test_arch_smoke.py's
# decode-vs-forward bound.
MOE_LOGIT_TOL = 0.2
MOE_CUT_LAYERS, MOE_CUT_TOL = 4, 2e-3
# the decode stream Union predicts beside the measured deepseek step
MOE_STREAM = ("deepseek-v2-lite-16b", ShapeConfig("h100_decode", MAX_LEN, SLOTS, "decode"))


@contextlib.contextmanager
def _moe_routes(model):
    """Records each MoE layer's expert indices (T, k), in call order."""
    routes = []

    def hook(m, args, out):
        routes.append(m.route(args[0].reshape(-1, args[0].shape[-1]))[1])

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, MoE)]
    try:
        yield routes
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def _moe_capacity(model, factor: float):
    """Every MoE layer's capacity factor set to ``factor`` inside the block."""
    moes = [m for m in model.modules() if isinstance(m, MoE)]
    saved = [m.cfg for m in moes]
    for m in moes:
        m.cfg = dataclasses.replace(m.cfg, capacity_factor=factor)
    try:
        yield
    finally:
        for m, c in zip(moes, saved):
            m.cfg = c


@contextlib.contextmanager
def _kv_tile_dropped(bk: int):
    """Every attention call of the model without its first ``bk`` cached
    keys: what a kernel that lost a KV tile would compute."""
    orig = model_layers.mha

    def dropped(q, k, v, *, causal, q_offset=0, kv_len=None, **kw):
        return orig(q, k[:, bk:], v[:, bk:], causal=causal, q_offset=max(q_offset - bk, 0),
                    kv_len=kv_len - bk, **kw)

    model_layers.mha = dropped
    try:
        yield
    finally:
        model_layers.mha = orig


@contextlib.contextmanager
def _expert_zeroed(moe, e: int):
    """Expert ``e`` of one MoE layer outputs zeros inside the block."""
    saved = moe.w_down[e].clone()
    with torch.no_grad():
        moe.w_down[e].zero_()
    try:
        yield
    finally:
        with torch.no_grad():
            moe.w_down[e].copy_(saved)


@contextlib.contextmanager
def _routes_forced(model, routes):
    """Each MoE call routes to the next entry of ``routes`` (its expert
    indices, (T, k), in call order), with gates renormalised from its own
    router probabilities at those experts; the expert indices it would
    have chosen are appended to the list yielded."""
    moes = [m for m in model.modules() if isinstance(m, MoE)]
    it, own = iter(routes), []

    def forced(orig):
        def route(xt):
            _, eidx, probs = orig(xt)
            own.append(eidx)
            want = next(it)
            g = torch.gather(probs, 1, want)
            return g / g.sum(dim=-1, keepdim=True), want, probs
        return route

    for m in moes:
        m.route = forced(m.route)
    try:
        yield own
    finally:
        for m in moes:
            del m.route


def _moe_decode_wave(cfg, model, prompts, first, kernels_on, routes=None):
    """Prefill one wave token by token, then the first decode step fed the
    served first tokens, with a cache of the model's dtype. Returns that
    step's logits, every MoE call's expert indices (prefill steps
    included; with ``routes`` forced to them, the ones it would have
    chosen), the cache and the step's position."""
    kernels.enable_kernels(kernels_on)
    toks = torch.cat([_wave_tokens(prompts), first[:, None]], 1)
    dtype = model.embed.dtype
    dtype = next(model.parameters()).dtype
    cache = [{k: t.to(dtype) if t.dtype == torch.bfloat16 else t for k, t in c.items()}
             for c in init_cache(cfg, len(prompts), MAX_LEN, "cuda")]
    with (_routes_forced(model, routes) if routes is not None else _moe_routes(model)) as chosen:
        for t in range(toks.shape[1]):
            logits, _ = decode_step(cfg, model, cache, toks[:, t:t + 1], t)
    return logits.float(), chosen, cache, toks.shape[1] - 1


def _planted_faults(cfg, model, cache, first, pos, routes_last):
    """The first decode step from ``cache`` (kernels off) with a fault
    planted: the first KV tile dropped in every attention layer, and the
    output of one expert (the last MoE layer's top-1 of token 0) zeroed in
    every MoE layer. Returns {fault: logits}."""
    kernels.enable_kernels(False)
    D = (compiled_dim(cfg.nope_head_dim + cfg.rope_head_dim, cfg.v_head_dim) if cfg.use_mla
         else compiled_dim(cfg.head_dim, cfg.head_dim))
    bk = plan_blocks(1, MAX_LEN, D)[1]
    e = int(routes_last[0, 0])

    def step():
        c = [{k: t.clone() for k, t in layer.items()} for layer in cache]
        return decode_step(cfg, model, c, first[:, None], pos)[0].float()

    out = {}
    with _kv_tile_dropped(bk):
        out[f"first KV tile ({bk} keys) dropped in every layer"] = step()
    with contextlib.ExitStack() as stack:
        for m in model.modules():
            if isinstance(m, MoE):
                stack.enter_context(_expert_zeroed(m, e))
        out[f"output of expert {e} zeroed in every MoE layer"] = step()
    return out


def _check_logits(cfg, label, got, ref, tol, faults):
    diff = (got - ref).abs().max().item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    print(f"serve_moe {cfg.name}: {label}: max abs diff {diff:.4g} (tol {tol}), |logit| max "
          f"{ref.abs().max().item():.3g}, argmax agreement {agree:.3f}")
    check(bool(torch.isfinite(got).all()) and diff <= tol, f"{cfg.name} {label}: {diff} > {tol}")
    for name, planted in faults.items():
        d = (planted - ref).abs().max().item()
        print(f"  teeth: the kernels-off step with the {name}: {d:.4g} from the reference "
              f"(must exceed {tol})")
        check(d > tol, f"{cfg.name} {label}: the tolerance {tol} passes the {name} ({d})")


def _cut_f32(cfg, named, n_layers):
    """The first ``n_layers`` of a model given by its ``named_parameters()``
    (its prefix first), with its embedding, frontend and head, as a float32
    model of its own on the card."""
    cut = dataclasses.replace(cfg, n_layers=min(n_layers, cfg.n_layers))
    small = Model(cut, generator=None, device="meta")
    names = {n for n, _ in small.named_parameters()}
    small.load_state_dict({n: p.detach().to("cuda", torch.float32) for n, p in named
                           if n in names}, strict=True, assign=True)
    return cut, small


def _flip_share(own, ref) -> torch.Tensor:
    """Per (call, token): whether a top-k expert set differs from ``ref``'s."""
    return (torch.stack(own).sort(-1).values != torch.stack(ref).sort(-1).values).any(-1)


def _moe_logit_checks(cfg, model, waves, wave0):
    """The first decode step's logits after a prefill of wave 0, kernels on
    against kernels off (the same cache path) and against the full forward
    pass (kernels off, capacity raised to E: nothing dropped, as decode
    drops nothing), at full depth in bf16 as served and on the first
    MOE_CUT_LAYERS layers in float32 (full width).

    Routing is discontinuous: a near-tie between the k-th and (k+1)-th
    expert flips with any rounding (bf16 router logits tie outright), and a
    flipped route moves that token's later layers and everything that
    attends to its cache. So the kernels-on decode and the forward route
    every MoE call of the wave, prefill included, to the kernels-off
    decode's experts (gates from their own router), and the share of
    (step, layer, token) top-k sets they would have chosen otherwise is
    printed. What is left is the paths' rounding. Each tolerance must fail
    the kernels-off step with its first KV tile dropped in every layer,
    and with one expert's output zeroed in every MoE layer. Returns the
    full-depth share of top-k sets the kernels move."""
    first = torch.tensor([r.out[0] for r in wave0], device="cuda")
    toks = torch.cat([_wave_tokens(waves[0]), first[:, None]], 1)
    S, k = toks.shape[1], cfg.top_k
    moved = None
    cut, small = _cut_f32(cfg, model.named_parameters(), MOE_CUT_LAYERS)
    for label, c, m, tol in (("full depth, bf16", cfg, model, MOE_LOGIT_TOL),
                             (f"first {cut.n_layers} layers, float32", cut, small, MOE_CUT_TOL)):
        n_moe = sum(isinstance(x, MoE) for x in m.modules())
        off, routes, cache, pos = _moe_decode_wave(c, m, waves[0], first, False)
        on, own_on, _, _ = _moe_decode_wave(c, m, waves[0], first, True, routes)
        # the decode's routes, per MoE layer, in the forward's (b, S) row order
        per_layer = torch.stack(routes).reshape(S, n_moe, SLOTS, k).permute(1, 2, 0, 3)
        fwd_routes = list(per_layer.reshape(n_moe, SLOTS * S, k))
        kernels.enable_kernels(False)
        with torch.no_grad(), _moe_capacity(m, float(cfg.n_routed_experts)), \
                _routes_forced(m, fwd_routes) as own_fwd:
            full = forward(c, m, {"tokens": toks})[0][:, -1].float()
        flips = _flip_share(own_on, routes)
        by_layer = flips.reshape(S, n_moe, SLOTS).float().mean(dim=(0, 2))
        fwd_flips = _flip_share(own_fwd, fwd_routes).float().mean().item()
        print(f"serve_moe {cfg.name} ({label}): of the wave's {flips.numel()} (step, MoE layer, "
              f"token) top-{k} sets, kernels on would route {flips.float().mean().item():.4f} "
              f"to another set than kernels off (by layer "
              f"{[round(x, 3) for x in by_layer.tolist()]}), the full forward {fwd_flips:.4f}; "
              f"both follow the kernels-off routes")
        if moved is None:
            moved = flips.float().mean().item()
        faults = _planted_faults(c, m, cache, first, pos, routes[-1])
        del cache
        for what, got, ref in (("kernels on vs off", on, off),
                               ("kernels on vs the full forward (capacity E)", on, full)):
            _check_logits(cfg, f"{label}, first decode step, {what}", got, ref, tol, faults)
    del small
    kernels.enable_kernels(True)
    return moved


def _serve_moe_model(stamp, arch, n_req, max_new) -> dict:
    cfg = get_config(arch)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(len(model.prefix) + len(model.blocks) == cfg.n_layers,
          f"{arch}: {len(model.prefix)} prefix + {len(model.blocks)} unit layers, "
          f"want {cfg.n_layers}")
    D = (compiled_dim(cfg.nope_head_dim + cfg.rope_head_dim, cfg.v_head_dim) if cfg.use_mla
         else compiled_dim(cfg.head_dim, cfg.head_dim))
    run = _served(cfg, model, n_req, max_new)
    prompts, waves, steps, done, dt, peak = (run[k] for k in ("prompts", "waves", "steps", "done",
                                                               "dt", "peak"))
    launches, by_dim = flash_attention_cuda.launches, dict(flash_attention_cuda.launches_by_dim)
    check(launches == cfg.n_layers * steps == by_dim[D],
          f"{arch}: flash_attention launches {launches} (by compiled D {by_dim}) != n_layers "
          f"{cfg.n_layers} x steps {steps}, all at D = {D}")
    new_tokens = sum(len(r.out) for r in done)
    attn = (f"MLA d={cfg.nope_head_dim + cfg.rope_head_dim} dv={cfg.v_head_dim}" if cfg.use_mla
            else f"GQA {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}")
    print(f"serve_moe {arch}: {n_params / 1e9:.3f} B params bf16 (random init {init_s:.1f} s), "
          f"{cfg.n_layers} layers ({cfg.first_k_dense} dense prefix), {cfg.n_routed_experts} "
          f"experts top-{cfg.top_k} + {cfg.n_shared_experts} shared, {attn}; {n_req} requests, "
          f"slots {SLOTS}, max_len {MAX_LEN}, prompts {min(map(len, prompts))}-"
          f"{max(map(len, prompts))} tokens, {steps} steps, flash_attention launches {launches} = "
          f"{cfg.n_layers} x {steps}, all on the D = {D} instance")

    wave0 = done[:SLOTS]
    flipped = _moe_logit_checks(cfg, model, waves, wave0)

    toks = torch.tensor([[r.out[-1]] for r in wave0], device="cuda")
    step_ms = _decode_ms(cfg, model, toks, MOE_TIMED_POS, MOE_TIMED_STEPS)
    busy = _profile_decode(stamp, cfg, model, toks, MAX_LEN - PROFILE_STEPS - 1)
    wall = min(step_ms[True])
    print(f"time [{stamp}] serve_moe {arch}: {new_tokens} new tokens in {dt:.3f} s = "
          f"{new_tokens / dt:.1f} tok/s ({steps * SLOTS / dt:.1f} tok/s incl. prefill); peak "
          f"memory {peak / 2**30:.3f} GiB (weights {n_params * 2 / 2**30:.3f} GiB)")
    print(f"time [{stamp}] serve_moe {arch} decode step (b={SLOTS}, pos {MOE_TIMED_POS}-"
          f"{MOE_TIMED_POS + MOE_TIMED_STEPS - 1}): kernels on {wall:.3f} ms, kernels off "
          f"{min(step_ms[False]):.3f} ms; device busy at KV {MAX_LEN - PROFILE_STEPS + 1}-"
          f"{MAX_LEN} (profiled) "
          + ("not measured" if busy is None else f"{busy:.3f} ms ({busy / wall:.1%} of the "
                                                  f"eager step)"))
    del run, done, model
    return {"launches": launches, "steps": steps, "wall_ms": wall, "device_ms": busy,
            "tok_s": new_tokens / dt, "peak_gib": peak / 2**30, "flipped": flipped}


def _union_step(model, shape) -> tuple:
    """Union's prediction of one step of ``model`` at ``shape`` on
    ``h100_sm()``: one ``union_opt_sweep`` of the stream's mappable entries
    (heuristic mapper, timeloop model, numpy engine), as the whole_model
    phase sweeps. Returns (predicted ms, a line describing it). A
    prediction, printed only."""
    arch = h100_sm()
    s = build_opstream(model, shape)
    r = reconcile_model_flops(s)
    lo, hi = RECONCILE_BAND
    check(lo <= r["ratio"] <= hi, f"{model} {shape.name}: stream / MODEL_FLOPS {r['ratio']} "
                                  f"outside {RECONCILE_BAND}")
    tasks, index = stream_sweep_tasks([s], arch)
    t0 = time.perf_counter()
    sweep = union_opt_sweep(tasks)
    sweep_s = time.perf_counter() - t0
    c = aggregate_stream_costs([s], index, sweep.solutions, arch)[0]
    pred = c.latency_s * 1e3
    roles = ", ".join(f"{k} {v['latency_s'] * 1e3:.4f}" for k, v in c.roles.items())
    return pred, (f"{getattr(model, 'name', model)} {shape.name} ({len(s)} unique entries, "
                  f"stream / MODEL_FLOPS "
                  f"{r['ratio']:.4f}; sweep of {len(tasks)} entries {sweep_s:.2f} s host) predicts "
                  f"{pred:.4f} ms a step (ms by role: {roles})")


def _union_moe_decode(stamp, measured) -> None:
    """Union's prediction of deepseek-v2-lite's decode step (8 slots x
    max_len 512) on ``h100_sm()``, by role, beside the measured step."""
    pred, line = _union_step(*MOE_STREAM)
    dev = ("device busy not measured (the profiler saw no kernel)" if measured["device_ms"] is None
           else f"device busy {measured['device_ms']:.3f} ms (profiled at KV "
                f"{MAX_LEN - PROFILE_STEPS + 1}-{MAX_LEN}), {measured['device_ms'] / pred:.2f}x "
                f"the prediction")
    print(f"serve_moe [{stamp}] Union: {line}; measured step: {dev}; wall "
          f"{measured['wall_ms']:.3f} ms (eager, positions {MOE_TIMED_POS}-"
          f"{MOE_TIMED_POS + MOE_TIMED_STEPS - 1}), "
          f"{measured['wall_ms'] / pred:.2f}x")


def phase_serve_moe(stamp) -> dict:
    """deepseek-v2-lite-16b (MLA on the D = 192 flash instance, a dense
    prefix layer, 26 MoE layers) and qwen2-moe-a2.7b (GQA, 24 MoE layers) at
    full width and depth, one after the other, each freed before the next;
    returns each model's measurements by arch."""
    t0 = time.perf_counter()
    out = {}
    for arch, n_req, max_new in SERVE_MOE:
        gc.collect()
        torch.cuda.empty_cache()
        out[arch] = _serve_moe_model(stamp, arch, n_req, max_new)
    gc.collect()
    torch.cuda.empty_cache()
    _union_moe_decode(stamp, out[MOE_STREAM[0]])
    print(f"time [{stamp}] serve_moe phase: {time.perf_counter() - t0:.1f} s")
    return out


# families: the three configs whose block kinds and frontends were ported
# last, at full width and depth, each freed before the next. xlstm-1.3b
# (mLSTM + sLSTM, no attention) serves one wave of the serve phase's load; the f32 check
# runs one unit (5 mLSTM + 1 sLSTM) cut from it at XLSTM_CUT_L = 512
# positions, two mLSTM chunks of 256 (the chunk carry), against
# test_arch_smoke.py's decode bound
XLSTM_ARCH = "xlstm-1.3b"
XLSTM_REQ = SLOTS  # one wave (the serve phase's load was two): the script's time limit
XLSTM_CUT_L, XLSTM_CUT_TOL = 512, 2e-3
# xlstm's first decode step after a prefill of wave 0 against the chunked
# forward at full depth. In bf16 the two forms of the recurrence round
# differently (q, k, v and the conv in bf16 feed exponential gates) and the
# difference grows ~2x a unit until the logits decorrelate: on the H100,
# 5.39 of |logit| 5.19 at 48 layers, argmax agreement 0, as far from the
# forward as a reset stabiliser (5.58). The reference grows the same way:
# full width, bf16, on the CPU, 0.242 of 3.6 at 6 layers and 0.524 of 3.25
# at 12 (the port 0.249 and 0.543). So bf16 is printed and float32 held:
# on the H100 0.00508 of |logit| 4.61 at 48 layers, against 5.36 with a
# reset stabiliser
XLSTM_BF16_GROWTH = ("the reference's own bf16 decode and forward drift apart the same way, "
                     "~2x a unit")
XLSTM_F32_TOL = 2e-2
XLSTM_STREAM = (XLSTM_ARCH, ShapeConfig("h100_decode", MAX_LEN, SLOTS, "decode"))
# hubert-xlarge: 8 clips of 30 s of 16 kHz audio, 1499 frames each after
# HuBERT's conv stack (stubbed: random frame embeddings of d_frontend 512)
HUBERT = dict(arch="hubert-xlarge", b=8, frames=1499)
# llava-next-34b: one anyres image (2880 patch embeddings) and a 128-token prompt
LLAVA = dict(arch="llava-next-34b", b=1, text=128)
LLAVA_CUT_LAYERS, LLAVA_CUT_TOL = 4, 2e-3
LLAVA_ACT_RESERVE = 12 * 2**30  # bytes the prefill and its kernels-off check need beside the weights
# kernels on vs off at full depth in bf16: the kernel and the plain version
# round P and the attention output to bf16 at other points. On the H100
# (PERF.md): 0.0732 (hubert, 48 layers) and 0.1017 (llava's text
# logits, 60 layers), against 0.1211 and 0.1406 with the last KV tile
# dropped in every layer of the plain version
FAMILY_TOL = {"hubert-xlarge": 0.1, "llava-next-34b": 0.12}
FAMILY_TIMED = 3  # timed forwards after the first


@contextlib.contextmanager
def _fa_launch_log():
    """Records (q shape, k shape, causal, bq) of every flash-attention
    kernel launch inside the block; the launch counts stay the kernel's."""
    calls, orig = [], fa_ops.flash_attention_cuda

    def logged(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw["causal"], kw["bq"]))
        return orig(q, k, v, **kw)

    fa_ops.flash_attention_cuda = logged
    try:
        yield calls
    finally:
        fa_ops.flash_attention_cuda = orig


@contextlib.contextmanager
def _attention_patched(q_chunk=None, causal=None, drop_tail=0):
    """Every attention call of the model with its arguments replaced: the
    plain version's row chunk ``q_chunk`` (which must divide the sequence;
    the model passes 1024), ``causal``, or the last ``drop_tail`` keys
    masked out through ``kv_len``, as a kernel that lost its last KV tile."""
    orig = model_layers.mha

    forced = causal

    def patched(q, k, v, *, causal: bool, q_offset=0, kv_len=None, **kw):
        if drop_tail:
            kv_len = (k.shape[1] if kv_len is None else kv_len) - drop_tail
        if q_chunk is not None:
            kw["q_chunk"] = q_chunk
        return orig(q, k, v, causal=causal if forced is None else forced, q_offset=q_offset,
                    kv_len=kv_len, **kw)

    model_layers.mha = patched
    try:
        yield
    finally:
        model_layers.mha = orig


def _max_diff(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _timed_forwards(cfg, model, batch, n=FAMILY_TIMED) -> list:
    """Seconds of each of n synchronised forwards, kernels on."""
    out = []
    with torch.no_grad():
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward(cfg, model, batch)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
    return out


def _xlstm_unit_f32(cfg, model) -> None:
    """Decode against the chunked forward on one unit cut from the model
    (5 mLSTM + 1 sLSTM at full width, with its embedding and head), float32
    weights and caches, over XLSTM_CUT_L positions: two mLSTM chunks. The
    tolerance must fail the decode with the first mLSTM layer's stabiliser
    m reset to 0 at the chunk boundary."""
    cut, small = _cut_f32(cfg, model.named_parameters(), len(cfg.block_pattern))
    L, half = XLSTM_CUT_L, XLSTM_CUT_L // 2
    toks = torch.from_numpy(np.random.default_rng(SEED + 1).integers(0, cfg.vocab, (2, L))).cuda()
    with torch.no_grad():
        full, _ = forward(cut, small, {"tokens": toks})
    cache = [{k: t.float() for k, t in c.items()} for c in init_cache(cut, 2, L, "cuda")]
    steps = [decode_step(cut, small, cache, toks[:, t:t + 1], t)[0] for t in range(half)]
    faulted = [{k: t.clone() for k, t in c.items()} for c in cache]
    faulted[0]["m"].zero_()
    steps += [decode_step(cut, small, cache, toks[:, t:t + 1], t)[0] for t in range(half, L)]
    bad = [decode_step(cut, small, faulted, toks[:, t:t + 1], t)[0] for t in range(half, L)]
    err, ok = _allclose([torch.stack(steps, 1)], [full], XLSTM_CUT_TOL)
    planted, planted_ok = _allclose([torch.stack(bad, 1)], [full[:, half:]], XLSTM_CUT_TOL)
    print(f"families {cfg.name}: one unit ({', '.join(cfg.block_pattern)}) cut at full width, "
          f"float32, {L} decode steps from the -1e30 caches vs the chunked forward (two mLSTM "
          f"chunks of {half}): max abs diff {err:.4g} (rtol = atol = {XLSTM_CUT_TOL}), |logit| "
          f"max {full.abs().max().item():.3g}; teeth: the first mLSTM layer's m reset to 0 at "
          f"position {half}: {planted:.4g}, " + ("outside" if not planted_ok else "INSIDE")
          + " the tolerance")
    check(ok, f"{cfg.name} one unit f32: decode vs forward {err} not within {XLSTM_CUT_TOL}")
    check(not planted_ok, f"{cfg.name} one unit f32: the tolerance passes a reset stabiliser")
    del small, cache, faulted


def _xlstm_first_step(cfg, model, prompts, first):
    """The first decode step after a prefill of one wave (token by token
    through the recurrent steps; the caches in the model's dtype where the
    served caches are bf16: the conv windows) and the chunked
    forward's last position over the same tokens; also the step with the
    first mLSTM layer's m reset to 0 in the prefilled cache. Returns
    (step, forward, faulted step) logits in f32."""
    toks = torch.cat([_wave_tokens(prompts), first[:, None]], 1)
    pos = toks.shape[1] - 1
    dtype = next(model.parameters()).dtype
    cache = [{k: t.to(dtype) if t.dtype == torch.bfloat16 else t for k, t in c.items()}
             for c in init_cache(cfg, len(prompts), MAX_LEN, "cuda")]
    for t in range(pos):
        decode_step(cfg, model, cache, toks[:, t:t + 1], t)
    faulted = [{k: t.clone() for k, t in c.items()} for c in cache]
    faulted[0]["m"].zero_()
    step = decode_step(cfg, model, cache, toks[:, pos:], pos)[0].float()
    bad = decode_step(cfg, model, faulted, toks[:, pos:], pos)[0].float()
    with torch.no_grad():
        full = forward(cfg, model, {"tokens": toks})[0][:, -1].float()
    return step, full, bad


def _xlstm_full_depth(cfg, model, prompts, first) -> None:
    """The first decode step after a prefill of one wave against the
    chunked forward at full depth. In bf16, as served, the two forms of
    the recurrence round differently and the difference grows with depth
    until they decorrelate (the reference's own do: XLSTM_BF16_GROWTH), so
    it is printed, not held; the full model cast to float32 is held to
    XLSTM_F32_TOL, which must fail the step with the first mLSTM layer's
    stabiliser m reset to 0 in the prefilled cache."""
    pos = max(map(len, prompts))
    step, full, bad = _xlstm_first_step(cfg, model, prompts, first)
    agree = (step.argmax(-1) == full.argmax(-1)).float().mean().item()
    print(f"families {cfg.name}: full depth bf16 (as served), the first decode step after a "
          f"{pos}-token prefill vs the chunked forward's last position: max abs diff "
          f"{_max_diff(step, full):.4g}, |logit| max {full.abs().max().item():.3g}, argmax "
          f"agreement {agree:.3f}; the m-reset step {_max_diff(bad, full):.4g} from the forward "
          f"(printed, not held: {XLSTM_BF16_GROWTH})")
    cut, f32 = _cut_f32(cfg, model.named_parameters(), cfg.n_layers)
    step, full, bad = _xlstm_first_step(cut, f32, prompts, first)
    diff, planted = _max_diff(step, full), _max_diff(bad, full)
    agree = (step.argmax(-1) == full.argmax(-1)).float().mean().item()
    print(f"families {cfg.name}: full depth float32 (the served weights cast), the same step: "
          f"max abs diff {diff:.4g} (tol {XLSTM_F32_TOL}), |logit| max "
          f"{full.abs().max().item():.3g}, argmax agreement {agree:.3f}; teeth: the first mLSTM "
          f"layer's m reset to 0 after the prefill: {planted:.4g} (must exceed {XLSTM_F32_TOL})")
    check(bool(torch.isfinite(step).all()) and diff <= XLSTM_F32_TOL,
          f"{cfg.name} f32 decode vs forward at full depth: {diff} > {XLSTM_F32_TOL}")
    check(planted > XLSTM_F32_TOL,
          f"{cfg.name} f32: the tolerance {XLSTM_F32_TOL} passes a reset stabiliser ({planted})")
    del f32


def _families_xlstm(stamp) -> dict:
    """xlstm-1.3b served through WaveServer (one wave of SLOTS requests), its
    decode checked against the chunked forward (one unit in f32, full depth
    in bf16), timed and profiled, beside its byte bound and Union's
    predicted step."""
    cfg = get_config(XLSTM_ARCH)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    run = _served(cfg, model, XLSTM_REQ, MAX_NEW)
    prompts, waves, steps, done, dt, peak = (run[k] for k in ("prompts", "waves", "steps", "done",
                                                               "dt", "peak"))
    check(flash_attention_cuda.launches == 0, f"{cfg.name} has no attention layer, yet flash "
                                              f"attention launched {flash_attention_cuda.launches}")
    new_tokens = sum(len(r.out) for r in done)
    dh = cfg.d_inner // cfg.n_heads
    print(f"families {cfg.name}: {n_params / 1e9:.3f} B params bf16 (random init {init_s:.1f} s), "
          f"{cfg.n_layers} layers ({cfg.n_layers // len(cfg.block_pattern)} units of "
          f"{'+'.join(cfg.block_pattern)}), d {cfg.d_model}, {cfg.n_heads} heads, d_inner "
          f"{cfg.d_inner} (mLSTM heads of {dh}, sLSTM heads of {cfg.d_model // cfg.n_heads}); "
          f"{XLSTM_REQ} requests, slots {SLOTS}, max_len {MAX_LEN}, prompts {min(map(len, prompts))}-"
          f"{max(map(len, prompts))} tokens, {steps} steps; no attention layer and no TPU kernel "
          f"on this path: flash attention launched 0 times")

    _xlstm_unit_f32(cfg, model)
    wave0 = done[:SLOTS]
    _xlstm_full_depth(cfg, model, waves[0], torch.tensor([r.out[0] for r in wave0], device="cuda"))

    toks = torch.tensor([[r.out[-1]] for r in wave0], device="cuda")
    step_ms = _decode_ms(cfg, model, toks, MOE_TIMED_POS, MOE_TIMED_STEPS)
    busy = _profile_decode(stamp, cfg, model, toks, MAX_LEN - PROFILE_STEPS - 1)
    wall = min(step_ms[True])
    state = init_cache(cfg, SLOTS, MAX_LEN, "meta")
    state_bytes = sum(t.numel() * t.element_size() for c in state for t in c.values())
    mlstm_bytes = sum(t.numel() * t.element_size() for c in state if "C" in c for t in c.values())
    bound = (2 * n_params + 2 * state_bytes) / HBM_BYTES_PER_S * 1e3
    print(f"time [{stamp}] families {cfg.name}: {new_tokens} new tokens in {dt:.3f} s = "
          f"{new_tokens / dt:.1f} tok/s ({steps * SLOTS / dt:.1f} tok/s incl. prefill); peak memory "
          f"{peak / 2**30:.3f} GiB (weights {n_params * 2 / 2**30:.3f} GiB)")
    print(f"time [{stamp}] families {cfg.name} decode step (b={SLOTS}, pos {MOE_TIMED_POS}-"
          f"{MOE_TIMED_POS + MOE_TIMED_STEPS - 1}): kernels on {wall:.3f} ms, kernels off "
          f"{min(step_ms[False]):.3f} ms (no kernel on this path); device busy (profiled) "
          + ("not measured" if busy is None else f"{busy:.3f} ms ({busy / wall:.1%} of the eager "
                                                  f"step)")
          + f"; byte bound {bound:.3f} ms (weights {n_params * 2 / 1e9:.2f} GB read once, the "
            f"recurrent state {state_bytes / 1e9:.2f} GB, of which mLSTM {mlstm_bytes / 1e9:.2f} "
            f"GB, read and written once, at 3.35 TB/s)")
    pred, line = _union_step(*XLSTM_STREAM)
    print(f"families [{stamp}] Union: {line}; measured step: device busy "
          + ("not measured" if busy is None else f"{busy:.3f} ms ({busy / pred:.2f}x)")
          + f", wall {wall:.3f} ms ({wall / pred:.2f}x)")
    del run, done, model
    return {"tok_s": new_tokens / dt, "wall_ms": wall, "device_ms": busy, "bound_ms": bound,
            "peak_gib": peak / 2**30, "union_ms": pred}


def _prefill_checks(cfg, label, model, batch, S, tol, rows, q_chunk) -> dict:
    """Kernels on vs off (the plain attention in chunks of ``q_chunk``
    rows) on the logits at ``rows`` of an S-position forward; the
    tolerance must fail the kernels-off forward with its last KV tile
    dropped (the partial one where S is ragged). Returns the kernels-on
    logits at ``rows`` and the two differences."""
    bk = plan_blocks(S, S, compiled_dim(cfg.head_dim, cfg.head_dim))[1]
    with torch.no_grad():
        kernels.enable_kernels(True)
        on = forward(cfg, model, batch)[0][:, rows].float()
        kernels.enable_kernels(False)
        with _attention_patched(q_chunk=q_chunk):
            off = forward(cfg, model, batch)[0][:, rows].float()
        with _attention_patched(q_chunk=q_chunk, drop_tail=S % bk or bk):
            dropped = forward(cfg, model, batch)[0][:, rows].float()
    kernels.enable_kernels(True)
    diff, planted = _max_diff(on, off), _max_diff(dropped, off)
    agree = (on.argmax(-1) == off.argmax(-1)).float().mean().item()
    print(f"families {cfg.name} ({label}): logits kernels on vs off (plain attention, {q_chunk}-row "
          f"chunks): max abs diff {diff:.4g} (tol {tol}), |logit| max {off.abs().max().item():.3g},"
          f" argmax agreement {agree:.3f}; teeth: kernels off with the last KV tile "
          f"({S % bk or bk} keys of {S}; bk {bk}) dropped: {planted:.4g} (must exceed {tol})")
    check(bool(torch.isfinite(on).all()) and diff <= tol,
          f"{cfg.name} kernels on vs off: {diff} > {tol}")
    check(planted > tol, f"{cfg.name}: the tolerance {tol} passes a dropped KV tile ({planted})")
    return {"on": on, "diff": diff, "planted": planted}


def _check_launches(cfg, calls, launches, want, b, S, causal) -> None:
    """``want`` launches, each many-row on the compiled D over (b, S) with
    the model's heads and mask, as ``_fa_launch_log`` recorded them."""
    D = compiled_dim(cfg.head_dim, cfg.head_dim)
    bq = plan_blocks(S, S, D)[0]
    shapes = set(calls)
    check(launches == want == flash_attention_cuda.launches_by_dim[D] == len(calls) and bq > 1
          and shapes == {((b, S, cfg.n_heads, D), (b, S, cfg.n_kv_heads, D), causal, bq)},
          f"{cfg.name}: flash attention launches {launches} (by D "
          f"{flash_attention_cuda.launches_by_dim}), want {want} many-row launches at D = {D}, "
          f"causal {causal}; launched {shapes}")


def _families_hubert(stamp) -> dict:
    """hubert-xlarge encodes 8 clips of 1499 frames (forward and loss), its
    attention non-causal on the flash kernel's D = 80 many-row instance;
    kernels on vs off, bidirectionality, frames/s and a profile."""
    cfg = get_config(HUBERT["arch"])
    b, S = HUBERT["b"], HUBERT["frames"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = init_params(cfg, gen, "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    frames = torch.randn((b, S, cfg.d_frontend), generator=gen, device="cuda").bfloat16()
    labels = torch.randint(0, cfg.vocab, (b, S), generator=gen, device="cuda")
    batch = {"frames": frames, "labels": labels}

    kernels.enable_kernels(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_fa_launches()
    with torch.no_grad(), _fa_launch_log() as calls:
        t0 = time.perf_counter()
        logits, _ = forward(cfg, model, batch)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        per_forward = flash_attention_cuda.launches
        loss = loss_fn(cfg, model, batch).item()
    launches = flash_attention_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    check(per_forward == cfg.n_layers, f"{cfg.name}: {per_forward} flash attention launches in a "
                                       f"forward, want {cfg.n_layers}")
    _check_launches(cfg, calls, launches, 2 * cfg.n_layers, b, S, False)
    check(math.isfinite(loss) and logits.shape == (b, S, cfg.vocab)
          and bool(torch.isfinite(logits).all()), f"{cfg.name}: loss {loss}, logits not finite")
    D = compiled_dim(cfg.head_dim, cfg.head_dim)
    print(f"families {cfg.name}: {n_params / 1e9:.3f} B params bf16, {cfg.n_layers} encoder "
          f"layers, d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}; "
          f"{b} clips x {S} frames (d_frontend {cfg.d_frontend}); flash attention launches "
          f"{launches} = {per_forward} a forward x (forward + loss), all non-causal on the D = {D} "
          f"many-row instance (bq {calls[0][3]}), S = {S} ({S % 64} rows in the last 64-row "
          f"tile); loss {loss:.4f} (ln {cfg.vocab} = {math.log(cfg.vocab):.4f})")

    checks = _prefill_checks(cfg, "full depth, bf16", model, batch, S, FAMILY_TOL[cfg.name],
                             slice(None), S)
    # bidirectional: another last frame moves the first position; under a
    # causal mask it could not (the same forward, mask forced causal)
    frames2 = frames.clone()
    frames2[:, -1] = torch.randn((b, cfg.d_frontend), generator=gen, device="cuda").bfloat16()
    with torch.no_grad():
        moved = _max_diff(forward(cfg, model, {"frames": frames2})[0][:, 0], checks["on"][:, 0])
        with _attention_patched(causal=True):
            causal_moved = _max_diff(forward(cfg, model, {"frames": frames2})[0][:, 0],
                                     forward(cfg, model, batch)[0][:, 0])
    print(f"families {cfg.name}: the last frame of each clip redrawn moves the first position's "
          f"logits by {moved:.4g} (kernels on); with the mask forced causal, by {causal_moved:.4g}")
    check(moved > 0 and causal_moved == 0, f"{cfg.name}: not bidirectional (first position "
                                           f"moved {moved}; forced causal {causal_moved})")

    times = _timed_forwards(cfg, model, batch)
    with torch.no_grad():
        busy = _profile(stamp, f"{cfg.name} forward (b={b}, {S} frames, kernels on)",
                        lambda: forward(cfg, model, batch), 1)
    best = min(times)
    print(f"time [{stamp}] families {cfg.name}: forward {best * 1e3:.3f} ms (best of "
          f"{len(times)}; first call {first_s * 1e3:.3f} ms) = {b * S / best:.1f} frames/s "
          f"({b * 30 / best:.1f} s of audio per second); device busy "
          + ("not measured" if busy is None else f"{busy:.3f} ms ({busy / best / 1e3:.1%})")
          + f"; peak memory {peak / 2**30:.3f} GiB")
    pred, line = _union_step(cfg.name, ShapeConfig("h100_encode", S, b, "prefill"))
    print(f"families [{stamp}] Union: {line}; measured forward {best * 1e3:.3f} ms "
          f"({best * 1e3 / pred:.3f}x)")
    del model, logits, checks
    return {"launches": launches, "frames_s": b * S / best, "forward_ms": best * 1e3,
            "device_ms": busy, "peak_gib": peak / 2**30, "loss": loss}


def _families_llava(stamp) -> dict:
    """llava-next-34b prefills one image (2880 patch embeddings) and a
    128-token prompt: flash attention causal at GQA group 7 (56/8 heads of
    128, many rows); time to the first token, kernels on vs off on the text
    logits at full depth in bf16 and on the first 4 layers in float32."""
    cfg = get_config(LLAVA["arch"])
    n_img, T = cfg.n_frontend_tokens, LLAVA["text"]
    S = n_img + T
    weights = 2 * sum(p.numel() for p in Model(cfg, generator=None, device="meta").parameters())
    free, total = torch.cuda.mem_get_info()
    cuts = []
    if weights + LLAVA_ACT_RESERVE > free:
        per_layer = (weights - 2 * cfg.vocab * cfg.d_model * 2) / cfg.n_layers
        n = int((free - LLAVA_ACT_RESERVE - 4 * cfg.vocab * cfg.d_model) // per_layer)
        print(f"families {cfg.name}: the card cannot hold the full depth: weights "
              f"{weights / 2**30:.3f} GiB + {LLAVA_ACT_RESERVE / 2**30:.0f} GiB for the prefill > "
              f"{free / 2**30:.3f} GiB free of {total / 2**30:.3f} GiB (allocated "
              f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB, reserved "
              f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB)")
        cuts.append(f"depth {cfg.n_layers} -> {n} layers (memory)")
        cfg = dataclasses.replace(cfg, n_layers=n)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    model = init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    patches = torch.randn((LLAVA["b"], n_img, cfg.d_frontend), generator=gen,
                          device="cuda").bfloat16()
    tokens = torch.randint(0, cfg.vocab, (LLAVA["b"], T), generator=gen, device="cuda")
    batch = {"tokens": tokens, "patch_embeds": patches}

    kernels.enable_kernels(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_fa_launches()
    with torch.no_grad(), _fa_launch_log() as calls:
        t1 = time.perf_counter()
        logits, _ = forward(cfg, model, batch)
        first_token = int(logits[0, -1].argmax())
        first_s = time.perf_counter() - t1
    launches = flash_attention_cuda.launches
    check(logits.shape == (LLAVA["b"], S, cfg.vocab) and 0 <= first_token < cfg.vocab,
          f"{cfg.name}: logits {tuple(logits.shape)}, first token {first_token}")
    del logits
    _check_launches(cfg, calls, launches, cfg.n_layers, LLAVA["b"], S, True)
    ttft = []
    with torch.no_grad():
        for _ in range(FAMILY_TIMED):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            tok = int(forward(cfg, model, batch)[0][0, -1].argmax())
            ttft.append(time.perf_counter() - t1)
            check(tok == first_token, f"{cfg.name}: first token {tok} != {first_token}")
    peak = torch.cuda.max_memory_allocated()
    D = compiled_dim(cfg.head_dim, cfg.head_dim)
    print(f"families {cfg.name}: {n_params / 1e9:.3f} B params bf16 (random init {init_s:.1f} s; "
          f"{n_params * 2 / 2**30:.3f} GiB), {cfg.n_layers} layers"
          + (f" (cut: {'; '.join(cuts)})" if cuts else " (full depth)")
          + f", d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim} (GQA "
            f"group {cfg.n_heads // cfg.n_kv_heads}); {n_img} patch embeddings (d "
            f"{cfg.d_frontend}) + {T} text tokens = {S} positions; flash attention launches "
            f"{launches} = {cfg.n_layers} layers, causal, many-row (bq {calls[0][3]}) on the "
            f"D = {D} instance")

    text = slice(n_img, S)
    checks = _prefill_checks(cfg, "bf16, text positions", model, batch, S,
                             FAMILY_TOL[LLAVA["arch"]], text, S // 2)
    with torch.no_grad():
        blank = forward(cfg, model, {**batch, "patch_embeds": torch.zeros_like(patches)})[0][:, text]
    moved = _max_diff(blank, checks["on"])
    print(f"families {cfg.name}: zeroing the patch embeddings moves the text logits by "
          f"{moved:.4g} (must exceed the tolerance {FAMILY_TOL[LLAVA['arch']]})")
    check(moved > FAMILY_TOL[LLAVA["arch"]], f"{cfg.name}: the image does not reach the text")
    del blank
    with torch.no_grad():
        busy = _profile(stamp, f"{cfg.name} prefill (b=1, {S} positions, kernels on)",
                        lambda: forward(cfg, model, batch), 1)
    best = min(ttft)
    print(f"time [{stamp}] families {cfg.name}: time to the first token (prefill of {S} positions "
          f"and the argmax of the last text logit, synchronised): {best * 1e3:.3f} ms (best of "
          f"{len(ttft)}, median {statistics.median(ttft) * 1e3:.3f}; first call "
          f"{first_s * 1e3:.3f} ms) = {S / best:.1f} prefill tokens/s; device busy "
          + ("not measured" if busy is None else f"{busy:.3f} ms ({busy / best / 1e3:.1%})")
          + f"; peak memory {peak / 2**30:.3f} GiB")
    pred, line = _union_step(cfg, ShapeConfig("h100_prefill", S, LLAVA["b"], "prefill"))
    print(f"families [{stamp}] Union: {line}; measured prefill {best * 1e3:.3f} ms "
          f"({best * 1e3 / pred:.4f}x)")

    # the first LLAVA_CUT_LAYERS layers in float32, cut after the bf16 model is freed
    small = Model(dataclasses.replace(cfg, n_layers=LLAVA_CUT_LAYERS), generator=None,
                  device="meta")
    names = {n for n, _ in small.named_parameters()}
    stash = {n: p.detach().cpu() for n, p in model.named_parameters() if n in names}
    del model, checks, small
    gc.collect()
    torch.cuda.empty_cache()
    cut, small = _cut_f32(cfg, stash.items(), LLAVA_CUT_LAYERS)
    del stash
    _prefill_checks(cut, f"first {cut.n_layers} layers, float32, text positions", small, batch,
                    S, LLAVA_CUT_TOL, text, S // 2)
    del small
    return {"launches": launches, "ttft_ms": best * 1e3, "prefill_tok_s": S / best,
            "device_ms": busy, "peak_gib": peak / 2**30, "cuts": cuts}


def phase_families(stamp) -> dict:
    """xlstm-1.3b served, hubert-xlarge encoded and llava-next-34b
    prefilled at full width, one after the other, each freed before the
    next; returns each one's measurements."""
    t0 = time.perf_counter()
    out = {}
    for name, run in (("xlstm", _families_xlstm), ("hubert", _families_hubert),
                      ("llava", _families_llava)):
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        out[name] = run(stamp)
        print(f"time [{stamp}] families {name}: {time.perf_counter() - t1:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"time [{stamp}] families phase: {time.perf_counter() - t0:.1f} s")
    return out


PROFILE_STEPS = 5  # decode steps under the profiler
PROFILE_TRIES = 3  # sessions of the bf16 calibration profile that may see no device kernel


def _profile_decode(stamp, cfg, model, toks, start, n=PROFILE_STEPS):
    """Where a decode step's time goes: torch.profiler over the n steps at
    positions start + 1 .. start + n (one step at ``start`` warms up).
    Returns the device busy ms a step."""
    cache = init_cache(cfg, SLOTS, MAX_LEN, "cuda")
    decode_step(cfg, model, cache, toks, start)
    pos = iter(range(start + 1, start + 1 + n))
    return _profile(stamp, f"decode step (b={SLOTS}, pos {start + 1}-{start + n}, kernels on, "
                           f"under the profiler)",
                    lambda: decode_step(cfg, model, cache, toks, next(pos)), n)


FA_KERNELS = ("fa_mma_kernel", "fa_fwd_kernel", "fa_decode_kernel", "fa_combine_kernel")


def _profile(stamp, label, fn, n):
    """torch.profiler over n calls of fn: wall time per call, device busy
    share, device kernels per call, the flash-attention kernels' share of
    the busy time, the device time of the plain attention backward (the
    kernels launched inside ops.BACKWARD_RANGE) and the top kernels by
    device time. Returns the device busy ms a call, None where the profiler
    saw no device kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    # a record_function range may also appear on the device timeline: it is no kernel
    ranges = {"attention": BACKWARD_RANGE, "SSD": SSD_BACKWARD_RANGE}
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.key not in ranges.values()]
    if not events:
        print(f"profile [{stamp}] {label}: the profiler saw no device kernels "
              f"(wall {wall:.3f} ms under the profiler)")
        return None
    busy = sum(e.self_device_time_total for e in events) / n / 1e3
    launches = sum(e.count for e in events) / n
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    print(f"profile [{stamp}] {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({busy / wall:.1%}; idle {1 - busy / wall:.1%}), {launches:.0f} device kernels per call")
    fa = [e for e in events if any(k in e.key for k in FA_KERNELS)]
    fa_ms = sum(e.self_device_time_total for e in fa) / n / 1e3
    print(f"  flash attention kernels: {fa_ms:.4f} ms/call ({fa_ms / busy:.2%} of device busy), "
          f"{sum(e.count for e in fa) / n:.0f} device launches per call")
    ssd = [e for e in events if "ssd_chunk_kernel" in e.key or "ssd_scores_kernel" in e.key]
    if ssd:
        ssd_ms = sum(e.self_device_time_total for e in ssd) / n / 1e3
        print(f"  SSD kernels (score and main): {ssd_ms:.4f} ms/call ({ssd_ms / busy:.2%} of "
              f"device busy), {sum(e.count for e in ssd) / n:.0f} device launches per call")
    for what, name in ranges.items():
        bwd = [e for e in prof.events() if e.name == name and e.device_type == DeviceType.CPU]
        if bwd:
            bwd_ms = sum(e.device_time_total for e in bwd) / n / 1e3
            print(f"  plain {what} backward ({name}, {len(bwd) / n:.0f} per call): "
                  f"{bwd_ms:.4f} ms/call of device time ({bwd_ms / busy:.2%} of device busy)")
    for e in top:
        print(f"  {e.self_device_time_total / n / 1e3:.4f} ms/call  x{e.count // n:<5d} "
              f"{e.key[:90]}")
    return busy


def _time_ms(fn, n=100, warmup=10) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _interleaved_ms(fns: dict, n: int) -> dict:
    """Time each callable in turns (a, b, c, c, b, a) on one card; the best
    of its two runs."""
    ms = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        ms[name].append(_time_ms(fns[name], n=n, warmup=max(2, n // 10)))
    return {name: min(v) for name, v in ms.items()}


def _graph_interleaved_ms(fns: dict, n: int, replays: int = 10) -> dict:
    """Device time per call with the host's dispatch out of the way: each
    callable's n calls are captured once in a CUDA graph (after a warm-up
    outside it), the graphs are replayed in turns (a, b, c, c, b, a) and
    timed with CUDA events; the best of each one's two turns."""
    graphs = {}
    for name, fn in fns.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for _ in range(n):
                fn()
    ms = {name: [] for name in fns}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for name in list(fns) + list(fns)[::-1]:
        graphs[name].replay()
        start.record()
        for _ in range(replays):
            graphs[name].replay()
        end.record()
        torch.cuda.synchronize()
        ms[name].append(start.elapsed_time(end) / (replays * n))
    del graphs
    return {name: min(v) for name, v in ms.items()}


def _rotating(sets):
    """Cycle through input sets larger together than the 50 MB L2, so each
    launch finds its inputs cold, as the model's layers do."""
    it = iter(range(1 << 30))
    return lambda: sets[next(it) % len(sets)]


def _bound(bytes_: float, flops: float, flop_per_s: float):
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / flop_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_train(stamp) -> tuple:
    """zamba2-2.7b at full width through the training entry point, then a
    kernels-on vs kernels-off check of one batch's loss and grads and a
    profile of one train step."""
    t = TRAIN
    cfg = get_config(t["arch"])
    n_mamba = cfg.n_layers // len(cfg.block_pattern) * cfg.block_pattern.count("mamba2")
    n_attn = cfg.n_layers - n_mamba
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ssd_intra_chunk_cuda.launches = 0
    flash_attention_cuda.launches = 0
    t0 = time.perf_counter()
    out = train_main(["--arch", t["arch"], "--steps", str(t["steps"]), "--batch", str(t["batch"]),
                      "--seq", str(t["seq"]), "--lr", str(t["lr"]), "--warmup", str(t["warmup"]),
                      "--optimizer", "adamw", "--seed", str(SEED), "--log-every", "1"])
    wall = time.perf_counter() - t0
    launches = {"ssd_scan": ssd_intra_chunk_cuda.launches,
                "flash_attention": flash_attention_cuda.launches}
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    check(out["steps"] == t["steps"] and all(math.isfinite(x) for x in losses),
          f"train losses not finite: {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    # forward + the remat recompute of every unit: two calls per layer per
    # step; an SSD call with one group of B/C (stride 0 over the heads)
    # launches the score kernel and the main kernel
    ssd_kernels = 2 if cfg.ssm_groups == 1 else 1
    want = {"ssd_scan": n_mamba * 2 * t["steps"] * ssd_kernels,
            "flash_attention": n_attn * 2 * t["steps"]}
    check(launches == want, f"train launches {launches} != {want} ({n_mamba} mamba2 and "
          f"{n_attn} attention layers x 2 x {t['steps']} steps; {ssd_kernels} SSD kernels a call)")
    steady = sorted(out["step_s"][1:])
    step_s = steady[len(steady) // 2]
    tokens = t["batch"] * t["seq"]
    print(f"train {t['arch']}: {cfg.n_layers} layers ({n_mamba} mamba2, {n_attn} attention), "
          f"batch {t['batch']} x seq {t['seq']}, {t['steps']} adamw steps (lr {t['lr']}, warmup "
          f"{t['warmup']}), remat on, kernels on; launches ssd_scan {launches['ssd_scan']} = "
          f"{n_mamba} x 2 x {t['steps']} calls ({n_mamba * 2} a step) x {ssd_kernels} kernels, "
          f"flash_attention {launches['flash_attention']} = "
          f"{n_attn} x 2 x {t['steps']}")
    print(f"train losses: {' '.join(f'{x:.4f}' for x in losses)}")
    print(f"time [{stamp}] train step (median of steps 2-{t['steps']}): {step_s:.3f} s = "
          f"{tokens / step_s:.0f} tokens/s; first step {out['step_s'][0]:.3f} s; whole run "
          f"{wall:.1f} s incl. init; peak memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated)")
    gc.collect()
    torch.cuda.empty_cache()
    busy = _train_kernels_on_vs_off(stamp, cfg)
    return launches, {"wall_ms": step_s * 1e3, "device_ms": busy}


def _train_kernels_on_vs_off(stamp, cfg):
    t = TRAIN
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = init_params(cfg, gen, "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in SyntheticLM(cfg.vocab, seed=SEED).batch(0, t["batch"], t["seq"]).items()}
    grads_of = steps_mod.make_grads_fn(cfg)

    dtypes = {name: p.dtype for name, p in model.named_parameters()}

    def cast(to_f32: bool):  # bf16 -> f32 -> bf16 is exact
        for name, p in model.named_parameters():
            p.data = p.data.to(torch.float32 if to_f32 else dtypes[name])

    def grads(on: bool):
        kernels.enable_kernels(on)
        loss, g = grads_of(model, batch)
        kernels.enable_kernels(True)
        g = dict(g)  # keeps this call's grads alive once the model lets go of them
        for p in model.parameters():
            p.grad = None
        check(math.isfinite(float(loss)) and all(bool(torch.isfinite(x).all()) for x in g.values()),
              f"kernels {'on' if on else 'off'}: loss or grads not finite")
        return float(loss), g

    def rel_l2(a, b):  # ||a - b|| / ||b|| over every leaf, in f32
        num = sum(((a[k].float() - b[k].float()) ** 2).sum() for k in b)
        return math.sqrt(float(num) / float(sum((x.float() ** 2).sum() for x in b.values())))

    cast(True)
    loss32, g32 = grads(False)
    loss32_on, g = grads(True)
    rel32 = rel_l2(g, g32)
    cast(False)
    loss_on, g_on = grads(True)
    loss_off, g_off = grads(False)
    err_on, err_off, rel_bf16 = rel_l2(g_on, g32), rel_l2(g_off, g32), rel_l2(g_on, g_off)
    del g, g32, g_on, g_off
    dl32, dl16 = abs(loss32_on - loss32), abs(loss_on - loss_off)
    print(f"train {t['arch']} one batch, kernels on vs off: {n_params / 1e9:.3f} B params")
    print(f"  float32 weights: loss {loss32_on:.6f} vs {loss32:.6f} (abs diff {dl32:.3g}, tol "
          f"{TRAIN_F32_LOSS_TOL}); grads relative L2 {rel32:.3g} (tol {TRAIN_F32_GRAD_REL_L2})")
    print(f"  bf16 weights: loss {loss_on:.5f} vs {loss_off:.5f} (abs diff {dl16:.3g}, tol "
          f"{TRAIN_BF16_LOSS_TOL}); grads relative L2 on vs off {rel_bf16:.3g}; against the "
          f"float32 kernels-off grads: kernels on {err_on:.3g}, kernels off {err_off:.3g} "
          f"(ratio {err_on / err_off:.3f}, tol {TRAIN_BF16_ERR_RATIO})")
    check(dl32 <= TRAIN_F32_LOSS_TOL and rel32 <= TRAIN_F32_GRAD_REL_L2,
          f"kernels on vs off, float32: loss diff {dl32}, grads rel L2 {rel32}")
    check(dl16 <= TRAIN_BF16_LOSS_TOL and err_on <= TRAIN_BF16_ERR_RATIO * err_off,
          f"kernels on vs off, bf16: loss diff {dl16}, grads error {err_on} vs {err_off}")
    # one train step under the profiler, with the optimizer state made now
    opt = adamw(cosine_schedule(t["lr"], t["warmup"], t["steps"]))
    state = {"model": model, "opt": opt.init(dict(model.named_parameters()))}
    step = steps_mod.make_train_step(cfg, opt)
    data = iter(range(1, 1 << 30))

    def one_step():
        nonlocal state
        b = SyntheticLM(cfg.vocab, seed=SEED).batch(next(data), t["batch"], t["seq"])
        state, _ = step(state, {"tokens": torch.from_numpy(b["tokens"]).cuda()})

    one_step()  # warm-up
    return _profile(stamp, f"train step ({t['arch']}, batch {t['batch']} x {t['seq']}, adamw, remat, "
             f"kernels on, under the profiler)", one_step, 1)


ROOT = Path(__file__).resolve().parent
# train_ft: qwen3-0.6b at full width and depth (28 layers, 16/8 heads of 128,
# vocab 151936) through ``python -m repro_torch.launch.train`` in processes of
# its own: a straight run of 12 steps, and a run with injected faults that
# is killed with SIGKILL after its step-8 checkpoint (its only one, which
# keeps the phase's disk writes at five checkpoints) and resumed by a new
# process. Every run is ``--deterministic``, so the faulted and the resumed
# runs must repeat the straight run's checkpoints and losses bit for bit.
# Each process keeps the entry point's default of 3 checkpoints.
TRAIN_FT = dict(arch="qwen3-0.6b", batch=4, seq=2048, steps=12, every=4, keep=3, warmup=2,
                lr=3e-4, fault_step=5, update_fault_step=7, kill_at=8, step_timeout=300,
                run_timeout=600)
# device memory a train_ft process needs: it peaks at 31.5 GiB on an H100 80GB
FT_DEVICE_NEED = 40 * 2**30
# where the straight run's step-DIST_RESTORE checkpoint waits for the distributed phase
FT_KEPT = ROOT / "chiprun_out" / "train_ft_kept"
# the faulted run: ``fault_hook`` raises before step ``fault_step``'s first
# attempt, and ``update_hook`` raises in step ``update_fault_step`` once half
# of the parameters are written. A record file gets a line for each
# attempt (its step, the flash-attention launches so far) and for each
# finished step (its loss), as they happen: the run is killed (argv: the
# two steps, the record file, then train's argv)
FT_FAULTS = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
from repro_torch.launch import train
from repro_torch.models.model import Model
step_at, update_at, record, argv = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4:]
cfg = get_config(argv[argv.index("--arch") + 1])
half = len(list(Model(cfg, generator=None, device="meta").parameters())) // 2
fired, current = set(), {}
def note(**line):
    with open(record, "a") as f:
        f.write(json.dumps(line) + "\\n")
run_step = train.FaultTolerantRunner.run_step
def run_step_noted(self, state, batch, step):
    out = run_step(self, state, batch, step)
    note(step=step, loss=float(out[1]["loss"]))
    return out
train.FaultTolerantRunner.run_step = run_step_noted
def fault_hook(step):
    current["step"] = step
    note(attempt=step, launches=flash_attention_cuda.launches)
    if step == step_at and "step" not in fired:
        fired.add("step")
        raise RuntimeError(f"injected fault before step {step}")
def update_hook(n):
    if current["step"] == update_at and n == half and "update" not in fired:
        fired.add("update")
        raise RuntimeError(f"injected failure after {n} parameters of the update")
train.main(argv, fault_hook=fault_hook, update_hook=update_hook)
"""
# train_moe: deepseek-v2-lite-16b at full width (MLA d 192 / dv 128 on the
# flash kernel's D = 192 instance; 64 experts top-6 + 2 shared) cut to its
# dense prefix layer and 5 MoE layers: 3.43 B parameters, 16 bytes each with
# AdamW (bf16 weights and grads; f32 m, v, master) = 55 GB, the deepest cut
# that leaves room for a 2 x 2048 step's activations on 80 GB. The f32
# kernels-on vs kernels-off check runs on its first 3 layers.
TRAIN_MOE = dict(arch="deepseek-v2-lite-16b", n_layers=6, batch=2, seq=2048, steps=6, warmup=2,
                 lr=3e-4, f32_layers=3)
# the two training shapes the flash kernel had not been timed at: qwen3-0.6b
# at 4 x 2048 (16/8 heads of 128) and deepseek-v2-lite's MLA at 2 x 2048
# (16/16 heads, d 192, dv 128 padded to the D = 192 instance); causal, bf16.
# (name, (b, sq, skv, hq, hkv, d[, dv]), the path whose launches it carries)
FA_TRAIN_NEW = [
    ("qwen3 train_ft", (4, 2048, 2048, 16, 8, 128), "train_ft"),
    ("MLA train_moe d=192 dv=128", (2, 2048, 2048, 16, 16, 192, 128), "train_moe"),
    # the distributed phase's (d): train --mesh 2,2, one rank's 2 rows and its
    # 8 of 16 q heads, 4 of 8 kv heads, over the gathered sequence
    ("qwen3 train --mesh 2,2, one rank's heads", (2, 2048, 2048, 8, 4, 128), "distributed"),
    # (e): one rank's row; zamba2's 16 of 32 heads of 80, MLA's 8 of 16
    ("zamba2 train --mesh 2,2, one rank's heads", (1, 2048, 2048, 16, 16, 80),
     "distributed (e) zamba2"),
    ("MLA train --mesh 2,2, one rank's heads d=192 dv=128", (1, 2048, 2048, 8, 8, 192, 128),
     "distributed (e) deepseek"),
]
# context parallelism under fsdp_only on --mesh 2,2 (the distributed
# phase's (h)): a rank's shard of a row's positions, causal from the
# shard's start (q_offset), against the gathered keys. (name, (b, sq, skv,
# hq, hkv, d[, dv]), q_offset, the (h1) run whose launches it carries):
# (h1)'s training steps (2 x 2048: a row a "data" rank, 1024 positions a
# "model" rank; qwen3's 16 q and 8 kv heads of 128, MLA's 16 heads of d 192
# and dv 128) and (h2)'s prefill (2 x 512: 256 positions a rank)
FA_CONTEXT = [("context q_offset 0", (1, 1024, 2048, 16, 8, 128), 0, "qwen3-0.6b"),
              ("context q_offset 1024", (1, 1024, 2048, 16, 8, 128), 1024, "qwen3-0.6b"),
              ("context MLA q_offset 0 d=192 dv=128", (1, 1024, 2048, 16, 16, 192, 128), 0,
               "deepseek-v2-lite-16b"),
              ("context MLA q_offset 1024 d=192 dv=128", (1, 1024, 2048, 16, 16, 192, 128), 1024,
               "deepseek-v2-lite-16b"),
              ("context prefill q_offset 0", (1, 256, 512, 16, 8, 128), 0, None),
              ("context prefill q_offset 256", (1, 256, 512, 16, 8, 128), 256, None)]


def _ft_args(t, ckpt_dir: Path, metrics: Path, every: int) -> list:
    return ["--arch", t["arch"], "--steps", str(t["steps"]), "--batch", str(t["batch"]),
            "--seq", str(t["seq"]), "--lr", str(t["lr"]), "--warmup", str(t["warmup"]),
            "--optimizer", "adamw", "--seed", str(SEED), "--log-every", "1", "--deterministic",
            "--step-timeout", str(t["step_timeout"]), "--ckpt-dir", str(ckpt_dir),
            "--ckpt-every", str(every), "--metrics-out", str(metrics)]


def _child_env() -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}


def _ft_child(stamp, label: str, cmd: list, log: Path, metrics: Path) -> dict:
    """Run one training process to its end; its returned dict, with the
    process's wall seconds and where they went."""
    t0 = time.time()
    with open(log, "w") as f:
        proc = subprocess.run(cmd, cwd=ROOT, env=_child_env(), stdout=f, stderr=subprocess.STDOUT,
                              timeout=TRAIN_FT["run_timeout"])
    t_exit = time.time()
    tail = log.read_text()[-3000:]
    check(proc.returncode == 0, f"train_ft {label}: exit {proc.returncode}; its log ends:\n{tail}")
    out = json.loads(metrics.read_text())
    out["wall_s"] = t_exit - t0
    out["spans"] = {"start-up to main": out["t_main"] - t0,
                    "init or restore": out["t_loop"] - out["t_main"],
                    "steps and checkpoints": out["t_done"] - out["t_loop"],
                    "exit": t_exit - out["t_done"]}
    out["recover_s"] = out["t_first_step"] - t0  # process start to its first step's end
    print(f"time [{stamp}] train_ft {label} process: {out['wall_s']:.1f} s wall = "
          + " + ".join(f"{k} {v:.1f} s" for k, v in out["spans"].items()))
    return out


def _ckpt_digest(step_dir: Path) -> dict:
    """sha256 of each leaf file of a checkpoint, by leaf key (8 threads)."""
    manifest = json.loads((step_dir / "manifest.json").read_text())

    def one(entry):
        h = hashlib.sha256()
        with open(step_dir / entry["file"], "rb") as f:
            while chunk := f.read(1 << 26):
                h.update(chunk)
        return entry["key"], h.hexdigest()

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        return dict(pool.map(one, manifest["leaves"]))


def _ft_records(stamp, label, out) -> None:
    for r in out.get("checkpoints", []):
        overlap = max(0.0, r["write_s"] - r["waited_s"])
        print(f"time [{stamp}] train_ft {label} checkpoint step {r['step']}: {r['bytes'] / 1e9:.3f} "
              f"GB; synchronous snapshot to host {r['snapshot_s']:.3f} s "
              f"({r['bytes'] / r['snapshot_s'] / 1e9:.2f} GB/s); async write {r['write_s']:.3f} s "
              f"({r['bytes'] / r['write_s'] / 1e9:.2f} GB/s), of which {overlap:.3f} s overlapped "
              f"training and {r['waited_s']:.3f} s blocked the next save or the final wait")


def phase_train_ft(stamp) -> dict:
    """qwen3-0.6b at full width: checkpointed, faulted, killed and resumed
    through the training entry point (TRAIN_FT); each run's flash-attention
    launches, losses and final checkpoint checked. Returns the straight
    run's launches and step time."""
    t = TRAIN_FT
    cfg = get_config(t["arch"])
    meta = Model(cfg, generator=None, device="meta")
    n_params = sum(p.numel() for p in meta.parameters())
    # bf16 (or f32) parameters plus f32 m, v and master, and the int32 step
    ckpt_bytes = sum(p.numel() * (p.element_size() + 12) for p in meta.parameters()) + 4
    per_step = cfg.n_layers * 2  # forward + the remat recompute of every unit
    # the training processes share the card with this one: hand back what
    # the earlier phases left in this process's allocator cache
    gc.collect()
    torch.cuda.empty_cache()
    free_dev, total_dev = torch.cuda.mem_get_info()
    print(f"train_ft: this process holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"(reserved {torch.cuda.memory_reserved() / 2**30:.2f} GiB); {free_dev / 2**30:.2f} of "
          f"{total_dev / 2**30:.2f} GiB of the card free for the training processes")
    check(free_dev >= FT_DEVICE_NEED, f"train_ft: {free_dev / 2**30:.2f} GiB free on the card, "
                                      f"{FT_DEVICE_NEED / 2**30:.0f} GiB needed")
    root = ROOT / "chiprun_out" / "train_ft"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free = shutil.disk_usage(root).free
    need = (t["keep"] + 1) * ckpt_bytes + 2 * 2**30  # keep + one being written, + 2 GiB
    print(f"train_ft {t['arch']}: {n_params / 1e9:.3f} B parameters, a checkpoint "
          f"{ckpt_bytes / 1e9:.3f} GB; {free / 2**30:.1f} GiB free under {root} (need "
          f"{need / 2**30:.1f} GiB for keep={t['keep']} and one being written)")
    check(free >= need, f"train_ft: {free / 2**30:.1f} GiB free under {root}, {need / 2**30:.1f} "
                        f"GiB needed")
    train = [sys.executable, "-m", "repro_torch.launch.train"]
    # the straight run on a 1x1 mesh (NCCL, world size 1): the faulted and
    # resumed runs, unmeshed, are held to it bit for bit
    meshed = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
              "1", "-m", "repro_torch.launch.train"]
    final = f"step_{t['steps']:09d}"
    t_phase = time.perf_counter()
    try:
        # 1. straight, train --mesh 1,1
        a = _ft_child(stamp, "straight", meshed + _ft_args(t, root / "a", root / "a.json",
                                                           t["every"]) + ["--mesh", "1,1"],
                      root / "a.log", root / "a.json")
        check(a.get("mesh") == {"data": 1, "model": 1}, f"train_ft straight: mesh {a.get('mesh')}")
        losses = a["losses"]
        check(a["steps"] == t["steps"] and all(math.isfinite(x) for x in losses)
              and losses[-1] < losses[0], f"train_ft straight: losses {losses}")
        want = per_step * t["steps"]
        check(a["launches"]["flash_attention"] == want,
              f"train_ft straight: {a['launches']['flash_attention']} flash-attention launches, "
              f"not {cfg.n_layers} layers x 2 x {t['steps']} steps = {want}")
        check([r["step"] for r in a["checkpoints"]] == list(range(t["every"], t["steps"] + 1,
                                                                 t["every"])),
              f"train_ft straight: checkpoints at {[r['step'] for r in a['checkpoints']]}")
        k = t["kill_at"]
        digest_k = _ckpt_digest(root / "a" / f"step_{k:09d}")
        digest = _ckpt_digest(root / "a" / final)
        # the distributed phase's (d) restores the step-DIST_RESTORE checkpoint on its 2x2 mesh
        shutil.rmtree(FT_KEPT, ignore_errors=True)
        FT_KEPT.mkdir(parents=True)
        (root / "a" / f"step_{DIST_RESTORE:09d}").rename(FT_KEPT / f"step_{DIST_RESTORE:09d}")
        shutil.rmtree(root / "a")
        steady = sorted(a["step_s"][1:])
        step_s = steady[len(steady) // 2]
        tokens = t["batch"] * t["seq"]
        print(f"train_ft straight: train --mesh 1,1 through torchrun (NCCL, world size 1), "
              f"{t['steps']} adamw steps of {t['batch']} x {t['seq']}, remat, "
              f"kernels on, deterministic, checkpoint every {t['every']} (keep {t['keep']}); "
              f"flash_attention launches {a['launches']['flash_attention']} = {cfg.n_layers} x 2 "
              f"x {t['steps']}")
        print(f"train_ft losses: {' '.join(f'{x:.6f}' for x in losses)}")
        print(f"time [{stamp}] train_ft step (median of steps 2-{t['steps']}): {step_s:.3f} s = "
              f"{tokens / step_s:.0f} tokens/s; first step {a['step_s'][0]:.3f} s; peak memory "
              f"{a['peak_bytes'] / 2**30:.2f} GiB (max_memory_allocated); process wall "
              f"{a['wall_s']:.1f} s incl. start-up and init")
        _ft_records(stamp, "straight", a)

        # 2. injected faults (before step 5's first attempt, and halfway
        # through step 7's update), then SIGKILL once the step-8 checkpoint
        # is complete
        c_dir, record = root / "c", root / "c.attempts"
        t_c = time.time()
        with open(root / "c.log", "w") as f:
            proc = subprocess.Popen([sys.executable, "-c", FT_FAULTS, str(t["fault_step"]),
                                     str(t["update_fault_step"]), str(record)]
                                    + _ft_args(t, c_dir, root / "c.json", k),
                                    cwd=ROOT, env=_child_env(), stdout=f, stderr=subprocess.STDOUT)
            deadline = time.monotonic() + t["run_timeout"]
            while latest_step(c_dir) != k:
                if proc.poll() is not None or time.monotonic() > deadline:
                    proc.kill()
                    proc.wait()
                    check(False, f"train_ft kill: the run ended ({proc.returncode}) or timed out "
                                 f"before its step-{k} checkpoint; its log ends:\n"
                                 f"{(root / 'c.log').read_text()[-3000:]}")
                time.sleep(0.02)
            proc.kill()  # SIGKILL
            rc = proc.wait()
        print(f"time [{stamp}] train_ft faulted process: {time.time() - t_c:.1f} s wall to its "
              f"step-{k} checkpoint and the kill")
        check(rc == -9 and latest_step(c_dir) == k,
              f"train_ft kill: exit {rc}, latest checkpoint {latest_step(c_dir)}")
        # (step, launches before the attempt): each step's grads run once, so
        # step s starts at s x per_step; step 5's retry follows a fault before
        # its dispatch, step 7's a failure after its grads
        notes = [json.loads(line) for line in record.read_text().splitlines()]
        attempts = [(n["attempt"], n["launches"]) for n in notes if "attempt" in n]
        step_losses = {n["step"]: n["loss"] for n in notes if "loss" in n}
        want_attempts = []
        for s_ in range(k):
            want_attempts.append((s_, per_step * s_))
            if s_ == t["fault_step"]:
                want_attempts.append((s_, per_step * s_))
            if s_ == t["update_fault_step"]:
                want_attempts.append((s_, per_step * (s_ + 1)))
        check(attempts[:len(want_attempts)] == want_attempts
              and all(a_ == (s_, per_step * s_) for s_, a_ in
                      zip(range(k, t["steps"]), attempts[len(want_attempts):])),
              f"train_ft faults: attempts [step, flash launches before it] {attempts}, "
              f"not {want_attempts} then [s, {per_step} s] for s >= {k}")
        check(all(step_losses.get(s_) == losses[s_] for s_ in range(k)),
              f"train_ft faults: losses {[step_losses.get(s_) for s_ in range(k)]} != "
              f"{losses[:k]}")
        manifest = json.loads((c_dir / f"step_{k:09d}" / "manifest.json").read_text())
        check(_ckpt_digest(c_dir / f"step_{k:09d}") == digest_k
              and manifest["extra"]["loss"] == losses[k - 1],
              f"train_ft faults: the step-{k} checkpoint (loss {manifest['extra']['loss']}) "
              f"differs from the straight run's (loss {losses[k - 1]})")
        print(f"train_ft faults: a fault before step {t['fault_step']} and a failure after half "
              f"of step {t['update_fault_step']}'s update, each retried once; flash_attention "
              f"launches before each attempt {[n for _, n in attempts]} (no step ran its grads "
              f"twice); the losses of steps 1-{k} and every leaf of the step-{k} checkpoint "
              f"equal the straight run's bit for bit; SIGKILL once latest_step read {k} "
              f"(exit {rc})")

        # 3. a new process resumes the killed run
        d = _ft_child(stamp, "resumed", train + _ft_args(t, c_dir, root / "d.json", t["every"]),
                      root / "d.log", root / "d.json")
        check(d["start_step"] == k and d["losses"] == losses[k:],
              f"train_ft resumed: from step {d['start_step']}, losses {d['losses']} != "
              f"{losses[k:]}")
        want_d = per_step * (t["steps"] - k)
        check(d["launches"]["flash_attention"] == want_d,
              f"train_ft resumed: {d['launches']['flash_attention']} flash launches != {want_d}")
        check(_ckpt_digest(c_dir / final) == digest,
              "train_ft resumed: the final checkpoint differs from the straight run's")
        mesh_s = statistics.median(a["step_s"][k + 1:])
        plain_s = statistics.median(d["step_s"][1:])
        print(f"time [{stamp}] train_ft --mesh 1,1 step (the straight run, median of steps "
              f"{k + 2}-{t['steps']}): {mesh_s:.3f} s vs unmeshed {plain_s:.3f} s (the resumed "
              f"run's same steps; {mesh_s / plain_s - 1:+.1%}); peak memory "
              f"{a['peak_bytes'] / 2**30:.2f} GiB vs {d['peak_bytes'] / 2**30:.2f} GiB")
        print(f"train_ft resumed: a new process restored step {k} and ran steps {k + 1}-"
              f"{t['steps']}: losses {' '.join(f'{x:.6f}' for x in d['losses'])} and every leaf "
              f"of the step-{t['steps']} checkpoint equal the straight run's bit for bit; "
              f"flash_attention launches {d['launches']['flash_attention']} = {cfg.n_layers} x 2 "
              f"x {t['steps'] - k}")
        print(f"time [{stamp}] train_ft restore of the step-{k} checkpoint "
              f"({ckpt_bytes / 1e9:.3f} GB, from disk to the card): {d['restore_s']:.3f} s "
              f"({ckpt_bytes / d['restore_s'] / 1e9:.2f} GB/s); time to recover (the new "
              f"process's start to the end of its first step): {d['recover_s']:.1f} s; peak "
              f"memory of the resumed run {d['peak_bytes'] / 2**30:.2f} GiB")
        _ft_records(stamp, "resumed", d)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _ft_profile(stamp, cfg)
    print(f"time [{stamp}] train_ft phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": a["launches"]["flash_attention"], "step_s": step_s, "losses": losses,
            "steps_s": a["step_s"], "peak_bytes": a["peak_bytes"]}


def _ft_profile(stamp, cfg) -> None:
    """One train_ft step in this process under the profiler, after a
    warm-up step, with deterministic algorithms as the train_ft runs."""
    t = TRAIN_FT
    gc.collect()
    torch.cuda.empty_cache()
    opt = adamw(cosine_schedule(t["lr"], t["warmup"], t["steps"]))
    state = steps_mod.make_init_state(cfg, opt, "cuda")(
        torch.Generator(device="cuda").manual_seed(SEED))
    step = steps_mod.make_train_step(cfg, opt)
    data = SyntheticLM(cfg.vocab, seed=SEED)
    it = iter(range(1 << 30))

    def one_step():
        nonlocal state
        b = data.batch(next(it), t["batch"], t["seq"])
        state, m = step(state, {"tokens": torch.from_numpy(b["tokens"]).cuda()})
        float(m["loss"])

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        torch.use_deterministic_algorithms(True)
        one_step()
        _profile(stamp, f"train_ft step ({t['arch']}, batch {t['batch']} x {t['seq']}, adamw, remat, "
                 f"kernels on, deterministic, under the profiler)", one_step, 1)
    finally:
        torch.use_deterministic_algorithms(False)
    del state
    gc.collect()
    torch.cuda.empty_cache()


def _grads_host(grads_of, model, batch) -> tuple:
    """Loss and grads of one batch, the grads copied to the host, and the
    pass's peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss, g = grads_of(model, batch)
    peak = torch.cuda.max_memory_allocated()
    g = {k: v.detach().to("cpu") for k, v in g.items()}
    for p in model.parameters():
        p.grad = None
    return float(loss), g, peak


def phase_train_moe(stamp) -> dict:
    """deepseek-v2-lite-16b at full width, cut to TRAIN_MOE's depth, trained
    through the entry point (losses finite and falling, flash launches
    exact), then on one batch: ``save_block_outputs`` against ``full``
    (grads bit for bit under deterministic algorithms; a step's time and
    peak memory under each), and kernels on vs off in float32 on the first
    layers with the MoE routes forced equal."""
    t = TRAIN_MOE
    full = get_config(t["arch"])
    cfg = register(dataclasses.replace(full, name=f"{full.name}-{t['n_layers']}l",
                                       n_layers=t["n_layers"]))
    n_moe = cfg.n_layers - cfg.first_k_dense
    n_params = sum(p.numel() for p in Model(cfg, generator=None, device="meta").parameters())
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_fa_launches()
    out = train_main(["--arch", cfg.name, "--steps", str(t["steps"]), "--batch", str(t["batch"]),
                      "--seq", str(t["seq"]), "--lr", str(t["lr"]), "--warmup", str(t["warmup"]),
                      "--optimizer", "adamw", "--seed", str(SEED), "--log-every", "1"])
    launches = flash_attention_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    check(out["steps"] == t["steps"] and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0], f"train_moe losses: {losses}")
    # the prefix layer runs once a step (outside the units, no remat); each
    # unit layer runs in the forward and in its remat recompute
    want = (cfg.first_k_dense + 2 * n_moe) * t["steps"]
    check(launches == want == flash_attention_cuda.launches_by_dim[192],
          f"train_moe: {launches} flash launches ({flash_attention_cuda.launches_by_dim}), not "
          f"({cfg.first_k_dense} + 2 x {n_moe}) x {t['steps']} = {want}, all at D = 192")
    steady = sorted(out["step_s"][1:])
    step_s = steady[len(steady) // 2]
    tokens = t["batch"] * t["seq"]
    print(f"train_moe {cfg.name}: {n_params / 1e9:.3f} B parameters ({cfg.first_k_dense} dense "
          f"MLA layer + {n_moe} MLA + MoE layers of {cfg.n_routed_experts} experts top-"
          f"{cfg.top_k} + {cfg.n_shared_experts} shared; cut from {full.n_layers} layers), batch "
          f"{t['batch']} x {t['seq']}, {t['steps']} adamw steps, remat full, kernels on; "
          f"flash_attention launches {launches} = ({cfg.first_k_dense} + 2 x {n_moe}) x "
          f"{t['steps']}, all on the D = 192 instance")
    print(f"train_moe losses: {' '.join(f'{x:.4f}' for x in losses)}")
    print(f"time [{stamp}] train_moe step (median of steps 2-{t['steps']}): {step_s:.3f} s = "
          f"{tokens / step_s:.0f} tokens/s; first step {out['step_s'][0]:.3f} s; peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated)")
    del out
    gc.collect()
    torch.cuda.empty_cache()

    # the two remat policies on one batch and one step each
    opt = adamw(cosine_schedule(t["lr"], t["warmup"], t["steps"]))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    state = steps_mod.make_init_state(cfg, opt, "cuda")(gen)
    model = state["model"]
    data = SyntheticLM(cfg.vocab, seed=SEED)
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch(0, t["batch"], t["seq"]).items()}
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        grads = {p: _grads_host(steps_mod.make_grads_fn(cfg, remat_policy=p), model, batch)
                 for p in ("full", "save_block_outputs")}
    finally:
        torch.use_deterministic_algorithms(False)
    (l_full, g_full, m_full), (l_sbo, g_sbo, m_sbo) = grads.values()
    same = l_full == l_sbo and all(torch.equal(g_full[k], g_sbo[k]) for k in g_full)
    check(same, f"train_moe: save_block_outputs grads differ from full's (loss {l_sbo} vs "
                f"{l_full})")
    del grads, g_full, g_sbo
    timed = {}
    for i, policy in enumerate(("full", "save_block_outputs", "full", "save_block_outputs")):
        step = steps_mod.make_train_step(cfg, opt, remat_policy=policy)
        b = {k: torch.from_numpy(v).cuda() for k, v in data.batch(1 + i, t["batch"], t["seq"]).items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        float(metrics["loss"])
        torch.cuda.synchronize()
        timed[policy] = (time.perf_counter() - t0, torch.cuda.max_memory_allocated())
    print(f"train_moe remat policies, one batch, deterministic algorithms: loss and every grad "
          f"of save_block_outputs equal full's bit for bit (loss {l_full:.6f}); peak memory of "
          f"the forward and backward (AdamW state allocated): full {m_full / 2**30:.2f} GiB, "
          f"save_block_outputs {m_sbo / 2**30:.2f} GiB")
    print(f"time [{stamp}] train_moe step by remat policy (the second step of each, steps "
          f"interleaved): " + "; ".join(
              f"{p} {s:.3f} s = {tokens / s:.0f} tokens/s, peak memory {m / 2**30:.2f} GiB"
              for p, (s, m) in timed.items()))

    # kernels on vs off in float32 on the first layers, the MoE routes forced equal
    cut, small = _cut_f32(cfg, model.named_parameters(), t["f32_layers"])
    del state, model
    gc.collect()
    torch.cuda.empty_cache()
    grads_of = steps_mod.make_grads_fn(cut, remat=False)
    kernels.enable_kernels(False)
    with _moe_routes(small) as routes:
        loss_off, g_off, _ = _grads_host(grads_of, small, batch)
    kernels.enable_kernels(True)
    before = flash_attention_cuda.launches
    with _routes_forced(small, routes) as own:
        loss_on, g_on, _ = _grads_host(grads_of, small, batch)
    check(flash_attention_cuda.launches - before == cut.n_layers,
          f"train_moe f32: {flash_attention_cuda.launches - before} flash launches, not "
          f"{cut.n_layers}")
    flips = _flip_share(own, routes).float().mean().item()
    num = sum(((g_on[k] - g_off[k]) ** 2).sum() for k in g_off)
    rel = math.sqrt(float(num) / float(sum((x ** 2).sum() for x in g_off.values())))
    dl = abs(loss_on - loss_off)
    print(f"train_moe float32, first {cut.n_layers} layers, kernels on vs off with the MoE "
          f"routes forced to the kernels-off ones (the kernels-on step would have moved "
          f"{flips:.2%} of its (layer, token) routes): loss {loss_on:.6f} vs {loss_off:.6f} (abs "
          f"diff {dl:.3g}, tol {TRAIN_F32_LOSS_TOL}); grads relative L2 {rel:.3g} (tol "
          f"{TRAIN_F32_GRAD_REL_L2})")
    check(dl <= TRAIN_F32_LOSS_TOL and rel <= TRAIN_F32_GRAD_REL_L2,
          f"train_moe f32 kernels on vs off: loss diff {dl}, grads rel L2 {rel}")
    del small, g_on, g_off
    gc.collect()
    torch.cuda.empty_cache()
    print(f"time [{stamp}] train_moe phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "step_s": step_s}


# distributed: the port's distributed layer on the card. One card
# means world size 1 (NCCL; train_ft's straight run is ``--mesh 1,1``) or
# ranks sharing it (gloo); nothing here measures a speed-up across cards.
# One ``torch.distributed.run`` launch of 4 gloo ranks sharing the card
# runs (b), (c) and (d):
# (b) the expert-parallel MoE layer at qwen2-moe-a2.7b's width (d 2048, 60
#     experts top-4, d_expert 1408, 4 shared) in f32, mesh (1, 4) ("data",
#     "model"): 15 experts a rank, against the port's MoE at the reference
#     test's tolerances, at the first capacity factor of DIST_EP_CF at which
#     neither path drops an assignment (the plain MoE's from the routes and
#     its capacity, the layer's from its own count, moe_ep.DROPPED).
#     DIST_EP_X tokens, not the 2 x 2048 of a training batch: the reference
#     layer dispatches each sender's empty slots to local expert 0 on the
#     owner, so a drop-free owner needs capacity_factor ~ e_loc (11 at e_loc
#     = 15), and its (e_loc, cap_own, d) f32 buffers, activations and grads
#     at 2 x 2048 tokens would need ~25 GB a rank, 4 ranks more than the
#     card holds; at 2 x 512, ~9 GB.
# (c) the int8 compressed all-reduce on the same 4 ranks over (b)'s grads
#     (each rank's x grad and its experts' w_down grads: distinct per rank).
# (d) qwen3-0.6b at full width and depth through the training entry point
#     with train_ft's arguments (no checkpoints) and ``--mesh 2,2``: the
#     partitioned step (FSDP per unit over "data", tensor and sequence
#     parallel over "model", the vocabulary split), ended before step
#     DIST_STOP. Its losses within DIST_LOSS_RTOL of train_ft's straight run
#     at each step, flash attention launched 28 x 2 a step at
#     one rank's shape (2 rows, 8 q and 4 kv heads, the whole sequence),
#     each rank's parameters, grads and moments of its ``param_specs``
#     slice's shape, each rank's peak memory over the steps (the dryrun
#     phase traces the same step against rank 0's). Then the ranks restore
#     train_ft's straight-run step-DIST_RESTORE checkpoint (kept for it under
#     FT_KEPT) with ``restore(shardings=)`` onto their 2x2 mesh as cuda
#     DTensors and hold each rank's slice of every leaf to the file's.
DIST_STOP = 1  # (d)'s steps: each ~27 s, every collective staged through the host
DIST_RESTORE = 4  # train_ft's straight-run checkpoint that (d) restores on its mesh
DIST_LOSS_RTOL = 2e-2
DIST_EP_X = (2, 512)
DIST_EP_CF = (8.0, 10.0, 11.0, 12.0, 14.0, 16.0)  # the first drop-free one is used
DIST_EP_TIMED = 3  # timed forward calls of each path
DIST_Y_TOL, DIST_AUX_RTOL, DIST_GRAD_TOL = 2e-4, 1e-5, 2e-3  # tests/test_moe_ep.py's
DIST_TIMEOUT = 420
# (e): zamba2-2.7b cut to one unit (5 Mamba-2 blocks and 1 attention
# block) and deepseek-v2-lite cut to its dense prefix layer and one MoE
# layer, at full width; train_moe's 2 x 2048 batch, one step through the
# training entry point on --mesh 2,2 and unmeshed. train_moe's 6 layers
# (3.4 B parameters, 16.6 GiB a rank on an H100 80GB in processes of
# their own) ran out of the card's memory on two ranks after (b)-(d) in
# the same processes; 4 layers (2.2 B) left room, 3 left time for (f)
# and 2 for (h) (zamba2's unmeshed comparison is out, ``meshed_only``, to
# make room for (g): its --mesh 2,2 step and launches are still checked)
DIST_E = [dict(arch="zamba2-2.7b", n_layers=6, meshed_only=True),
          dict(arch="deepseek-v2-lite-16b", n_layers=2)]
DIST_E_ARGS = ["--steps", "1", "--batch", "2", "--seq", "2048", "--lr", "3e-4", "--warmup", "2",
               "--optimizer", "adamw", "--seed", str(SEED), "--log-every", "1", "--deterministic"]
# (f): xlstm-1.3b at full width cut to one unit (5 mLSTM blocks and 1 sLSTM
# block, 0.62 B with the vocabulary), (e)'s batch and step on --mesh 2,2
# and unmeshed: its 4 heads 2 a rank in every block (mode "tp"); each
# rank's compute shapes of the leaves in ``watch``. With ``f32`` the step
# functions again in f32 from the same seed and batch: in bf16 the
# unmeshed step's grad norm is itself 4.2e-2 off the f32 step's (xLSTM's
# gate grads are rounding noise in bf16), above DIST_LOSS_RTOL, so the
# grad norm is held in f32; the bf16 norms' gaps are printed
# (cut to 2 x 256, ``f32_seq``, to make room for (g); the bf16 step
# through the entry point to 2 x 1024, ``seq``, to make room for (h): its
# sLSTM is a loop over positions)
DIST_F = [dict(arch="xlstm-1.3b", n_layers=6, f32=True, f32_seq=256, seq=1024,
               watch=["blocks.0.core.wq.w", "blocks.0.core.w_i.w", "blocks.0.core.up.w",
                      "blocks.5.core.r", "blocks.5.core.wx.w", "blocks.5.core.ffn_up.w"])]
# (g): partitioned serving, 4 gloo ranks on --mesh 2,2 after (f):
# qwen3-0.6b at full width cut to G_QWEN3_LAYERS layers (at all 28 the
# phase took ~150 s more and the script 1213 s, over its limit; at 8,
# 1081 s on the same host), a
# prefill of 8 x 512 tokens and a wave of 8 prompts of PROMPT_TOKENS[0]
# tokens fed one at a time, then 16 greedy steps, in bf16 and in f32, the
# cache by kv head (4 of 8 a rank) and by sequence
# (``shard_cache_heads=False``: 32 of 64 slots a rank, so the second
# shard is empty until the prompt passes it); deepseek-v2-lite cut to 3
# layers in f32 (the MLA latent by sequence, the D = 192 instance with the
# log-sum-exp, 32 of 64 experts a rank). In f32 every logit within
# DIST_G_F32_TOL of its row's largest (test_torch_serve_mesh.py's 1e-5 is
# the smoke widths'; full width carries the order of the f32 sums
# further); in bf16 within MODEL_LOGIT_TOL (the same rounding-order gap as
# kernels on/off), which leaving the partial sums unreduced breaks.
G_QWEN3_LAYERS = 4
_G = dict(rows=8, prompt=PROMPT_TOKENS[0], new=16, max_len=64)
_G_QWEN3 = dict(arch="qwen3-0.6b", n_layers=G_QWEN3_LAYERS, **_G)
_G_SEQ = {"shard_cache_heads": False}
DIST_G = [
    dict(label="qwen3 bf16 heads", f32=False, prefill=(8, 512), fault=True, **_G_QWEN3),
    dict(label="qwen3 bf16 sequence", f32=False, rules=_G_SEQ, **_G_QWEN3),
    dict(label="qwen3 f32 heads", f32=True, **_G_QWEN3),
    dict(label="qwen3 f32 sequence", f32=True, rules=_G_SEQ, **_G_QWEN3),
    dict(label="deepseek f32", arch="deepseek-v2-lite-16b", n_layers=3, f32=True,
         prefill=(8, 512), **_G),
    # (h2): the same qwen3 cut under fsdp_only in f32 with 2 rows, which do
    # not divide over the 4 ranks' pool: the prefill's 2 x 512 prompt a row a
    # "data" rank, its sequence over "model" (attention context parallel,
    # 256 queries a rank); the decode's rows whole on every rank, the
    # weights gathered per unit (2.2 s a step through host memory, the f32
    # embedding 0.62 GB of it: an 8-token prompt and 4 greedy steps), the
    # cache's 16 slots over (data, model), 4 a rank (the last shard empty),
    # the shards' partials merged by log-sum-exp
    dict(label="qwen3 f32 fsdp_only", f32=True, rules={"fsdp_only": True}, prefill=(2, 512),
         **{**_G_QWEN3, "rows": 2, "prompt": 8, "new": 4, "max_len": 16}),
    # (h3): xlstm-1.3b cut to one unit (5 mLSTM + 1 sLSTM) in f32, its 4
    # heads 2 a "model" rank: the recurrent caches by head, the mLSTM's conv
    # windows by channel (no attention: no flash call)
    dict(label="xlstm f32", arch="xlstm-1.3b", n_layers=6, f32=True, **_G),
]
DIST_G_F32_TOL = 1e-4
DIST_G_BF16_TOL = MODEL_LOGIT_TOL
# (h1): the fsdp_only training steps (H_RUN below): qwen3-0.6b cut to 4
# layers, with the planted fault, and deepseek-v2-lite cut to its dense
# prefix layer and one MoE layer (MLA context parallel on its gathered
# latent and rope key, the MoE on each rank's tokens counted over the
# global batch). ``kv``: the leaves whose grads the key gather's backward
# sums
H_TRAIN = [dict(arch="qwen3-0.6b", n_layers=4, batch=2, seq=2048, fault=True,
                kv=["attn.wk.w", "attn.wv.w"]),
           dict(arch="deepseek-v2-lite-16b", n_layers=2, batch=2, seq=2048,
                kv=["attn.kv_down.w"])]
# (g)'s flash decode at one rank's local shapes (b, sq, cache, hq, hkv, d[,
# dv]): qwen3's 4 rows on 8 of 16 q heads over 4 of 8 kv heads of the whole
# 64-slot cache; every head over a 32-slot sequence shard (with the
# log-sum-exp); MLA's 16 heads, d 192, dv 128 over a 32-slot latent shard
G_LSE = [("g heads", (4, 1, 64, 8, 4, 128), (1, 33, 48, 64)),
         ("g sequence", (4, 1, 32, 16, 8, 128), (0, 16, 32)),
         ("g mla", (4, 1, 32, 16, 16, 192, 128), (0, 20, 32)),
         # (h2): both rows, every head over a 4-slot quarter of the cache
         ("h sequence over dp", (2, 1, 4, 16, 8, 128), (0, 3, 4))]
G_LSE_TOL = 1e-4  # the f32 log-sum-exp of the same f32 scores, summed in another order
# (b)-(d) take ~75-85 s and (e) + (f) ~150-220 s on a normal host; a rank
# that fails inside a collective leaves the others waiting until this limit
DIST_E_TIMEOUT = 390
# (e)'s unmeshed deepseek step on rank 0 (~40 GiB at 4 layers; 57.4 GiB
# at 6 on an H100 80GB), beside the other ranks' contexts
DIST_DEVICE_NEED = 48 * 2**30
# (b) and (c): each of the 4 ranks (torchrun) on cuda:0 over gloo
EP_RUN = """
import gc, json, math, sys, time
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe_ep
from repro_torch.models.moe import MoE
from repro_torch.runtime.compression import (compressed_wire_bytes, error_feedback_update,
                                             make_compressed_allreduce, raw_wire_bytes)
from repro_torch.sharding.hints import clear_hints, hints_from_mesh
from repro_torch.sharding.place import from_full, local_index
out_path, seed, B, S, n_timed = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])
cfs = [float(c) for c in sys.argv[6].split(",")]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dist.init_process_group("gloo", init_method="env://")
rank, world = dist.get_rank(), dist.get_world_size()
torch.cuda.set_device(0)
mesh = make_mesh((1, world), ("data", "model"), device_type="cuda")
hints_from_mesh(mesh, None)
cfg0 = get_config("qwen2-moe-a2.7b")
e, k, d = cfg0.n_routed_experts, cfg0.top_k, cfg0.d_model
gen = torch.Generator(device="cuda").manual_seed(seed)
moe = MoE(cfg0, generator=gen, device="cuda").float()
x = torch.randn((B, S, d), generator=gen, device="cuda")
T, T_loc, e_loc = B * S, B * S // world, -(-e // world)
# the first capacity factor at which neither path drops an assignment: the
# plain MoE's from the routes and its capacity, the expert-parallel layer's
# from its own count (a forward at each candidate)
import dataclasses
with torch.no_grad():
    _, eidx, _ = moe.route(x.reshape(T, d))
load = int(torch.bincount(eidx.reshape(-1), minlength=e).max())
xd = from_full(x, mesh, (Shard(0), Shard(1)))
for cf in cfs:
    cfg = dataclasses.replace(cfg0, capacity_factor=cf)
    moe.cfg = cfg
    moe_ep.DROPPED["assignments"] = 0
    with torch.no_grad():
        moe_ep.moe_apply_ep(moe, cfg, xd)
    dropped = torch.tensor([int(moe_ep.DROPPED["assignments"])], dtype=torch.int64)
    dist.all_reduce(dropped)
    torch.cuda.empty_cache()
    if load <= moe.capacity(T) and int(dropped) == 0:
        break
else:
    raise SystemExit(f"no capacity factor of {cfs} is drop-free")
cap_send, cap_own = moe_ep._capacities(cfg, T_loc, world, e_loc)
moe_ep.HOST_STAGED.update(calls=0, bytes=0)  # count the checked run's alone
res = {"cf": cf, "cap_send": cap_send, "cap_own": cap_own, "e_loc": e_loc, "T": T}
# the port's MoE on the whole x: the reference of the check
xa = x.clone().requires_grad_(True)
y0, a0 = moe(xa)
y0.sum().backward()
g0 = {n: p.grad.clone() for n, p in moe.named_parameters()}
gx0 = xa.grad
moe.zero_grad(set_to_none=True)
# the expert-parallel layer on this rank's block (the contract's layout)
layout = (Shard(0), Shard(1))
xd.requires_grad_(True)
ex0 = dict(moe_ep.EXCHANGE)
y1, a1 = moe_ep.moe_apply_ep(moe, cfg, xd)
ex1 = dict(moe_ep.EXCHANGE)
y1.to_local().sum().backward()
idx = local_index(x.shape, mesh, layout)
def maxerr(a, b):
    return float((a.detach() - b.detach()).abs().max())
def within(a, b, tol):
    return bool(((a - b).abs() <= tol + tol * b.abs()).all())
res["y_err"] = maxerr(y1.to_local(), y0[idx])
res["y_ok"] = within(y1.to_local(), y0[idx], YTOL)
res["aux"] = [float(a1), float(a0)]
res["aux_ok"] = abs(float(a1) - float(a0)) <= AUXTOL * abs(float(a0))
g1 = {n: p.grad for n, p in moe.named_parameters()}
res["grad_err"] = max([maxerr(g1[n], g0[n]) for n in g0] + [maxerr(xd.grad.to_local(), gx0[idx])])
res["grad_ok"] = all(within(g1[n], g0[n], GTOL) for n in g0) and within(xd.grad.to_local(), gx0[idx], GTOL)
res["grad_max"] = max(float(g.abs().max()) for g in g0.values())
res["a2a_bytes_fwd"] = ex1["bytes"] - ex0["bytes"]
res["a2a_calls_fwd"] = ex1["calls"] - ex0["calls"]
res["staged"] = dict(moe_ep.HOST_STAGED)
# forward times, ranks in step
def timed(fn, together=True):
    out = []
    for _ in range(n_timed):
        if together:
            dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            fn()
        torch.cuda.synchronize()
        if together:
            dist.barrier()
        out.append((time.perf_counter() - t0) * 1e3)
    return out
res["ep_ms"] = timed(lambda: moe_ep.moe_apply_ep(moe, cfg, xd))
dist.barrier()
res["moe_ms"] = timed(lambda: moe(x), together=False) if rank == 0 else []  # the card to itself
dist.barrier()
# (c) the compressed all-reduce over this rank's own grads: its block's x
# grad and its experts' w_down grads (each rank's differ)
own = {"x": xd.grad.to_local(), "w_down": g1["w_down"][rank * e_loc:(rank + 1) * e_loc].contiguous()}
ar = make_compressed_allreduce()
c_err, c_bound, res_ok = 0.0, 0.0, True
for n, g in own.items():
    avg, new_res = ar(g, None)
    plain = g.clone()
    dist.all_reduce(plain)
    plain /= world
    _, scale, want_res, _ = error_feedback_update(g, None)
    scales = scale.reshape(1).clone()
    gathered = [torch.zeros_like(scales) for _ in range(world)]
    dist.all_gather(gathered, scales)
    bound = float(torch.stack(gathered).mean()) / 2
    c_err = max(c_err, maxerr(avg, plain) / bound)
    res_ok &= torch.equal(new_res, want_res)
    avg2, _ = ar(g, new_res)  # a second step through the error feedback
    res_ok &= bool(torch.isfinite(avg2).all())
res["compress_err_over_bound"] = c_err
res["residual_ok"] = bool(res_ok)
res["wire"] = [compressed_wire_bytes(own), raw_wire_bytes(own)]
clear_hints()
flags = torch.tensor([res["y_ok"], res["aux_ok"], res["grad_ok"], res["residual_ok"],
                      c_err <= 1.0 + 1e-3], dtype=torch.int32)
dist.all_reduce(flags, op=dist.ReduceOp.MIN)
res["all_ranks_ok"] = flags.tolist()
errs = torch.tensor([res["y_err"], res["grad_err"], c_err, max(res["ep_ms"])], dtype=torch.float64)
dist.all_reduce(errs, op=dist.ReduceOp.MAX)
res["max_over_ranks"] = errs.tolist()
if rank == 0:
    Path(out_path).write_text(json.dumps(res))
del moe, x, xd, xa, y0, y1, g0, g1, gx0, own
gc.collect()
torch.cuda.empty_cache()
# (d) train --mesh 2,2 on the same ranks, ended before step d_stop
from repro_torch.configs import get_config as config_of
from repro_torch.kernels import flash_attention as fa_pkg
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
from repro_torch.launch import train
from repro_torch.sharding.specs import ShardingRules, named, param_specs
d_out, d_stop, kept, d_argv = sys.argv[7], int(sys.argv[8]), Path(sys.argv[9]), sys.argv[10:]
rec = {"losses": [], "step_s": [], "shapes": set()}
seen = {}
fa = fa_pkg.flash_attention
def fa_noted(q, k, v, **kw):  # the shapes the model's attention launches at
    rec["shapes"].add((q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3]))
    return fa(q, k, v, **kw)
fa_pkg.flash_attention = fa_noted
class Stop(BaseException):
    pass
run_step = train.FaultTolerantRunner.run_step
def timed(self, state, batch, step):
    seen["state"] = state
    t0 = time.perf_counter()
    out = run_step(self, state, batch, step)  # waits for the device
    rec["step_s"].append(time.perf_counter() - t0)
    rec["losses"].append(float(out[1]["loss"]))
    return out
train.FaultTolerantRunner.run_step = timed
def fault_hook(step):
    torch.cuda.synchronize()
    if step == 0:  # the path starts: its counts and its peak from here
        flash_attention_cuda.launches = 0
        moe_ep.HOST_STAGED.update(calls=0, bytes=0)
        torch.cuda.reset_peak_memory_stats()
    if step == d_stop:
        rec["launches"] = flash_attention_cuda.launches
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        raise Stop
def update_hook(n):  # the grads of the step are pending: note their shapes once
    if n == 1 and "grads" not in seen:
        seen["grads"] = {k: tuple(g.shape) for k, g in seen["state"]["pending"]["grads"].items()}
try:
    train.main(d_argv, fault_hook=fault_hook, update_hook=update_hook)
except Stop:
    pass
state = seen["state"]
mesh = next(state["model"].parameters()).device_mesh
cfg = config_of(d_argv[d_argv.index("--arch") + 1])
specs = named(param_specs(state["model"], cfg, mesh, ShardingRules()), mesh)
params = dict(state["model"].named_parameters())
want = {n: tuple(sl.stop - sl.start for sl in local_index(params[n].shape, mesh, pl))
        for n, (_, pl) in specs.items()}
bad = [n for n, p in params.items() if tuple(p.to_local().shape) != want[n]]
bad += [n for n, sh in seen["grads"].items() if sh != want[n]]
bad += [f"{k}.{n}" for k in ("m", "v", "master") for n, t in state["opt"][k].items()
        if tuple(t.to_local().shape) != want[n]]
rec.update(bad_shapes=bad, n_leaves=len(params), shapes=sorted(rec["shapes"]),
           staged=dict(moe_ep.HOST_STAGED), rank=rank,
           local_params=sum(p.to_local().numel() for p in params.values()),
           params=sum(p.numel() for p in params.values()))
# train_ft's straight-run checkpoint restored with shardings= onto this 2x2
# mesh of cuda DTensors: each rank reads its slices; each equals the file's
from repro_torch.checkpoint import restore
from repro_torch.checkpoint.checkpoint import _from_native
from repro_torch.launch import steps
from repro_torch.models.convert import reference_leaves
from repro_torch.optim import adamw
from repro_torch.sharding.specs import state_specs
del state, seen
gc.collect()
meta = steps.make_init_state(cfg, adamw(1e-4), "meta")(None)
t0 = time.perf_counter()
got, step, _ = restore(kept, meta, shardings=named(state_specs(meta, cfg, mesh, ShardingRules()),
                                                   mesh), device="cuda")
torch.cuda.synchronize()
rec["restore_s"] = time.perf_counter() - t0
cdir = kept / f"step_{step:09d}"
files = {e["key"]: e for e in json.loads((cdir / "manifest.json").read_text())["leaves"]}
bad, n, local = [], 0, 0
for key, _, _, ts, stacked in reference_leaves(got, cfg):
    n += 1
    if key == "['opt']['step']":
        bad += [] if ts[0] == step else [key]
        continue
    e = files[key]
    arr = _from_native(np.load(cdir / e["file"], mmap_mode="c"), e["dtype"])
    for u, t_ in enumerate(ts):
        whole = arr[u] if stacked else arr
        if type(t_).__name__ != "DTensor" or not t_.to_local().is_cuda or not torch.equal(
                t_.to_local().cpu(), whole[local_index(whole.shape, mesh, t_.placements)]):
            bad.append(key)
        local += t_.to_local().numel()
rec.update(restore_leaves=n, restore_bad=sorted(set(bad)), restore_step=step,
           restore_local=local)
Path(f"{d_out}.{rank}").write_text(json.dumps(rec))
fa_pkg.flash_attention, train.FaultTolerantRunner.run_step = fa, run_step
del got
gc.collect()
torch.cuda.empty_cache()
""".replace("YTOL", repr(DIST_Y_TOL)).replace("AUXTOL", repr(DIST_AUX_RTOL)).replace(
    "GTOL", repr(DIST_GRAD_TOL))
# (e) and (f) on the same ranks after (d), or on their own: each run of
# e_spec.json (beside the script) through the training entry point on
# --mesh 2,2, one step, then rank 0 alone (the others wait) the unmeshed
# step of the same cut from the same seed; each run's loss, the grads'
# global norm, its flash and SSD launches by local shape, the partition's
# modes and the compute shapes of its ``watch`` leaves, its peak memory
E_RUN = """
import collections, dataclasses, gc, json, time
from pathlib import Path
import torch
import torch.distributed as dist
from repro_torch.configs import get_config as e_config
from repro_torch.configs.base import register as e_register
from repro_torch.kernels import flash_attention as e_fa
from repro_torch.kernels.flash_attention.flash_attention import (flash_attention_cuda as e_fa_cuda,
                                                              reset_launches as e_fa_reset)
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_intra_chunk_cuda as e_ssd_cuda
from repro_torch.launch import train as e_train
from repro_torch.models import moe as e_moe, moe_ep as e_ep, ssm as e_ssm
from repro_torch.optim.optimizers import global_norm
from repro_torch.sharding import partition as e_part
from repro_torch.sharding.hints import clear_hints
if not dist.is_initialized():  # on its own
    dist.init_process_group("gloo", init_method="env://")
    torch.cuda.set_device(0)
e_rank = dist.get_rank()
e_spec = json.loads(Path(__file__).with_name("e_spec.json").read_text())
e_fa0, e_ssd0, e_run0 = e_fa.flash_attention, e_ssm._ssd_fast, e_train.FaultTolerantRunner.run_step
e_gather0, e_init0 = e_part.gather_group, e_part.Partition.__init__
e_res = []
for e_run in e_spec["runs"]:
    e_full = e_config(e_run["arch"])
    e_cfg = e_register(dataclasses.replace(e_full, name=f"{e_full.name}-{e_run['n_layers']}l",
                                           n_layers=e_run["n_layers"]))
    for meshed in (True, False):
        if meshed or (e_rank == 0 and not e_run.get("meshed_only")):
            note, seen = {"fa": {}, "ssd": {}, "modes": {}, "shapes": {}}, {}
            def gather_e(group, shards):  # the compute tensors of a unit's or the root's leaves
                out = e_gather0(group, shards)
                for k in e_run.get("watch", ()):
                    if k in out:
                        note["shapes"][k] = list(out[k].shape)
                return out
            def init_e(self, *a, **kw):  # the plan of the partitioned step: its modes
                e_init0(self, *a, **kw)
                note["modes"] = dict(collections.Counter(self.modes.values()))
            def fa_e(q, k, v, **kw):  # the shapes the model's attention launches at
                key = str((q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3], v.shape[3]))
                note["fa"][key] = note["fa"].get(key, 0) + 1
                return e_fa0(q, k, v, **kw)
            def ssd_e(x, dA, B, C, chunk):  # (b, l, heads, hp, n, chunk, B's head stride)
                key = str((x.shape[0], x.shape[1], x.shape[2], x.shape[3], B.shape[3], chunk,
                           B.stride(2)))
                note["ssd"][key] = note["ssd"].get(key, 0) + 1
                return e_ssd0(x, dA, B, C, chunk=chunk)
            def run_e(self, state, batch, step):
                seen["state"] = state
                t0 = time.perf_counter()
                out = e_run0(self, state, batch, step)  # waits for the device
                seen["step_s"] = time.perf_counter() - t0
                return out
            def fault_e(step):
                torch.cuda.synchronize()
                if step == 0:  # the step starts: its counts and its peak from here
                    e_fa_reset()
                    e_ssd_cuda.launches = 0
                    e_ep.HOST_STAGED.update(calls=0, bytes=0)
                    seen["dropped"] = e_moe.DROPPED["assignments"]
                    torch.cuda.reset_peak_memory_stats()
            def hook_e(n):  # the grads are pending: their global norm, once
                if n == 1 and "norm" not in seen:
                    p = seen["state"]["pending"]
                    seen["norm"] = float(p["norm"] if "norm" in p else global_norm(p["grads"]))
            e_fa.flash_attention, e_ssm._ssd_fast = fa_e, ssd_e
            e_part.gather_group, e_part.Partition.__init__ = gather_e, init_e
            e_train.FaultTolerantRunner.run_step = run_e
            clear_hints()
            t_run = time.perf_counter()
            try:
                e_out = e_train.main(["--arch", e_cfg.name, *(["--mesh", "2,2"] if meshed else []),
                                      *e_spec["args"],
                                      *(["--seq", str(e_run["seq"])] if "seq" in e_run else [])],
                                     fault_hook=fault_e, update_hook=hook_e)
            finally:
                e_fa.flash_attention, e_ssm._ssd_fast = e_fa0, e_ssd0
                e_part.gather_group, e_part.Partition.__init__ = e_gather0, e_init0
                e_train.FaultTolerantRunner.run_step = e_run0
            params = list(seen["state"]["model"].parameters())
            e_res.append({
                "arch": e_run["arch"], "meshed": meshed, "rank": e_rank, "losses": e_out["losses"],
                "norm": seen["norm"], "step_s": seen["step_s"],
                "run_s": time.perf_counter() - t_run, "fa": note["fa"], "ssd": note["ssd"],
                "fa_launches": e_fa_cuda.launches,
                "fa_by_dim": {str(k): v for k, v in e_fa_cuda.launches_by_dim.items()},
                "ssd_launches": e_ssd_cuda.launches, "peak_bytes": torch.cuda.max_memory_allocated(),
                "staged": dict(e_ep.HOST_STAGED), "modes": note["modes"],
                "shapes": note["shapes"],
                "dropped": e_moe.DROPPED["assignments"] - seen["dropped"],
                "params": sum(p.numel() for p in params),
                "local_params": sum((p.to_local() if meshed else p).numel() for p in params)})
            del e_out, seen, params
            gc.collect()
            torch.cuda.empty_cache()
            Path(f"{e_spec['out']}.{e_rank}").write_text(json.dumps(e_res))
        dist.barrier()  # every rank's memory freed before the next run
    if e_run.get("f32"):  # the step functions in f32 from the same seed and batch
        from repro_torch.configs import ShapeConfig as e_Shape
        from repro_torch.data import SyntheticLM as e_Synth
        from repro_torch.data.pipeline import _place as e_place
        from repro_torch.launch import steps as e_steps
        from repro_torch.launch.mesh import make_mesh as e_make_mesh
        from repro_torch.models.model import Model as e_Model
        from repro_torch.optim import adamw as e_adamw
        from repro_torch.sharding.hints import hints_from_mesh as e_hints
        from repro_torch.sharding.specs import ShardingRules as e_Rules, batch_specs as e_bspecs
        e_a = dict(zip(e_spec["args"][::2], e_spec["args"][1::2]))
        e_b, e_s, e_seed = int(e_a["--batch"]), e_run.get("f32_seq", int(e_a["--seq"])), int(e_a["--seed"])
        e_np = e_Synth(e_cfg.vocab, seed=e_seed).batch(0, e_b, e_s)
        def e_f32():
            gen = torch.Generator(device="cuda").manual_seed(e_seed)
            return e_Model(e_cfg, generator=gen, device="cuda").float()
        e_32 = {"arch": e_run["arch"], "f32": True, "meshed": None, "rank": e_rank}
        if e_rank == 0:  # the unmeshed step
            e_m = e_f32()
            torch.cuda.synchronize()
            t_run = time.perf_counter()
            e_loss, e_g = e_steps.make_grads_fn(e_cfg)(e_m, {"tokens": torch.from_numpy(e_np["tokens"]).cuda()})
            e_32["plain"] = {"loss": float(e_loss), "norm": float(global_norm(e_g)),
                             "s": time.perf_counter() - t_run}
            del e_m, e_g
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
        e_mesh, e_rules, e_opt = e_make_mesh((2, 2), ("data", "model"), device_type="cuda"), e_Rules(), e_adamw(1e-4)
        e_hints(e_mesh, e_rules)
        try:  # the partitioned step on the 2x2 mesh
            e_st = e_steps.distribute_state({"model": e_f32(), "opt": e_opt.init({})}, e_cfg, e_mesh, e_rules)
            e_fn = e_steps.make_sharded_train_step(e_cfg, e_opt, e_mesh, agree=e_steps.make_agree("cuda"),
                                                   rules=e_rules)
            e_placed = e_place(e_np, e_mesh, e_bspecs(e_cfg, e_Shape("f32", e_s, e_b, "train"), e_mesh,
                                                      e_rules), "cuda")
            torch.cuda.synchronize()
            t_run = time.perf_counter()
            e_loss, e_g, e_norm = e_fn.grads(e_st["model"], e_placed)
            torch.cuda.synchronize()
            e_32["mesh"] = {"loss": float(e_loss), "norm": float(e_norm), "s": time.perf_counter() - t_run}
            del e_st, e_fn, e_g
        finally:
            clear_hints()
        gc.collect()
        torch.cuda.empty_cache()
        e_32["seq"] = e_s
        e_res.append(e_32)
        Path(f"{e_spec['out']}.{e_rank}").write_text(json.dumps(e_res))
        dist.barrier()
"""
# (g) on the same ranks after (f), or on its own: partitioned serving on
# --mesh 2,2 (``make_sharded_prefill_step``, ``make_sharded_serve_step``),
# each run of g_spec.json (beside the script) against the unmeshed steps on
# rank 0 (the others wait): the prefill's last-position logits, and a wave
# of prompts fed one token at a time then greedy steps, every step's logits
# and token; each rank's flash calls by local shape (q rows, q positions, q
# heads, cache positions, kv heads, d, dv, lse), empty-shard calls, decode
# step ms and peak memory
G_RUN = """
import collections as g_col, dataclasses as g_dc, gc as g_gc, json as g_json, time as g_time
from pathlib import Path as g_Path
import torch
import torch.distributed as dist
from repro_torch import kernels as g_kernels
from repro_torch.configs import ShapeConfig as g_Shape, get_config as g_config
from repro_torch.kernels import flash_attention as g_fa
from repro_torch.kernels.flash_attention.flash_attention import (flash_attention_cuda as g_fa_cuda,
                                                              reset_launches as g_fa_reset)
from repro_torch.launch import steps as g_steps
from repro_torch.launch.mesh import make_mesh as g_make_mesh
from repro_torch.launch.specs import row_dp as g_row_dp
from repro_torch.models import init_cache as g_init_cache, moe_ep as g_ep
from repro_torch.models.model import Model as g_Model, decode_step as g_decode_step
from repro_torch.sharding import partition as g_part
from repro_torch.sharding.place import from_full as g_from_full, local_index as g_index
from repro_torch.sharding.specs import (P as g_P, ShardingRules as g_Rules,
                                        batch_specs as g_bspecs, placements as g_pl)
if not dist.is_initialized():  # on its own
    dist.init_process_group("gloo", init_method="env://")
    torch.cuda.set_device(0)
g_rank = dist.get_rank()
g_spec = g_json.loads(g_Path(__file__).with_name("g_spec.json").read_text())
g_kernels.enable_kernels(True)
g_mesh = g_make_mesh((2, 2), ("data", "model"), device_type="cuda")
g_fa0, g_note, g_res = g_fa.flash_attention, {}, []
def g_fa_noted(q, k, v, **kw):  # the local shapes the model's attention launches at
    key = str((q.shape[0], q.shape[1], q.shape[2], k.shape[1], k.shape[2], q.shape[3],
               v.shape[3], bool(kw.get("return_lse"))))
    g_note[key] = g_note.get(key, 0) + 1
    if kw.get("kv_len") == 0:
        g_note["empty shard"] = g_note.get("empty shard", 0) + 1
    return g_fa0(q, k, v, **kw)
def g_model(cfg, f32, seed):
    m = g_Model(cfg, generator=torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    return m.float() if f32 else m
def g_cache(cfg, b, L, f32):
    return [{n: (t.float() if f32 else t) for n, t in layer.items()}
            for layer in g_init_cache(cfg, b, L, "cuda")]
def g_whole(t, local=None):  # a DTensor's whole value on every rank, by way of host memory
    loc = t.to_local().float().cpu() if local is None else local  # local: blocks stacked over steps
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, (g_index(t.shape, g_mesh, t.placements), loc))
    out = torch.empty((*loc.shape[:loc.dim() - t.dim()], *t.shape))
    for sl, part in parts:
        out[(..., *sl)] = part
    return out
def g_timed(fn):
    torch.cuda.synchronize()
    t0 = g_time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (g_time.perf_counter() - t0) * 1e3
g_fa.flash_attention = g_fa_noted
for g_run in g_spec["runs"]:
    g_full = g_config(g_run["arch"])
    g_cfg = g_dc.replace(g_full, n_layers=g_run.get("n_layers") or g_full.n_layers)
    g_f32, g_rules = g_run["f32"], g_Rules(**g_run.get("rules", {}))
    g_b, g_p, g_new, g_L = g_run["rows"], g_run["prompt"], g_run["new"], g_run["max_len"]
    # the tokens' rows over the dp dims where they divide (the cell's P(bdp, None))
    g_rows_pl = g_pl(g_P(g_row_dp(g_Shape("g", g_L, g_b, "decode"), g_mesh, g_rules), None), g_mesh)
    g_gen = torch.Generator().manual_seed(g_spec["seed"])
    g_prompt = torch.randint(0, g_cfg.vocab, (g_b, g_p), generator=g_gen).cuda()
    g_pb, g_ps = g_run.get("prefill") or (0, 0)
    g_ptoks = torch.randint(0, g_cfg.vocab, (g_pb, g_ps), generator=g_gen).cuda() if g_pb else None
    g_ref = g_Path(g_spec["out"]).with_name(f"g_ref_{g_run['label']}.pt")
    if g_rank == 0:  # the unmeshed steps
        m = g_model(g_cfg, g_f32, g_spec["seed"])
        torch.cuda.reset_peak_memory_stats()
        want = {"prefill": None}
        if g_pb:
            want["prefill"] = g_steps.make_prefill_step(g_cfg)(m, {"tokens": g_ptoks}).float().cpu()
        cache, fed, lg, ms, tok = g_cache(g_cfg, g_b, g_L, g_f32), [], [], [], g_prompt[:, :1]
        torch.cuda.reset_peak_memory_stats()
        for pos in range(g_p + g_new):
            (logits, cache), t = g_timed(lambda: g_decode_step(g_cfg, m, cache, tok, pos))
            fed.append(tok.cpu())
            lg.append(logits.float().cpu())
            ms.append(t)
            tok = g_prompt[:, pos + 1:pos + 2] if pos + 1 < g_p else logits.argmax(-1, keepdim=True)
        want.update(fed=torch.stack(fed), logits=torch.stack(lg), ms=ms,
                    peak=torch.cuda.max_memory_allocated())
        torch.save({"fed": want["fed"]}, g_ref)  # rank 0 keeps the rest
        del m, cache, logits
        g_gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    want = want if g_rank == 0 else torch.load(g_ref)
    g_base = torch.cuda.memory_allocated()  # what the process holds before (g)'s run
    dm = g_steps.distribute_params(g_model(g_cfg, g_f32, g_spec["seed"]), g_cfg, g_mesh, g_rules)
    g_gc.collect()
    torch.cuda.empty_cache()
    rec = {"label": g_run["label"], "rank": g_rank}
    g_note.clear()
    g_fa_reset()
    g_ep.HOST_STAGED.update(calls=0, bytes=0)
    if g_pb:  # the meshed prefill: this rank's sequence shard of its rows
        pre = g_steps.make_sharded_prefill_step(g_cfg, g_mesh, g_rules)
        sh = g_pl(g_bspecs(g_cfg, g_Shape("g", g_ps, g_pb, "prefill"), g_mesh, g_rules)["tokens"],
                  g_mesh)
        out, rec["prefill_ms"] = g_timed(lambda: pre(dm, {"tokens": g_from_full(g_ptoks, g_mesh, sh)}))
        got = g_whole(out)
        if g_rank == 0:
            rec["prefill_gap"] = float((got - want["prefill"]).abs().max())
            rec["prefill_max"] = float(want["prefill"].abs().max())
        rec["prefill_modes"] = dict(g_col.Counter(pre.partition.modes.values()))
        if g_run.get("fault"):  # planted: each rank keeps its own partial sums
            red = g_part._sum_, g_part._scatter_flat
            def g_own(x, group, n):
                c, j = x.numel() // n, dist.get_rank(group)
                return x.contiguous().view(-1)[j * c:(j + 1) * c].clone()
            g_part._sum_, g_part._scatter_flat = (lambda x, group, op=None: x), g_own
            try:
                bad = pre(dm, {"tokens": g_from_full(g_ptoks, g_mesh, sh)})
            finally:
                g_part._sum_, g_part._scatter_flat = red
            bad = g_whole(bad)
            if g_rank == 0:
                rec["prefill_fault_gap"] = float((bad - want["prefill"]).abs().max())
        del out
    rec["prefill_staged"] = dict(g_ep.HOST_STAGED)
    cache = g_steps.distribute_cache(g_cache(g_cfg, g_b, g_L, g_f32), g_cfg, g_mesh, g_rules)
    serve = g_steps.make_sharded_serve_step(g_cfg, g_mesh, g_rules)
    g_fa_reset()
    g_note.clear()
    g_ep.HOST_STAGED.update(calls=0, bytes=0)
    torch.cuda.reset_peak_memory_stats()
    lgs, toks, ms = [], [], []
    for pos in range(g_p + g_new):
        t_in = g_from_full(want["fed"][pos].cuda(), g_mesh, g_rows_pl)
        (nt, cache, lg), t = g_timed(lambda: serve(dm, cache, t_in, pos, logits=True))
        lgs.append(lg.to_local().float().cpu())
        toks.append(nt.to_local().cpu())
        ms.append(t)
    lgs, toks = g_whole(lg, torch.stack(lgs)), g_whole(nt, torch.stack(toks).float())[..., 0].long()
    rec.update(peak_bytes=torch.cuda.max_memory_allocated() - g_base, base_bytes=g_base,
               fa=dict(g_note),
               fa_launches=g_fa_cuda.launches,
               fa_by_dim={str(k): v for k, v in g_fa_cuda.launches_by_dim.items()},
               staged=dict(g_ep.HOST_STAGED), cache=serve.partition.cache_kinds(),
               modes=dict(g_col.Counter(serve.partition.modes.values())), ms=ms,
               local_params=sum(p.to_local().numel() for p in dm.parameters()),
               params=sum(p.numel() for p in dm.parameters()))
    if g_run.get("fault"):  # the last step again, planted: each rank keeps its partial sums
        red = g_part._sum_
        g_part._sum_ = lambda x, group, op=None: x
        try:
            t_in = g_from_full(want["fed"][-1].cuda(), g_mesh, g_rows_pl)
            bad = serve(dm, cache, t_in, g_p + g_new - 1, logits=True)[2]
        finally:
            g_part._sum_ = red
        bad = g_whole(bad)
        if g_rank == 0:
            rec["decode_fault_gap"] = float((bad - want["logits"][-1]).abs().max())
    if g_rank == 0:
        got, ref = lgs, want["logits"]
        top = ref.abs().amax(dim=-1)  # (steps, rows)
        rec["gap"] = float((got - ref).abs().max())
        rec["rel_gap"] = float(((got - ref).abs().amax(dim=-1) / top).max())
        top2 = ref.topk(2, dim=-1).values
        decisive = (top2[..., 0] - top2[..., 1]) > g_spec["f32_tol"] * top
        mine = toks
        rec["decisive"] = [int(decisive.sum()), decisive.numel()]
        rec["tokens_equal"] = bool(torch.equal(mine[decisive], ref.argmax(-1)[decisive]))
        rec["tokens_agree"] = float((mine == ref.argmax(-1)).float().mean())
        rec.update(plain_ms=want["ms"], plain_peak=want["peak"], logit_max=float(top.max()))
    dist.barrier()
    if g_rank == 0:
        g_ref.unlink()
    g_res.append(rec)
    g_Path(f"{g_spec['out']}.{g_rank}").write_text(g_json.dumps(g_res))
    del dm, cache, serve, lgs, want
    g_gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
g_fa.flash_attention = g_fa0
"""
# (h1) on the same ranks after (g): the sequence split over "model" under
# fsdp_only (h_spec.json beside the script). For each of H_TRAIN's runs, a
# model at full width cut in depth, one 2 x 2048 step of
# make_sharded_train_step with ShardingRules(fsdp_only=True): the 2 rows do
# not divide over the 4 ranks' pool, so a row a "data" rank and the
# sequence over "model"; attention (MLA: its latent and rope key) context
# parallel (this rank's 1024 queries against the 2048 gathered keys,
# q_offset its shard's start), the MLP and the MoE per token (the MoE
# counted over the global batch), the weights FSDP over both dims and
# gathered per unit. Against the unmeshed step on rank 0: the loss, the
# grads' global norm and the norm of the grads of the leaves that make the
# gathered keys; the flash calls by local shape and q_offset; then, for a
# run with ``fault``, the step again with the gather's backward
# reduce-scatter skipped (planted: each rank keeps its own queries' partial
# grads of its keys)
H_RUN = """
import collections as h_col, dataclasses as h_dc, gc as h_gc, json as h_json, math as h_math
import time as h_time
from pathlib import Path as h_Path
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard as h_Shard
from repro_torch import kernels as h_kernels
from repro_torch.configs import ShapeConfig as h_Shape, get_config as h_config
from repro_torch.data import SyntheticLM as h_Synth
from repro_torch.data.pipeline import _place as h_place
from repro_torch.kernels import flash_attention as h_fa
from repro_torch.kernels.flash_attention.flash_attention import (flash_attention_cuda as h_fa_cuda,
                                                              reset_launches as h_fa_reset)
from repro_torch.launch import steps as h_steps
from repro_torch.launch.mesh import make_mesh as h_make_mesh
from repro_torch.models import moe as h_moe, moe_ep as h_ep
from repro_torch.models.model import Model as h_Model
from repro_torch.optim import adamw as h_adamw
from repro_torch.optim.optimizers import global_norm as h_gnorm
from repro_torch.sharding import partition as h_part
from repro_torch.sharding.hints import clear_hints as h_clear, hints_from_mesh as h_hints
from repro_torch.sharding.specs import ShardingRules as h_Rules, batch_specs as h_bspecs
if not dist.is_initialized():  # on its own
    dist.init_process_group("gloo", init_method="env://")
    torch.cuda.set_device(0)
h_rank = dist.get_rank()
h_spec = h_json.loads(h_Path(__file__).with_name("h_spec.json").read_text())
h_kernels.enable_kernels(True)
h_mesh = h_make_mesh((2, 2), ("data", "model"), device_type="cuda")
h_rules = h_Rules(fsdp_only=True)
h_note, h_fa0 = {}, h_fa.flash_attention
def h_fa_noted(q, k, v, **kw):  # (rows, q positions, q heads, keys, kv heads, d, dv, q_offset)
    key = str((q.shape[0], q.shape[1], q.shape[2], k.shape[1], k.shape[2], q.shape[3],
               v.shape[3], kw.get("q_offset", 0)))
    h_note[key] = h_note.get(key, 0) + 1
    return h_fa0(q, k, v, **kw)
def h_timed(fn):
    torch.cuda.synchronize()
    t0 = h_time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, h_time.perf_counter() - t0
h_out = {"rank": h_rank, "runs": {}}
for h_run in h_spec["runs"]:
    h_cfg = h_dc.replace(h_config(h_run["arch"]), n_layers=h_run["n_layers"])
    h_np = h_Synth(h_cfg.vocab, seed=h_spec["seed"]).batch(0, h_run["batch"], h_run["seq"])
    def h_model():
        gen = torch.Generator(device="cuda").manual_seed(h_spec["seed"])
        return h_Model(h_cfg, generator=gen, device="cuda")
    def h_kv(grads, model=None):  # the norm of the key leaves' grads (slices: summed over ranks)
        sq = torch.zeros((), dtype=torch.float32, device="cuda")
        params = dict(model.named_parameters()) if model is not None else {}
        for k, g in grads.items():
            if k.endswith(tuple(h_run["kv"])):
                reps = 1
                if model is not None:  # the ranks that hold the same slice
                    reps = h_mesh.size() // h_math.prod(h_mesh.size(i) for i, pl in enumerate(
                        params[k].placements) if isinstance(pl, h_Shard))
                sq = sq + torch.sum(torch.square(g.float())) / reps
        if model is not None:
            dist.all_reduce(sq)
        return float(torch.sqrt(sq))
    h_res = {}
    if h_rank == 0:  # the unmeshed step
        h_m = h_model()
        (h_loss, h_g), h_s = h_timed(lambda: h_steps.make_grads_fn(h_cfg)(
            h_m, {"tokens": torch.from_numpy(h_np["tokens"]).cuda()}))
        h_res["plain"] = {"loss": float(h_loss), "norm": float(h_gnorm(h_g)), "kv": h_kv(h_g),
                          "s": h_s}
        del h_m, h_g
        h_gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    h_hints(h_mesh, h_rules)
    try:
        h_opt = h_adamw(1e-4)
        h_st = h_steps.distribute_state({"model": h_model(), "opt": h_opt.init({})}, h_cfg,
                                        h_mesh, h_rules)
        h_fn = h_steps.make_sharded_train_step(h_cfg, h_opt, h_mesh,
                                               agree=h_steps.make_agree("cuda"), rules=h_rules)
        h_placed = h_place(h_np, h_mesh, h_bspecs(h_cfg, h_Shape("h", h_run["seq"], h_run["batch"],
                                                                "train"), h_mesh, h_rules), "cuda")
        h_gc.collect()
        torch.cuda.empty_cache()
        h_fa.flash_attention = h_fa_noted
        h_note.clear()  # the counts from here: the main path's step
        h_fa_reset()
        h_ep.HOST_STAGED.update(calls=0, bytes=0)
        h_drops = h_moe.DROPPED["assignments"]
        torch.cuda.reset_peak_memory_stats()
        (h_loss, h_g, h_norm), h_s = h_timed(lambda: h_fn.grads(h_st["model"], h_placed))
        h_res.update(mesh={"loss": float(h_loss), "norm": float(h_norm),
                           "kv": h_kv(h_g, h_st["model"]), "s": h_s},
                     fa=dict(h_note), fa_launches=h_fa_cuda.launches,
                     fa_by_dim={str(k): v for k, v in h_fa_cuda.launches_by_dim.items()},
                     staged=dict(h_ep.HOST_STAGED), peak_bytes=torch.cuda.max_memory_allocated(),
                     modes=dict(h_col.Counter(h_fn.partition.modes.values())),
                     sp=h_fn.partition.sp, drops=h_moe.DROPPED["assignments"] - h_drops,
                     local_params=sum(p.to_local().numel() for p in h_st["model"].parameters()),
                     params=sum(p.numel() for p in h_st["model"].parameters()))
        h_fa.flash_attention = h_fa0
        del h_g
        if h_run.get("fault"):
            h_scatter = h_part._scatter_dim
            def h_skipped(x, dim, group, n):  # planted: this rank's own partial grads of its keys
                c = x.shape[dim] // n
                return x.narrow(dim, dist.get_rank(group) * c, c).contiguous()
            h_part._scatter_dim = h_skipped
            try:
                h_loss, h_g, h_norm = h_fn.grads(h_st["model"], h_placed)
            finally:
                h_part._scatter_dim = h_scatter
            h_res["fault"] = {"loss": float(h_loss), "norm": float(h_norm),
                              "kv": h_kv(h_g, h_st["model"])}
            del h_g
        del h_st, h_fn, h_placed
    finally:
        h_fa.flash_attention = h_fa0
        h_clear()
    h_gc.collect()
    torch.cuda.empty_cache()
    h_out["runs"][h_run["arch"]] = h_res
    dist.barrier()
h_Path(f"{h_spec['out']}.{h_rank}").write_text(h_json.dumps(h_out))
dist.barrier()
"""
PG_END = "dist.destroy_process_group()\n"


def _torchrun(stamp, label: str, root: Path, nproc: int, script: str, args: list,
              timeout: float = DIST_TIMEOUT) -> float:
    """Run ``script`` (written under ``root``) on ``nproc`` ranks through
    ``python -m torch.distributed.run --standalone``; its wall seconds."""
    path = root / f"{label}.py"
    path.write_text(script)
    log = root / f"{label}.log"
    t0 = time.time()
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                                 "--nproc-per-node", str(nproc), str(path), *args],
                                cwd=ROOT, env=_child_env(), stdout=f, stderr=subprocess.STDOUT)
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:  # SIGTERM: the launcher stops its ranks (each a
            proc.send_signal(signal.SIGTERM)  # session of its own), then exits
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            raise RuntimeError(f"distributed {label}: stopped with its ranks after {timeout} s; "
                               f"its log ends:\n{log.read_text()[-3000:]}") from None
    check(proc.returncode == 0, f"distributed {label}: exit {proc.returncode}; its log ends:\n"
                                f"{log.read_text()[-3000:]}")
    return time.time() - t0


def phase_distributed(stamp, ft: dict) -> dict:
    """One launch of 4 gloo ranks sharing the card: (b) the expert-parallel
    MoE at qwen2-moe's width against the port's MoE, (c) the compressed
    all-reduce, (d) train --mesh 2,2 of qwen3-0.6b against train_ft's
    straight run, (e) train --mesh 2,2 of zamba2-2.7b (meshed only) and
    deepseek-v2-lite and (f) of xlstm-1.3b, each cut in depth, against
    their unmeshed steps, (g) partitioned serving, (h1) the fsdp_only
    steps with the sequence over "model". Returns (d)'s flash launches
    (rank 0's), step time and rank 0's peak memory, under "e" each (e)
    run's launches at its local shapes (rank 0's), under "f" (f)'s gaps,
    under "g" (g)'s records and under "h" (h1)'s launches by run and
    q_offset."""
    t = TRAIN_FT
    cfg = get_config(t["arch"])
    root = ROOT / "chiprun_out" / "distributed"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    free_dev, _ = torch.cuda.mem_get_info()
    check(free_dev >= DIST_DEVICE_NEED, f"distributed: {free_dev / 2**30:.2f} GiB free on the "
                                        f"card, {DIST_DEVICE_NEED / 2**30:.0f} GiB needed")
    print(f"distributed: {free_dev / 2**30:.2f} GiB free on the card at the start")
    B, S = DIST_EP_X
    d_args = _ft_args(t, root, root, t["every"])
    d_args = d_args[:d_args.index("--ckpt-dir")] + ["--mesh", "2,2"]  # no checkpoints
    (root / "e_spec.json").write_text(json.dumps(
        {"runs": DIST_E + DIST_F, "args": DIST_E_ARGS, "out": str(root / "e.json")}))
    (root / "g_spec.json").write_text(json.dumps(
        {"runs": DIST_G, "seed": SEED, "f32_tol": DIST_G_F32_TOL, "out": str(root / "g.json")}))
    (root / "h_spec.json").write_text(json.dumps(
        {"runs": H_TRAIN, "seed": SEED, "out": str(root / "h.json")}))
    try:
        wall = _torchrun(stamp, "dist_run", root, 4, EP_RUN + E_RUN + G_RUN + H_RUN + PG_END,
                         [str(root / "ep.json"), str(SEED), str(B), str(S), str(DIST_EP_TIMED),
                          ",".join(map(str, DIST_EP_CF)), str(root / "tp.json"), str(DIST_STOP),
                          str(FT_KEPT), *d_args], timeout=DIST_TIMEOUT + DIST_E_TIMEOUT)
    finally:
        shutil.rmtree(FT_KEPT, ignore_errors=True)
    r = json.loads((root / "ep.json").read_text())
    moe_cfg = get_config("qwen2-moe-a2.7b")
    print(f"distributed (b) moe_apply_ep, qwen2-moe-a2.7b width (d {moe_cfg.d_model}, "
          f"{moe_cfg.n_routed_experts} experts top-{moe_cfg.top_k}, d_expert "
          f"{moe_cfg.d_expert}, {moe_cfg.n_shared_experts} shared), x ({B}, {S}, "
          f"{moe_cfg.d_model}) f32, 4 gloo ranks on cuda:0, mesh (1, 4): {r['e_loc']} experts "
          f"a rank; capacity_factor {r['cf']} (the first of {DIST_EP_CF} drop-free on both "
          f"paths): cap_send {r['cap_send']}, cap_own {r['cap_own']}")
    print(f"distributed (b) against the port's MoE: y max abs err {r['max_over_ranks'][0]:.3g} "
          f"(rtol = atol = {DIST_Y_TOL}); aux {r['aux'][0]:.8f} vs {r['aux'][1]:.8f} (rtol "
          f"{DIST_AUX_RTOL}); grads max abs err {r['max_over_ranks'][1]:.3g} (rtol = atol = "
          f"{DIST_GRAD_TOL}; largest grad {r['grad_max']:.4g}); all ranks [y, aux, grads, "
          f"residual, bound] {r['all_ranks_ok']}")
    check(r["all_ranks_ok"][:3] == [1, 1, 1], f"distributed (b): [y, aux, grads] within "
                                              f"tolerance on all ranks: {r['all_ranks_ok'][:3]}")
    print(f"distributed (b) gloo has no all-to-all for CUDA tensors: the layer copied "
          f"{r['staged']['calls']} collectives' buffers ({r['staged']['bytes'] / 1e6:.1f} MB) "
          f"to the host and back on rank 0")
    print(f"time [{stamp}] distributed (b) moe_apply_ep forward: {min(r['ep_ms']):.2f} ms "
          f"(min of {DIST_EP_TIMED}; slowest rank {r['max_over_ranks'][3]:.2f} ms; 4 ranks "
          f"share one card and exchange through host memory), all-to-all "
          f"{r['a2a_calls_fwd']} calls sending {r['a2a_bytes_fwd'] / 1e6:.1f} MB a rank; the "
          f"port's MoE on the whole x on one rank {min(r['moe_ms']):.2f} ms")
    print(f"distributed (c) make_compressed_allreduce over each rank's x grad and its "
          f"{r['e_loc']} experts' w_down grads: |mean - plain all_reduce mean| at most "
          f"{r['max_over_ranks'][2]:.3f} of the int8 bound (half the mean scale); residual "
          f"= g_eff - deq bit for bit: {bool(r['all_ranks_ok'][3])}; wire bytes "
          f"{r['wire'][0]:,} int8 + scales vs {r['wire'][1]:,} raw "
          f"({r['wire'][0] / r['wire'][1]:.4f})")
    check(r["all_ranks_ok"][3:] == [1, 1], f"distributed (c): [residual, bound] "
                                           f"{r['all_ranks_ok'][3:]}")

    # (d) train --mesh 2,2
    ranks = [json.loads((root / f"tp.json.{k}").read_text()) for k in range(4)]
    r0 = ranks[0]
    want = cfg.n_layers * 2 * DIST_STOP
    shape = (t["batch"] // 2, t["seq"], cfg.n_heads // 2, cfg.n_kv_heads // 2, cfg.head_dim)
    ref = ft["losses"][:DIST_STOP]
    gaps = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], ref)]
    print(f"distributed (d) train --mesh 2,2: 4 gloo ranks on cuda:0, {t['arch']} "
          f"{t['batch']} x {t['seq']}, train_ft's arguments and 12-step schedule ended before "
          f"step {DIST_STOP}; each rank holds {r0['local_params']:,} of {r0['params']:,} "
          f"parameters; flash attention launched at {r0['shapes']} (rows, positions, q heads, "
          f"kv heads, head dim)")
    print(f"distributed (d) losses: {' '.join(f'{x:.6f}' for x in r0['losses'])}; train_ft "
          f"straight: {' '.join(f'{x:.6f}' for x in ref)}; relative gaps "
          f"{' '.join(f'{g:.2e}' for g in gaps)} (limit {DIST_LOSS_RTOL})")
    check(all(r["losses"] == r0["losses"] for r in ranks) and len(r0["losses"]) == DIST_STOP,
          f"distributed (d): losses by rank {[r['losses'] for r in ranks]}")
    check(max(gaps) <= DIST_LOSS_RTOL, f"distributed (d): losses {r0['losses']} against {ref}")
    for r in ranks:
        check(r["launches"] == want and r["shapes"] == [list(shape)],
              f"distributed (d) rank {r['rank']}: {r['launches']} flash launches at "
              f"{r['shapes']}, not {cfg.n_layers} x 2 x {DIST_STOP} = {want} at {[list(shape)]}")
        check(not r["bad_shapes"], f"distributed (d) rank {r['rank']}: local shapes not by "
                                   f"param_specs: {r['bad_shapes'][:5]}")
        check(r["staged"]["calls"] > 0, f"distributed (d) rank {r['rank']}: no collective went "
                                        f"through the host")
    for r in ranks:
        check(r["restore_step"] == DIST_RESTORE and not r["restore_bad"],
              f"distributed (d) rank {r['rank']}: restore(shardings=) of train_ft's "
              f"step-{DIST_RESTORE} checkpoint (read step {r['restore_step']}): leaves differ "
              f"from the file's {r['restore_bad'][:5]}")
    local = " ".join(f"{r['restore_local']:,}" for r in ranks)
    secs = " ".join(f"{r['restore_s']:.2f}" for r in ranks)
    print(f"distributed (d): train_ft's straight-run step-{DIST_RESTORE} checkpoint restored "
          f"with shardings= onto the 2x2 mesh as cuda DTensors: {r0['restore_leaves']} leaves, "
          f"each rank's slices ({local} elements by rank) equal the file's bit for bit")
    print(f"time [{stamp}] distributed (d) restore(shardings=) by rank: {secs} s")
    step_s = statistics.median(r0["step_s"][1:] or r0["step_s"])
    print(f"distributed (d): on every rank {want} flash launches = {cfg.n_layers} x 2 x "
          f"{DIST_STOP} at one rank's heads; parameters, grads and m, v, master of all "
          f"{r0['n_leaves']} leaves of its param_specs slice's shape; gloo staged "
          f"{r0['staged']['calls']} all-gathers and reduce-scatters "
          f"({r0['staged']['bytes'] / 1e9:.2f} GB) through host memory on rank 0")
    print(f"time [{stamp}] distributed (d) step (median of steps 2-{DIST_STOP}, or step 1 "
          f"alone; 4 ranks sharing the card over gloo, collectives through host memory): "
          f"{step_s:.3f} s "
          f"({' '.join(f'{x:.3f}' for x in r0['step_s'])}); peak memory by rank "
          + " ".join(f"{r['peak_bytes'] / 2**30:.2f}" for r in ranks)
          + f" GiB (max_memory_allocated from step 0) vs train_ft's {ft['peak_bytes'] / 2**30:.2f}"
          f" GiB on one rank")
    e_ranks = [json.loads((root / f"e.json.{k}").read_text()) for k in range(4)]
    e = report_e(stamp, e_ranks)
    f = report_f(stamp, e_ranks)
    g = report_g(stamp, [json.loads((root / f"g.json.{k}").read_text()) for k in range(4)])
    h = report_h(stamp, [json.loads((root / f"h.json.{k}").read_text()) for k in range(4)])
    print(f"time [{stamp}] distributed (b)+(c)+(d)+(e)+(f)+(g)+(h) 4 processes: {wall:.1f} s wall")
    print(f"time [{stamp}] distributed phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": r0["launches"], "step_s": step_s, "peak_bytes": r0["peak_bytes"], "e": e,
            "f": f, "g": g, "h": h}


def report_h(stamp, ranks: list) -> dict:
    """(h1)'s checks, for each of H_TRAIN's runs: the fsdp_only step with
    the sequence over "model" against the unmeshed step on rank 0 (the
    loss, the grads' global norm and the norm of the grads of the leaves
    that make the gathered keys within DIST_LOSS_RTOL, in bf16), which the
    planted fault (the gather's backward reduce-scatter skipped) must break
    where the run has one; every rank's attention (MLA) in mode "context"
    and its MLP (MoE) in mode "tokens", with flash launched at its local
    shape (a row, its 1024 queries from q_offset 1024 * its "model"
    coordinate, the 2048 gathered keys), forward and recompute of each unit
    layer, once for a dense prefix layer. Returns {"arch q_offset":
    launches} (ranks 0 and 1: (data 0, model 0) and (data 0, model 1))
    for the kernels records."""
    out, gaps_by, fault_by = {}, {}, {}
    for t in H_TRAIN:
        cfg = dataclasses.replace(get_config(t["arch"]), n_layers=t["n_layers"])
        rs = [dict(r["runs"][t["arch"]], rank=r["rank"]) for r in ranks]
        r0, plain = rs[0], rs[0]["plain"]
        n = cfg.first_k_dense + 2 * n_units(cfg) * cfg.block_pattern.count("attn")
        if cfg.use_mla:
            d, dv, hkv = cfg.nope_head_dim + cfg.rope_head_dim, cfg.v_head_dim, cfg.n_heads
        else:
            d, dv, hkv = cfg.head_dim, cfg.head_dim, cfg.n_kv_heads
        for r in rs:
            start = (r["rank"] % 2) * (t["seq"] // 2)
            shape = (1, t["seq"] // 2, cfg.n_heads, t["seq"], hkv, d, dv, start)
            check(r["fa"] == {str(shape): n} and r["fa_launches"] == n,
                  f"distributed (h1) {t['arch']} rank {r['rank']}: flash calls {r['fa']} "
                  f"({r['fa_launches']} launches), not {n} at {shape}")
            check(r["modes"].get("context") == cfg.n_layers
                  and r["modes"].get("tokens") == cfg.n_layers and r["sp"] == 2,
                  f"distributed (h1) {t['arch']} rank {r['rank']}: modes {r['modes']}, sequence "
                  f"split {r['sp']}")
            check(r["staged"]["calls"] > 0, f"distributed (h1) {t['arch']} rank {r['rank']}: no "
                                            f"collective went through the host")
            check(all(r["mesh"][k] == r0["mesh"][k] for k in ("loss", "norm", "kv")),
                  f"distributed (h1) {t['arch']}: losses and norms by rank "
                  f"{[x['mesh'] for x in rs]}")
            out.setdefault(f"{t['arch']} {start}", r["fa_launches"])
        gaps = {k: abs(r0["mesh"][k] - plain[k]) / abs(plain[k]) for k in ("loss", "norm", "kv")}
        what = (f"{cfg.first_k_dense} dense MLA + {cfg.n_layers - cfg.first_k_dense} MLA + MoE of "
                f"{cfg.n_routed_experts} experts" if cfg.use_mla else f"{cfg.n_layers} layers")
        print(f"distributed (h1) fsdp_only train on --mesh 2,2: {cfg.name} cut to {what}, "
              f"{t['batch']} x {t['seq']} (a row a \"data\" rank, the sequence over \"model\"), "
              f"one step: {r0['local_params']:,} of {r0['params']:,} parameters a rank; modes "
              f"{r0['modes']}; flash calls by rank " + "; ".join(f"{r['fa']}" for r in rs)
              + " (rows, q positions, q heads, keys, kv heads, d, dv, q_offset: calls)"
              + (f"; {r0['drops']} assignments dropped past the capacity of the global batch"
                 if cfg.n_routed_experts else ""))
        line = (f"distributed (h1) {t['arch']} bf16 against the unmeshed step: loss "
                f"{r0['mesh']['loss']:.6f} vs {plain['loss']:.6f}, grads' global norm "
                f"{r0['mesh']['norm']:.6f} vs {plain['norm']:.6f}, the norm of "
                f"{'/'.join(t['kv'])}'s grads {r0['mesh']['kv']:.6f} vs {plain['kv']:.6f}: gaps "
                f"{gaps['loss']:.2e} {gaps['norm']:.2e} {gaps['kv']:.2e} (limit {DIST_LOSS_RTOL})")
        check(max(gaps.values()) <= DIST_LOSS_RTOL, f"distributed (h1) {t['arch']}: gaps {gaps}")
        if t.get("fault"):
            fault = {k: abs(r0["fault"][k] - plain[k]) / abs(plain[k])
                     for k in ("loss", "norm", "kv")}
            line += (f"; planted (the key gather's backward reduce-scatter skipped): gaps "
                     f"{fault['loss']:.2e} {fault['norm']:.2e} {fault['kv']:.2e}")
            check(max(fault.values()) > DIST_LOSS_RTOL,
                  f"distributed (h1) {t['arch']}: the planted fault passes the limit: {fault}")
            fault_by[t["arch"]] = fault
        print(line)
        print(f"time [{stamp}] distributed (h1) {t['arch']} grads: --mesh 2,2 fsdp_only "
              f"{r0['mesh']['s']:.3f} s (4 ranks sharing the card over gloo; "
              f"{r0['staged']['calls']} collectives, {r0['staged']['bytes'] / 1e9:.2f} GB through "
              f"host memory on rank 0), unmeshed {plain['s']:.3f} s; peak memory by rank "
              + " ".join(f"{r['peak_bytes'] / 2**30:.2f}" for r in rs) + " GiB")
        gaps_by[t["arch"]] = gaps
    return {"launches": out, "gaps": gaps_by, "fault": fault_by}


def report_g(stamp, ranks: list) -> dict:
    """(g)'s checks: each run's meshed prefill and decode wave against the
    unmeshed steps on rank 0: in f32 the greedy tokens equal wherever the
    unmeshed top two logits lie more than DIST_G_F32_TOL of the largest
    apart, and every logit within DIST_G_F32_TOL of its row's largest; in
    bf16 every logit within DIST_G_BF16_TOL, which the planted fault (row
    products left unreduced) breaks; every rank's flash calls at its local
    shapes (this rank's rows; its kv heads with its q heads, or every head
    over its sequence shard with the log-sum-exp), the cache's layout.
    (h2), under ``fsdp_only``: both rows on every rank, every head over a
    quarter of the cache's sequence; (h3), the xLSTM: no flash call, its
    recurrent caches by head and every mLSTM and sLSTM in mode "tp".
    Returns {label: rank 0's record} for the kernels records."""
    out = {}
    for run in DIST_G:
        mine = [next(r for r in rk if r["label"] == run["label"]) for rk in ranks]
        r0 = mine[0]
        cfg = get_config(run["arch"])
        cfg = dataclasses.replace(cfg, n_layers=run.get("n_layers") or cfg.n_layers)
        f32 = run["f32"]
        only = run.get("rules", {}).get("fsdp_only", False)
        heads = run.get("rules", {}).get("shard_cache_heads", True) and not cfg.use_mla and (
            cfg.n_kv_heads % 2 == 0) and not only
        rows, L = run["rows"] // 2, run["max_len"]
        if cfg.use_mla:
            d, dv, hq, hkv = cfg.nope_head_dim + cfg.rope_head_dim, cfg.v_head_dim, cfg.n_heads, cfg.n_heads
        else:
            d = dv = cfg.head_dim
            hq, hkv = cfg.n_heads, cfg.n_kv_heads
        layers = cfg.n_layers - sum(n_units(cfg) for k in cfg.block_pattern if k != "attn")
        if only:  # every row on every rank; the sequence over both dims
            want, kind = (run["rows"], 1, hq, L // 4, hkv, d, dv, True), {"sequence over dp"}
        elif heads:
            want, kind = (rows, 1, hq // 2, L, hkv // 2, d, dv, False), {"heads"}
        else:
            want, kind = (rows, 1, hq, L // 2, hkv, d, dv, True), {"sequence"}
        if not layers:  # the xLSTM: recurrent caches by head, conv windows by channel
            want, kind = None, {"heads", "channels"}
        steps_ = run["prompt"] + run["new"]
        for r in mine:
            fa = {k: v for k, v in r["fa"].items() if k != "empty shard"}
            check(fa == ({str(want): layers * steps_} if layers else {})
                  and r["fa_launches"] == layers * steps_,
                  f"distributed (g) {run['label']} rank {r['rank']}: flash calls {r['fa']} "
                  f"({r['fa_launches']} launches), not {layers * steps_} at {want}")
            check(r["staged"]["calls"] > 0, f"distributed (g) {run['label']} rank {r['rank']}: "
                                            f"no collective went through the host")
        check(set(r0["cache"]) == kind, f"distributed (g) {run['label']}: cache {r0['cache']}")
        if not layers:
            check(r0["modes"].get("tp") == cfg.n_layers,
                  f"distributed (g) {run['label']}: modes {r0['modes']}: not every mLSTM and "
                  f"sLSTM on its heads")
        kind = ", ".join(sorted(kind))
        # a sequence shard holds no key until the prompt passes it
        empty = sum(r.get("fa", {}).get("empty shard", 0) for r in mine)
        if layers and not heads:
            check(empty > 0, f"distributed (g) {run['label']}: no step had an empty shard")
        tol = DIST_G_F32_TOL if f32 else DIST_G_BF16_TOL
        gap = r0["rel_gap"] if f32 else r0["gap"]
        dec = r0["decisive"]
        print(f"distributed (g) {run['label']}: {cfg.name} ({cfg.n_layers} layers) "
              f"{'f32' if f32 else 'bf16'} on --mesh 2,2, the cache by {kind} ({r0['cache']}), "
              f"modes {r0['modes']}; {r0['local_params']:,} of {r0['params']:,} parameters a rank; "
              f"a wave of {run['rows']} prompts of {run['prompt']} tokens fed one at a time, then "
              f"{run['new']} greedy steps, cache {L}: every rank's flash calls {r0['fa']} (rows, "
              f"q positions, q heads, cache positions, kv heads, d, dv, lse: calls; "
              f"{empty} calls on an empty shard over the 4 ranks)")
        print(f"distributed (g) {run['label']}: logits against the unmeshed steps' on rank 0: "
              f"max |gap| {r0['gap']:.3g} (of the largest: {r0['rel_gap']:.3g}; limit {tol}"
              f"{' of the largest' if f32 else ' absolute'}; |logit| max {r0['logit_max']:.3g}); "
              f"greedy tokens equal on {dec[0]} of {dec[1]} decisive (row, step)s: "
              f"{r0['tokens_equal']} (all: {r0['tokens_agree']:.1%})")
        check(gap <= tol, f"distributed (g) {run['label']}: logit gap {gap:.3g} > {tol}")
        if f32:
            check(r0["tokens_equal"] and dec[0] >= 0.9 * dec[1],
                  f"distributed (g) {run['label']}: tokens {r0['tokens_equal']}, decisive {dec}")
        if "prefill_gap" in r0:
            ptol = DIST_G_F32_TOL * r0["prefill_max"] if f32 else DIST_G_BF16_TOL
            print(f"distributed (g) {run['label']}: prefill {run['prefill'][0]} x "
                  f"{run['prefill'][1]} tokens, last-position logits gathered: max |gap| "
                  f"{r0['prefill_gap']:.3g} (limit {ptol:.3g}; |logit| max "
                  f"{r0['prefill_max']:.3g}), modes {r0['prefill_modes']}")
            check(r0["prefill_gap"] <= ptol, f"distributed (g) {run['label']}: prefill gap "
                                             f"{r0['prefill_gap']:.3g} > {ptol:.3g}")
        if run.get("fault"):
            print(f"distributed (g) {run['label']}: planted fault (every all-reduce and "
                  f"reduce-scatter skipped: each rank keeps its own partial sums): prefill gap {r0['prefill_fault_gap']:.3g}, decode gap "
                  f"{r0['decode_fault_gap']:.3g}, against the limit {tol}")
            check(min(r0["prefill_fault_gap"], r0["decode_fault_gap"]) > tol,
                  f"distributed (g) {run['label']}: the planted fault passes the limit")
        meshed_ms = statistics.median(r0["ms"][run["prompt"]:])
        plain_ms = statistics.median(r0["plain_ms"][run["prompt"]:])
        print(f"time [{stamp}] distributed (g) {run['label']} decode step (median of the "
              f"{run['new']} greedy steps, host clock, synced): --mesh 2,2 {meshed_ms:.2f} ms "
              f"(4 ranks sharing the card over gloo; {r0['staged']['calls']} collectives, "
              f"{r0['staged']['bytes'] / 1e6:.1f} MB through host memory on rank 0 in the wave), "
              f"unmeshed {plain_ms:.2f} ms; peak memory by rank "
              + " ".join(f"{r['peak_bytes'] / 2**30:.3f}" for r in mine)
              + f" GiB above what each held before the run ({r0['base_bytes'] / 2**30:.3f} GiB on "
              f"rank 0), unmeshed {r0['plain_peak'] / 2**30:.3f} GiB in all"
              + (f"; prefill --mesh 2,2 {r0['prefill_ms']:.1f} ms" if "prefill_ms" in r0 else ""))
        out[run["label"]] = {**r0, "shape": want, "empty": empty, "meshed_ms": meshed_ms,
                             "plain_ms_median": plain_ms}
    return out


def report_f(stamp, ranks: list) -> dict:
    """(f)'s checks: xlstm-1.3b's --mesh 2,2 step against its unmeshed step
    (the loss within DIST_LOSS_RTOL; with ``f32``, the step functions' loss
    and grads' global norm in f32 within it, each bf16 norm's gap to the
    f32 one printed; else the bf16 norm within it), every mLSTM and sLSTM on 2 of its
    4 heads on every rank (mode "tp", none whole), the compute shapes of
    the watched leaves, collectives through the host. No kernel lies on
    xLSTM's path."""
    out = {}
    for run in DIST_F:
        full = get_config(run["arch"])
        cfg = dataclasses.replace(full, n_layers=run["n_layers"])
        mine = [r for rk in ranks for r in rk if r["arch"] == run["arch"]]
        mesh = [r for r in mine if r["meshed"]]
        plain = next(r for r in mine if r["meshed"] is False and r["rank"] == 0)
        check(len(mesh) == 4 and all(r["losses"] == mesh[0]["losses"] and r["norm"] == mesh[0]["norm"]
                                     for r in mesh),
              f"distributed (f) {run['arch']}: losses / norms by rank "
              f"{[(r['losses'], r['norm']) for r in mesh]}")
        m0 = mesh[0]
        loss_gap = abs(m0["losses"][0] - plain["losses"][0]) / abs(plain["losses"][0])
        norm_gap = abs(m0["norm"] - plain["norm"]) / abs(plain["norm"])
        d, di, nh, h = cfg.d_model, cfg.d_inner, cfg.n_heads, 2  # 2 "model" ranks
        hd, ffw = d // nh, int(round(4 * d / 3 / 64)) * 64
        want = {"blocks.0.core.wq.w": [di, di // h], "blocks.0.core.w_i.w": [d, nh // h],
                "blocks.0.core.up.w": [d, 2 * di // h], "blocks.5.core.r": [4, nh // h, hd, hd],
                "blocks.5.core.wx.w": [d, 4 * d // h], "blocks.5.core.ffn_up.w": [d, ffw // h]}
        for r in mesh:
            check(r["shapes"] == want, f"distributed (f) {run['arch']} rank {r['rank']}: compute "
                                       f"shapes {r['shapes']}, not {want}")
            check(r["modes"].get("tp") == cfg.n_layers and not r["modes"].get("whole"),
                  f"distributed (f) {run['arch']} rank {r['rank']}: modes {r['modes']}: not every "
                  f"mLSTM and sLSTM on its heads")
            check(r["staged"]["calls"] > 0, f"distributed (f) {run['arch']} rank {r['rank']}: no "
                                            f"collective went through the host")
        print(f"distributed (f) train --mesh 2,2 {run['arch']} at full width cut to "
              f"{cfg.n_layers} layers ({cfg.block_pattern.count('mlstm')} mLSTM + "
              f"{cfg.block_pattern.count('slstm')} sLSTM of {nh} heads: {nh // h} a rank, mode "
              f"\"tp\"), {DIST_E_ARGS[DIST_E_ARGS.index('--batch') + 1]} x "
              f"{run.get('seq', DIST_E_ARGS[DIST_E_ARGS.index('--seq') + 1])}, one step: "
              f"{m0['local_params']:,} of "
              f"{m0['params']:,} parameters a rank; modes {m0['modes']}; compute shapes on every "
              f"rank {m0['shapes']}")
        print(f"distributed (f) {run['arch']} bf16: loss {m0['losses'][0]:.6f} against the "
              f"unmeshed step's {plain['losses'][0]:.6f} (gap {loss_gap:.2e}; limit "
              f"{DIST_LOSS_RTOL}), grads' global norm {m0['norm']:.6f} against {plain['norm']:.6f} "
              f"(gap {norm_gap:.2e})")
        check(loss_gap <= DIST_LOSS_RTOL,
              f"distributed (f) {run['arch']}: loss gap {loss_gap:.3g}")
        if run.get("f32"):
            f32 = next(r for r in ranks[0] if r["arch"] == run["arch"] and r.get("f32"))
            p32, m32 = f32["plain"], f32["mesh"]
            gaps32 = [abs(m32[k] - p32[k]) / abs(p32[k]) for k in ("loss", "norm")]
            # each bf16 step's grad norm against the f32 step's
            floor = abs(plain["norm"] - p32["norm"]) / p32["norm"]
            mesh16 = abs(m0["norm"] - p32["norm"]) / p32["norm"]
            print(f"distributed (f) {run['arch']} f32 (the step functions, same seed and batch): "
                  f"--mesh 2,2 loss {m32['loss']:.6f} and grads' global norm {m32['norm']:.6f} "
                  f"against the unmeshed step's {p32['loss']:.6f} and {p32['norm']:.6f} (gaps "
                  f"{gaps32[0]:.2e}, {gaps32[1]:.2e}; limit {DIST_LOSS_RTOL}); the bf16 norms "
                  f"against the f32 norm: unmeshed {floor:.2e}, --mesh 2,2 {mesh16:.2e} (bf16's "
                  f"own rounding: not checked)")
            print(f"time [{stamp}] distributed (f) {run['arch']} f32 grads: --mesh 2,2 "
                  f"{m32['s']:.3f} s, unmeshed {p32['s']:.3f} s")
            check(max(gaps32) <= DIST_LOSS_RTOL,
                  f"distributed (f) {run['arch']} f32: loss gap {gaps32[0]:.3g}, norm gap "
                  f"{gaps32[1]:.3g}")
            out[run["arch"]] = {"f32_gaps": gaps32, "bf16_floor": floor, "mesh_bf16_to_f32": mesh16}
        else:
            check(norm_gap <= DIST_LOSS_RTOL,
                  f"distributed (f) {run['arch']}: norm gap {norm_gap:.3g}")
        print(f"time [{stamp}] distributed (f) {run['arch']} step: --mesh 2,2 {m0['step_s']:.3f} s "
              f"(4 ranks sharing the card over gloo; {m0['staged']['calls']} collectives, "
              f"{m0['staged']['bytes'] / 1e9:.2f} GB through host memory on rank 0), the run "
              f"{max(r['run_s'] for r in mesh):.1f} s with start-up; unmeshed {plain['step_s']:.3f} "
              f"s, the run {plain['run_s']:.1f} s; peak memory by rank "
              + " ".join(f"{r['peak_bytes'] / 2**30:.2f}" for r in mesh)
              + f" GiB, unmeshed {plain['peak_bytes'] / 2**30:.2f} GiB")
        out.setdefault(run["arch"], {}).update(loss_gap=loss_gap, norm_gap=norm_gap)
    return out


def report_e(stamp, ranks: list) -> dict:
    """(e)'s checks: each model's --mesh 2,2 step against its unmeshed step
    on the card (loss and the grads' global norm within DIST_LOSS_RTOL;
    none for a ``meshed_only`` run),
    every rank's flash and SSD calls at its local shapes (this rank's heads
    of the whole sequence of its dp group's row) and the kernels' launch
    counts. Returns {path: launches} of rank 0 for the kernels records."""
    t = dict(zip(DIST_E_ARGS[::2], DIST_E_ARGS[1::2]))
    rows, seq = int(t["--batch"]) // 2, int(t["--seq"])
    out = {}
    for run in DIST_E:
        full = get_config(run["arch"])
        cfg = dataclasses.replace(full, n_layers=run["n_layers"])
        mesh = [r for rk in ranks for r in rk if r["arch"] == run["arch"] and r["meshed"]]
        plain = next((r for r in ranks[0] if r["arch"] == run["arch"] and not r["meshed"]), None)
        check(len(mesh) == 4 and all(r["losses"] == mesh[0]["losses"] and r["norm"] == mesh[0]["norm"]
                                     for r in mesh),
              f"distributed (e) {run['arch']}: losses / norms by rank "
              f"{[(r['losses'], r['norm']) for r in mesh]}")
        m0 = mesh[0]
        if plain is not None:
            loss_gap = abs(m0["losses"][0] - plain["losses"][0]) / abs(plain["losses"][0])
            norm_gap = abs(m0["norm"] - plain["norm"]) / abs(plain["norm"])
        # one remat step: the prefix layers' attention once, each unit layer
        # in its forward and its recompute
        units = n_units(cfg)
        n_fa = cfg.first_k_dense + 2 * units * cfg.block_pattern.count("attn")
        n_ssd = 2 * units * cfg.block_pattern.count("mamba2")
        D = compiled_dim(cfg.nope_head_dim + cfg.rope_head_dim if cfg.use_mla else cfg.head_dim,
                         cfg.v_head_dim if cfg.use_mla else cfg.head_dim)
        if cfg.use_mla:
            fa_shape = (rows, seq, cfg.n_heads // 2, cfg.n_heads // 2,
                        cfg.nope_head_dim + cfg.rope_head_dim, cfg.v_head_dim)
        else:
            fa_shape = (rows, seq, cfg.n_heads // 2, cfg.n_kv_heads // 2, cfg.head_dim, cfg.head_dim)
        want_fa = {str(fa_shape): n_fa}
        # this rank's heads, B/C of the one group shared by them (head stride 0)
        ssd_shape = (rows, seq, cfg.n_ssm_heads // 2, cfg.ssm_head_dim, cfg.ssm_state,
                     min(256, seq), 0)
        want_ssd = {str(ssd_shape): n_ssd} if n_ssd else {}
        for r in mesh:
            check(r["fa"] == want_fa and r["fa_launches"] == n_fa == r["fa_by_dim"][str(D)],
                  f"distributed (e) {run['arch']} rank {r['rank']}: flash calls {r['fa']} "
                  f"({r['fa_launches']} launches, by D {r['fa_by_dim']}), not {want_fa} at D = {D}")
            check(r["ssd"] == want_ssd and r["ssd_launches"] == 2 * n_ssd,
                  f"distributed (e) {run['arch']} rank {r['rank']}: SSD calls {r['ssd']} "
                  f"({r['ssd_launches']} launches), not {want_ssd}: a score and a main kernel each")
            check(r["staged"]["calls"] > 0, f"distributed (e) {run['arch']} rank {r['rank']}: no "
                                            f"collective went through the host")
        check(plain is None or (plain["fa_launches"] == n_fa and plain["ssd_launches"] == 2 * n_ssd),
              f"distributed (e) {run['arch']} unmeshed: {plain and plain['fa_launches']} flash, "
              f"{plain and plain['ssd_launches']} SSD launches")
        what = (f"{cfg.n_layers} layers ({cfg.first_k_dense} dense MLA + {cfg.n_layers - cfg.first_k_dense} "
                f"MLA + MoE of {cfg.n_routed_experts} experts: {cfg.n_routed_experts // 2} a rank)"
                if cfg.use_mla else f"{cfg.n_layers} layers ({cfg.block_pattern.count('mamba2')} "
                f"Mamba-2 of {cfg.n_ssm_heads} heads: {cfg.n_ssm_heads // 2} a rank, "
                f"{cfg.block_pattern.count('attn')} attention of {cfg.n_heads} heads)")
        print(f"distributed (e) train --mesh 2,2 {run['arch']} at full width cut to {what}, "
              f"{t['--batch']} x {seq}, one step: {m0['local_params']:,} of {m0['params']:,} "
              f"parameters a rank; flash attention {want_fa} (rows, positions, q heads, kv heads, "
              f"d, dv: calls) on the D = {D} instance"
              + (f", SSD {want_ssd} (rows, positions, heads, hp, n, chunk, B/C head stride: calls; "
                 f"{2 * n_ssd} launches, a score and a main kernel a call)" if n_ssd else "")
              + " on every rank"
              + (f"; {m0['dropped']} assignments dropped past the capacity of the global batch "
                 f"(forward and recompute)" if cfg.n_routed_experts else ""))
        if plain is None:
            print(f"distributed (e) {run['arch']}: loss {m0['losses'][0]:.6f}, grads' global norm "
                  f"{m0['norm']:.6f}; the unmeshed comparison is cut (``meshed_only``)")
            loss_gap = norm_gap = None
        else:
            print(f"distributed (e) {run['arch']}: loss {m0['losses'][0]:.6f} against the "
                  f"unmeshed step's {plain['losses'][0]:.6f} (gap {loss_gap:.2e}), grads' global "
                  f"norm {m0['norm']:.6f} against {plain['norm']:.6f} (gap {norm_gap:.2e}); limit "
                  f"{DIST_LOSS_RTOL}")
            check(loss_gap <= DIST_LOSS_RTOL and norm_gap <= DIST_LOSS_RTOL,
                  f"distributed (e) {run['arch']}: loss gap {loss_gap:.3g}, norm gap "
                  f"{norm_gap:.3g}")
        print(f"time [{stamp}] distributed (e) {run['arch']} step: --mesh 2,2 {m0['step_s']:.3f} s "
              f"(4 ranks sharing the card over gloo; {m0['staged']['calls']} collectives, "
              f"{m0['staged']['bytes'] / 1e9:.2f} GB through host memory on rank 0), the run "
              f"{max(r['run_s'] for r in mesh):.1f} s with start-up; peak memory by rank "
              + " ".join(f"{r['peak_bytes'] / 2**30:.2f}" for r in mesh) + " GiB"
              + ("" if plain is None else f"; unmeshed {plain['step_s']:.3f} s, the run "
                 f"{plain['run_s']:.1f} s, {plain['peak_bytes'] / 2**30:.2f} GiB"))
        out[run["arch"]] = {"flash": m0["fa_launches"], "ssd": m0["ssd_launches"],
                            "loss_gap": loss_gap, "norm_gap": norm_gap}
    return out


DRYRUN_PEAK_TOL = 0.20  # the traced peak against train_ft's measured one
DRYRUN_TIMEOUT = 300


def phase_dryrun(stamp, ft: dict, dist_run: dict) -> dict:
    """(a) the dry-run's one-card trace of train_ft's step against that
    run's measured peak and step, and its trace of the distributed phase's
    (d) step (train --mesh 2,2) for rank 0 of a fake group of 4 against
    rank 0's measured peak; (b) the dry-run CLI on qwen3-0.6b train_4k on
    both production meshes, in a process of its own."""
    from repro_torch.launch import dryrun

    t = TRAIN_FT
    cfg = get_config(t["arch"])
    root = ROOT / "chiprun_out" / "dryrun"
    shutil.rmtree(root, ignore_errors=True)
    t_phase = time.perf_counter()
    # (a) the cell train_ft's straight run trains, on a (1, 1) mesh
    shape = ShapeConfig("train_ft", t["seq"], t["batch"], "train")
    hbm = torch.cuda.get_device_properties(0).total_memory
    art = dryrun.run_cell(t["arch"], shape, False, out_dir=root, hbm_bytes=hbm,
                          mesh_shape=(1, 1))
    mem, est = art["memory"], art["memory_tpu_analytic"]
    peak, measured = mem["peak_per_device"], ft["peak_bytes"]
    rel = peak / measured - 1
    print(f"dryrun (a) {art['cell']}: {cfg.name} {t['batch']} x {t['seq']}, adamw, remat full, "
          f"kernels off, traced for rank 0 of a fake 1-rank group on meta tensors in "
          f"{art['lower_s']:.1f} s (build) + {art['compile_s']:.1f} s (trace, "
          f"{art['aten_ops']} aten ops); microbatches {art['microbatches']}")
    print(f"dryrun (a) traced peak {peak / 2**30:.2f} GiB vs train_ft's measured "
          f"{measured / 2**30:.2f} GiB (max_memory_allocated): {rel:+.1%} (limit "
          f"{DRYRUN_PEAK_TOL:.0%}); at the peak "
          + ", ".join(f"{k} {v / 2**30:.2f}" for k, v in mem["peak_by_category"].items())
          + f" GiB; fits {hbm / 2**30:.2f} GiB: {mem['fits_hbm']}")
    print(f"dryrun (a) the reference's analytic estimate {est['total_bytes'] / 2**30:.2f} GiB "
          f"(arguments {est['args_bytes'] / 2**30:.2f}, activations "
          f"{est['activation_bytes'] / 2**30:.2f}; for its partitioned step, not gated)")
    check(abs(rel) <= DRYRUN_PEAK_TOL,
          f"dryrun (a): traced peak {peak / 2**30:.2f} GiB is {rel:+.1%} off the measured "
          f"{measured / 2**30:.2f} GiB")
    flops_s = art["flops_per_device"] / H100_SXM["peak_bf16_flops"]
    bytes_s = art["bytes_per_device"] / H100_SXM["hbm_bw"]
    print(f"time [{stamp}] dryrun (a) H100 roofline of the traced step: FLOPs "
          f"{art['flops_per_device']:.4e} / 989 TFLOP/s = {flops_s:.3f} s, bytes "
          f"{art['bytes_per_device']:.4e} / 3.35 TB/s = {bytes_s:.3f} s, bound "
          f"{max(flops_s, bytes_s):.3f} s vs train_ft's measured step {ft['step_s']:.3f} s "
          f"({ft['step_s'] / max(flops_s, bytes_s):.2f}x the bound; not gated); useful FLOPs "
          f"{art['model_flops'] / art['flops_per_device']:.3f}")

    # (a) the distributed phase's 2x2 step, rank 0 of a fake group of 4
    art = dryrun.run_cell(t["arch"], shape, False, out_dir=root, hbm_bytes=hbm,
                          mesh_shape=(2, 2))
    peak2, measured2 = art["memory"]["peak_per_device"], dist_run["peak_bytes"]
    rel2 = peak2 / measured2 - 1
    c = art["collectives"]
    print(f"dryrun (a) {art['cell']}: the distributed phase's (d) step traced for rank 0 of a fake "
          f"group of 4 in {art['lower_s']:.1f} s + {art['compile_s']:.1f} s ({art['aten_ops']} aten "
          f"ops): traced peak {peak2 / 2**30:.2f} GiB vs rank 0's measured {measured2 / 2**30:.2f} "
          f"GiB: {rel2:+.1%} (limit {DRYRUN_PEAK_TOL:.0%}); at the peak "
          + ", ".join(f"{k} {v / 2**30:.2f}" for k, v in art["memory"]["peak_by_category"].items())
          + f" GiB; all-gathers {c['all-gather_count']}, reduce-scatters "
          f"{c['reduce-scatter_count']}, all-reduces {c['all-reduce_count']}, "
          f"{art['collective_bytes_per_device'] / 1e9:.3f} GB a device; useful FLOPs "
          f"{art['model_flops'] / (art['flops_per_device'] * art['chips']):.3f}")
    check(abs(rel2) <= DRYRUN_PEAK_TOL,
          f"dryrun (a) 2x2: traced peak {peak2 / 2**30:.2f} GiB is {rel2:+.1%} off rank 0's "
          f"measured {measured2 / 2**30:.2f} GiB")

    # (c) the distributed phase's (g) decode (qwen3-0.6b, bf16, the cache by
    # kv head), rank 0 of a fake group of 4, against rank 0's measured peak
    g = dist_run["g"]["qwen3 bf16 heads"]
    run = next(r for r in DIST_G if r["label"] == "qwen3 bf16 heads")
    g_cfg = dataclasses.replace(get_config(run["arch"]), n_layers=run["n_layers"])
    art = dryrun.run_cell(g_cfg, ShapeConfig("g_decode", run["max_len"], run["rows"], "decode"),
                          False, out_dir=root, hbm_bytes=hbm, mesh_shape=(2, 2))
    peak3, measured3 = art["memory"]["peak_per_device"], g["peak_bytes"]
    c = art["collectives"]
    print(f"dryrun (c) {art['cell']}: the distributed phase's (g) decode step traced for rank 0 "
          f"of a fake group of 4 ({art['partition']}): traced peak {peak3 / 2**30:.3f} GiB vs "
          f"rank 0's measured {measured3 / 2**30:.3f} GiB over (g)'s wave: "
          f"{peak3 / measured3 - 1:+.1%} (limit {DRYRUN_PEAK_TOL:.0%}); at the peak "
          + ", ".join(f"{k} {v / 2**30:.3f}" for k, v in art["memory"]["peak_by_category"].items())
          + f" GiB; all-gathers {c['all-gather_count']}, all-reduces {c['all-reduce_count']}, "
          f"{art['collective_bytes_per_device'] / 1e6:.3f} MB a device")
    check(abs(peak3 / measured3 - 1) <= DRYRUN_PEAK_TOL,
          f"dryrun (c): traced peak {peak3 / 2**30:.3f} GiB is {peak3 / measured3 - 1:+.1%} off "
          f"rank 0's measured {measured3 / 2**30:.3f} GiB")

    # (b) the CLI on the production meshes, in a process of its own
    t_b = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", t["arch"], "--shape",
           "train_4k", "--out", str(root)]
    proc = subprocess.run(cmd, cwd=ROOT, env=_child_env(), capture_output=True, text=True,
                          timeout=DRYRUN_TIMEOUT)
    (root / "cli.log").write_text(proc.stdout + proc.stderr)
    check(proc.returncode == 0, f"dryrun (b): exit {proc.returncode}; its output ends:\n"
                                f"{(proc.stdout + proc.stderr)[-3000:]}")
    wall_b = time.perf_counter() - t_b
    arts = {m: json.loads((root / f"{t['arch']}__train_4k__{m}.json").read_text())
            for m in ("16x16", "2x16x16")}
    want_mf = formula_model_flops(cfg, SHAPES["train_4k"])
    for m, a in arts.items():
        c = a["collectives"]
        print(f"dryrun (b) {a['cell']}: {a['chips']} ranks, {a['compute']}; per device "
              f"FLOPs {a['flops_per_device']:.4e}, bytes {a['bytes_per_device']:.4e}, "
              f"collective bytes {a['collective_bytes_per_device']:.4e} (all-gather "
              f"{c['all-gather_count']}, reduce-scatter {c['reduce-scatter_count']}, all-reduce "
              f"{c['all-reduce_count']}); peak {a['memory']['peak_per_device'] / 2**30:.2f} GiB "
              f"(fits: {a['memory']['fits_hbm']}), analytic "
              f"{a['memory_tpu_analytic']['total_bytes'] / 2**30:.2f} GiB; useful FLOPs "
              f"{a['model_flops'] / (a['flops_per_device'] * a['chips']):.4f}; host "
              f"{a['lower_s']:.1f} s build + {a['compile_s']:.1f} s trace")
        check(c["all-gather_count"] > 0 and c["reduce-scatter_count"] > 0,
              f"dryrun (b) {m}: all-gathers {c['all-gather_count']}, reduce-scatters "
              f"{c['reduce-scatter_count']}")
        check(a["model_flops"] == want_mf, f"dryrun (b) {m}: model_flops {a['model_flops']} != "
                                           f"formula_model_flops {want_mf}")
    f1, f2 = (arts[m]["flops_per_device"] for m in ("16x16", "2x16x16"))
    check(f2 < f1, f"dryrun (b): FLOPs per device {f1:.4e} (16x16) -> {f2:.4e} (2x16x16)")
    print(f"time [{stamp}] dryrun (b) the CLI's process: {wall_b:.1f} s wall for both meshes")
    print(f"time [{stamp}] dryrun phase: {time.perf_counter() - t_phase:.1f} s")
    return {"peak": peak, "measured": measured, "rel": rel, "rel_2x2": rel2,
            "rel_g": peak3 / measured3 - 1}


def phase_codesign(stamp, gen) -> dict:
    """The co-design loop on the card: quickstart step 4 (plan the GEMM in
    each dtype's space, launch it with the planned tile in f32 and bf16,
    check it), then every kernel space calibrated with CUDA events next to
    the model's prediction, both matmul spaces included. Every bf16 matmul
    launch of the loop must have run on the wgmma instance, shown by the
    per-instance counts and by the kernel name a profiler window over one
    bf16 calibration launch records. Each calibration row is then held
    against its plain version on inputs drawn from ``gen``. Returns the
    loop's kernel launches."""
    flash_attention_cuda.launches = ssd_intra_chunk_cuda.launches = 0
    reset_launches()
    t0 = time.perf_counter()
    res = quickstart.run_matmul(*quickstart.GEMM, "cuda")
    rows, scales = quickstart.calibrate("cuda")
    torch.cuda.synchronize()
    launches = {"matmul": matmul_cuda.launches, "flash_attention": flash_attention_cuda.launches,
                "ssd_scan": ssd_intra_chunk_cuda.launches}
    by_instance = dict(matmul_cuda.launches_by_instance)
    M, N, K = quickstart.GEMM
    print(f"codesign: quickstart step 4, {M}x{N}x{K} planned on h100_sm(): tiles "
          f"{res['tiles_by_dtype']}; kernel vs plain version max abs err {res['max_abs_err']} "
          f"(tol {quickstart.TOL} x (1 + max |out|))")
    check(all(n > 0 for n in launches.values()), f"the co-design loop missed a kernel: {launches}")
    # step 4 launches once per dtype; each calibration row's launches are its space's dtype's
    want = {"fma": 1 + sum(r["launches"] for r in rows if r["kernel"] == MATMUL_H100.name),
            "wgmma": 1 + sum(r["launches"] for r in rows if r["kernel"] == MATMUL_BF16_H100.name)}
    check(by_instance == want and res["launches_by_instance"] == {"wgmma": 1, "fma": 1},
          f"matmul launches by instance {by_instance} (step 4: {res['launches_by_instance']}): "
          f"every bf16 launch of the loop should be wgmma's, every f32 one fma's: {want}")
    print(f"codesign: matmul launches by instance {by_instance}: every bf16 launch of the loop "
          f"(step 4 and the {MATMUL_BF16_H100.name} rows) ran on wgmma, every f32 one on fma")
    print(f"calibration [{stamp}] (device rows; error after the per-kernel scale):")
    print(f"  {'space':22s} {'shape':20s} {'planned':16s} {'source':7s} {'default':16s} "
          f"{'default/planned':>15s} {'predicted ms':>12s} {'measured ms':>11s} {'error %':>8s} "
          f"{'launches':>8s}")
    for r in rows:
        check(not r["interpret"] and r["measured_s"] > 0, f"calibration row {r} is not a device row")
        check(r["launches"] > 0, f"calibration row {r} launched no kernel")
        print(f"  {r['kernel']:22s} {str(tuple(r['shape'])):20s} {str(tuple(r['config'])):16s} "
              f"{r['source']:7s} {str(tuple(r['default_config'])):16s} "
              f"{r['default_over_planned']:15.3f} {r['predicted_s'] * 1e3:12.4f} "
              f"{r['measured_s'] * 1e3:11.4f} {r['error_pct']:8.1f} {r['launches']:8d}")
    print("calibration scales (measured / predicted, geometric mean per space): "
          + ", ".join(f"{k} {v:.4g}" for k, v in scales.items()))
    print(f"codesign: launches {launches} in {time.perf_counter() - t0:.1f} s")
    _profile_bf16_calibration_launch(rows)
    # every shape and tile the loop launched, held against its plain version
    # (these launches are not the loop's)
    for r in rows:
        space, shape, config = codesign.get_space(r["kernel"]), tuple(r["shape"]), tuple(r["config"])
        inputs = space.example_inputs(shape, "cuda", gen)
        err, ratio, rule = _check_space_output(space, shape, config, inputs, space.run(inputs, config))
        ok = math.isfinite(ratio) and ratio <= 1.0
        if space is SSD_SCAN_H100:  # the space times the kernel alone; the whole op too
            cl = min(config[0], inputs[0].shape[1])
            whole, ok_whole = _allclose(ssd_chunked(*inputs, chunk=cl),
                                        ssd_chunked_ref(*inputs, chunk=cl), SSD_TOL)
            ok = ok and ok_whole
            rule += f"; the whole op ssd_chunked vs ssd_chunked_ref: max abs err {whole:.3g}"
        check(ok, f"codesign: {space.name} {shape} tile {config} {str(inputs[0].dtype)[6:]}: max "
                  f"abs err {err}, not within {rule}")
        print(f"codesign: {space.name} {shape} tile {config} {str(inputs[0].dtype)[6:]}, "
              f"{r['launches']} launches in the loop: kernel vs plain version max abs err "
              f"{err:.3g} ({rule})")
        del inputs
    return {"launches": launches, "max_abs_err": max(res["max_abs_err"].values()),
            "matmul_by_shape": _matmul_launches_by_shape(res, rows), "scales": scales}


def _check_space_output(space, shape, config, inputs, got, exact=False):
    """Hold a space's kernel output ``got`` at ``config`` against the
    space's plain version on the same inputs: flash attention (bf16) within
    the space's tolerance and the row-scaled limit (a kernel that drops a
    KV tile fails it); the matmul by ``product_check`` (f32 within sqrt(K)
    u |a||b| of a float64 evaluation, bf16 within rtol = atol); the SSD
    kernel within rtol = atol. With ``exact``, the SSD kernel is held within
    rtol = atol of the plain version evaluated in float64, as the kernel
    phase holds it at the training shape (both f32 versions round; the
    float64 one is the answer they approximate), and the plain f32
    version's distance from it is reported. Returns (max abs error, worst
    error over its limit, the rule): the output passes where the second is
    at most 1."""
    if exact and space is SSD_SCAN_H100:
        cl = min(config[0], inputs[0].shape[1])
        want = ssd_intra_chunk_ref(*inputs, cl, dtype=torch.float64)
        plain = space.reference(inputs, config)
        ratio = _allclose_ratio(got, want, SSD_TOL)
        rule = (f"rtol = atol = {SSD_TOL} of a float64 evaluation; the plain f32 version: "
                f"{_allclose(plain, want, SSD_TOL)[0]:.3g} from it "
                f"({_allclose_ratio(plain, want, SSD_TOL):.3f}), {_allclose(got, plain, SSD_TOL)[0]:.3g} "
                f"from the kernel")
        return _allclose(got, want, SSD_TOL)[0], ratio, rule
    want = space.reference(inputs, config)
    got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
    check(len(got) == len(want) and all(a.shape == b.shape for a, b in zip(got, want)),
          f"{space.name} {shape} tile {config}: output shapes differ from the plain version's")
    if space is FLASH_ATTENTION_H100:
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
        q, k, v = inputs
        rows, planted = _fa_check_rows(f"{space.name} {shape}", got[0], want[0], q, k, v,
                                       config[1], causal=False,
                                       scale=1.0 / math.sqrt(q.shape[-1]))
        return (err, max(err / space.tolerance, rows),
                f"tol {space.tolerance}; worst |err| / (2^-7 max_row |want| + 1e-3) {rows:.3f}, "
                f"limit 1; the plain version without its last KV tile: {planted:.3f}")
    if space in (MATMUL_H100, MATMUL_BF16_H100):
        torch.cuda.synchronize()
        return product_check(got[0], *inputs)
    return _allclose(got, want, SSD_TOL)[0], _allclose_ratio(got, want, SSD_TOL), \
        f"rtol = atol = {SSD_TOL}"


# The whole_model phase: Union's operator streams of three full-width model
# steps, the serve phase's qwen3-0.6b decode step (8 slots, max_len 512) and
# a prefill of the same slots, and the train phase's zamba2-2.7b step
# (2 x 2048); one union_opt_sweep over their mappable entries on h100_sm(),
# serially and on SWEEP_WORKERS spawned processes
WHOLE_MODEL = [("qwen3-0.6b", ShapeConfig("h100_decode", MAX_LEN, SLOTS, "decode")),
               ("qwen3-0.6b", ShapeConfig("h100_prefill", MAX_LEN, SLOTS, "prefill")),
               (TRAIN["arch"], ShapeConfig("h100_train", TRAIN["seq"], TRAIN["batch"], "train"))]
SWEEP_WORKERS = 8
GEMM_EINSUM = "bi,io->bo"  # the stream's linear layers: (M, N, K) = (b, o, i)
GRAPH_BELOW_MS = 0.05  # GEMM rows with less device time are timed by CUDA-graph replay
CHECK_ROWS = 256  # outputs wider than CHECK_WIDE elements are checked on the first and last rows
CHECK_WIDE = 1 << 28
# the stream entries each fused kernel computes, one call each: (role,
# einsums); the inter-chunk SSD term (clhn,chpn->clhp) lies outside the kernel
FUSED = {"flash_attention": ("attention_score", ("bhqd,bhkd->bhqk", "bhqk,bhkd->bhqd")),
         "ssd_scan": ("ssm_scan", ("clhn,cshn->chls", "chls,cshp->clhp", "clhp,cln->chpn"))}
# the (model, shape) streams that must hold each fused group
FUSED_IN = {"flash_attention": {("qwen3-0.6b", "h100_decode"), ("qwen3-0.6b", "h100_prefill"),
                                (TRAIN["arch"], "h100_train")},
            "ssd_scan": {(TRAIN["arch"], "h100_train")}}

MAPPERS = ("heuristic", "exhaustive", "random", "genetic", "decoupled")
MAPPER_DRAWS = 3  # input draws each tile of the mappers phase is checked on; the first is timed


def _kernel_keys(space) -> dict:
    """The kernels-line keys naming the CUDA kernel a space launches and
    the TPU kernel it replaces."""
    name, source, replaces = {
        FLASH_ATTENTION_H100.name: ("flash_attention", "flash_attention/csrc/flash_attention.cu",
                                    "src/repro/kernels/flash_attention/flash_attention.py:100"),
        SSD_SCAN_H100.name: ("ssd_scan", "ssd_scan/csrc/ssd_scan.cu",
                             "src/repro/kernels/ssd_scan/ssd_scan.py:69"),
        MATMUL_H100.name: ("matmul", "matmul/csrc/matmul.cu", "src/repro/kernels/matmul/matmul.py:39"),
        MATMUL_BF16_H100.name: ("matmul", "matmul/csrc/matmul_wgmma.cu",
                                "src/repro/kernels/matmul/matmul.py:39"),
    }[space.name]
    return {"name": name, "route": "cuda", "source": f"src/repro_torch/kernels/{source}",
            "replaces": replaces}


def _ssd_work(b, l, nh, hp, n, cl):
    """Bytes and operations of one intra-chunk call with B/C shared by the
    heads: x, dA, y, S_c and dte once, B and C once (one group); the score
    block C B^T once per (batch, chunk), its decayed product with x and S_c
    per head."""
    nc = -(-l // cl)
    bytes_ = 4 * (b * l * nh * hp + b * l * nh + 2 * b * l * n
                  + b * l * nh * hp + b * nc * nh * n * hp + b * l * nh)
    tri = cl * (cl + 1) // 2
    return bytes_, b * nc * (2 * tri * n + nh * (2 * tri * hp + 2 * cl * n * hp))


def _space_bound(space, shape, tile, inputs):
    """(bound ms, what bounds it) of one launch of ``space`` at ``tile`` on
    ``inputs``: each input read and each output written once at 3.35 TB/s,
    against the operations at the peak of the route the kernel takes."""
    if space in (MATMUL_H100, MATMUL_BF16_H100):
        M, N, K = shape
        peak = F32_FLOP_PER_S if inputs[0].dtype == torch.float32 else BF16_FLOP_PER_S
        return _bound(inputs[0].element_size() * (M * K + K * N + M * N), 2 * M * N * K, peak)
    if space is FLASH_ATTENTION_H100:
        sq, skv, d = shape
        return _bound(2 * (2 * sq * d + 2 * skv * d), 4 * sq * skv * d, BF16_FLOP_PER_S)
    b, l, nh, hp = inputs[0].shape
    bytes_, flops = _ssd_work(b, l, nh, hp, shape[1], min(tile[0], l))
    return _bound(bytes_, 3 * flops, TF32_FLOP_PER_S)  # 3xTF32 on the tensor cores


def _library_call(space, inputs):
    """The PyTorch call computing what the space's kernel computes on
    ``inputs``, or None (the SSD intra-chunk step has none)."""
    if space in (MATMUL_H100, MATMUL_BF16_H100):
        return lambda: torch.matmul(*inputs)
    if space is FLASH_ATTENTION_H100:
        q, k, v = (t.transpose(1, 2) for t in inputs)
        return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)
    return None


def _mapper_tile(space, shape, tile, draws) -> dict:
    """One tile of the mappers phase: held against its plain version on
    every draw (the first launch under the hang limit), then timed on the
    first draw as the calibration table times (``time_launches``), beside
    the plain version. Only the timed launches are counted."""
    err, ratio, rule = 0.0, -math.inf, ""
    for i, inputs in enumerate(draws):
        got = space.run(inputs, tile)
        if i == 0:
            _sync_within(f"mappers {space.name} {shape} tile {tile}")
        e, r, why = _check_space_output(space, shape, tile, inputs, got, exact=True)
        check(math.isfinite(r) and r <= 1.0,
              f"mappers: {space.name} {shape} tile {tile}, draw {i}: max abs err {e}, worst "
              f"|err| / limit {r:.3f}, not within {why}")
        err = max(err, e)
        if r > ratio:
            ratio, rule = r, why
        del got
    inputs = draws[0]
    before = quickstart.kernel_launches()
    ms = codesign.time_launches(lambda: space.run(inputs, tile), "cuda") * 1e3
    torch.cuda.synchronize()
    launches = quickstart.kernel_launches() - before
    plain_ms = codesign.time_launches(lambda: space.reference(inputs, tile), "cuda") * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "launches": launches, "max_abs_err": err,
            "ratio": ratio, "rule": rule}


def phase_mappers(stamp, scales, gen) -> list:
    """Which tile each of Union's five mappers gives each kernel, on the
    card. For every calibration row (``quickstart.CALIBRATION_SHAPES``) and
    every mapper, ``union_opt`` searches the space's problem on its H100
    hierarchy with the space's cost model and metric but without its tile
    constraints (under them the sampling mappers find only the trivial
    mapping, as the reference's do); the C1 tile is decoded and legalized
    and predicted under the calibration scale of this run. Each distinct
    tile of the row (the mappers', the row's ``codesign.plan`` tile and its
    default) is held against its plain version on ``MAPPER_DRAWS`` input
    sets drawn from ``gen`` and timed as the calibration table times (CUDA
    events, inputs warm in L2, best of 3 windows of 10 launches) beside the
    plain version and, once a row, the PyTorch call. Returns one
    kernels-line record per (row, distinct tile), with its timed launches."""
    flash_attention_cuda.launches = ssd_intra_chunk_cuda.launches = 0
    reset_launches()
    t0 = time.perf_counter()
    rows, records, host, worst = [], [], 0.0, {}
    for name, shapes in quickstart.CALIBRATION_SHAPES.items():
        space = codesign.get_space(name)
        for shape in shapes:
            cands = [{"mapper": "plan", "evaluated": None, "host_s": None, "raw": None,
                      "tile": codesign.plan(space, shape).config},
                     {"mapper": "default", "evaluated": None, "host_s": None, "raw": None,
                      "tile": space.legalize(space.default_config(shape), shape)}]
            for mapper in MAPPERS:
                t1 = time.perf_counter()
                sol = union_opt(space.problem(shape), space.arch(), mapper=mapper,
                                cost_model=space.cost_model, metric=space.metric)
                dt = time.perf_counter() - t1
                host += dt
                raw = space.decode(sol.mapping, shape)
                cands.append({"mapper": mapper, "evaluated": sol.search.evaluated, "host_s": dt,
                              "raw": list(raw), "tile": space.legalize(raw, shape)})
            draws = [space.example_inputs(shape, "cuda", gen) for _ in range(MAPPER_DRAWS)]
            library = _library_call(space, draws[0])
            library_ms = None if library is None else codesign.time_launches(library, "cuda") * 1e3
            tiles = {}
            for c in cands:
                tile = tuple(c["tile"])
                if tile not in tiles:
                    tiles[tile] = {**_mapper_tile(space, shape, tile, draws), "mappers": []}
                t = tiles[tile]
                t["mappers"].append(c["mapper"])
                c.update(tile=list(tile), measured_ms=t["ms"], max_abs_err=t["max_abs_err"],
                         over_limit=t["ratio"], rule=t["rule"],
                         predicted_ms=codesign.predict_cost(space, shape, tile).latency_s * 1e3
                         * scales[name])
            for c in cands:
                c["over_plan"] = c["measured_ms"] / cands[0]["measured_ms"]
                rows.append({"space": name, "shape": list(shape), **c})
            inst = {"instance": instance_for(*draws[0])} if space in MM_SPACES.values() else {}
            for tile, t in tiles.items():
                bound, bound_by = _space_bound(space, shape, tile, draws[0])
                records.append({
                    **_kernel_keys(space), **inst, "path": "mappers",
                    "shape": f"{name} {'x'.join(map(str, shape))} tile {tile} "
                             f"({', '.join(t['mappers'])}); warm L2, best of 3 x 10",
                    "launches": t["launches"], "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                    "plain_ms": t["plain_ms"], "bound_ms": bound, "bound_by": bound_by,
                    "library_ms": library_ms, "worst_over_limit": t["ratio"]})
                worst[name] = max(worst.get(name, -math.inf), t["ratio"])
            del draws, library
    torch.cuda.synchronize()
    timed = {}
    for r in records:
        key = r["name"] + (f" {r['instance']}" if "instance" in r else "")
        timed[key] = timed.get(key, 0) + r["launches"]
    check(sorted(timed) == ["flash_attention", "matmul fma", "matmul wgmma", "ssd_scan"]
          and all(n > 0 for n in timed.values()),
          f"the mappers phase's timed launches missed a kernel or an instance: {timed}")
    n_search = sum(len(v) for v in quickstart.CALIBRATION_SHAPES.values()) * len(MAPPERS)
    print(f"mappers [{stamp}] ({n_search} searches without the spaces' tile constraints, "
          f"{host:.1f} s of host search; tiles decoded, legalized, checked on {MAPPER_DRAWS} "
          f"draws and timed with CUDA events, best of 3 x 10 launches, inputs warm in L2; "
          f"predicted under this run's calibration scales):")
    print(f"  {'space':20s} {'shape':18s} {'mapper':10s} {'evals':>6s} {'host s':>7s} "
          f"{'raw tile':16s} {'launched':16s} {'pred ms':>9s} {'meas ms':>9s} {'/plan':>6s}")
    for r in rows:
        evals = "" if r["evaluated"] is None else str(r["evaluated"])
        hs = "" if r["host_s"] is None else f"{r['host_s']:.2f}"
        raw = "" if r["raw"] is None else str(tuple(r["raw"]))
        print(f"  {r['space']:20s} {str(tuple(r['shape'])):18s} {r['mapper']:10s} {evals:>6s} "
              f"{hs:>7s} {raw:16s} {str(tuple(r['tile'])):16s} {r['predicted_ms']:9.4f} "
              f"{r['measured_ms']:9.4f} {r['over_plan']:6.3f}")
    for name, shapes in quickstart.CALIBRATION_SHAPES.items():
        for shape in map(tuple, shapes):
            rs = [r for r in rows if r["space"] == name and tuple(r["shape"]) == shape]
            ms = {r["mapper"]: r["measured_ms"] for r in rs}
            best = min((r for r in rs if r["mapper"] in MAPPERS), key=lambda r: r["measured_ms"])
            def beats(t):
                return "beats" if t < ms["default"] else "does not beat"

            print(f"mappers: {name} {shape}: plan {ms['plan']:.4f} ms, default "
                  f"{ms['default']:.4f} ms{' (the plan loses)' if ms['plan'] > ms['default'] else ''}"
                  f"; fastest mapper tile {tuple(best['tile'])} ({best['mapper']}) "
                  f"{best['measured_ms']:.4f} ms ({beats(best['measured_ms'])} the default); "
                  f"exhaustive argmin {ms['exhaustive']:.4f} ms ({beats(ms['exhaustive'])} the "
                  f"default)")
    print(f"mappers: worst |err| / limit over {MAPPER_DRAWS} draws a tile, per space: "
          + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()))
    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "mappers.json").write_text(json.dumps(
        {"device": stamp, "rows": rows, "tiles": records, "worst_over_limit": worst}, indent=1))
    print(f"mappers: timed launches {timed} ({len(records)} tiles) in "
          f"{time.perf_counter() - t0:.1f} s; the full record is in chiprun_out/mappers.json")
    return records


@contextlib.contextmanager
def _spawn_without_this_script():
    """Spawned processes re-run the parent's main script by its path
    before they work; this one imports torch, which a sweep worker needs
    not (it imports numpy and repro_torch.core). Hide the path meanwhile."""
    main = sys.modules["__main__"]
    path = main.__dict__.pop("__file__", None)
    try:
        yield
    finally:
        if path is not None:
            main.__file__ = path


def _sweep_view(sweep) -> list:
    return [(s.mapping.to_dict(), s.cost) for s in sweep]


def phase_whole_model(stamp, gen) -> dict:
    """Union's whole-model layer on the card's hierarchy, and every GEMM of
    the three steps on the card. Each stream of ``WHOLE_MODEL`` is built at
    full width and depth and its parameter FLOPs reconciled with the
    MODEL_FLOPS formula; one ``union_opt_sweep`` (heuristic mapper,
    timeloop model, ``h100_sm()``) over all mappable entries runs serially,
    then on ``SWEEP_WORKERS`` spawned processes with a journal, then replays
    the journal: the three must agree bit for bit, no pool may have fallen
    back to serial, and the replay must search nothing. Every unique GEMM
    entry is then planned in ``matmul_bf16_h100`` (as the op plans it),
    launched through the op's routing (wgmma), held against its plain
    version and timed beside ``torch.matmul`` (CUDA-graph replay below
    ``GRAPH_BELOW_MS``, else CUDA events; inputs rotated past L2), next to
    Union's prediction for the entry and its bound. Returns the kernels-line
    records (``path`` "whole_model", the timed launches) and what the final
    report needs."""
    arch = h100_sm()
    streams = []
    for model, shape in WHOLE_MODEL:
        s = build_opstream(model, shape)
        r = reconcile_model_flops(s)
        lo, hi = RECONCILE_BAND
        print(f"whole_model: {model} {shape.name} ({shape.kind}, batch {shape.global_batch} x "
              f"{shape.seq_len}): {s.meta['n_ops_pre_dedup']:.0f} ops -> {len(s)} unique "
              f"({len(s.mappable_entries())} mappable), {s.total_flops() / 1e12:.3f} TFLOP a "
              f"step, stream / MODEL_FLOPS {r['ratio']:.4f} (band {lo}-{hi})")
        check(lo <= r["ratio"] <= hi, f"{model} {shape.name}: stream / MODEL_FLOPS {r['ratio']} "
                                      f"outside {RECONCILE_BAND}")
        streams.append(s)
    tasks, index = stream_sweep_tasks(streams, arch)
    t0 = time.perf_counter()
    serial = union_opt_sweep(tasks)
    serial_s = time.perf_counter() - t0
    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    journal = out / "whole_model_journal.json"
    journal.unlink(missing_ok=True)
    with _spawn_without_this_script():
        t0 = time.perf_counter()
        pooled = union_opt_sweep(tasks, workers=SWEEP_WORKERS, pool="process",
                                 journal=str(journal))
        pooled_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    replay = union_opt_sweep(tasks, journal=str(journal), resume=True)
    replay_s = time.perf_counter() - t0
    st = pooled.stats
    print(f"whole_model [{stamp}] sweep of {len(tasks)} entries ({st['engines']} engine groups, "
          f"heuristic mapper, timeloop model, h100_sm(); host time): serial {serial_s:.2f} s, "
          f"{SWEEP_WORKERS} spawned processes {pooled_s:.2f} s ({st['attempts']} attempts, "
          f"{st['retries']} retries, {st['stragglers']} stragglers, pool_failed "
          f"{st['pool_failed']}), journal replay {replay_s:.3f} s "
          f"({replay.stats['replayed_groups']} groups replayed)")
    check(_sweep_view(pooled) == _sweep_view(serial),
          "whole_model: the process-pool sweep differs from the serial one")
    check(serial.stats["pool_failed"] == 0 and st["pool_failed"] == 0,
          f"whole_model: a pool fell back to serial ({st['pool_failed']})")
    check(_sweep_view(replay) == _sweep_view(serial)
          and replay.stats["replayed_groups"] == st["engines"]
          and all(g["replayed"] for g in replay.stats["group_wall"]),
          f"whole_model: the journal replay re-searched groups: {replay.stats['group_wall']}")
    costs = aggregate_stream_costs(streams, index, serial.solutions, arch)
    sol = dict(zip(index, serial.solutions))
    for s, c in zip(streams, costs):
        print(f"whole_model: Union's {s.model} {s.shape} step on h100_sm(): "
              f"{c.latency_s * 1e3:.4f} ms, {c.energy_j:.4g} J; by role "
              + ", ".join(f"{k} {v['latency_s'] * 1e3:.4f} ms" for k, v in c.roles.items()))

    reset_launches()
    records, rows = [], []
    print(f"whole_model [{stamp}] every unique GEMM entry on the card, bf16, planned in "
          f"{MATMUL_BF16_H100.name} (union ms: the sweep's prediction for the entry, raw cycles "
          f"at the h100_sm() clock; plan ms: the space's model at the planned tile, unscaled; "
          f"ms per call, one step's multiplicity beside it):")
    print(f"  {'model':12s} {'shape':12s} {'entry':18s} {'role':9s} {'MxNxK':22s} {'mult':>5s} "
          f"{'tile':16s} {'union ms':>9s} {'plan ms':>9s} {'kernel ms':>9s} {'torch ms':>9s} "
          f"{'plain ms':>9s} {'bound ms':>9s} {'k/torch':>7s} {'timed by':8s}")
    for si, s in enumerate(streams):
        for ei, e in enumerate(s.entries):
            if not e.mappable or e.problem.attrs.get("einsum") != GEMM_EINSUM:
                continue
            dims = e.problem.dims
            M, N, K = dims["b"], dims["o"], dims["i"]
            pshape = planned_shape(M, N, K, torch.bfloat16)
            plan = codesign.plan(MATMUL_BF16_H100, pshape)
            plan_ms = codesign.predict_cost(MATMUL_BF16_H100, pshape, plan.config).latency_s * 1e3
            set_bytes = 2 * (M * K + K * N + M * N)
            sets = [_mm_inputs(gen, M, N, K, torch.bfloat16)
                    for _ in range(max(2, math.ceil(150e6 / set_bytes)))]
            pick = _rotating(sets)
            x, y = sets[0]
            inst = instance_for(x, y)
            check(inst == "wgmma" and plan_for(x, y) == plan.config,
                  f"whole_model {e.problem.name} {M}x{N}x{K}: routed to {inst}, tile "
                  f"{plan_for(x, y)} vs plan {plan.config}")
            got = matmul(x, y)
            _sync_within(f"whole_model {e.problem.name} {M}x{N}x{K} tile {plan.config}")
            if M * N > CHECK_WIDE:  # the first and last rows: both edges of the M tiles
                rows_ = torch.cat([torch.arange(CHECK_ROWS), torch.arange(M - CHECK_ROWS, M)])
                rows_ = rows_.to(x.device)
                err = _check_mm(f"{M}x{N}x{K} rows", got[rows_], x[rows_], y)
            else:
                err = _check_mm(f"{M}x{N}x{K}", got, x, y)
            del got
            fns = {"plain": lambda: matmul_ref(*pick()), "kernel": lambda: matmul(*pick()),
                   "library": lambda: torch.matmul(*pick())}
            before = matmul_cuda.launches
            n = max(3, min(50, int(2e11 / (2 * M * N * K))))
            # decided by the kernel's device time (a short graph), not by an
            # eager probe, which times the host's launch at these sizes
            if _graph_interleaved_ms({"kernel": fns["kernel"]}, n=3, replays=3)["kernel"] < (
                    GRAPH_BELOW_MS):
                ms, timed_by = _graph_interleaved_ms(fns, n=n), "graph"
            else:
                ms, timed_by = _interleaved_ms(fns, n=n), "events"
            launches = matmul_cuda.launches - before
            bound, bound_by = _bound(set_bytes, 2 * M * N * K, BF16_FLOP_PER_S)
            union_ms = sol[(si, ei)].cost.latency_s * 1e3
            rows.append({"model": s.model, "shape": s.shape, "entry": e.problem.name,
                         "role": e.role, "mnk": (M, N, K), "mult": e.multiplicity,
                         "bf": s.backward_factor, "tile": plan.config, "union_ms": union_ms,
                         "plan_ms": plan_ms, "ms": ms["kernel"], "library_ms": ms["library"],
                         "plain_ms": ms["plain"], "bound_ms": bound})
            print(f"  {s.model:12s} {s.shape:12s} {e.problem.name:18s} {e.role:9s} "
                  f"{f'{M}x{N}x{K}':22s} {e.multiplicity:5.0f} {str(plan.config):16s} "
                  f"{union_ms:9.4f} {plan_ms:9.4f} {ms['kernel']:9.4f} {ms['library']:9.4f} "
                  f"{ms['plain']:9.4f} {bound:9.4f} {ms['kernel'] / ms['library']:7.3f} "
                  f"{timed_by:8s}")
            check(launches > 0, f"whole_model {e.problem.name}: no timed launch")
            records.append({**_kernel_keys(MATMUL_BF16_H100), "instance": inst,
                            "path": "whole_model",
                            "shape": f"{s.model} {s.shape} {e.problem.name} {M}x{N}x{K} bf16 "
                                     f"tile {plan.config}; timed by {timed_by}",
                            "launches": launches, "max_abs_err": err, "ms": ms["kernel"],
                            "plain_ms": ms["plain"], "bound_ms": bound, "bound_by": bound_by,
                            "library_ms": ms["library"]})
            del sets, x, y, pick, fns
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    by_instance = dict(matmul_cuda.launches_by_instance)
    check(by_instance["wgmma"] == matmul_cuda.launches > 0,
          f"whole_model: matmul launches by instance {by_instance}: every one should be wgmma's")
    sums = {}
    for r in rows:
        w = r["mult"] * r["bf"]
        acc = sums.setdefault((r["model"], r["shape"]), dict.fromkeys(
            ("union_ms", "plan_ms", "ms", "library_ms", "plain_ms", "bound_ms"), 0.0))
        for k in acc:
            acc[k] += w * r[k]
    for (model, shape), acc in sums.items():
        bf = next(s.backward_factor for s in streams if (s.model, s.shape) == (model, shape))
        print(f"whole_model [{stamp}] {model} {shape} GEMMs, multiplicity-weighted"
              f"{' x3 (backward)' if bf == 3 else ''}: Union {acc['union_ms']:.3f} ms, plan "
              f"model {acc['plan_ms']:.3f} ms, kernel "
              f"{acc['ms']:.3f} ms, torch.matmul {acc['library_ms']:.3f} ms, plain "
              f"{acc['plain_ms']:.3f} ms, bound {acc['bound_ms']:.3f} ms (kernel / bound "
              f"{acc['ms'] / acc['bound_ms']:.2f})")
    out.joinpath("whole_model.json").write_text(json.dumps(
        {"device": stamp, "rows": rows, "sums": [{"model": m, "shape": sh, **acc}
                                                 for (m, sh), acc in sums.items()]},
        indent=1, default=str))
    print("whole_model: the full table is in chiprun_out/whole_model.json")
    return {"records": records, "costs": {(c.model, c.shape): c for c in costs},
            "fused": _fused_predictions(streams, sol),
            "sweep_s": {"serial": serial_s, "pooled": pooled_s},
            "tasks": tasks, "serial": serial}


# ---------------------------------------------------------------------- #
# search_engine: Union's search on the card (the engine's torch backend)
# ---------------------------------------------------------------------- #
# the top-level torch ops a replayed fused dispatch may issue: the copy of
# the batch into the graph's input, the incumbent's fill, the copies out
# (``.cpu()`` and ``.numpy()``); the program's body runs inside the graph
DISPATCH_OPS = {"aten::copy_", "aten::fill_", "aten::to", "aten::_to_copy", "aten::detach",
                "aten::resolve_conj", "aten::resolve_neg"}
# warm timing rounds a (problem, mapper) cell, each backend once a round
SEARCH_ROUNDS = 5
# benchmarks/serve_bench.py's smoke service load: 24 Poisson arrivals at 25/s
# over 4 GEMM shapes, budget 150; a burst of 8 cold queries at queue cap 2
SERVE_REQUESTS, SERVE_SHAPES, SERVE_RATE, SERVE_BURST = 24, 4, 25.0, 8
# cold queries a backend for (c)'s cold-query p50/p99
COLD_QUERIES = engine_ab.COLD_QUERIES


def _runners_on_card(problem, arch) -> None:
    """Check that every fused runner the context holds runs on the card."""
    devices = {key[2] for key in get_context(problem, arch)._fused_runners}
    check(devices == {"cuda"}, f"{problem.name}: fused runners on {devices}, not the card")


def _profile_dispatch(stamp, problem, arch, rows) -> dict:
    """``engine_ab.profile_dispatch`` over warm dispatches of the engine's
    generic fused runner, each a replay of the bucket's CUDA graph,
    printed; none of the top-level torch ops may be of the program's body
    (only the copy in, the incumbent's fill and the copies out)."""
    p = engine_ab.profile_dispatch(problem, arch, rows)
    busy, wall = p["busy_ms"], p["wall_ms"]
    dev = ("device kernels and busy not measured (the profiler saw no device kernel)"
           if busy is None else
           f"{p['kernels']:.0f} device kernels, device busy {busy:.3f} ms (idle {1 - busy / wall:.1%})")
    check(p["graph_ms"] is not None, f"search_engine: {problem.name}: no graph at {p['padded']}")
    print(f"  dispatch profile [{stamp}] {problem.name} on {arch.name}, {rows} rows (padded "
          f"{p['padded']}), graph replay: wall {wall:.3f} ms under the profiler, "
          f"{p['plain_wall_ms']:.3f} ms without, {p['ops']:.0f} top-level torch ops "
          f"{json.dumps(p['op_names'])}, {dev}; the graph alone {p['graph_ms']:.3f} ms a replay "
          f"on the device, {p['graph_launch_ms']:.3f} ms to launch")
    check(set(p["op_names"]) <= DISPATCH_OPS and p["ops"] <= 16,
          f"search_engine: a replayed dispatch ran ops of the program's body: {p['op_names']}")
    return p


def _check_torch_record(label, env) -> None:
    c = env["record"]["counters"]
    check(env.get("backend", "torch") == "torch" and c["backend_fallbacks"] == 0
          and c["fused_dispatches"] > 0,
          f"search_engine {label}: the torch service fell back or never dispatched: {env}")


def phase_search_engine(stamp, wm) -> dict:
    """Union's search on the card: the engine's ``backend="torch"`` runs
    its array programs as float64/int64 tensors on CUDA, and every result
    must equal the numpy engine's bit for bit, with no fallback.

    (a) the whole_model phase's sweep (29 entries, heuristic mapper,
        timeloop, ``h100_sm()``) again on torch, against its numpy sweep;
    (b) ``benchmarks/mappers_bench.py``'s matrix outside smoke mode (BERT-2
        on ``cloud_accelerator()``, timeloop, EDP: random, exhaustive at
        3000, genetic, heuristic) and the exhaustive mapper at its 50,000
        cap on the prefill head on ``h100_sm()`` (device loop on and off),
        each on numpy and on torch (cold, then warm): evals/s on the host
        clock with the card synchronised, programs first dispatched
        (``n_traces``), device syncs and dispatches;
    (c) the mapping service on torch: 24 Poisson queries over 4 shapes
        through the HTTP front on 127.0.0.1, each answer equal to a numpy
        service's, itself served over HTTP and timed in turns with it;
        then 120 cold queries of distinct GEMM shapes to both in turns
        (cold-query p50/p99 on both backends), each answer equal; a burst
        of 8 against queue cap 2 must shed; injected
        ``jaxfail:0;jaxfail:1`` must walk the breaker closed -> open ->
        half_open -> closed with exactly the injected fallbacks.

    The measurements are ``tools/engine_ab.py``'s, which times a parent
    tree the same way. On the card each program runs as one CUDA graph per pow2 bucket: in
    (a) and in every row of (b) the graphs captured must equal the traces
    (``n_traces``); the graphs' memory pool is reported after each, and
    the graphs are released at the end of the phase.
    """
    arch = h100_sm()
    out = {"device": stamp}
    # (a) --------------------------------------------------------------- #
    g0, tr0 = graph_count(), global_trace_count()
    t0 = time.perf_counter()
    swept = union_opt_sweep(wm["tasks"], engine_backend="torch", engine_device="cuda")
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    st = swept.stats
    graphs, pool = graph_count() - g0, graph_pool_bytes()
    print(f"search_engine [{stamp}] (a) the whole-model sweep on the card: {st['tasks']} entries, "
          f"{st['engines']} engine groups, {sweep_s:.3f} s host (numpy serial "
          f"{wm['sweep_s']['serial']:.3f} s); fused dispatches {st['fused_dispatches']}, programs "
          f"first dispatched {st['n_traces']} (+ {st['warmed_buckets']} warmed), CUDA graphs "
          f"captured {graphs} (pool "
          f"{pool / 2**20:.1f} MiB), warmed buckets {st['warmed_buckets']}, device syncs "
          f"{st['device_syncs']}, backend fallbacks {st['backend_fallbacks']}")
    # the searches' traces plus the warmup's (each warmed bucket of the
    # shape-generic runner is a program first dispatched)
    check(graphs == global_trace_count() - tr0 == st["n_traces"] + st["warmed_buckets"],
          f"search_engine (a): {graphs} graphs captured for {global_trace_count() - tr0} traces "
          f"({st['n_traces']} in the searches, {st['warmed_buckets']} warmed buckets)")
    check(_sweep_view(swept) == _sweep_view(wm["serial"]),
          "search_engine (a): the torch sweep differs from the numpy sweep")
    check(st["backend_fallbacks"] == 0 and st["fused_dispatches"] > 0,
          f"search_engine (a): fallbacks {st['backend_fallbacks']}, fused dispatches "
          f"{st['fused_dispatches']}")
    ctxs = {id(c): c for c in (get_context(s.problem, arch) for s in swept)}
    devices = {key[2] for c in ctxs.values() for key in c._fused_runners}
    dispatches = sum(c.device_dispatches for c in ctxs.values())
    print(f"search_engine (a): {dispatches} device dispatches over {len(ctxs)} analysis contexts, "
          f"runners on {sorted(devices)}")
    check(devices == {"cuda"} and dispatches > 0,
          f"search_engine (a): runners on {devices}, {dispatches} device dispatches")
    out["sweep"] = {"tasks": st["tasks"], "torch_s": sweep_s, "numpy_s": wm["sweep_s"]["serial"],
                    "fused_dispatches": st["fused_dispatches"], "n_traces": st["n_traces"],
                    "graphs": graphs, "pool_bytes": pool,
                    "device_syncs": st["device_syncs"], "device_dispatches": dispatches}
    # (b) --------------------------------------------------------------- #
    rows = []
    print(f"search_engine [{stamp}] (b) mapper matrix, timeloop, EDP; evals/s = scored "
          f"candidates / host seconds (card synchronised); torch cold, then {SEARCH_ROUNDS} warm "
          f"rounds interleaved with numpy (median [min, max]):")
    print(f"  {'problem':13s} {'mapper':10s} {'loop':4s} {'numpy ev/s':>28s} {'torch cold':>10s} "
          f"{'torch warm ev/s':>28s} {'t/n':>5s} {'scored':>6s} {'pruned':>6s} {'fused':>5s} "
          f"{'traces':>6s} {'graphs':>6s} {'syncs':>5s} {'dispatches':>10s}")
    for problem, a, mp, kw, loop in engine_ab.mapper_runs(arch):
        row, sol_n, sols = engine_ab.mapper_cell(problem, a, mp, kw, loop, SEARCH_ROUNDS)
        _runners_on_card(problem, a)
        check(row["graphs_cold"] == row["n_traces_cold"]
              and row["graphs_warm"] == row["n_traces_warm"],
              f"search_engine (b) {problem.name} {mp}: {row['graphs_cold']} graphs captured cold "
              f"for {row['n_traces_cold']} traces, {row['graphs_warm']} warm for "
              f"{row['n_traces_warm']}")
        for sol in sols:
            check(engine_ab.search_view(sol) == engine_ab.search_view(sol_n),
                  f"search_engine (b) {problem.name} {mp}: torch differs from numpy")
            check(sol.search.backend_fallbacks == 0 and sol.search.fused_dispatches > 0,
                  f"search_engine (b) {problem.name} {mp}: fallbacks "
                  f"{sol.search.backend_fallbacks}, fused {sol.search.fused_dispatches}")
        rows.append(row)
        med = {"numpy": (row["numpy_evals_per_s"], row["numpy_evals_per_s_range"]),
               "torch": (row["torch_warm_evals_per_s"], row["torch_warm_evals_per_s_range"])}
        span = {b: f"{m:9.0f} [{lo:8.0f}, {hi:8.0f}]" for b, (m, (lo, hi)) in med.items()}
        print(f"  {problem.name:13s} {mp:10s} {'on' if loop else 'off':4s} {span['numpy']:>28s} "
              f"{row['torch_cold_evals_per_s']:10.0f} {span['torch']:>28s} "
              f"{row['torch_over_numpy']:5.2f}{'' if row['resolved'] else '~'} "
              f"{row['scored']:6d} {row['pruned']:6d} {row['fused_dispatches']:5d} "
              f"{row['n_traces_cold']:6d} {row['graphs_cold']:6d} {row['device_syncs']:5d} "
              f"{row['device_dispatches']:10d}")
    print("  (~: the backends' ranges overlap, the ratio is not resolved within host noise)")
    print(f"  CUDA graphs captured: {graph_count()}, their pool "
          f"{graph_pool_bytes() / 2**20:.1f} MiB")
    out["mappers"] = rows
    out["dispatch_profiles"] = [_profile_dispatch(stamp, p, a, r) for p, a in (
        (engine_ab.bert2(), cloud_accelerator()), (engine_ab.prefill_head(), arch))
        for r in (256, 2048)]
    # (c) --------------------------------------------------------------- #
    state = Path(tempfile.mkdtemp(prefix="search-engine-"))
    try:
        out["service"] = _service_on_card(stamp, state)
    finally:
        shutil.rmtree(state, ignore_errors=True)
    out["graphs"], out["pool_bytes"] = graph_count(), graph_pool_bytes()
    # the phases after this one search on numpy: give the pool back
    reset_trace_registry()
    torch.cuda.empty_cache()
    target = Path(__file__).resolve().parent / "chiprun_out"
    target.mkdir(exist_ok=True)
    target.joinpath("search_engine.json").write_text(json.dumps(out, indent=1, default=str))
    print("search_engine: the full record is in chiprun_out/search_engine.json")
    return out


def _service_on_card(stamp, state: Path) -> dict:
    svc = MappingService(str(state / "torch"), backend="torch", device="cuda", deadline_s=30.0,
                         queue_cap=2, workers=2)
    twin = MappingService(str(state / "numpy"), backend="numpy", deadline_s=30.0)
    httpd, twin_httpd = serve_mapping(svc), serve_mapping(twin)
    port, twin_port = httpd.server_address[1], twin_httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    twin_th = threading.Thread(target=twin_httpd.serve_forever, daemon=True)
    th.start()
    twin_th.start()

    sizes = [32 + 16 * i for i in range(SERVE_SHAPES)]
    bursts = [40 + 8 * i for i in range(SERVE_BURST)]
    drills = [(32 + 16 * i, 32, 32) for i in range(4)]
    # cold queries: shapes no other query of (c) asks for
    cold_shapes = engine_ab.cold_shapes(
        COLD_QUERIES, exclude=[(m, m, m) for m in sizes] + [(m, m + 8, m) for m in bursts] + drills)
    try:
        rng = random.Random(SEED)
        lat, warm = [], 0
        for i in range(SERVE_REQUESTS):
            time.sleep(rng.expovariate(SERVE_RATE))
            m = rng.choice(sizes)
            q = engine_ab.gemm_query(m, m, m)
            # the two services in turns, each over its own HTTP front
            envs = {}
            for backend in (("torch", "numpy") if i % 2 == 0 else ("numpy", "torch")):
                t0 = time.perf_counter()
                code, envs[backend] = engine_ab.post(port if backend == "torch" else twin_port, q)
                ms = (time.perf_counter() - t0) * 1e3
                check(code == 200 and envs[backend]["ok"]
                      and not envs[backend]["budget_exhausted"],
                      f"search_engine (c) query {i} on {backend}: {code} {envs[backend]}")
                if backend == "torch":
                    lat.append(ms)
            env = envs["torch"]
            if env["source"] == "store":
                warm += 1
            else:
                _check_torch_record(f"query {i}", env)
            check(engine_ab.answer(env) == engine_ab.answer(envs["numpy"]),
                  f"search_engine (c) query {i} ({m}^3): the torch answer differs from numpy's")
        p50, p99 = engine_ab.p50_p99(lat)
        # the cold series: each shape a search on both services, in turns
        cold = engine_ab.cold_series({"torch": port, "numpy": twin_port}, cold_shapes)
        for (m, n, k), env, twin_env in zip(cold_shapes, cold["torch"].pop("envs"),
                                            cold["numpy"].pop("envs")):
            _check_torch_record(f"cold query {m}x{n}x{k}", env)
            check(engine_ab.answer(env) == engine_ab.answer(twin_env),
                  f"search_engine (c) cold query {m}x{n}x{k}: torch's answer differs from numpy's")

        def burst_one(m):
            q = engine_ab.gemm_query(m, m + 8, m, budget=400, deadline_s=5.0)
            return engine_ab.post(port, q), m

        with concurrent.futures.ThreadPoolExecutor(max_workers=SERVE_BURST) as ex:
            burst = list(ex.map(burst_one, bursts))
        shed = sum(1 for (code, _e), _m in burst if code == 429)
        served = [(env, m) for (code, env), m in burst if code == 200 and env.get("ok")]
        check(shed >= 1 and shed + len(served) == SERVE_BURST,
              f"search_engine (c) burst of {SERVE_BURST} at queue cap 2: {shed} shed, "
              f"{len(served)} served")
        for env, m in served:
            if not env["budget_exhausted"]:
                _check_torch_record(f"burst {m}", env)
                check(engine_ab.answer(env) == engine_ab.answer(twin.handle_query(
                    engine_ab.gemm_query(m, m + 8, m, budget=400))),
                      f"search_engine (c) burst {m}: the torch answer differs from numpy's")
        metrics = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                                    timeout=30).read())
    finally:
        httpd.shutdown()
        twin_httpd.shutdown()
        svc.drain()
        th.join(timeout=30)
        twin_th.join(timeout=30)
    check(not th.is_alive() and not twin_th.is_alive(),
          "search_engine (c): an HTTP thread did not stop")
    check(metrics["shed"] == shed and metrics["store_hits"] == warm,
          f"search_engine (c) metrics disagree with the run: {metrics}")
    print(f"search_engine [{stamp}] (c) mapping service on the card (HTTP on 127.0.0.1, "
          f"{SERVE_REQUESTS} Poisson queries at {SERVE_RATE}/s over {SERVE_SHAPES} shapes, budget "
          f"{engine_ab.SERVE_BUDGET}): p50 {p50:.3f} ms, p99 {p99:.3f} ms, {warm} journal-served; "
          f"{COLD_QUERIES} cold queries of distinct shapes, the numpy service in turns: torch p50 "
          f"{cold['torch']['p50_ms']:.3f} ms p99 {cold['torch']['p99_ms']:.3f} ms, numpy p50 "
          f"{cold['numpy']['p50_ms']:.3f} ms p99 {cold['numpy']['p99_ms']:.3f} ms; burst of "
          f"{SERVE_BURST} at queue cap 2: {shed} shed, {len(served)} served; metrics "
          + json.dumps({k: metrics[k] for k in ("queries", "store_hits", "searches", "partials",
                                                 "shed", "seeded", "seed_misfires",
                                                 "neighbor_hits", "backend", "device")}))
    drill = MappingService(str(state / "breaker"), backend="torch", device="cuda",
                           deadline_s=None, breaker_threshold=2, probe_interval=2,
                           fault_spec="jaxfail:0;jaxfail:1")
    envs = []
    for i, (m, n, k) in enumerate(drills):
        q = engine_ab.gemm_query(m, n, k, budget=96)
        env = drill.handle_query(q)
        check(env["ok"] and engine_ab.answer(env) == engine_ab.answer(twin.handle_query(q)),
              f"search_engine (c) breaker query {i}: the answer differs from numpy's")
        envs.append(env)
    br = drill.metrics()["breaker"]
    backends = [e["backend"] for e in envs]
    fallbacks = [e["record"]["counters"]["backend_fallbacks"] for e in envs]
    check(br["transitions"] == ["closed->open", "open->half_open", "half_open->closed"]
          and br["state"] == "closed" and backends == ["numpy", "numpy", "numpy", "torch"]
          and fallbacks == [1, 1, 0, 0],
          f"search_engine (c) breaker drill: {br}, backends {backends}, fallbacks {fallbacks}")
    _check_torch_record("breaker probe", envs[3])
    print(f"search_engine (c) breaker drill (jaxfail:0;jaxfail:1, threshold 2, probe interval 2): "
          f"{' '.join(br['transitions'])}; backends {backends}; fallbacks {fallbacks}")
    return {"p50_ms": p50, "p99_ms": p99, "latencies_ms": lat, "warm": warm, "shed": shed,
            "cold": cold,
            "served": len(served), "metrics": metrics, "breaker": br}


def _fused_predictions(streams, sol) -> dict:
    """Union's ms for the stream entries each fused kernel computes, summed
    per (model, shape, kernel); fails unless each stream of ``FUSED_IN``
    holds its whole group, swept, and no other stream holds any of it."""
    fused = {}
    for si, s in enumerate(streams):
        for name, (role, einsums) in FUSED.items():
            found = {e.problem.attrs.get("einsum"): ei for ei, e in enumerate(s.entries)
                     if e.role == role and e.problem.attrs.get("einsum") in einsums}
            if (s.model, s.shape) not in FUSED_IN[name]:
                check(not found, f"whole_model: {s.model} {s.shape} holds {name}'s entries")
                continue
            check(sorted(found) == sorted(einsums) and all((si, ei) in sol for ei in found.values()),
                  f"whole_model: {s.model} {s.shape}: {name}'s entries {einsums} not all in the "
                  f"swept stream (found {sorted(found)})")
            fused[(s.model, s.shape, name)] = sum(
                sol[(si, ei)].cost.latency_s * 1e3 for ei in found.values())
    return fused


def report_whole_model(stamp, wm, decode_step, train_step, time_records) -> None:
    """Union's whole-model predictions beside the steps and fused kernels
    this run measured: the share of each step outside Union's stream. Each
    step is compared by its device busy time under the profiler (the decode
    step at the stream's KV length) and, apart, by its wall time."""
    measured = {
        ("qwen3-0.6b", "h100_decode"): (
            decode_step, f"profiled at positions {MAX_LEN - PROFILE_STEPS}-{MAX_LEN - 1} (KV "
                         f"{MAX_LEN - PROFILE_STEPS + 1}-{MAX_LEN}; the stream's KV is {MAX_LEN})",
            "eager, positions 200-219, host dispatch included"),
        (TRAIN["arch"], "h100_train"): (
            train_step, "one profiled step", f"median of steps 2-{TRAIN['steps']}")}
    for (model, shape), c in wm["costs"].items():
        pred = c.latency_s * 1e3
        roles = ", ".join(f"{k} {v['latency_s'] * 1e3:.4f}" for k, v in c.roles.items())
        head = (f"whole_model [{stamp}] {model} {shape}: Union predicts {pred:.4f} ms a step "
                f"(ms by role: {roles})")
        if (model, shape) not in measured:
            print(f"{head}; no step measured at this shape")
            continue
        step, dev_how, wall_how = measured[(model, shape)]
        dev = ("device busy not measured (the profiler saw no kernel)"
               if step["device_ms"] is None else
               f"device busy {step['device_ms']:.3f} ms ({dev_how}), "
               f"{step['device_ms'] / pred:.2f}x the prediction")
        print(f"{head}; measured step: {dev}; wall {step['wall_ms']:.3f} ms ({wall_how}), "
              f"{step['wall_ms'] / pred:.2f}x")

    def timed(name, prefix, key="ms"):
        return next(r[key] for r in time_records
                    if r["name"] == name and r["shape"].startswith(prefix))

    kernel_ms = {("qwen3-0.6b", "h100_decode", "flash_attention"):
                 (timed("flash_attention", "decode", "device_ms"), "decode, device time"),
                 (TRAIN["arch"], "h100_train", "flash_attention"):
                 (timed("flash_attention", "train"), "training shape, causal"),
                 (TRAIN["arch"], "h100_train", "ssd_scan"):
                 (timed("ssd_scan", "train"), "training shape")}
    for (model, shape, name), pred in wm["fused"].items():
        got = kernel_ms.get((model, shape, name))
        what = " + ".join(FUSED[name][1])
        if got is None:
            print(f"whole_model [{stamp}] {model} {shape} {name} ({what}): Union {pred:.4f} ms "
                  f"a call; no kernel time at this shape")
        else:
            print(f"whole_model [{stamp}] {model} {shape} {name} ({what}): Union {pred:.4f} ms "
                  f"a call, the kernel {got[0]:.4f} ms ({got[1]}), "
                  f"{got[0] / pred:.3f}x the prediction")


def _profile_bf16_calibration_launch(rows) -> None:
    """Bf16 calibration launches (three of the last matmul_bf16_h100 row's
    shape and tile) under torch.profiler: the device kernel that ran must be
    the wgmma instance, not only a count that rose. This is the process's
    first profiler session, and a first CUPTI session has been seen to
    return no device events at all: one unchecked session warms the
    profiler up, and a session that saw no device kernel is taken again,
    up to PROFILE_TRIES times. Any kernel seen must be the wgmma instance."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    r = [r for r in rows if r["kernel"] == MATMUL_BF16_H100.name][-1]
    inputs = MATMUL_BF16_H100.example_inputs(tuple(r["shape"]), "cuda",
                                             torch.Generator(device="cuda").manual_seed(SEED))

    def device_kernels():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                MATMUL_BF16_H100.run(inputs, tuple(r["config"]))
            torch.cuda.synchronize()
        return [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    MATMUL_BF16_H100.run(inputs, tuple(r["config"]))
    device_kernels()
    for tries in range(1, PROFILE_TRIES + 1):
        names = device_kernels()
        if names:
            break
    print(f"codesign: profiled bf16 calibration launches {tuple(r['shape'])} tile "
          f"{tuple(r['config'])} (after one warm-up session; session {tries} of at most "
          f"{PROFILE_TRIES}): device kernels {[n[:100] for n in names]}")
    check(names and any("matmul_wgmma_kernel" in n for n in names),
          f"the bf16 calibration launches ran {names}, not the wgmma instance")


def _matmul_launches_by_shape(res, rows) -> dict:
    """The loop's matmul launches at each (M, N, K, dtype): step 4's (one
    in each dtype) and the calibration rows'."""
    out = {(*res["shape"], t): 1 for t in (torch.float32, torch.bfloat16)}
    for r in rows:
        for dtype, space in MM_SPACES.items():
            if r["kernel"] == space.name:
                key = (*r["shape"], dtype)
                out[key] = out.get(key, 0) + r["launches"]
    return out


def _time_mla_decode(stamp, gen, fa, errs, moe_launches) -> dict:
    """Flash attention at deepseek-v2-lite's MLA decode shape: q and k of
    d = 192 (nope 128 + rope 64), v of dv = 128 as the model passes it (a
    strided view of the up-projection), zero-padded to the D = 192
    instance; eager and by CUDA-graph replay, beside its bound, its plain
    version and SDPA. Returns the kernels-line record (serve_moe's launches)."""
    b, hq, hkv, dn, dr, dv, cache = MLA_DECODE.values()
    d, kv_len = dn + dr, cache

    def mla_inputs():
        q = torch.randn((b, 1, hq, d), generator=gen, device="cuda").bfloat16()
        k = torch.randn((b, cache, hkv, d), generator=gen, device="cuda").bfloat16()
        kv = torch.randn((b, cache, hkv, dn + dv), generator=gen, device="cuda").bfloat16()
        return q, k, kv[..., dn:]

    pick = _rotating([mla_inputs() for _ in range(6)])
    kw = dict(causal=False, q_offset=kv_len - 1, kv_len=kv_len, sm_scale=1.0 / math.sqrt(d))
    fns = {
        "plain": lambda: _plain(*pick(), causal=False, q_offset=kv_len - 1, kv_len=kv_len,
                                scale=1.0 / math.sqrt(d)),
        "kernel": lambda: flash_attention(*pick(), **kw),
        "library": lambda: (lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            scale=1.0 / math.sqrt(d)))(*pick()),
    }
    ms = _interleaved_ms(fns, n=100)
    dev = _graph_interleaved_ms(fns, n=100)
    bytes_ = 2 * (b * hq * d + b * kv_len * hkv * (d + dv) + b * hq * dv)
    bound, bound_by = _bound(bytes_, 2 * b * hq * kv_len * (d + dv), BF16_FLOP_PER_S)
    parts = n_split(b, hkv, kv_len, plan_blocks(1, cache, compiled_dim(d, dv))[1])
    print(f"time [{stamp}] flash_attention MLA decode b={b} hq={hq} hkv={hkv} d={d} dv={dv} "
          f"kv_len={kv_len} bf16 (the D = {compiled_dim(d, dv)} instance, v padded to it), "
          f"n_split {parts}: eager calls: kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} "
          f"ms, sdpa {ms['library']:.4f} ms; CUDA-graph replay (device time): kernel "
          f"{dev['kernel']:.4f} ms ({bytes_ / dev['kernel'] / 1e6:.1f} GB/s), plain "
          f"{dev['plain']:.4f} ms, sdpa {dev['library']:.4f} ms, kernel / sdpa "
          f"{dev['kernel'] / dev['library']:.3f}, bound {bound:.4f} ms ({bound_by}: "
          f"{bytes_ / 1e6:.2f} MB at 3.35 TB/s; {bound / dev['kernel']:.1%} of it); "
          f"{moe_launches} launches on the serve_moe path (deepseek-v2-lite-16b)")
    return {**fa, "path": "serve_moe",
            "shape": f"MLA decode b={b} hq={hq} hkv={hkv} d={d} dv={dv} kv_len={kv_len} bf16",
            "launches": moe_launches, "max_abs_err": errs["fa_mla_decode"],
            "ms": ms["kernel"], "plain_ms": ms["plain"], "bound_ms": bound,
            "bound_by": bound_by, "library_ms": ms["library"],
            "device_ms": dev["kernel"], "device_plain_ms": dev["plain"],
            "device_library_ms": dev["library"], "n_split": parts}


def _time_fa_prefill(stamp, gen, fa, path, launches, err) -> dict:
    """Flash attention at the FA_FAMILIES shape named ``path`` (many rows,
    bf16) beside its bound, its plain version and SDPA; the kernels-line
    record with that path's launches."""
    (b, S, _, hq, hkv, d), causal = next(c[1:3] for c in FA_FAMILIES if c[0] == path)
    pick = _rotating([_qkv(gen, b, S, S, hq, hkv, d, torch.bfloat16) for _ in range(2)])
    ms = _interleaved_ms({
        "plain": lambda: _plain(*pick(), causal=causal, scale=1.0 / math.sqrt(d)),
        "kernel": lambda: flash_attention(*pick(), causal=causal),
        "library": lambda: torch.nn.functional.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in pick()), is_causal=causal, enable_gqa=hq != hkv),
    }, n=10)
    bytes_ = 2 * (2 * b * S * hq * d + 2 * b * S * hkv * d)  # q, o; k, v in bf16
    flops = 4 * b * hq * (S * (S + 1) // 2 if causal else S * S) * d
    bound, bound_by = _bound(bytes_, flops, BF16_FLOP_PER_S)
    label = (f"b={b} S={S} hq={hq} hkv={hkv} d={d} {'causal' if causal else 'non-causal'} bf16")
    print(f"time [{stamp}] flash_attention {path} {label} (tile {plan_blocks(S, S, d)}): kernel "
          f"{ms['kernel']:.4f} ms ({flops / ms['kernel'] / 1e9:.1f} TFLOP/s), plain "
          f"{ms['plain']:.4f} ms, sdpa {ms['library']:.4f} ms "
          f"({flops / ms['library'] / 1e9:.1f} TFLOP/s), kernel / sdpa "
          f"{ms['kernel'] / ms['library']:.3f}, bound {bound:.4f} ms ({bound_by}: "
          f"{flops / 1e9:.1f} GFLOP at 989 TFLOP/s bf16; {bound / ms['kernel']:.1%} of it); "
          f"{launches} launches on the families path")
    return {**fa, "path": "families", "shape": f"{path} {label}", "launches": launches,
            "max_abs_err": err, "ms": ms["kernel"], "plain_ms": ms["plain"], "bound_ms": bound,
            "bound_by": bound_by, "library_ms": ms["library"]}


def _time_fa_train(stamp, gen, fa, name, shape, path, launches, err) -> dict:
    """Flash attention at a training shape of FA_TRAIN_NEW (causal, bf16; v
    of dv < d zero-padded by the op as the model's MLA call is) beside its
    bound, its plain version and SDPA; the kernels-line record with that
    path's launches."""
    b, S, _, hq, hkv, d = shape[:6]
    dv = shape[6] if len(shape) > 6 else d
    pick = _rotating([_qkv(gen, b, S, S, hq, hkv, d, torch.bfloat16, dv) for _ in range(2)])
    ms = _interleaved_ms({
        "plain": lambda: _plain(*pick(), causal=True, scale=1.0 / math.sqrt(d)),
        "kernel": lambda: flash_attention(*pick(), causal=True),
        "library": lambda: torch.nn.functional.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in pick()), is_causal=True, enable_gqa=hq != hkv),
    }, n=10)
    bytes_ = 2 * b * S * (hq * d + hkv * d + hkv * dv + hq * dv)  # q, k, v, o in bf16
    flops = 2 * b * hq * (S * (S + 1) // 2) * (d + dv)
    bound, bound_by = _bound(bytes_, flops, BF16_FLOP_PER_S)
    label = f"b={b} S={S} hq={hq} hkv={hkv} d={d}" + (f" dv={dv}" if dv != d else "") + " causal bf16"
    D = compiled_dim(d, dv)
    print(f"time [{stamp}] flash_attention {path} {label} (the D={D} instance, tile "
          f"{plan_blocks(S, S, D)}): kernel {ms['kernel']:.4f} ms "
          f"({flops / ms['kernel'] / 1e9:.1f} TFLOP/s), plain {ms['plain']:.4f} ms, sdpa "
          f"{ms['library']:.4f} ms ({flops / ms['library'] / 1e9:.1f} TFLOP/s), kernel / sdpa "
          f"{ms['kernel'] / ms['library']:.3f}, bound {bound:.4f} ms ({bound_by}: "
          f"{flops / 1e9:.1f} GFLOP at 989 TFLOP/s bf16; {bound / ms['kernel']:.1%} of it); "
          f"{launches} launches on the {path} path")
    return {**fa, "path": path, "shape": f"{name} {label}", "launches": launches,
            "max_abs_err": err, "ms": ms["kernel"], "plain_ms": ms["plain"], "bound_ms": bound,
            "bound_by": bound_by, "library_ms": ms["library"]}


def _time_fa_context(stamp, gen, fa, name, shape, start, launches, err, arch) -> dict:
    """Flash attention at (h1)'s context-parallel shape (a shard's queries
    from ``start`` against every key, causal, bf16) beside its bound (the
    causal pairs of the shard's rows, and the keys they read), its plain
    version and SDPA with an explicit boolean mask; the kernels-line record
    with the launches at that q_offset on (h1)'s main path for ``arch``."""
    b, sq, skv, hq, hkv, d = shape[:6]
    dv = shape[6] if len(shape) > 6 else d
    pick = _rotating([_qkv(gen, b, sq, skv, hq, hkv, d, torch.bfloat16, dv) for _ in range(2)])
    mask = (torch.arange(sq, device="cuda")[:, None] + start
            >= torch.arange(skv, device="cuda")[None, :])
    ms = _interleaved_ms({
        "plain": lambda: _plain(*pick(), causal=True, scale=1.0 / math.sqrt(d), q_offset=start),
        "kernel": lambda: flash_attention(*pick(), causal=True, q_offset=start),
        "library": lambda: torch.nn.functional.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in pick()), attn_mask=mask, enable_gqa=hq != hkv),
    }, n=10)
    pairs = sq * start + sq * (sq + 1) // 2  # the live (query, key) pairs of the shard's rows
    live = min(skv, start + sq)  # the keys those rows read
    bytes_ = 2 * b * (sq * hq * (d + dv) + live * hkv * (d + dv))  # q, o; k, v read once; bf16
    flops = 2 * b * hq * pairs * (d + dv)
    bound, bound_by = _bound(bytes_, flops, BF16_FLOP_PER_S)
    dims = f"d={d}" + (f" dv={dv}" if dv != d else "")
    label = f"b={b} Sq={sq} Skv={skv} q_offset={start} hq={hq} hkv={hkv} {dims} causal bf16"
    print(f"time [{stamp}] flash_attention distributed (h1) {arch} {label} (tile "
          f"{plan_blocks(sq, skv, compiled_dim(d, dv))}): kernel {ms['kernel']:.4f} ms "
          f"({flops / ms['kernel'] / 1e9:.1f} TFLOP/s), plain {ms['plain']:.4f} ms, sdpa with a "
          f"boolean mask {ms['library']:.4f} ms, bound {bound:.4f} ms ({bound_by}: "
          f"{flops / 1e9:.2f} GFLOP at 989 TFLOP/s bf16, {bytes_ / 1e6:.1f} MB at 3.35 TB/s "
          f"({live} keys read); {bound / ms['kernel']:.1%} of it); {launches} launches on each "
          f"rank at this q_offset in (h1)'s step")
    return {**fa, "path": f"distributed (h1) {arch}", "shape": f"{name} {label}",
            "launches": launches, "max_abs_err": err, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": bound, "bound_by": bound_by, "library_ms": ms["library"]}


# (g)'s decode shapes timed on one rank: the G_LSE case, the (g) run whose
# launches it carries, the live keys (the wave's last step: 48 of the 64
# slots; a full sequence shard of 32)
G_TIMED = [("g heads", "qwen3 bf16 heads", 48), ("g sequence", "qwen3 bf16 sequence", 32),
           ("g mla", "deepseek f32", 32), ("h sequence over dp", "qwen3 f32 fsdp_only", 4)]


def _time_g_decode(stamp, gen, fa, name, run, kv_len, err) -> dict:
    """Flash attention at one of distributed (g)'s local decode shapes, in
    the dtype that run served in (with the log-sum-exp where its cache is
    split by sequence), beside its bound, its plain version and SDPA; the
    kernels-line record with that run's launches on rank 0."""
    b, sq, hq, skv, hkv, d, dv, lse = run["shape"]
    shape = next(c[1] for c in G_LSE if c[0] == name)
    check((b, sq, skv, hq, hkv, d) == shape[:6], f"{name}: (g) launched at {run['shape']}, "
                                                 f"the kernels phase checked {shape}")
    dtype = torch.float32 if "f32" in run["label"] else torch.bfloat16
    scale = 1.0 / math.sqrt(d)
    pick = _rotating([_qkv(gen, b, 1, skv, hq, hkv, d, dtype, dv) for _ in range(6)])
    kw = dict(causal=False, q_offset=0, kv_len=kv_len, sm_scale=scale, return_lse=lse)
    ms = _interleaved_ms({
        "plain": lambda: fa_ops._plain(*pick(), False, scale, 0, kv_len, lse),
        "kernel": lambda: flash_attention(*pick(), **kw),
        "library": lambda: (lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k[:, :kv_len].transpose(1, 2), v[:, :kv_len].transpose(1, 2),
            scale=scale, enable_gqa=hq != hkv))(*pick()),
    }, n=100)
    item = torch.finfo(dtype).bits // 8
    bytes_ = item * (b * hq * d + b * kv_len * hkv * (d + dv) + b * hq * dv) + 4 * b * hq * lse
    peak = F32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S
    bound, bound_by = _bound(bytes_, 2 * b * hq * kv_len * (d + dv), peak)
    launches = next(v for k, v in run["fa"].items() if k != "empty shard")
    label = (f"{run['label']} on one rank of --mesh 2,2: b={b} hq={hq} hkv={hkv} d={d}"
             + (f" dv={dv}" if dv != d else "") + f" cache {skv} kv_len={kv_len} "
             f"{str(dtype)[6:]}" + (" with its log-sum-exp" if lse else ""))
    print(f"time [{stamp}] flash_attention {label} (the D = {compiled_dim(d, dv)} instance, "
          f"n_split {n_split(b, hkv, kv_len, plan_blocks(1, skv, compiled_dim(d, dv))[1])}): "
          f"eager calls: kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms, sdpa "
          f"{ms['library']:.4f} ms (no log-sum-exp), bound {bound:.4f} ms ({bound_by}: "
          f"{bytes_ / 1e6:.3f} MB at 3.35 TB/s); {launches} launches on each rank in (g)'s "
          f"wave)")
    return {**fa, "path": "distributed (g)", "shape": label, "launches": launches,
            "max_abs_err": err[dtype], "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": bound, "bound_by": bound_by, "library_ms": ms["library"]}


def phase_times(stamp, plans, serve_launches, moe_launches, fam, train_launches, errs,
                loop, new_train) -> list:
    """Each kernel at its main-path shape beside its bound, its plain version
    and, where one exists, the PyTorch call computing the same function. A
    matmul whose plan is not the searched tile (the model rated the default
    cheaper once launched) is timed at both. Each record's launches are its
    own path's at its shape: serving, training or the co-design loop."""
    fa = _kernel_keys(FLASH_ATTENTION_H100)
    records = []
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    # flash attention at the serving decode shape (full 512-token cache)
    b, hq, hkv, d, cache = DECODE.values()
    kv_len = cache
    sets = [_qkv(gen, b, 1, cache, hq, hkv, d, torch.bfloat16) for _ in range(8)]
    pick = _rotating(sets)
    kw = dict(causal=False, q_offset=kv_len - 1, kv_len=kv_len)
    fns = {
        "plain": lambda: _plain(*pick(), scale=1.0 / math.sqrt(d), **kw),
        "kernel": lambda: flash_attention(*pick(), **kw),
        "library": lambda: (lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k[:, :kv_len].transpose(1, 2), v[:, :kv_len].transpose(1, 2),
            enable_gqa=True))(*pick()),
    }
    # a decode call is short enough that eager timing, which the serving
    # loop pays, measures the host's dispatch too; replayed CUDA graphs
    # measure the device
    ms = _interleaved_ms(fns, n=100)
    # what bounds the kernel: the same call with its inputs warm in L2 (bytes
    # would get cheaper), and with one live key (the fixed cost of a launch)
    dev = _graph_interleaved_ms({
        **fns,
        "kernel_warm": lambda: flash_attention(*sets[0], **kw),
        "kernel_kv1": lambda: flash_attention(*pick(), causal=False, q_offset=0, kv_len=1),
    }, n=100)
    bytes_ = 2 * (b * hq * d + 2 * b * kv_len * hkv * d + b * hq * d)
    bound, bound_by = _bound(bytes_, 4 * b * hq * kv_len * d, BF16_FLOP_PER_S)
    parts = n_split(b, hkv, kv_len, plan_blocks(1, cache, d)[1])
    print(f"time [{stamp}] flash_attention decode b={b} hq={hq} hkv={hkv} d={d} kv_len={kv_len} "
          f"bf16, n_split {parts} ({b * hkv * parts} CTAs): eager calls (host dispatch included, "
          f"as serving pays it): kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms, sdpa "
          f"{ms['library']:.4f} ms, kernel / sdpa {ms['kernel'] / ms['library']:.3f}; CUDA-graph "
          f"replay (device time): kernel {dev['kernel']:.4f} ms "
          f"({bytes_ / dev['kernel'] / 1e6:.1f} GB/s), plain {dev['plain']:.4f} ms, sdpa "
          f"{dev['library']:.4f} ms, kernel / sdpa {dev['kernel'] / dev['library']:.3f}, bound "
          f"{bound:.4f} ms ({bound_by}: {bytes_ / 1e6:.2f} MB at 3.35 TB/s; "
          f"{bound / dev['kernel']:.1%} of it); inputs warm in L2 {dev['kernel_warm']:.4f} ms, "
          f"one live key {dev['kernel_kv1']:.4f} ms")
    records.append({**fa, "shape": f"decode b={b} hq={hq} hkv={hkv} d={d} kv_len={kv_len} bf16",
                    "launches": serve_launches, "max_abs_err": errs["fa_decode"],
                    "ms": ms["kernel"], "plain_ms": ms["plain"], "bound_ms": bound,
                    "bound_by": bound_by, "library_ms": ms["library"],
                    "device_ms": dev["kernel"], "device_plain_ms": dev["plain"],
                    "device_library_ms": dev["library"], "n_split": parts})

    records.append(_time_mla_decode(stamp, gen, fa, errs, moe_launches))
    for path, model in (("hubert encode", "hubert"), ("llava prefill", "llava")):
        records.append(_time_fa_prefill(stamp, gen, fa, path, fam[model]["launches"],
                                        errs[FAMILY_ERRS[path]]))

    # flash attention at zamba2's training shape: causal over 2 x 2048, 32 heads of 80
    t = FA_TRAIN
    b, S, hq, d = t["b"], t["s"], t["hq"], t["d"]
    pick = _rotating([_qkv(gen, b, S, S, hq, t["hkv"], d, torch.bfloat16) for _ in range(2)])
    planned = plan_blocks(S, S, d)
    ms = _interleaved_ms({
        "plain": lambda: _plain(*pick(), causal=True, scale=1.0 / math.sqrt(d)),
        "kernel": lambda: flash_attention(*pick(), causal=True),
        "fixed_rule": lambda: flash_attention(*pick(), causal=True, blocks=FA_FIXED_RULE),
        "library": lambda: torch.nn.functional.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in pick()), is_causal=True),
    }, n=10)
    bytes_ = 2 * 4 * b * S * hq * d  # q, k, v, o in bf16 (hq == hkv)
    flops = 4 * b * hq * (S * (S + 1) // 2) * d
    bound, bound_by = _bound(bytes_, flops, BF16_FLOP_PER_S)
    print(f"time [{stamp}] flash_attention train b={b} S={S} hq={hq} d={d} causal bf16: kernel "
          f"(planned tile {planned}) {ms['kernel']:.4f} ms ({flops / ms['kernel'] / 1e9:.1f} "
          f"TFLOP/s), the same kernel at the earlier fixed rule's tile "
          f"{FA_FIXED_RULE} {ms['fixed_rule']:.4f} ms, plain {ms['plain']:.4f} ms, sdpa "
          f"{ms['library']:.4f} ms ({flops / ms['library'] / 1e9:.1f} TFLOP/s), bound "
          f"{bound:.4f} ms ({bound_by}: {flops / 1e9:.1f} GFLOP at 989 TFLOP/s bf16; "
          f"{bound / ms['kernel']:.1%} of it); kernel / sdpa {ms['kernel'] / ms['library']:.3f}")
    records.append({**fa, "shape": f"train b={b} S={S} hq={hq} d={d} causal bf16",
                    "launches": train_launches["flash_attention"], "max_abs_err": errs["fa_train"],
                    "ms": ms["kernel"], "plain_ms": ms["plain"], "bound_ms": bound,
                    "bound_by": bound_by, "library_ms": ms["library"]})
    for name, shape, path in FA_TRAIN_NEW:
        records.append(_time_fa_train(stamp, gen, fa, name, shape, path,
                                      new_train[path]["launches"], errs[name]))
    g = new_train["distributed"]["g"]
    for name, label, kv_len in G_TIMED:
        records.append(_time_g_decode(stamp, gen, fa, name, g[label], kv_len, errs[name]))
    h = new_train["distributed"]["h"]["launches"]
    for name, shape, start, arch in FA_CONTEXT:
        if arch is not None:  # (h1)'s training shapes
            records.append(_time_fa_context(stamp, gen, fa, name, shape, start,
                                            h[f"{arch} {start}"], errs[name], arch))

    # the SSD kernel at zamba2's training shape, B/C shared by the heads as
    # the model passes them (stride 0: the score kernel, then the main
    # kernel), and with per-head B/C (scores built per CTA)
    b, l, nh, hp, n, cl = SSD_TRAIN
    nc = l // cl
    pick = _rotating([_ssd_inputs(gen, b, l, nh, hp, n, True) for _ in range(4)])
    check(shares_scores(*pick()[2:]), "the timed SSD inputs do not share B/C")
    per_head = _rotating([_ssd_inputs(gen, b, l, nh, hp, n, False) for _ in range(2)])
    ms = _interleaved_ms({
        "plain": lambda: ssd_intra_chunk_ref(*pick(), cl),
        "kernel": lambda: ssd_intra_chunk_cuda(*pick(), cl),
        "per_head": lambda: ssd_intra_chunk_cuda(*per_head(), cl),
    }, n=20)
    del pick, per_head
    # what these inputs need (_ssd_work). The kernel runs the products as
    # 3xTF32 on the tensor cores (three TF32 products each); the f32 FMA
    # figure and the earlier count (scores per head) are printed for
    # continuity.
    bytes_, flops = _ssd_work(b, l, nh, hp, n, cl)
    tri = cl * (cl + 1) // 2
    per_head_flops = b * nh * nc * (2 * tri * (n + hp) + 2 * cl * n * hp)
    bound, bound_by = _bound(bytes_, 3 * flops, TF32_FLOP_PER_S)
    tc_ms = 3 * flops / TF32_FLOP_PER_S * 1e3
    fma_ms = flops / F32_FLOP_PER_S * 1e3
    nmax = 64 if n <= 64 else 128
    regs = {inst: SSD_PTXAS[(inst, nmax)] for inst in ("shared", "scores", "per-head")}
    print(f"time [{stamp}] ssd_scan train b={b} l={l} nh={nh} hp={hp} n={n} cl={cl} f32, B/C "
          f"stride 0 (the score kernel, then the main kernel): {ms['kernel']:.4f} ms; per-head "
          f"B/C (scores per CTA) {ms['per_head']:.4f} ms; plain {ms['plain']:.4f} ms; bound "
          f"{bound:.4f} ms ({bound_by}: {bytes_ / 1e6:.1f} MB at 3.35 TB/s; "
          f"{bound / ms['kernel']:.1%} of it); operations {flops / 1e9:.2f} GFLOP (the score "
          f"block once per batch and chunk): 3xTF32 {3 * flops / 1e9:.1f} GFLOP at 495 TFLOP/s "
          f"{tc_ms:.4f} ms (the route taken), f32 FMA at 67 TFLOP/s {fma_ms:.4f} ms (scores per "
          f"head, the earlier count: {per_head_flops / 1e9:.2f} GFLOP, "
          f"{per_head_flops / F32_FLOP_PER_S * 1e3:.4f} ms); registers / spill bytes "
          + ", ".join(f"{k} {v[0]} / {v[1]}" for k, v in regs.items())
          + "; no single PyTorch call computes it")
    records.append({**_kernel_keys(SSD_SCAN_H100),
                    "shape": f"train b={b} l={l} nh={nh} hp={hp} n={n} cl={cl} f32",
                    "launches": train_launches["ssd_scan"], "max_abs_err": errs["ssd_train"],
                    "ms": ms["kernel"], "plain_ms": ms["plain"], "bound_ms": bound,
                    "bound_by": bound_by, "library_ms": None, "per_head_bc_ms": ms["per_head"],
                    "registers_spills": {k: list(v) for k, v in regs.items()}})
    records.append(_time_ssd_mesh(stamp, gen, new_train["distributed (e) zamba2"]["ssd"],
                                  errs["ssd_mesh"]))

    # the matmul kernel with its planned tile, beside torch.matmul (TF32 off):
    # f32 on the FMA instance, bf16 on the wgmma instance
    for M, N, K, dtype in MM_TIMED:
        space = MM_SPACES[dtype]
        isz = torch.empty((), dtype=dtype).element_size()
        set_bytes = isz * (M * K + K * N + M * N)
        sets = [_mm_inputs(gen, M, N, K, dtype) for _ in range(max(2, math.ceil(150e6 / set_bytes)))]
        pick = _rotating(sets)
        x, y = sets[0]
        inst = instance_for(x, y)
        check(inst == ("wgmma" if dtype == torch.bfloat16 else "fma"),
              f"matmul {M}x{N}x{K} {dtype} routed to {inst}")
        err = _check_mm(f"{M}x{N}x{K} timed", matmul(x, y), x, y)
        teeth = ""
        if dtype == torch.bfloat16:  # the tolerance would catch a lost 64-deep K slice
            want = matmul_ref(x, y)
            dropped = matmul_ref(x[:, :K - TC_BK], y[:K - TC_BK])
            planted, ok = _allclose([dropped], [want], MM_TOL[dtype])
            check(not ok, f"matmul {M}x{N}x{K}: the plain version without its last {TC_BK} of K "
                          f"passes rtol = atol = {MM_TOL[dtype]}")
            teeth = (f"; the plain version without its last {TC_BK} of K is off by {planted:.3g}, "
                     f"outside the tolerance")
            del want, dropped
        n = max(3, min(50, int(2e11 / (2 * M * N * K))))
        p = plans[(space.name, (M, N, K))]
        other = (p.searched if p.source == "default"
                 else space.legalize(space.default_config((M, N, K)), (M, N, K)))
        bm, bn, bk = other
        err = max(err, _check_mm(f"{M}x{N}x{K} tile {other}", matmul_cuda(
            x, y, bm=bm, bn=bn, bk=bk, out_dtype=dtype), x, y))
        ms = _interleaved_ms({
            "plain": lambda: matmul_ref(*pick()),
            "kernel": lambda: matmul(*pick()),
            "other": lambda: matmul_cuda(*pick(), bm=bm, bn=bn, bk=bk, out_dtype=dtype),
            "library": lambda: torch.matmul(*pick()),
        }, n=n)
        flops = 2 * M * N * K
        peak = F32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S
        bound, bound_by = _bound(set_bytes, flops, peak)
        tiles = plan_tiles(M, N, K, dtype=dtype)
        launches = loop["matmul_by_shape"].get((M, N, K, dtype), 0)
        check(tiles == p.config and launches > 0,
              f"matmul {M}x{N}x{K}: tile {tiles} vs plan {p.config}, {launches} loop launches")
        print(f"time [{stamp}] matmul {M}x{N}x{K} {str(dtype)[6:]} on {inst}, tile {tiles} "
              f"({p.source}): kernel {ms['kernel']:.4f} ms ({flops / ms['kernel'] / 1e9:.1f} "
              f"TFLOP/s), the same kernel at the "
              f"{'searched' if p.source == 'default' else 'default'} tile {other} "
              f"{ms['other']:.4f} ms, plain {ms['plain']:.4f} ms, torch.matmul "
              f"{ms['library']:.4f} ms (kernel / torch.matmul {ms['kernel'] / ms['library']:.3f}), "
              f"bound {bound:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP at "
              f"{peak / 1e12:.0f} TFLOP/s, {set_bytes / 1e6:.1f} MB; {bound / ms['kernel']:.1%} of "
              f"it); max abs err {err:.3g}{teeth}; {launches} launches at this shape and dtype in "
              f"the co-design loop")
        records.append({**_kernel_keys(space), "instance": inst,
                        "shape": f"{M}x{N}x{K} {str(dtype)[6:]} tile {tiles}",
                        "launches": launches, "max_abs_err": err,
                        "ms": ms["kernel"], "plain_ms": ms["plain"], "bound_ms": bound,
                        "bound_by": bound_by, "library_ms": ms["library"]})
        del sets, x, y
    _matmul_host_costs(stamp, gen)
    return records


def _time_ssd_mesh(stamp, gen, launches, err) -> dict:
    """The SSD kernel at distributed (e)'s local shape (one rank's heads,
    B/C shared) beside its bound and its plain version; the kernels-line
    record with (e)'s launches on rank 0."""
    b, l, nh, hp, n, cl = SSD_MESH
    pick = _rotating([_ssd_inputs(gen, b, l, nh, hp, n, True) for _ in range(6)])
    ms = _interleaved_ms({"plain": lambda: ssd_intra_chunk_ref(*pick(), cl),
                          "kernel": lambda: ssd_intra_chunk_cuda(*pick(), cl)}, n=20)
    bytes_, flops = _ssd_work(b, l, nh, hp, n, cl)
    bound, bound_by = _bound(bytes_, 3 * flops, TF32_FLOP_PER_S)
    label = f"train --mesh 2,2 b={b} l={l} nh={nh} hp={hp} n={n} cl={cl} f32"
    print(f"time [{stamp}] ssd_scan {label}, B/C stride 0 (the score kernel, then the main "
          f"kernel): {ms['kernel']:.4f} ms; plain {ms['plain']:.4f} ms; bound {bound:.4f} ms "
          f"({bound_by}: {bytes_ / 1e6:.1f} MB at 3.35 TB/s, 3xTF32 {3 * flops / 1e9:.2f} GFLOP "
          f"at 495 TFLOP/s; {bound / ms['kernel']:.1%} of it); {launches} launches on "
          f"distributed (e)'s rank 0; no single PyTorch call computes it")
    return {**_kernel_keys(SSD_SCAN_H100), "path": "distributed (e)", "shape": label,
            "launches": launches, "max_abs_err": err, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None}


def _matmul_host_costs(stamp, gen) -> None:
    """Host time one matmul call costs: the op's eager call and a direct
    launch of each instance at 64x64x64 (the host's work bounds them), and
    the two tensor-map encodes inside every wgmma launch."""
    xb, yb = _mm_inputs(gen, 64, 64, 64, torch.bfloat16)
    xf, yf = xb.float(), yb.float()
    tb, tf = plan_for(xb, yb), plan_for(xf, yf)
    fns = {"op bf16 (wgmma)": lambda: matmul(xb, yb), "op f32 (fma)": lambda: matmul(xf, yf),
           "wgmma launch": lambda: matmul_cuda(xb, yb, bm=tb[0], bn=tb[1], bk=tb[2],
                                              out_dtype=torch.bfloat16),
           "fma launch": lambda: matmul_cuda(xf, yf, bm=tf[0], bn=tf[1], bk=tf[2],
                                            out_dtype=torch.float32)}
    us = {}
    for name, fn in fns.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        best = math.inf
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(500):
                fn()
            best = min(best, (time.perf_counter() - t0) / 500 * 1e6)
            torch.cuda.synchronize()
        us[name] = best
    M, N, K = quickstart.MATMUL_SHAPES[2]
    x, y = _mm_inputs(gen, M, N, K, torch.bfloat16)
    enc = encode_ns(x, y, *plan_tiles(M, N, K, dtype=torch.bfloat16))
    print(f"time [{stamp}] matmul host work per call (64x64x64, no sync, best of 3 x 500): "
          + ", ".join(f"{k} {v:.2f} us" for k, v in us.items())
          + f"; encoding the two tensor maps of a wgmma launch ({M}x{N}x{K}): {enc / 1e3:.2f} us")


class _PhaseClock:
    """Host seconds of each phase of ``main`` since the previous mark,
    printed together at the end: where the script's time limit goes."""

    def __init__(self):
        self.t, self.s = time.perf_counter(), {}

    def __call__(self, name, value=None):
        now = time.perf_counter()
        self.s[name], self.t = now - self.t, now
        return value

    def report(self, stamp) -> None:
        print(f"time [{stamp}] phases (host s): "
              + ", ".join(f"{k} {v:.1f}" for k, v in self.s.items())
              + f"; {sum(self.s.values()):.1f} in all")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clock = _PhaseClock()
    smi = clock("device", phase_device())
    stamp = smi.strip()
    clock("build", phase_build())
    plans = clock("plan", phase_plan())
    errs = clock("kernels", phase_kernels())
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)  # the loop's and the mappers' inputs
    loop = clock("codesign", phase_codesign(stamp, gen))
    mapper_records = clock("mappers", phase_mappers(stamp, loop["scales"], gen))
    wm = clock("whole_model", phase_whole_model(stamp, gen))
    clock("search_engine", phase_search_engine(stamp, wm))
    serve_launches, decode_step = clock("serve", phase_serve(stamp))
    moe = clock("serve_moe", phase_serve_moe(stamp))
    fam = clock("families", phase_families(stamp))
    train_launches, train_step = clock("train", phase_train(stamp))
    new_train = {"train_ft": clock("train_ft", phase_train_ft(stamp)),
                 "train_moe": clock("train_moe", phase_train_moe(stamp))}
    new_train["distributed"] = clock("distributed",
                                     phase_distributed(stamp, new_train["train_ft"]))
    e = new_train["distributed"]["e"]
    new_train["distributed (e) zamba2"] = {"launches": e["zamba2-2.7b"]["flash"],
                                           "ssd": e["zamba2-2.7b"]["ssd"]}
    new_train["distributed (e) deepseek"] = {"launches": e["deepseek-v2-lite-16b"]["flash"]}
    clock("dryrun", phase_dryrun(stamp, new_train["train_ft"], new_train["distributed"]))
    records = clock("times", phase_times(stamp, plans, serve_launches,
                                         moe["deepseek-v2-lite-16b"]["launches"], fam,
                                         train_launches, errs, loop, new_train))
    report_whole_model(stamp, wm, decode_step, train_step, records)
    clock.report(stamp)
    print(json.dumps({"kernels": records + mapper_records + wm["records"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
