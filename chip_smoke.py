"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases (any failure raises and the exit code is non-zero):
  1. device: the card's name, count, and power limit (nvidia-smi);
  2. build: every CUDA kernel of the port with nvcc for sm_90a, one process
     per source, printing each instance's registers, shared memory and
     spills (ptxas -v);
  3. kernels: each kernel against its plain PyTorch version on the card:
     flash attention at the serving decode shape, the zamba2 training shape
     (D = 80, causal, bf16) and f32 sweeps at D = 128-and-less and D = 80,
     its autograd wrapper's grads; the SSD kernel at the test_ssd_sweep
     shapes and the zamba2 training shape with B/C materialised and
     expanded over heads with stride 0, and ``ssd_chunked`` against the
     token-by-token recurrence;
  4. serve: qwen3-0.6b at full width (random weights from a seeded
     generator on the card), 16 requests through ``WaveServer`` with the
     kernels on; the kernel launch counts must match the steps run, and one
     wave's first decode-step logits are checked against the kernels-off
     (chunked attention) decode and against the full forward pass;
  5. train: zamba2-2.7b at full width (2.90 B parameters, random weights
     from a seeded generator) through ``repro_torch.launch.train.main``:
     batch 2 x 2048 tokens of ``SyntheticLM``, 8 AdamW steps, remat on,
     kernels on. Losses must be finite and fall, and the kernels must have
     launched exactly as the model's layers say (forward + remat recompute).
     On one batch, loss and grads with kernels on are checked against
     kernels off, and one train step is profiled (device busy share, top
     kernels);
  6. times: each kernel at its main-path shape beside its bound, its plain
     version and, where one exists, the PyTorch call computing the same
     function (a yardstick only: the port never calls it); ``torch.matmul``
     at the quickstart GEMM shape, for the matmul kernel still to be ported;
     serving tokens/s, decode-step time, train step time, tokens/s and peak
     memory. Every time is stamped with the card and its power limit.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    MAX_BK,
    flash_attention_cuda,
    smem_bytes,
)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunked  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as ssd_launcher  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref, ssd_recurrent_ref  # noqa: E402
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_intra_chunk_cuda  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.launch.serve import Request, WaveServer  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import decode_step, forward, init_cache, init_params  # noqa: E402
from repro_torch.models.ssm import _heads  # noqa: E402
from repro_torch.optim import adamw, cosine_schedule  # noqa: E402

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak, H100 SXM
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores, H100 SXM
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
ARCH, SLOTS, MAX_LEN, N_REQ, MAX_NEW = "qwen3-0.6b", 8, 512, 16, 32
# Kernels-on decode logits of the full model after a ~200-token prefill, vs
# the kernels-off decode and the full forward pass: the paths round P and the
# attention output to bf16 at different points, and 28 layers carry that;
# logits reach ~3, where a bf16 ulp is 2^-6.
MODEL_LOGIT_TOL = 0.25


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


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, one process "
          f"per source)")
    for name, log in logs.items():
        for kernel, regs, spill, smem in _ptxas_report(log):
            line = f"  {name}: {kernel}: {regs} registers, {spill} bytes spilled, {smem} B static smem"
            m = re.search(r"<(\w+), (\d+), (\d+)>", kernel)
            if name == "flash_attention" and m:
                d, bq = int(m.group(2)), int(m.group(3))
                line += f", {smem_bytes(bq, MAX_BK, d)} B dynamic smem at bk={MAX_BK}"
            if name == "ssd_scan":
                cl = SSD_TRAIN[5]
                line += f", {ssd_launcher.smem_bytes(cl)} B dynamic smem at cl={cl}"
            print(line)


def _qkv(gen, b, sq, skv, hq, hkv, d, dtype):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)
    return randn(b, sq, hq, d), randn(b, skv, hkv, d), randn(b, skv, hkv, d)


def _plain(q, k, v, **kw):
    return attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw).transpose(1, 2)


def phase_kernels() -> dict:
    """Each kernel vs its plain version on the card; returns the max abs
    error at each main-path shape: flash attention at the serving decode
    shape and at the training shape, the SSD kernel at the training shape."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b, hq, hkv, d, cache = DECODE.values()
    cases = [(f"decode kv_len={n}", (b, 1, cache, hq, hkv, d), False, n - 1, n, torch.bfloat16)
             for n in (1, 37, 300, 512)]
    cases.append(("causal prefill", (2, 1024, 1024, 16, 8, 128), True, 0, None, torch.bfloat16))
    t = FA_TRAIN
    cases.append(("train (zamba2)", (t["b"], t["s"], t["s"], t["hq"], t["hkv"], t["d"]), True, 0,
                  None, torch.bfloat16))
    cases += [(f"sweep {shape}", shape[:6], shape[6], 0, None, torch.float32)
              for shape in FA_SWEEP]
    cases += [(f"sweep D=80 {shape[:5] + (80,)}", shape[:5] + (80,), shape[6], 0, None,
               torch.float32) for shape in FA_SWEEP]
    errs = {"fa_decode": 0.0}
    for name, shape, causal, q_offset, kv_len, dtype in cases:
        q, k, v = _qkv(gen, *shape, dtype)
        kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
        got = flash_attention(q, k, v, **kw)
        want = _plain(q, k, v, scale=1.0 / math.sqrt(shape[5]), **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(got.shape == want.shape and math.isfinite(err) and err <= TOL[dtype],
              f"flash_attention {name}: max abs err {err} > {TOL[dtype]}")
        line = f"kernel flash_attention {name} {str(dtype)[6:]}: max abs err {err:.3g} (tol {TOL[dtype]})"
        if kv_len is not None:
            k[:, kv_len:] = 99.0
            v[:, kv_len:] = 99.0
            check(torch.equal(flash_attention(q, k, v, **kw), got),
                  f"flash_attention {name}: slots past kv_len changed the output")
            errs["fa_decode"] = max(errs["fa_decode"], err)
            line += "; slots past kv_len unread"
        if name.startswith("train"):
            errs["fa_train"] = err
        print(line)

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

    for shape in SSD_SHAPES:
        for shared in (False, True):
            x, dA, B, C = _ssd_inputs(gen, *shape[:5], shared)
            got = ssd_intra_chunk_cuda(x, dA, B, C, shape[5])
            want = ssd_intra_chunk_ref(x, dA, B, C, shape[5])
            torch.cuda.synchronize()
            err, ok = _allclose(got, want, SSD_TOL)
            check(ok, f"ssd_scan {shape} shared={shared}: max abs err {err}, not within "
                      f"rtol = atol = {SSD_TOL}")
            if shape == SSD_TRAIN:
                errs["ssd_train"] = max(errs.get("ssd_train", 0.0), err)
            bc = "B/C expanded over heads, stride 0" if shared else "B/C materialised"
            print(f"kernel ssd_scan {shape} float32, {bc}: max abs err {err:.3g}, max |out| "
                  f"{max(w.abs().max().item() for w in want):.3g} (rtol = atol = {SSD_TOL})")
    x, dA, B, C = _ssd_inputs(gen, 2, 128, 3, 16, 8, False)
    err, ok = _allclose(ssd_chunked(x, dA, B, C, chunk=32), ssd_recurrent_ref(x, dA, B, C), SSD_TOL)
    check(ok, f"ssd_chunked vs recurrence: max abs err {err}, not within {SSD_TOL}")
    print(f"kernel ssd_chunked (2, 128, 3, 16, 8, 32) vs the token-by-token recurrence: "
          f"max abs err {err:.3g} (rtol = atol = {SSD_TOL})")
    return errs


def _allclose(got, want, tol):
    """(max abs error, whether every element is within numpy's allclose
    rule |got - want| <= tol + tol * |want|) over paired tensors."""
    err, ok = 0.0, True
    for a, w in zip(got, want):
        d = (a.float() - w.float()).abs()
        err = max(err, d.max().item())
        ok = ok and a.shape == w.shape and bool((d <= tol + tol * w.float().abs()).all())
    return err, ok and math.isfinite(err)


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


def phase_serve(stamp):
    cfg = get_config(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = init_params(cfg, gen, "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(32, 193))).tolist()
               for _ in range(N_REQ)]
    waves = [prompts[i:i + SLOTS] for i in range(0, N_REQ, SLOTS)]
    # each wave: one step per prefill token, then MAX_NEW - 1 decode steps
    steps = sum(max(len(p) for p in w) + MAX_NEW - 1 for w in waves)

    kernels.enable_kernels(True)
    server = WaveServer(cfg, model, batch_slots=SLOTS, max_len=MAX_LEN)
    for rid, p in enumerate(prompts):
        server.submit(Request(rid, p, MAX_NEW))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_cuda.launches = 0
    t0 = time.perf_counter()
    done = server.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = flash_attention_cuda.launches
    peak = torch.cuda.max_memory_allocated()

    check(sorted(r.rid for r in done) == list(range(N_REQ)), "not every request was served")
    for r in done:
        check(len(r.out) == MAX_NEW and all(0 <= t < cfg.vocab for t in r.out),
              f"request {r.rid}: {len(r.out)} tokens, want {MAX_NEW} in [0, {cfg.vocab})")
    check(launches == cfg.n_layers * steps,
          f"flash_attention launches {launches} != n_layers {cfg.n_layers} x steps {steps}")
    new_tokens = sum(len(r.out) for r in done)
    print(f"serve {ARCH}: {n_params / 1e9:.3f} B params bf16, {N_REQ} requests, slots {SLOTS}, "
          f"max_len {MAX_LEN}, prompts {min(map(len, prompts))}-{max(map(len, prompts))} tokens, "
          f"{steps} steps, flash_attention launches {launches} = {cfg.n_layers} x {steps}")

    wave0 = sorted(done, key=lambda r: r.rid)[:SLOTS]
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

    step_ms = {}
    toks = torch.tensor([[r.out[-1]] for r in wave0], device="cuda")
    for on_ in (True, False, True, False):
        kernels.enable_kernels(on_)
        cache = init_cache(cfg, SLOTS, MAX_LEN, "cuda")
        for _ in range(3):
            decode_step(cfg, model, cache, toks, 200)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(20):
            decode_step(cfg, model, cache, toks, 200 + i)
        torch.cuda.synchronize()
        step_ms.setdefault(on_, []).append((time.perf_counter() - t0) / 20 * 1e3)
    kernels.enable_kernels(True)
    _profile_decode(stamp, cfg, model, toks)
    print(f"time [{stamp}] serve: {new_tokens} new tokens in {dt:.3f} s = {new_tokens / dt:.1f} "
          f"tok/s ({steps * SLOTS / dt:.1f} tok/s incl. prefill); peak memory "
          f"{peak / 2**30:.3f} GiB")
    print(f"time [{stamp}] decode step (b={SLOTS}, pos 200-219): kernels on "
          f"{min(step_ms[True]):.3f} ms, kernels off {min(step_ms[False]):.3f} ms")
    return launches


def _profile_decode(stamp, cfg, model, toks, n=5):
    """Where a decode step's time goes: torch.profiler over n steps."""
    cache = init_cache(cfg, SLOTS, MAX_LEN, "cuda")
    decode_step(cfg, model, cache, toks, 200)
    pos = iter(range(201, 201 + n))
    _profile(stamp, f"decode step (b={SLOTS}, pos 201-{200 + n}, kernels on, under the profiler)",
             lambda: decode_step(cfg, model, cache, toks, next(pos)), n)


def _profile(stamp, label, fn, n):
    """torch.profiler over n calls of fn: wall time per call, device busy
    share, device kernels per call and the top kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not events:
        print(f"profile [{stamp}] {label}: the profiler saw no device kernels "
              f"(wall {wall:.3f} ms under the profiler)")
        return
    busy = sum(e.self_device_time_total for e in events) / n / 1e3
    launches = sum(e.count for e in events) / n
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    print(f"profile [{stamp}] {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({busy / wall:.1%}; idle {1 - busy / wall:.1%}), {launches:.0f} device kernels per call")
    for e in top:
        print(f"  {e.self_device_time_total / n / 1e3:.4f} ms/call  x{e.count // n:<5d} "
              f"{e.key[:90]}")


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


def _rotating(sets):
    """Cycle through input sets larger together than the 50 MB L2, so each
    launch finds its inputs cold, as the model's layers do."""
    it = iter(range(1 << 30))
    return lambda: sets[next(it) % len(sets)]


def _bound(bytes_: float, flops: float, flop_per_s: float):
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / flop_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_train(stamp) -> dict:
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
    # forward + the remat recompute of every unit: two launches per layer per step
    want = {"ssd_scan": n_mamba * 2 * t["steps"], "flash_attention": n_attn * 2 * t["steps"]}
    check(launches == want, f"train launches {launches} != {want} "
          f"({n_mamba} mamba2 and {n_attn} attention layers x 2 x {t['steps']} steps)")
    steady = sorted(out["step_s"][1:])
    step_s = steady[len(steady) // 2]
    tokens = t["batch"] * t["seq"]
    print(f"train {t['arch']}: {cfg.n_layers} layers ({n_mamba} mamba2, {n_attn} attention), "
          f"batch {t['batch']} x seq {t['seq']}, {t['steps']} adamw steps (lr {t['lr']}, warmup "
          f"{t['warmup']}), remat on, kernels on; launches ssd_scan {launches['ssd_scan']} = "
          f"{n_mamba} x 2 x {t['steps']}, flash_attention {launches['flash_attention']} = "
          f"{n_attn} x 2 x {t['steps']}")
    print(f"train losses: {' '.join(f'{x:.4f}' for x in losses)}")
    print(f"time [{stamp}] train step (median of steps 2-{t['steps']}): {step_s:.3f} s = "
          f"{tokens / step_s:.0f} tokens/s; first step {out['step_s'][0]:.3f} s; whole run "
          f"{wall:.1f} s incl. init; peak memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated)")
    gc.collect()
    torch.cuda.empty_cache()
    _train_kernels_on_vs_off(stamp, cfg)
    return launches


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
    _profile(stamp, f"train step ({t['arch']}, batch {t['batch']} x {t['seq']}, adamw, remat, "
             f"kernels on, under the profiler)", one_step, 1)


def phase_times(stamp, serve_launches, train_launches, errs) -> list:
    """Each kernel at its main-path shape beside its bound, its plain version
    and, where one exists, the PyTorch call computing the same function."""
    fa = {"name": "flash_attention", "route": "cuda",
          "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
          "replaces": "src/repro/kernels/flash_attention/flash_attention.py:100"}
    records = []
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    # flash attention at the serving decode shape (full 512-token cache)
    b, hq, hkv, d, cache = DECODE.values()
    kv_len = cache
    pick = _rotating([_qkv(gen, b, 1, cache, hq, hkv, d, torch.bfloat16) for _ in range(8)])
    kw = dict(causal=False, q_offset=kv_len - 1, kv_len=kv_len)
    ms = _interleaved_ms({
        "plain": lambda: _plain(*pick(), scale=1.0 / math.sqrt(d), **kw),
        "kernel": lambda: flash_attention(*pick(), **kw),
        "library": lambda: (lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k[:, :kv_len].transpose(1, 2), v[:, :kv_len].transpose(1, 2),
            enable_gqa=True))(*pick()),
    }, n=100)
    bytes_ = 2 * (b * hq * d + 2 * b * kv_len * hkv * d + b * hq * d)
    bound, bound_by = _bound(bytes_, 4 * b * hq * kv_len * d, BF16_FLOP_PER_S)
    print(f"time [{stamp}] flash_attention decode b={b} hq={hq} hkv={hkv} d={d} kv_len={kv_len} "
          f"bf16: kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms, sdpa {ms['library']:.4f} ms, "
          f"bound {bound:.4f} ms ({bound_by}: {bytes_ / 1e6:.2f} MB at 3.35 TB/s; "
          f"{bound / ms['kernel']:.1%} of it)")
    records.append({**fa, "shape": f"decode b={b} hq={hq} hkv={hkv} d={d} kv_len={kv_len} bf16",
                    "launches": serve_launches, "max_abs_err": errs["fa_decode"],
                    "ms": ms["kernel"], "plain_ms": ms["plain"], "bound_ms": bound,
                    "bound_by": bound_by, "library_ms": ms["library"]})

    # flash attention at zamba2's training shape: causal over 2 x 2048, 32 heads of 80
    t = FA_TRAIN
    b, S, hq, d = t["b"], t["s"], t["hq"], t["d"]
    pick = _rotating([_qkv(gen, b, S, S, hq, t["hkv"], d, torch.bfloat16) for _ in range(2)])
    ms = _interleaved_ms({
        "plain": lambda: _plain(*pick(), causal=True, scale=1.0 / math.sqrt(d)),
        "kernel": lambda: flash_attention(*pick(), causal=True),
        "library": lambda: torch.nn.functional.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in pick()), is_causal=True),
    }, n=10)
    bytes_ = 2 * 4 * b * S * hq * d  # q, k, v, o in bf16 (hq == hkv)
    bound, bound_by = _bound(bytes_, 4 * b * hq * (S * (S + 1) // 2) * d, BF16_FLOP_PER_S)
    print(f"time [{stamp}] flash_attention train b={b} S={S} hq={hq} d={d} causal bf16: kernel "
          f"{ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms, sdpa {ms['library']:.4f} ms, bound "
          f"{bound:.4f} ms ({bound_by}, bf16 tensor-core peak; {bound / ms['kernel']:.1%} of it)")
    records.append({**fa, "shape": f"train b={b} S={S} hq={hq} d={d} causal bf16",
                    "launches": train_launches["flash_attention"], "max_abs_err": errs["fa_train"],
                    "ms": ms["kernel"], "plain_ms": ms["plain"], "bound_ms": bound,
                    "bound_by": bound_by, "library_ms": ms["library"]})

    # the SSD kernel at zamba2's training shape, B/C shared by the heads as
    # the model passes them (stride 0)
    b, l, nh, hp, n, cl = SSD_TRAIN
    nc = l // cl
    pick = _rotating([_ssd_inputs(gen, b, l, nh, hp, n, True) for _ in range(4)])
    ms = _interleaved_ms({
        "plain": lambda: ssd_intra_chunk_ref(*pick(), cl),
        "kernel": lambda: ssd_intra_chunk_cuda(*pick(), cl),
    }, n=20)
    # inputs as stored (B/C: one group's rows) and outputs, f32
    bytes_ = 4 * (b * l * nh * hp + b * l * nh + 2 * b * l * n
                  + b * l * nh * hp + b * nc * nh * n * hp + b * l * nh)
    flops = b * nh * nc * (2 * (cl * (cl + 1) // 2) * (n + hp) + 2 * cl * n * hp)
    bound, bound_by = _bound(bytes_, flops, F32_FLOP_PER_S)
    print(f"time [{stamp}] ssd_scan train b={b} l={l} nh={nh} hp={hp} n={n} cl={cl} f32, B/C "
          f"stride 0: kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms, bound "
          f"{bound:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP at 67 TFLOP/s f32, "
          f"{bytes_ / 1e6:.1f} MB; {bound / ms['kernel']:.1%} of it); no single PyTorch call "
          f"computes it")
    records.append({"name": "ssd_scan", "route": "cuda",
                    "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                    "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:69",
                    "shape": f"train b={b} l={l} nh={nh} hp={hp} n={n} cl={cl} f32",
                    "launches": train_launches["ssd_scan"], "max_abs_err": errs["ssd_train"],
                    "ms": ms["kernel"], "plain_ms": ms["plain"], "bound_ms": bound,
                    "bound_by": bound_by, "library_ms": None})

    # torch.matmul at quickstart step 4's GEMM (the matmul kernel is not ported yet)
    M, N, K = 512, 3072, 768
    sets = [(torch.randn((M, K), generator=gen, device="cuda"),
             torch.randn((K, N), generator=gen, device="cuda")) for _ in range(8)]
    pick = _rotating(sets)
    ms = _interleaved_ms({"library": lambda: torch.matmul(*pick())}, n=100)
    bound, bound_by = _bound(4 * (M * K + K * N + M * N), 2 * M * N * K, F32_FLOP_PER_S)
    print(f"time [{stamp}] torch.matmul {M}x{N}x{K} f32 (TF32 off; the matmul kernel is not "
          f"ported yet): {ms['library']:.4f} ms, bound {bound:.4f} ms ({bound_by} at 67 TFLOP/s "
          f"f32; {bound / ms['library']:.1%} of it)")
    return records


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    stamp = smi.strip()
    phase_build()
    errs = phase_kernels()
    serve_launches = phase_serve(stamp)
    train_launches = phase_train(stamp)
    records = phase_times(stamp, serve_launches, train_launches, errs)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
