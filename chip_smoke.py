"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases (any failure raises and the exit code is non-zero):
  1. device: the card's name, count, and power limit (nvidia-smi);
  2. build: every CUDA kernel of the port with nvcc for sm_90a, printing
     each instance's registers, shared memory and spills (ptxas -v);
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the serving decode shape and the other listed shapes;
  4. serve: qwen3-0.6b at full width (random weights from a seeded
     generator on the card), 16 requests through ``WaveServer`` with the
     kernels on; the kernel launch counts must match the steps run, and one
     wave's first decode-step logits are checked against the kernels-off
     (chunked attention) decode and against the full forward pass;
  5. times: the kernel at the decode shape beside its bound, its plain
     version and ``torch.nn.functional.scaled_dot_product_attention`` (a
     yardstick only: the port never calls it); serving tokens/s, decode-step
     time and peak memory. Every time is stamped with the card and its
     power limit.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
from repro_torch.launch.serve import Request, WaveServer  # noqa: E402
from repro_torch.models import decode_step, forward, init_cache, init_params  # noqa: E402

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak, H100 SXM
TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}  # tests/test_kernels.py's bounds
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
            print(line)


def _qkv(gen, b, sq, skv, hq, hkv, d, dtype):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)
    return randn(b, sq, hq, d), randn(b, skv, hkv, d), randn(b, skv, hkv, d)


def _plain(q, k, v, **kw):
    return attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw).transpose(1, 2)


def phase_kernels() -> float:
    """Kernel vs plain version on the card; returns the max abs error at the
    serving decode shape."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b, hq, hkv, d, cache = DECODE.values()
    cases = [(f"decode kv_len={n}", (b, 1, cache, hq, hkv, d), False, n - 1, n, torch.bfloat16)
             for n in (1, 37, 300, 512)]
    cases.append(("causal prefill", (2, 1024, 1024, 16, 8, 128), True, 0, None, torch.bfloat16))
    cases += [(f"sweep {shape}", shape[:6], shape[6], 0, None, torch.float32) for shape in [
        (2, 128, 128, 4, 4, 64, True),
        (2, 128, 128, 8, 2, 64, True),
        (1, 256, 256, 4, 1, 32, True),
        (2, 64, 192, 4, 2, 64, False),
        (1, 100, 100, 2, 2, 16, True),
    ]]
    decode_err = 0.0
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
            decode_err = max(decode_err, err)
            line += "; slots past kv_len unread"
        print(line)
    return decode_err


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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cache = init_cache(cfg, SLOTS, MAX_LEN, "cuda")
    decode_step(cfg, model, cache, toks, 200)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            decode_step(cfg, model, cache, toks, 201 + i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not events:
        print(f"profile [{stamp}] decode step: the profiler saw no device kernels "
              f"(wall {wall:.3f} ms under the profiler)")
        return
    busy = sum(e.self_device_time_total for e in events) / n / 1e3
    launches = sum(e.count for e in events) / n
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    print(f"profile [{stamp}] decode step (b={SLOTS}, pos 201-{200 + n}, kernels on, under the "
          f"profiler): wall {wall:.3f} ms, device busy {busy:.3f} ms ({busy / wall:.1%}; idle "
          f"{1 - busy / wall:.1%}), {launches:.0f} device kernels per step")
    for e in top:
        print(f"  {e.self_device_time_total / n / 1e3:.4f} ms/step  x{e.count // n:<4d} "
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


def phase_times(stamp, launches, max_err):
    """The kernel at the serving decode shape (full 512-token cache). The
    caches rotate through 128 MB, more than the 50 MB L2, so each launch
    finds its K/V cold, as the model's 28 layers do."""
    b, hq, hkv, d, cache = DECODE.values()
    kv_len = cache
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    sets = [_qkv(gen, b, 1, cache, hq, hkv, d, torch.bfloat16) for _ in range(8)]
    it = iter(range(1 << 30))

    def pick():
        return sets[next(it) % len(sets)]

    def kernel():
        q, k, v = pick()
        flash_attention(q, k, v, causal=False, q_offset=kv_len - 1, kv_len=kv_len)

    def plain():
        q, k, v = pick()
        _plain(q, k, v, causal=False, scale=1.0 / math.sqrt(d), q_offset=kv_len - 1, kv_len=kv_len)

    def library():
        q, k, v = pick()
        torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k[:, :kv_len].transpose(1, 2), v[:, :kv_len].transpose(1, 2),
            enable_gqa=True)

    ms = {name: [] for name in ("kernel", "plain", "library")}
    for name in ("plain", "kernel", "library", "library", "kernel", "plain"):
        ms[name].append(_time_ms({"kernel": kernel, "plain": plain, "library": library}[name]))
    ms = {k: min(v) for k, v in ms.items()}
    item = 2
    bytes_ = item * (b * hq * d + 2 * b * kv_len * hkv * d + b * hq * d)
    flops = 4 * b * hq * kv_len * d
    bound = max(bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3
    bound_by = "bytes" if bytes_ / HBM_BYTES_PER_S >= flops / BF16_FLOP_PER_S else "operations"
    print(f"time [{stamp}] flash_attention decode b={b} hq={hq} hkv={hkv} d={d} kv_len={kv_len} "
          f"bf16: kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms, sdpa {ms['library']:.4f} ms, "
          f"bound {bound:.4f} ms ({bytes_ / 1e6:.2f} MB at 3.35 TB/s; {bound / ms['kernel']:.1%} of it)")
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:100",
        "launches": launches, "max_abs_err": max_err, "ms": ms["kernel"],
        "plain_ms": ms["plain"], "bound_ms": bound, "bound_by": bound_by,
        "library_ms": ms["library"],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    stamp = smi.strip()
    phase_build()
    max_err = phase_kernels()
    launches = phase_serve(stamp)
    record = phase_times(stamp, launches, max_err)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
