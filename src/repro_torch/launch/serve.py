"""Batched serving: wave-batched prefill + lock-step decode.

Port of ``repro/launch/serve.py``. Requests are packed into *waves* of up
to ``--batch`` sequences. Prompts in a wave are LEFT-padded to the wave's
max prompt length so every slot shares one scalar cache position; the wave
is prefilled token by token through the decode step and then decodes in
lock-step until all its members finish.

Runs on ``--device cuda`` (the default; raises without a card) with the
CUDA kernels switched on, or on ``--device cpu`` with their plain versions
switched off.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.launch import steps as steps_mod
from repro_torch.models import init_cache, init_params


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False


class WaveServer:
    """Fixed-shape wave batching on top of make_serve_step."""

    def __init__(self, cfg, model, *, batch_slots: int, max_len: int,
                 pad_token: int = 0) -> None:
        self.cfg = cfg
        self.model = model
        self.device = next(model.parameters()).device
        self.slots = batch_slots
        self.max_len = max_len
        self.pad = pad_token
        self.queue: List[Request] = []
        self._decode = steps_mod.make_serve_step(cfg)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _step(self, cache, toks: np.ndarray, pos: int):
        tokens = torch.as_tensor(toks, dtype=torch.long).to(self.device)
        nxt, cache = self._decode(self.model, cache, tokens[:, None], pos)
        return nxt[:, 0].cpu().numpy(), cache

    # ------------------------------------------------------------------ #
    def _prefill(self, wave: List[Request]):
        """Feed left-padded prompts token-by-token through the decode step.

        Left-padding means pad tokens occupy the OLDEST cache positions;
        every sequence's real tokens are contiguous at the end, so the
        shared scalar position is exact. Pad-prefix keys do enter the
        softmax, identically across the batch (the model treats the pad
        token as a BOS prefix).
        """
        L = max(len(r.prompt) for r in wave)
        toks = np.full((self.slots, L), self.pad, np.int64)
        for i, r in enumerate(wave):
            toks[i, L - len(r.prompt):] = r.prompt
        cache = init_cache(self.cfg, self.slots, self.max_len, self.device)
        last = None
        for t in range(L):
            last, cache = self._step(cache, toks[:, t], t)
        return last, cache, L

    def run_wave(self, wave: List[Request]) -> int:
        """Prefill + decode one wave to completion. Returns decode steps."""
        last, cache, pos = self._prefill(wave)
        steps = 0
        live = {i: r for i, r in enumerate(wave)}
        for i, r in live.items():
            r.out.append(int(last[i]))
        while any(not r.done for r in wave) and pos < self.max_len - 1:
            last, cache = self._step(cache, last, pos)
            pos += 1
            steps += 1
            for i, r in list(live.items()):
                if r.done:
                    continue
                r.out.append(int(last[i]))
                if len(r.out) >= r.max_new:
                    r.done = True
                    del live[i]
        for r in wave:
            r.done = True
        return steps

    def run(self) -> List[Request]:
        finished: List[Request] = []
        while self.queue:
            wave = self.queue[: self.slots]
            self.queue = self.queue[self.slots:]
            # pad the wave to full slot count with dummy requests
            while len(wave) < self.slots:
                wave.append(Request(-1, [self.pad], 1))
            self.run_wave(wave)
            finished += [r for r in wave if r.rid >= 0]
        return finished


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b_smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to serve on the CPU)")
    kernels.enable_kernels(args.device == "cuda")
    cfg = get_config(args.arch)
    assert cfg.supports_decode, f"{cfg.name} is encoder-only; nothing to serve"
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    model = init_params(cfg, gen, args.device)
    server = WaveServer(cfg, model, batch_slots=args.batch, max_len=args.max_len)

    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=int(rng.integers(4, 12))).tolist()
        server.submit(Request(rid, prompt, args.max_new))

    t0 = time.time()
    done = server.run()
    dt = time.time() - t0
    toks = sum(len(r.out) for r in done)
    return {
        "requests": len(done),
        "tokens": toks,
        "tok_per_s": toks / max(dt, 1e-9),
        "device": args.device,
    }


if __name__ == "__main__":
    out = main()
    print(f"served {out['requests']} requests, {out['tokens']} tokens "
          f"({out['tok_per_s']:.1f} tok/s on {out['device']})")
