"""Serving entry point: the continuous-batching engine over a zoo model
of the dense, MoE, vision or ssm (RWKV-6) family.

The port's copy of the JAX package's ``launch/serve.py``, on the card by
default (``--device cpu`` runs the plain versions on the CPU).  The
params are drawn from a seeded ``torch.Generator`` on the device leaf by
leaf into their compute-dtype copy (``models.init_compute_params``), so
the f32 master is never whole on the card: qwen2-moe-a2.7b (28.6 GB in
bf16) and llama-3.2-vision-11b (20.2 GB) fit one 80 GB card at full
width; dbrx-132b (263 GB) does not.  The prompts have 4–15 tokens,
within RWKV's chunk rule (a prompt longer than 64 tokens must be a
multiple of 64).

  python -m repro_torch.launch.serve --arch qwen2-1.5b            # full width, on the card
  python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --cache-len 1024
  python -m repro_torch.launch.serve --arch rwkv6-1.6b --max-new 32   # its state is O(1) in cache_len
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b --smoke --device cpu \\
      --requests 12 --slots 4 --max-new 12
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import configs as C
from ..device import resolve_device
from ..models import model as M
from ..serving import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = C.get_smoke(args.arch) if args.smoke else C.get(args.arch)
    dev = resolve_device(args.device)
    params = M.init_compute_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    engine = ServeEngine(cfg, params, slots=args.slots, cache_len=args.cache_len, seed=args.seed, device=dev)

    rng = np.random.default_rng(args.seed)
    reqs = []
    for r in range(args.requests):
        plen = int(rng.integers(4, 16))
        req = Request(
            rid=r,
            prompt=rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32),
            max_new_tokens=args.max_new,
            temperature=args.temperature,
        )
        reqs.append(req)
        engine.submit(req)

    t0 = time.time()
    engine.run()
    dt = time.time() - t0
    done = sum(r.done for r in reqs)
    print(
        f"served {done}/{len(reqs)} requests, {engine.tokens_out} tokens in "
        f"{engine.steps} engine steps ({dt:.1f}s, {engine.tokens_out / max(dt, 1e-9):.1f} tok/s)"
    )
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt[:4]={r.prompt[:4].tolist()} -> gen={r.generated[:8]}")
    return 0 if done == len(reqs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
