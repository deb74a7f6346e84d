"""Serving example on the PyTorch port: continuous batching over a reduced
zoo model, on the card by default.

  PYTHONPATH=src python examples/torch_serve_batched.py --arch qwen1.5-0.5b
  PYTHONPATH=src python examples/torch_serve_batched.py --arch qwen2-moe-a2.7b   # or dbrx-132b, llama-3.2-vision-11b
  PYTHONPATH=src python examples/torch_serve_batched.py --device cpu   # plain versions on the CPU
"""

import argparse
import time

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = C.get_smoke(args.arch)
    dev = resolve_device(args.device)
    values = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    eng = ServeEngine(cfg, values, slots=args.slots, cache_len=96, device=dev)

    rng = np.random.default_rng(1)
    reqs = []
    for i in range(args.requests):
        reqs.append(
            Request(
                rid=i,
                prompt=rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 20))).astype(np.int32),
                max_new_tokens=int(rng.integers(4, 12)),
            )
        )
        eng.submit(reqs[-1])

    t0 = time.time()
    eng.run()
    dt = time.time() - t0
    assert all(r.done for r in reqs)
    print(f"served {len(reqs)} variable-length requests on {args.slots} slots")
    print(f"{eng.tokens_out} tokens in {eng.steps} engine steps, {dt:.1f}s "
          f"({eng.tokens_out / dt:.1f} tok/s on {dev})")
    occ = eng.tokens_out / (eng.steps * args.slots)
    print(f"slot occupancy: {100 * occ:.0f}% (continuous batching keeps slots busy)")
    for r in reqs[:3]:
        print(f"  req {r.rid}: {len(r.prompt)}-token prompt -> {r.generated}")
    print("OK")


if __name__ == "__main__":
    main()
