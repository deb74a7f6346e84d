"""Train a reduced LM for a few hundred steps with the paper's Bubble-tree
summarizer curating the data stream, on the PyTorch port.

The port's copy of ``examples/train_lm_with_curation.py``, on the card by
default (``--device cpu`` runs the plain versions on the CPU).  The
curator ingests one embedding per training sequence (fully dynamic: old
sequences retire as the window slides), and at every 50th step the
offline HDBSCAN pass over the data bubbles reports cluster structure and
drift, at O(L²) cost whatever the number of sequences streamed.

  PYTHONPATH=src python examples/torch_train_lm_with_curation.py --steps 200
  PYTHONPATH=src python examples/torch_train_lm_with_curation.py --device cpu --steps 60
"""

import argparse
import time

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch.data.curation import StreamCurator
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.train.optim import AdamWConfig, adamw_init


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--window", type=int, default=64, help="curation window (sequences)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = C.get_smoke(args.arch)  # a reduced config of the same family
    values = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    print(f"{args.arch} (reduced): {M.count_params(values):,} params on {dev.type}")

    step_fn = M.make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps))
    opt_state = adamw_init(values)
    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq, seed=0)

    model = M.build_model(cfg)

    @torch.no_grad()
    def embed_fn(params, tokens):
        return model.forward(params, {"tokens": tokens, "labels": tokens}).mean(dim=1)

    curator = StreamCurator(dim=16, min_pts=8, compression=0.1, drift_tol=0.4, device=dev)
    seq_ids = []

    t0 = time.time()
    losses = []
    for step in range(args.steps):
        batch = next(pipe)
        tbatch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        values, opt_state, m = step_fn(values, opt_state, tbatch)
        losses.append(float(m["loss"]))

        # --- curation plane: pooled logits as sequence embeddings ---
        if step % 5 == 0:
            emb = embed_fn(values, tbatch["tokens"]).float().cpu().numpy()[:, :16]
            ids = [f"s{step}.{i}" for i in range(emb.shape[0])]
            curator.observe_block(ids, emb)
            seq_ids.extend(ids)
            while len(seq_ids) > args.window:  # slide: retire oldest
                curator.retire(seq_ids.pop(0))

        if (step + 1) % 50 == 0:
            rep = curator.curate(step=step + 1)
            print(
                f"step {step + 1:4d} loss {np.mean(losses[-50:]):.4f} | curation: "
                f"{rep.n_clusters} clusters / {rep.n_bubbles} bubbles over "
                f"{rep.n_examples} seqs, drift {rep.drift:.2f}"
                + (" <-- DRIFT ALARM" if rep.drifted else "")
            )

    pipe.close()
    dt = time.time() - t0
    print(f"\n{args.steps} steps in {dt:.1f}s; loss {losses[0]:.3f} -> {np.mean(losses[-20:]):.3f}")
    assert np.mean(losses[-20:]) < losses[0], "training should reduce loss"
    print("OK")


if __name__ == "__main__":
    main()
