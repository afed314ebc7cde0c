"""Training launcher: checkpoint/resume, the synthetic token stream, AdamW.

Held against ``src/repro/launch/train.py``: the same flags, output lines
and checkpoint cadence.

    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
        --batch 8 --seq 128 --steps 20 --ckpt-dir /tmp/ckpt [--reduced]

runs on the card (``--device cpu`` runs the same path on the CPU with the
kernels' plain versions; nothing falls back to the CPU unasked).
Parameters are random, drawn on the device from ``--seed``.  The data
stream is ``datagen.token_batches(np.random.default_rng(start_step))``;
a frontend that takes embeddings draws its stub inputs from a
``torch.Generator`` seeded by the step (the reference's distribution, not
JAX's bits).  Warmup is ``max(steps // 20, 1)``; every ``--ckpt-every``
steps ``(params, opt)`` is saved asynchronously in the reference's layout
(``convert.to_reference``), and synchronously at the end unless the last
step was just saved (the reference writes that step a second time, the
same bytes; hymba-1.5b's step is ~12.6 GB); a directory holding a step
resumes from it (``resumed from step N``), and a directory written by the
reference's launcher resumes too.

Which models train on one H100 (80 GB) at full width: a step holds bf16
parameters (2 B a parameter), AdamW's two float32 moments (8 B) and the
float32 microbatch accumulator (4 B), about 14 B a parameter before
activations and the bf16 microbatch gradients.  hymba-1.5b (1.26 B
parameters, ~18 GB) fits; rwkv6-7b (~105 GB), qwen3-14b (~207 GB) and
deepseek-moe-16b (~236 GB) need the model mesh (ROADMAP.md queue 1 item
10).  The default ``--arch`` stays the reference's, ``qwen3-14b``, which
runs here only ``--reduced``.
"""

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.checkpoint import checkpoint as C
from repro_torch.configs import canon, get_config, reduced
from repro_torch.data import datagen
from repro_torch.models import convert, model as M, transformer
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves


def restore(ckpt_dir: str, step: int, cfg, params, opt, dev):
    """Step ``step`` of ``ckpt_dir`` (the reference's layout) as the
    port's ``(params, opt)`` on ``dev``; ``params`` and ``opt`` give the
    shapes."""
    like = (convert.to_reference(params, cfg),
            convert.opt_to_reference(opt, cfg))
    p_ref, o_ref = C.restore(ckpt_dir, step, like)
    return (convert.from_reference(p_ref, cfg, dev),
            convert.opt_from_reference(o_ref, cfg, dev))


def save(ckpt_dir: str, step: int, cfg, params, opt, *, async_=True):
    C.save(ckpt_dir, step, (convert.to_reference(params, cfg),
                            convert.opt_to_reference(opt, cfg)),
           async_=async_)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random parameters")
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg = get_config(canon(args.arch))
    if args.reduced:
        cfg = reduced(cfg)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=max(args.steps // 20, 1))

    params = transformer.init_params(cfg, seed=args.seed, device=dev)
    opt = adamw.init_opt(params)
    n_params = sum(p.numel() for p in tree_leaves(params))
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"devices={n_dev}", flush=True)

    start_step = 0
    latest = C.latest_step(args.ckpt_dir)
    if latest is not None:
        start_step = latest
        params, opt = restore(args.ckpt_dir, latest, cfg, params, opt, dev)
        print(f"resumed from step {latest}", flush=True)

    rng = np.random.default_rng(start_step)
    stream = datagen.token_batches(rng, vocab=cfg.vocab, batch=args.batch,
                                   seq=args.seq,
                                   n_batches=args.steps - start_step)
    t0 = time.time()
    saved = start_step              # the step the directory holds last
    for i, batch in enumerate(stream, start=start_step + 1):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        if cfg.frontend != "token":
            gen = torch.Generator(device=dev).manual_seed(i)
            batch["inputs"] = torch.randn(
                (args.batch, args.seq, cfg.d_model), generator=gen,
                device=dev).to(torch.bfloat16)
        params, opt, m = M.train_step(params, opt, batch, cfg=cfg,
                                      opt_cfg=opt_cfg)
        if i % 10 == 0 or i == start_step + 1:
            dt = time.time() - t0
            print(f"step {i} loss={float(m['loss']):.4f} "
                  f"gnorm={float(m['grad_norm']):.3f} "
                  f"tok/s={args.batch*args.seq*10/max(dt,1e-9):.0f}",
                  flush=True)
            t0 = time.time()
        if i % args.ckpt_every == 0:
            save(args.ckpt_dir, i, cfg, params, opt)          # async
            saved = i
    C.wait(args.ckpt_dir)
    if saved != args.steps:
        save(args.ckpt_dir, args.steps, cfg, params, opt, async_=False)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
