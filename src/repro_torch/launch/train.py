"""Training launcher on one device (``repro.launch.train``'s single-device path).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \\
        --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ck --device cpu

Runs the production loop: the deterministic data pipeline, AdamW with a
linear warm-up and cosine decay, periodic async checkpoints, a straggler
monitor and resume from the latest complete checkpoint.  With --smoke it uses
the reduced config.  Weights are random, from seed 0, on ``--device``
(default ``cuda``; asking for ``cuda`` without a card raises).

The reference also builds a host mesh and installs its sharding annotations
(``make_host_mesh``, ``install_annotations``); on one device both are the
identity, so this path has neither.  As in the reference, a checkpoint holds
the parameters and the optimizer state only: a ``--compress-grads`` run
resumes with a fresh error-feedback state (ROADMAP queue 3, item 20).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw
from repro_torch.train import checkpoint, fault_tolerance
from repro_torch.train.loop import load_params, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b", choices=registry.list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--policy", default="bf16")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = registry.get_config(args.arch, smoke=args.smoke, policy_name=args.policy)
    dev = convert.resolve_device(args.device)
    model = Model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    params = dict(model.named_parameters())
    opt_cfg = adamw.AdamWConfig(lr=args.lr)
    opt_state = adamw.adamw_init(params, opt_cfg)
    n_params = sum(p.numel() for p in params.values())
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M policy={cfg.policy_name}")

    step_fn = make_train_step(model, opt_cfg, warmup_steps=max(args.steps // 10, 1),
                              total_steps=args.steps, compress_grads=args.compress_grads,
                              microbatch=args.microbatch)
    writer = checkpoint.AsyncWriter()
    monitor = fault_tolerance.StragglerDetector(num_hosts=1)

    start = 0
    if args.ckpt_dir and checkpoint.latest_step(args.ckpt_dir) is not None:
        state, extra = checkpoint.restore(args.ckpt_dir, like={"params": params,
                                                               "opt": opt_state})
        load_params(model, state["params"])
        opt_state = state["opt"]
        start = int(extra.get("next_step", 0))
        print(f"resumed from step {start}")

    data = Pipeline(DataConfig(global_batch=args.batch, seq_len=args.seq), cfg,
                    start_step=start, device=dev)
    try:
        try:
            compress_state = None
            for step in range(start, args.steps):
                batch = next(data)
                t0 = time.perf_counter()
                if args.compress_grads:
                    opt_state, metrics, _, compress_state = step_fn(opt_state, batch,
                                                                    compress_state)
                else:
                    opt_state, metrics, _ = step_fn(opt_state, batch)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                dt = time.perf_counter() - t0
                monitor.observe(np.asarray([dt]))
                if step % args.log_every == 0:
                    print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                          f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
                if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                    writer.save(args.ckpt_dir, step + 1, {"params": params, "opt": opt_state},
                                extra={"next_step": step + 1})
        finally:
            writer.wait()
    finally:
        data.close()
    print("done")


if __name__ == "__main__":
    main()
