"""Serving driver: continuous batching over a published or smoke config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
        --policy ozaki2_int8 --compute-dtype float32 --device cpu

``--arch`` takes any arch of ``configs.registry`` (whisper-medium, qwen2-vl-72b,
minitron-4b, yi-6b, gemma-7b, gemma3-4b, jamba-1.5-large-398b, deepseek-moe-16b,
llama4-scout-17b-a16e, xlstm-350m).  Requests are text: whisper's decode attends
over a cross cache of zeros (it takes no audio, as in the reference; ROADMAP
queue 3, item 16), and qwen2-vl's three M-RoPE streams are equal.

Weights and prompts are random, from seed 0, on ``--device`` (default
``cuda``; asking for ``cuda`` without a card raises).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.core import policy
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import ContinuousBatcher, Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b", choices=registry.list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--policy", default=None, choices=policy.POLICIES,
                    help="precision policy of the weight matmuls (default: the config's)")
    ap.add_argument("--compute-dtype", default=None, choices=("bfloat16", "float32"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=4)
    args = ap.parse_args(argv)

    over = {}
    if args.policy:
        over["policy_name"] = args.policy
    if args.compute_dtype:
        over["compute_dtype"] = args.compute_dtype
    cfg = registry.get_config(args.arch, smoke=args.smoke, **over)
    dev = convert.resolve_device(args.device)
    model = Model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    engine = ServeEngine(model, batch_slots=args.slots, max_seq=args.max_seq)
    batcher = ContinuousBatcher(engine)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for uid in range(args.requests):
        batcher.submit(Request(uid=uid, max_new_tokens=args.max_new,
                               prompt=rng.integers(0, cfg.vocab_size, args.prompt_len)))
    done = batcher.run_to_completion(max_steps=2000)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in done)
    for r in sorted(done, key=lambda r: r.uid):
        print(f"req {r.uid}: {list(r.prompt)} -> {r.generated}")
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{len(done)} requests, {toks} tokens in {dt:.1f}s ({toks / dt:.2f} tok/s on {where})")


if __name__ == "__main__":
    main()
