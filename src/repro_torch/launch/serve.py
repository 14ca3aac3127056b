"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Runs the batched decode engine on a smoke-sized model with random weights
(seed 0), as the reference's launcher does, on the card unless
``--device cpu`` is given (the default raises without CUDA).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, SKIP_CELLS, get_config
from repro_torch.edm.dataset import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    decodable = [a for a in ARCHS
                 if "decode_32k" not in SKIP_CELLS.get(a, set())]
    ap.add_argument("--arch", default="llama3-8b", choices=decodable)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device, "repro_torch.launch.serve")
    cfg = get_config(args.arch, smoke=True)
    model = tf.init_params(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    engine = ServeEngine(cfg, model, s_max=128)
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size,
                                          int(rng.integers(3, 10)))))
               for _ in range(args.requests)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    res = engine.generate(prompts, max_new=args.max_new,
                          temperature=args.temperature)
    dt = time.time() - t0
    new = sum(len(o) - len(p) for o, p in zip(res.tokens, prompts))
    print(f"[serve] arch={cfg.name} device={dev} batch={len(prompts)} "
          f"generated={new}tok in {dt:.2f}s")
    for p, o in zip(prompts, res.tokens):
        print(f"  {p} → {o[len(p):]}")
    return res


if __name__ == "__main__":
    main()
