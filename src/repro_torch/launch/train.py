"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Runs the fault-tolerant loop (``repro_torch.training.train``) on a
smoke-sized config (``--full`` for the configured widths), on the card
unless ``--device cpu`` is given (the default raises without CUDA).
Restart the process with the same ``--workdir`` and it resumes from the
latest checkpoint.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import ARCHS, TrainConfig, get_config
from repro_torch.data.pipeline import TokenPipeline, embeds_pipeline
from repro_torch.edm.dataset import resolve_device
from repro_torch.training import train


class _EmbedsPipe:
    def __init__(self, cfg, batch, seq, seed=0):
        self._get = embeds_pipeline(cfg.d_model, batch, seq, seed)
        self._vocab = cfg.vocab_size

    def global_batch(self, step):
        return self._get(step, self._vocab)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced config (the default)")
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adamw8bit"])
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device, "repro_torch.launch.train")
    cfg = get_config(args.arch, smoke=args.smoke)
    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=10,
                       total_steps=args.steps, microbatch=args.microbatch,
                       optimizer=args.optimizer,
                       grad_compression=args.grad_compression)
    workdir = args.workdir or os.path.join(tempfile.gettempdir(),
                                           f"repro_torch_{args.arch}")
    if cfg.embed_inputs:
        pipe = _EmbedsPipe(cfg, args.batch, args.seq)
    else:
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=args.batch,
                             seq_len=args.seq)
    print(f"[train] arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"steps={args.steps} device={dev} workdir={workdir}")
    _, history = train(cfg, tcfg, pipe, workdir=workdir,
                       num_steps=args.steps, ckpt_every=25, log_every=5,
                       device=dev)
    if history:
        print(f"[train] done: loss {history[0]['loss']:.3f} → "
              f"{history[-1]['loss']:.3f}")
    else:
        print(f"[train] done: {workdir} holds step {args.steps} already")
    return history


if __name__ == "__main__":
    main()
