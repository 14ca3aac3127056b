"""Batched serving engine: greedy/temperature decode through
``decode_step`` (the port of ``repro.serving.engine``).

Fixed-slot batching: requests are grouped into a batch, caches allocated
to ``s_max`` on the model's device, prompts replayed token by token
(left-padded with each row's first token, so every row ends at the same
position — correct for any lengths), then decoded together until every
slot hits EOS or ``max_new``. Only each step's logits row crosses to the
host; greedy is the host's argmax and temperature sampling the host's
``numpy.random.default_rng(seed).choice``, as the reference, so equal
probabilities give equal tokens.

On a mesh (``meshctx.set_mesh``, the model placed by
``carry.place_params``) every rank calls ``generate`` with the same
prompts: the cache is placed by ``cache_specs``, each step's logits come
back whole on every rank, and every rank returns the same tokens.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import meshctx
from repro_torch.models import transformer as tf


@dataclasses.dataclass
class GenerationResult:
    tokens: list[list[int]]
    steps: int


class ServeEngine:
    """Generates from ``model`` (an ``init_params`` module of ``cfg``) on
    the device its parameters are on."""

    def __init__(self, cfg, model, *, s_max: int = 256):
        self.cfg = cfg
        self.model = model
        self.s_max = s_max
        self.device = next(model.parameters()).device

    @torch.no_grad()
    def generate(
        self,
        prompts: list[list[int]],
        *,
        max_new: int = 32,
        temperature: float = 0.0,
        eos_id: int | None = None,
        seed: int = 0,
    ) -> GenerationResult:
        cfg = self.cfg
        B = len(prompts)
        lens = [len(p) for p in prompts]
        max_len = max(lens)
        if max_len + max_new > self.s_max:
            raise ValueError("s_max too small for prompt + max_new")
        cache = tf.init_cache(cfg, B, self.s_max, device=self.device,
                              mesh=meshctx.get_mesh())
        # Left-pad with the row's first token so all rows end at the same
        # position; padded prefix tokens are part of the replay but the
        # generated continuation starts from the true prompt ending.
        toks = np.zeros((B, max_len), np.int32)
        for i, p in enumerate(prompts):
            toks[i, max_len - len(p):] = p
            toks[i, : max_len - len(p)] = p[0]
        toks = torch.as_tensor(toks, device=self.device)
        logits = None
        for t in range(max_len):
            logits, cache = tf.decode_step(self.model, cfg, toks[:, t:t + 1],
                                           cache, t)
        out = [list(p) for p in prompts]
        rng = np.random.default_rng(seed)
        done = np.zeros(B, bool)
        steps = 0
        for t in range(max_new):
            lg = logits[:, 0].float().cpu().numpy()
            if temperature > 0:
                z = lg / temperature
                z = z - z.max(-1, keepdims=True)
                prob = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
                nxt = np.array(
                    [rng.choice(cfg.vocab_size, p=prob[i]) for i in range(B)],
                    np.int32)
            else:
                nxt = lg.argmax(-1).astype(np.int32)
            for i in range(B):
                if not done[i]:
                    out[i].append(int(nxt[i]))
                    if eos_id is not None and nxt[i] == eos_id:
                        done[i] = True
            steps += 1
            if done.all():
                break
            logits, cache = tf.decode_step(
                self.model, cfg, torch.as_tensor(nxt[:, None],
                                                 device=self.device),
                cache, max_len + t)
        return GenerationResult(tokens=out, steps=steps)
