"""Batched serving: prefill + decode with greedy/temperature sampling.

``make_serve_step`` gives the one-token step for the whole batch against the
KV cache; ``ServeEngine.generate`` drives prefill and then that step, as
``repro.serve.engine`` does.  Temperature sampling draws its Gumbel noise
from a ``torch.Generator`` seeded with ``ServeConfig.seed``: ``jax.random``
cannot be reproduced, so sampled tokens differ from the reference's and
only greedy decoding is held to it.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch

__all__ = ["ServeConfig", "ServeEngine", "greedy_consistency", "make_serve_step"]


class ServeConfig(NamedTuple):
    """KV-cache length, sampling temperature (0 is greedy) and sampling seed."""

    max_len: int
    temperature: float = 0.0
    seed: int = 0


def make_serve_step(lm):
    """``(cache, tokens (B, 1), index, generator, temperature) -> (next (B, 1), logits, cache)``."""

    def serve_step(cache, tokens, index, generator, temperature):
        logits, cache = lm.decode_step(cache, tokens, index)
        last = logits[:, -1]
        if temperature > 0.0:
            u = torch.rand(last.shape, generator=generator, device=last.device)
            gumbel = -torch.log(-torch.log(u + 1e-9) + 1e-9)
            nxt = torch.argmax(last / max(temperature, 1e-6) + gumbel, dim=-1)
        else:
            nxt = torch.argmax(last, dim=-1)
        return nxt[:, None], logits, cache

    return serve_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeEngine:
    """Prefill a batch of prompts and decode ``n_tokens`` for each.

    ``timings`` holds the last ``generate``'s prefill and decode seconds on
    ``time.perf_counter`` (the device is synchronised at both ends of each
    phase).
    """

    def __init__(self, lm, cfg: ServeConfig):
        self.lm = lm
        self.cfg = cfg
        self._step = make_serve_step(lm)
        self._gen = torch.Generator(lm.device).manual_seed(cfg.seed)
        self.timings: dict = {}

    @torch.no_grad()
    def generate(self, prompts: torch.Tensor, n_tokens: int) -> torch.Tensor:
        """prompts (B, T0) -> (B, T0 + n_tokens): the prompts and the new tokens."""
        prompts = torch.as_tensor(prompts, device=self.lm.device).long()
        t0 = prompts.shape[1]
        _sync(self.lm.device)
        start = time.perf_counter()
        pf_logits, cache = self.lm.prefill(prompts, self.cfg.max_len)
        cur = torch.argmax(pf_logits, dim=-1)[:, None]
        _sync(self.lm.device)
        prefilled = time.perf_counter()
        out = [prompts, cur]
        # cur (position t0) is already chosen; each decode step consumes it
        # and emits the next token.
        for i in range(n_tokens - 1):
            cur, _, cache = self._step(cache, cur, t0 + i, self._gen, self.cfg.temperature)
            out.append(cur)
        _sync(self.lm.device)
        self.timings = {"prefill_s": prefilled - start, "decode_s": time.perf_counter() - prefilled,
                        "decode_steps": n_tokens - 1}
        return torch.cat(out, dim=1)


@torch.no_grad()
def greedy_consistency(lm, out: torch.Tensor, prompt_len: int) -> float:
    """Share of generated tokens ``out[:, prompt_len:]`` that the teacher-forced
    forward over ``out[:, :-1]`` also picks greedily.  Only the generated
    positions are unembedded."""
    x, _ = lm.hidden(out[:, :-1])
    greedy = torch.argmax(lm.logits_at(x[:, prompt_len - 1:]), dim=-1)
    return float((greedy == out[:, prompt_len:]).float().mean())
