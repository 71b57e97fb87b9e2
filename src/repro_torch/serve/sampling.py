"""Token sampling (the JAX package's ``repro.serve.sampling``): greedy
argmax, or temperature with an optional top-k cut, drawn from a
``torch.Generator`` on the logits' device.  The draws do not match the
reference's ``jax.random.categorical``; greedy decoding does."""
from __future__ import annotations

from typing import Optional

import torch


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k > 0:
        cutoff = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < cutoff, torch.full_like(logits, -1e30),
                             logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
