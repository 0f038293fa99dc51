"""Losses (the port's copy of repro.train.loss): cross-entropy with the
z-loss and accuracy.  The reference's chunked-vocab `fused_ce_loss` is not
on its default path (loss_chunk_vocab = 0) and is not ported yet."""
from __future__ import annotations

from typing import Tuple

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0) -> Tuple[torch.Tensor, dict]:
    """logits [B, L, V] (any float), labels [B, L] int.  Returns (loss,
    metrics): the mean negative log-likelihood, plus z_loss * mean(lse^2)
    when z_loss > 0; metrics (detached) nll, accuracy and z_loss."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    lab = labels.to(torch.int64)
    gold = torch.gather(logits, -1, lab[..., None])[..., 0]
    loss = torch.mean(lse - gold)
    metrics = {"nll": loss.detach(),
               "accuracy": torch.mean(
                   (torch.argmax(logits, -1) == lab).to(torch.float32))}
    if z_loss > 0:
        zl = z_loss * torch.mean(lse ** 2)
        loss = loss + zl
        metrics["z_loss"] = zl.detach()
    return loss, metrics
