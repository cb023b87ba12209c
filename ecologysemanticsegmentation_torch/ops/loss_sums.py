"""The eight masked per-channel loss sums (plain PyTorch; port of the
constants and ``_sums_reference`` of
``ecologysemanticsegmentation_tpu/ops/pallas/loss_sums.py``).

Rows: Σg, Σp, Σp², Σgp, Σ(1−p)^1.5·log(p+ε), Σp^1.5·log(1−p+ε),
Σ max(p,0)+log1p(e^−|p|), and the count of non-ignored pixels.  The
``loss_sums`` kernel itself (the full-resolution loss path) is not ported yet.
"""

from __future__ import annotations

import torch

EPS = 1e-7
GAMMA = 1.5
NUM_SUMS = 8  # 7 sums + element count


def _sums_reference(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``p``, ``g`` are (C, N); returns (8, C) float32.  Pixels with
    ``g < 0`` (the ``-1`` ignore sentinel) drop out of every row, the count
    row included."""
    p = p.float()
    g = g.float()
    w = (g >= 0).float()
    gw = g * w
    pw = p * w
    return torch.stack([
        gw.sum(1),
        pw.sum(1),
        (pw * p).sum(1),
        (gw * p).sum(1),
        (w * torch.pow(1.0 - p, GAMMA) * torch.log(p + EPS)).sum(1),
        (w * torch.pow(p, GAMMA) * torch.log(1.0 - p + EPS)).sum(1),
        (w * (torch.clamp(p, min=0.0) + torch.log1p(torch.exp(-p.abs())))).sum(1),
        w.sum(1),
    ])
