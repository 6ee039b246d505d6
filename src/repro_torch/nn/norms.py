"""RMSNorm (counterpart of ``repro.nn.norms``)."""
from __future__ import annotations

import torch
from torch import nn


class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = nn.Parameter(scale)


def rmsnorm_init(dim: int, *, device=None) -> RMSNorm:
    return RMSNorm(torch.ones((dim,), dtype=torch.float32, device=device))


def rmsnorm_apply(p: RMSNorm, x: torch.Tensor, *, eps: float = 1e-6
                  ) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p.scale.float()).to(dt)
