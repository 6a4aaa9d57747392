"""Error-feedback int8 gradient compression for the cross-pod hop.

Gradients crossing the slowest link can be quantized with error feedback
(the residual carried into the next step) at no convergence cost in
practice [Seide'14-style EF-SGD].  In the reference, `compressed_psum` is
a `shard_map` all-gather over a mesh axis; here the ranks are a leading
tensor axis on one card, as the executor keeps n_dev: int8 values and one
float32 scale a rank are what would cross the link.
"""
from __future__ import annotations

import torch

from ..tree import tree_map


def compress(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Tensor-wise absmax int8; returns (q, scale)."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress(x: torch.Tensor, err: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback compression: returns (q, scale, new_err)."""
    target = x.float() + err
    q, scale = compress(target)
    new_err = target - decompress(q, scale)
    return q, scale, new_err


def compressed_psum(x: torch.Tensor, err: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sum over the leading rank axis moving int8 (+1 float32 scale a rank).

    x, err: (n, ...), rank r's gradient and residual in row r.  Each rank
    compresses its own row (`ef_compress`); returns (the decompressed sum,
    which every rank holds: (n, ...) float32, the new residuals for the
    NEXT step (n, ...))."""
    n = x.shape[0]
    target = x.float() + err
    flat = target.reshape(n, -1)
    scale = torch.clamp(flat.abs().amax(dim=1), min=1e-12) / 127.0  # (n,)
    q = torch.clamp(torch.round(flat / scale[:, None]), -127, 127
                    ).to(torch.int8)
    new_err = (flat - q.float() * scale[:, None]).reshape(x.shape)
    total = torch.tensordot(scale, q.float(), dims=([0], [0]))
    return total.reshape(x.shape[1:]).expand(x.shape).clone(), new_err


def init_error(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
