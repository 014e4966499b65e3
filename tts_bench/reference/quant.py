"""Weight-only quantisation as the served configurations state it, worked
out again from the master weights, and dequantised to float32.

  int8  symmetric per output channel: scale = max|w| / 127 over a column,
        q = round(w / scale) clamped to [-127, 127].
  int4  grouped symmetric (Q4_K-class), groups of 128 rows: a column scale
        s = max|w| / (7 * 127), a multiplier m = round(max|w_group| /
        (7 s)) in [1, 127] per group and column, q = round(w / (m s))
        in [-7, 7]; w ~= q * m * s.

Rounding is half to even (`torch.round`). The layer matmuls' int4 column
scale is the column maximum times the float32 reciprocal of 7 * 127 (as a
compiled quantiser computes it), the head's the quotient: the two differ in
the last bit of some scales and so in a few rounded weights.
"""

from __future__ import annotations

import torch

GROUP4 = 128


def int8(w: torch.Tensor) -> torch.Tensor:
    wf = w.float()
    scale = wf.abs().amax(dim=0).clamp_min(1e-8) / 127.0
    return torch.clamp(torch.round(wf / scale), -127, 127) * scale


def int4(w: torch.Tensor, reciprocal: bool) -> torch.Tensor:
    wf = w.float()
    K, N = wf.shape
    if K % (2 * GROUP4):
        raise ValueError(f"int4 needs rows in multiples of {2 * GROUP4}")
    wg = wf.reshape(K // GROUP4, GROUP4, N)
    amax_g = wg.abs().amax(dim=1)
    amax = amax_g.amax(dim=0).clamp_min(1e-8)
    scale = amax * (1.0 / (7.0 * 127.0)) if reciprocal \
        else amax / (7.0 * 127.0)
    m = torch.clamp(torch.round(amax_g / (7.0 * scale)), 1, 127)
    step = m * scale
    q = torch.clamp(torch.round(wg / step[:, None]), -7, 7)
    return (q * m[:, None] * scale).reshape(K, N)


def weight(w: torch.Tensor, kind: str, layer: bool) -> torch.Tensor:
    """[in, out] master weight -> float32 as `kind` serves it."""
    if kind == "dense":
        return w.float()
    if kind == "int8":
        return int8(w)
    if kind == "int4":
        return int4(w, reciprocal=layer)
    raise ValueError(f"weight kind {kind!r}")


# the next precision below each stated kind: the control of the check
LOWER = {"dense": "int8", "int8": "int4", "int4": "int4"}
