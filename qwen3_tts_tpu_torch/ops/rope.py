"""M-RoPE (multi-stream rotary position embedding).

Port of `qwen3_tts_tpu/ops/rope.py`. Four position streams per token
(temporal / height / width / channel) with t == h == w == sequence index and
channel == 0; the rotary frequency budget (head_dim // 2) is split into four
contiguous sections, one per stream. Rotation uses the rotate-half
convention: both halves of the head share one frequency table.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def mrope_positions(pos: torch.Tensor) -> torch.Tensor:
    """Sequence positions [..] -> 4-stream positions [4, ..]."""
    pos = pos.to(torch.int32)
    return torch.stack([pos, pos, pos, torch.zeros_like(pos)], dim=0)


def section_ids(sections: Sequence[int]) -> list:
    """Rotary frequency index -> stream id, from section widths."""
    out = []
    for stream, width in enumerate(sections):
        out.extend([stream] * width)
    return out


# per (sections, head_dim, theta, device): the inverse frequencies and the
# stream of each rotary index, made once, so that a call makes no host
# tensor (the talker step kernel's tables are made inside CUDA graphs)
_freq_tables: dict = {}


def _freqs(sections, head_dim: int, theta: float, dev):
    key = (tuple(sections), head_dim, theta, dev)
    if key not in _freq_tables:
        half = head_dim // 2
        inv_freq = 1.0 / (theta ** (torch.arange(
            0, half, dtype=torch.float32, device=dev) * 2.0 / head_dim))
        stream = torch.tensor(section_ids(sections), dtype=torch.long,
                              device=dev)
        _freq_tables[key] = (inv_freq, stream)
    return _freq_tables[key]


def rope_angles(
    pos4: torch.Tensor,
    sections: Tuple[int, int, int, int],
    head_dim: int,
    theta: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables: pos4 [4, B, S] -> (cos, sin) each [B, S, head_dim] f32
    in the rotate-half layout."""
    inv_freq, stream = _freqs(sections, head_dim, theta, pos4.device)
    pos_sel = pos4[stream].movedim(0, -1).to(torch.float32)   # [B, S, half]
    ang = pos_sel * inv_freq
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, n_heads, hd]; cos/sin [B, S, hd]. Computed in x.dtype, as
    the JAX package does."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return x * c + rotated * s
