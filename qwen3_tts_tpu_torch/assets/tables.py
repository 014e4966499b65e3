"""Embedding tables + projection ("assets") as device tensors.

Port of `qwen3_tts_tpu/assets/tables.py`: the text table [text_vocab, dim],
the 16 codec codebook tables (stacked [16, rows, dim], zero-padded to a
common row count) and the dim->1024 projection (PyTorch Linear layout
[1024, dim]).

Semantics kept from the reference:
  * codec lookup clamps negative codes to 0 and returns zeros for
    out-of-range rows;
  * `tts_pad` is text-table row 151671;
  * text-table OOB falls back to the pattern `((id*17 + i) % 2) - 1`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import protocol


@dataclass
class Assets:
    text_table: torch.Tensor      # [text_vocab, dim]
    codec_tables: torch.Tensor    # [16, rows, dim]
    proj_weight: torch.Tensor     # [1024, dim]
    proj_bias: torch.Tensor       # [1024]

    @property
    def device(self) -> torch.device:
        return self.text_table.device

    @property
    def tts_pad(self) -> torch.Tensor:
        """Text-table row 151671, added to every talker feedback embedding.
        A table with fewer rows (tiny test configs) gives its last row, as
        the JAX package's clamped indexing does."""
        n = self.text_table.shape[0]
        return self.text_table[min(protocol.TEXT_AUDIO_MARKER, n - 1)]

    @property
    def codec_rows(self) -> int:
        return self.codec_tables.shape[1]

    def project(self, hidden: torch.Tensor) -> torch.Tensor:
        """Dense dim -> 1024."""
        return hidden @ self.proj_weight.T + self.proj_bias

    def codec_embedding(self, q, code) -> torch.Tensor:
        """codec_tables[q][code] with clamp-to-0 / OOB-zeros semantics.

        `q` and `code` broadcast together; returns [..., dim].
        """
        q = torch.as_tensor(q, dtype=torch.long, device=self.device)
        code = torch.as_tensor(code, dtype=torch.long, device=self.device)
        q, code = torch.broadcast_tensors(q, code)
        clamped = code.clamp_min(0)
        valid = clamped < self.codec_rows
        safe = clamped.clamp_max(self.codec_rows - 1)
        emb = self.codec_tables[q, safe]
        return torch.where(valid[..., None], emb, torch.zeros_like(emb))

    def text_embedding(self, token_id) -> torch.Tensor:
        """text_table[token_id] with the deterministic OOB fallback pattern."""
        token_id = torch.as_tensor(token_id, dtype=torch.long,
                                   device=self.device)
        n, dim = self.text_table.shape
        valid = (token_id >= 0) & (token_id < n)
        emb = self.text_table[token_id.clamp(0, n - 1)]
        i = torch.arange(dim, device=self.device)
        fallback = (((token_id[..., None] * 17 + i) % 2)
                    .to(self.text_table.dtype) - 1.0)
        return torch.where(valid[..., None], emb, fallback)

    def frame_embedding_sum(self, frame_codes: torch.Tensor) -> torch.Tensor:
        """Sum_q codec_tables[q][code_q]: [..., 16] -> [..., dim]."""
        q = torch.arange(self.codec_tables.shape[0], device=self.device)
        return self.codec_embedding(q, frame_codes).sum(dim=-2)


def build_assets(text, codecs, proj_w, proj_b, *, device="cpu",
                 dtype=torch.float32) -> Assets:
    """Assets from numpy arrays, with the JAX package's reshaping rules."""
    proj_w = np.asarray(proj_w, np.float32)
    if proj_w.ndim == 1:
        proj_w = proj_w.reshape(protocol.PROJ_DIM, -1)
    dim = proj_w.shape[-1]
    text = np.asarray(text, np.float32).reshape(-1, dim)
    proj_b = np.asarray(proj_b, np.float32).reshape(-1)
    codecs = [np.asarray(c, np.float32).reshape(-1, dim) for c in codecs]
    if not codecs:
        raise ValueError("no codec embedding tables found")
    rows = max(c.shape[0] for c in codecs)
    stacked = np.zeros((protocol.NUM_CODEBOOKS, rows, dim), np.float32)
    for i, c in enumerate(codecs):
        stacked[i, : c.shape[0]] = c   # zero padding == OOB-zeros semantics

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    return Assets(text_table=t(text), codec_tables=t(stacked),
                  proj_weight=t(proj_w), proj_bias=t(proj_b))


def random_assets(
    generator: torch.Generator,
    text_vocab: int = 4096,
    codec_rows: int = 3072,
    dim: int = protocol.EMBED_DIM,
    proj_dim: int = protocol.PROJ_DIM,
    *,
    device="cpu",
    dtype=torch.float32,
    scale: float = 0.02,
) -> Assets:
    """Seeded random tables; `generator` lives on `device`."""

    def w(*shape):
        x = torch.randn(*shape, generator=generator, device=device)
        return (scale * x).to(dtype)

    return Assets(
        text_table=w(text_vocab, dim),
        codec_tables=w(protocol.NUM_CODEBOOKS, codec_rows, dim),
        proj_weight=w(proj_dim, dim),
        proj_bias=w(proj_dim),
    )
