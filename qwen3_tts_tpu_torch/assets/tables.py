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

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..core import protocol
from . import gguf


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

    def codec_embedding_1024(self, q, code) -> torch.Tensor:
        """Table row then projection (`src/assets_manager.rs:439-442`)."""
        return self.project(self.codec_embedding(q, code))

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


def load_assets(model_dir: str, *, device="cpu",
                dtype=torch.float32) -> Assets:
    """Load from `<dir>/qwen3_assets.gguf`, falling back to NPY files, the
    resolution order of the JAX package (and of the reference)."""
    gguf_path = os.path.join(model_dir, "qwen3_assets.gguf")
    if os.path.exists(gguf_path):
        f = gguf.GGUFFile(gguf_path)
        proj_w = f.read_tensor("proj.weight")
        proj_b = f.read_tensor("proj.bias")
        text = (f.read_tensor("text_embd") if "text_embd" in f.tensors
                else np.zeros((0, protocol.EMBED_DIM), np.float32))
        codecs = [f.read_tensor(f"codec_embd.{i}")
                  for i in range(protocol.NUM_CODEBOOKS)
                  if f"codec_embd.{i}" in f.tensors]
    elif not os.path.exists(os.path.join(model_dir, "proj_weight.npy")):
        raise FileNotFoundError(
            f"no embedding tables in {model_dir!r}: expected "
            "qwen3_assets.gguf or proj_weight.npy (run "
            "TtsEngine.download_models or tools/convert_weights.py)")
    else:
        proj_w = np.load(os.path.join(model_dir, "proj_weight.npy"))
        proj_b = np.load(os.path.join(model_dir, "proj_bias.npy"))
        text_path = os.path.join(model_dir, "text_embedding_projected.npy")
        text = (np.load(text_path) if os.path.exists(text_path)
                else np.zeros((0, protocol.EMBED_DIM), np.float32))
        codecs = []
        for i in range(protocol.NUM_CODEBOOKS):
            p = os.path.join(model_dir, f"codec_embedding_{i}.npy")
            if os.path.exists(p):
                codecs.append(np.load(p))
    return build_assets(text, codecs, proj_w, proj_b, device=device,
                        dtype=dtype)


def save_assets(path: str, assets: Assets) -> None:
    """Write `assets` as the F32 GGUF container `load_assets` reads
    (the tensors the JAX engine's `save_checkpoint` writes)."""
    def host(t):
        return t.detach().float().cpu().numpy()

    tensors = {"proj.weight": host(assets.proj_weight),
               "proj.bias": host(assets.proj_bias),
               "text_embd": host(assets.text_table)}
    for i in range(assets.codec_tables.shape[0]):
        tensors[f"codec_embd.{i}"] = host(assets.codec_tables[i])
    gguf.write_gguf(path, tensors)


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
