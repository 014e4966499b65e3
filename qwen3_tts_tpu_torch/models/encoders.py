"""Audio codec encoder + speaker encoder (the voice-cloning front ends).
Port of `qwen3_tts_tpu/models/encoders.py`.

  * AudioEncoder: waveform [N] f32 -> codes [N // 2000, 16]
    (`src/models/onnx.rs:97-121`). A strided, frame-local downsampling
    stack (kernel == stride: one matmul a stage, tanh gelu) -> a
    bidirectional transformer -> a 512-d latent projection -> greedy
    16-stage residual quantization against the vocoder's own embedding
    tables (the decoder sums them, so encoding is the matching stage-wise
    nearest-neighbour search, an argmax of r @ cb^T - ||cb||^2 / 2).
  * SpeakerEncoder: waveform -> log-mel [F, 128] (models/mel.py) -> conv
    subsampling -> bidirectional transformer -> attentive statistics
    pooling (weighted mean ++ std) -> linear to the 2048-d speaker
    embedding the prompt builder consumes (`src/tts/prompt.rs:207-222`).

The JAX package derived both architectures from the codec's structure (the
reference ships them as ONNX graphs); the port holds itself to the JAX
package. Everything is f32 torch ops (matmul, softmax, rfft): no Pallas
kernel runs here in the JAX package, so none is written here. On the card
the work runs with TF32 off (`core/precision.f32_exact`).

Both encoders are optional at engine load, as the reference's `.ok()`
loads are (`src/tts/engine.rs:107-120`). The torch-state-dict converters of
the JAX module (`convert_*_state_dict`, `export_*_state_dict`) are not
ported yet: they come with the ONNX converter (ROADMAP queue 1).
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..assets import checkpoint
from ..core.config import (AudioEncoderConfig, EngineConfig, MelConfig,
                           SpeakerEncoderConfig)
from ..core.precision import f32_exact
from . import mel as mel_mod
from .decoder import rms_norm


def _gelu(x):
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default form


def _weights(generator, device, scale):
    def w(*shape):
        return scale * torch.randn(shape, generator=generator, device=device)
    return w


# ----------------------------------------------------------------- encoder nn
def _init_encoder_stack(w, n_layers, hidden, n_heads, head_dim, ffn,
                        device):
    def ones(*shape):
        return torch.ones(shape, device=device)

    return {
        "ln1": ones(n_layers, hidden),
        "wqkv": w(n_layers, hidden, 3 * n_heads * head_dim),
        "wo": w(n_layers, n_heads * head_dim, hidden),
        "ln2": ones(n_layers, hidden),
        "w_gate": w(n_layers, hidden, ffn),
        "w_up": w(n_layers, hidden, ffn),
        "w_down": w(n_layers, ffn, hidden),
    }


def _encoder_stack(params, x: torch.Tensor, n_heads: int, head_dim: int,
                   eps: float) -> torch.Tensor:
    """Bidirectional (non-causal) transformer over [B, T, H]."""
    B, T, _ = x.shape
    h = x
    for i in range(params["ln1"].shape[0]):
        a = rms_norm(h, params["ln1"][i], eps)
        qkv = (a @ params["wqkv"][i]).reshape(B, T, 3, n_heads, head_dim)
        q, k, v = qkv.unbind(2)
        scores = torch.einsum("bsnh,btnh->bnst", q, k) / math.sqrt(head_dim)
        probs = torch.softmax(scores, dim=-1)
        att = torch.einsum("bnst,btnh->bsnh", probs, v).reshape(B, T, -1)
        h = h + att @ params["wo"][i]
        m = rms_norm(h, params["ln2"][i], eps)
        h = h + (F.silu(m @ params["w_gate"][i]) * (m @ params["w_up"][i])) \
            @ params["w_down"][i]
    return h


# ------------------------------------------------------------------------ RVQ
def rvq_encode(latents: torch.Tensor, codebooks: torch.Tensor
               ) -> torch.Tensor:
    """Greedy residual vector quantization.

    latents [T, D]; codebooks [Q, V, D] (the vocoder's embedding tables).
    Returns codes [T, Q] int64: per stage the argmax of r @ cb^T -
    ||cb||^2 / 2 (the nearest codeword; `torch.argmax` takes the first
    index on ties, as `jnp.argmax` does), then r -= cb[idx]."""
    cbs = codebooks.float()
    half_norms = 0.5 * (cbs ** 2).sum(dim=-1)                  # [Q, V]
    residual = latents.float()
    codes = []
    for q in range(cbs.shape[0]):
        scores = residual @ cbs[q].T - half_norms[q][None]     # [T, V]
        idx = scores.argmax(dim=-1)
        residual = residual - cbs[q][idx]
        codes.append(idx)
    return torch.stack(codes, dim=1)


# -------------------------------------------------------------- audio encoder
def downsample_channels(cfg: AudioEncoderConfig):
    """Mirror of the vocoder's upsampler schedule: 1 -> ... -> hidden."""
    chans = [cfg.hidden]
    c = cfg.hidden
    for _ in cfg.downsample_factors[:-1]:
        c = max(32, c // 2)
        chans.append(c)
    chans.append(1)
    return chans[::-1]


def init_audio_encoder(generator: Optional[torch.Generator],
                       cfg: AudioEncoderConfig, *, device="cpu",
                       scale: float = 0.02,
                       codebooks: Optional[torch.Tensor] = None
                       ) -> Dict[str, Any]:
    """Seeded random f32 weights with the JAX package's shapes; the RVQ
    codebooks are `codebooks` (the vocoder's tables) when given."""
    w = _weights(generator, device, scale)

    def zeros(n):
        return torch.zeros(n, device=device)

    chans = downsample_channels(cfg)
    down = [{"w": w(s * chans[i], chans[i + 1]), "b": zeros(chans[i + 1])}
            for i, s in enumerate(cfg.downsample_factors)]
    if codebooks is None:
        codebooks = w(cfg.num_codebooks, cfg.code_vocab, cfg.latent_dim)
    return {
        "down": down,
        "stack": _init_encoder_stack(w, cfg.n_layers, cfg.hidden,
                                     cfg.n_heads, cfg.head_dim, cfg.ffn_dim,
                                     device),
        "final_norm": torch.ones(cfg.hidden, device=device),
        "latent_proj": {"w": w(cfg.hidden, cfg.latent_dim),
                        "b": zeros(cfg.latent_dim)},
        "codebooks": codebooks.to(device=device, dtype=torch.float32),
    }


class AudioEncoder:
    def __init__(self, params: Dict[str, Any], cfg: AudioEncoderConfig):
        self.params = params
        self.cfg = cfg
        self.device = params["final_norm"].device

    def encode(self, audio: np.ndarray) -> np.ndarray:
        """wav [N] -> flat codes [T*16] int64, T = N // 2000
        (src/models/onnx.rs:97-121)."""
        audio = np.asarray(audio, np.float32)
        n_frames = len(audio) // self.cfg.frame_samples
        if n_frames == 0:
            return np.zeros((0,), np.int64)
        with torch.inference_mode(), f32_exact(self.device):
            codes = self.codes(torch.from_numpy(
                audio[: n_frames * self.cfg.frame_samples]).to(self.device))
        return codes.cpu().numpy().astype(np.int64).reshape(-1)

    def codes(self, audio: torch.Tensor) -> torch.Tensor:
        """audio [T * frame_samples] f32 on the device -> codes [T, 16]."""
        p, cfg = self.params, self.cfg
        z = audio.reshape(-1, 1)
        for stage, s in zip(p["down"], cfg.downsample_factors):
            z = _gelu(z.reshape(-1, s * z.shape[-1]) @ stage["w"]
                      + stage["b"])
        h = _encoder_stack(p["stack"], z[None], cfg.n_heads, cfg.head_dim,
                           cfg.rms_eps)
        h = rms_norm(h, p["final_norm"], cfg.rms_eps)
        lat = h[0] @ p["latent_proj"]["w"] + p["latent_proj"]["b"]
        return rvq_encode(lat, p["codebooks"])


# ------------------------------------------------------------ speaker encoder
def init_speaker_encoder(generator: Optional[torch.Generator],
                         cfg: SpeakerEncoderConfig, *, device="cpu",
                         scale: float = 0.02) -> Dict[str, Any]:
    w = _weights(generator, device, scale)

    def zeros(n):
        return torch.zeros(n, device=device)

    subs = []
    c_in = cfg.n_mels
    for s in cfg.subsample_factors:
        subs.append({"w": w(s * c_in, cfg.hidden), "b": zeros(cfg.hidden)})
        c_in = cfg.hidden
    return {
        "sub": subs,
        "stack": _init_encoder_stack(w, cfg.n_layers, cfg.hidden,
                                     cfg.n_heads, cfg.head_dim, cfg.ffn_dim,
                                     device),
        "final_norm": torch.ones(cfg.hidden, device=device),
        # attentive statistics pooling + output projection
        "attn_w": w(cfg.hidden, 1),
        "out_proj": {"w": w(2 * cfg.hidden, cfg.out_dim),
                     "b": zeros(cfg.out_dim)},
    }


class SpeakerEncoder:
    def __init__(self, params: Dict[str, Any], cfg: SpeakerEncoderConfig,
                 mel_cfg: MelConfig = MelConfig()):
        self.params = params
        self.cfg = cfg
        self.mel_cfg = mel_cfg
        self.device = params["final_norm"].device

    def encode(self, audio: np.ndarray) -> np.ndarray:
        """wav -> mel [F, 128] -> spk_emb [out_dim] f32; zeros below
        prod(subsample_factors) mel frames (src/models/onnx.rs:140-163)."""
        with torch.inference_mode(), f32_exact(self.device):
            mels = mel_mod.compute_mel(np.asarray(audio, np.float32),
                                       self.mel_cfg, self.device)
            if mels.shape[0] < int(np.prod(self.cfg.subsample_factors)):
                return np.zeros((self.cfg.out_dim,), np.float32)
            emb = self.embed(mels)
        return emb.cpu().numpy().astype(np.float32)

    def embed(self, mels: torch.Tensor) -> torch.Tensor:
        """mels [F, n_mels] on the device -> [out_dim]."""
        p, cfg = self.params, self.cfg
        z = mels
        for stage, s in zip(p["sub"], cfg.subsample_factors):
            keep = (z.shape[0] // s) * s
            z = _gelu(z[:keep].reshape(-1, s * z.shape[1]) @ stage["w"]
                      + stage["b"])
        h = _encoder_stack(p["stack"], z[None], cfg.n_heads, cfg.head_dim,
                           cfg.rms_eps)
        h = rms_norm(h, p["final_norm"], cfg.rms_eps)[0]       # [T, hidden]
        a = torch.softmax((h @ p["attn_w"])[:, 0], dim=0)      # [T]
        mean = (a[:, None] * h).sum(dim=0)
        var = (a[:, None] * (h - mean) ** 2).sum(dim=0)
        stats = torch.cat([mean, torch.sqrt(var + 1e-6)])
        return stats @ p["out_proj"]["w"] + p["out_proj"]["b"]


# ------------------------------------------------------------------- loading
def load_encoders(model_dir: str, config: EngineConfig, device="cpu"
                  ) -> Tuple[AudioEncoder, SpeakerEncoder]:
    """`audio_encoder.npz` and `speaker_encoder.npz` of `model_dir` (the
    JAX package's layout), each leaf straight to `device`; raises
    FileNotFoundError when either is missing."""
    ae_path = os.path.join(model_dir, "audio_encoder.npz")
    se_path = os.path.join(model_dir, "speaker_encoder.npz")
    if not (os.path.exists(ae_path) and os.path.exists(se_path)):
        raise FileNotFoundError(f"encoder checkpoints not found in {model_dir}")
    like_a = init_audio_encoder(None, config.audio_encoder, device="meta")
    like_s = init_speaker_encoder(None, config.speaker_encoder,
                                  device="meta")
    return (AudioEncoder(checkpoint.load_tree(ae_path, like_a, device=device),
                         config.audio_encoder),
            SpeakerEncoder(checkpoint.load_tree(se_path, like_s,
                                                device=device),
                           config.speaker_encoder, config.mel))


def random_encoders(generator: torch.Generator, config: EngineConfig,
                    vocoder_params: Optional[Dict[str, Any]] = None
                    ) -> Tuple[AudioEncoder, SpeakerEncoder]:
    """Seeded random encoders on the generator's device. With vocoder
    params the RVQ codebooks are TIED to the vocoder's embedding tables
    (the real codec's structure), making encode / decode a consistent
    round trip."""
    device = generator.device
    cb = None if vocoder_params is None else vocoder_params["embed"]
    return (
        AudioEncoder(init_audio_encoder(generator, config.audio_encoder,
                                        device=device, codebooks=cb),
                     config.audio_encoder),
        SpeakerEncoder(init_speaker_encoder(generator,
                                            config.speaker_encoder,
                                            device=device),
                       config.speaker_encoder, config.mel),
    )
