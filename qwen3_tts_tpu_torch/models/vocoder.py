"""Vocoder: 16-codebook frames -> 24 kHz waveform. Port of
`qwen3_tts_tpu/models/vocoder.py` on its default path, where every
upsampling stage has kernel == stride and so is one matmul per frame.

  codes [B,N,16] --embed-sum--> [B,N,512]
    --causal pre-conv (K=3, history carried)--> [B,N,1024]
    --8L/16H/64hd causal transformer (KV cache, ops/attention)--> latents
    --centered conv (K=2*LA+1: LA frames of lookahead)--> [B,N+LA,1024]
    --causal conv (K=3, history carried)--> [B,N+LA,1024]
    --upsampler, strides 5,5,5,4,4 as matmuls--> wav [B,(N+LA)*2000]

`decode` carries the streaming state like the JAX version: the offline
path calls it once (zero state sized to the frame count, is_last=True),
the streaming path once per 4-frame chunk against a state of `max_frames`
KV slots, and `flush` drains the lookahead window when a stream ends
between chunks. `gather_row` and `reset_row` take one row out of a batched
state and return a row to the stream-start state. The general BigVGAN/DAC
upsampler family and the snake activation come later (ROADMAP queue 1).
The activation is JAX's default gelu, the tanh form.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..core.config import PredictorConfig, VocoderConfig
from . import decoder


def transformer_config(cfg: VocoderConfig) -> PredictorConfig:
    """The vocoder transformer expressed through the shared decoder."""
    return PredictorConfig(
        hidden=cfg.hidden, n_layers=cfg.n_layers, n_q_heads=cfg.n_heads,
        n_kv_heads=cfg.n_heads, head_dim=cfg.head_dim, ffn_dim=cfg.ffn_dim,
        vocab=8, max_seq=cfg.max_frames,
        mrope_sections=(cfg.head_dim // 2, 0, 0, 0), dtype=cfg.dtype)


def _check_supported(cfg: VocoderConfig) -> None:
    if cfg.general_upsampler or cfg.activation != "gelu":
        raise NotImplementedError(
            "only the kernel == stride upsampler with gelu is ported "
            "(general family and snake: ROADMAP queue 1)")


@dataclass
class VocoderState:
    pre_conv_history: torch.Tensor   # [B, embed_dim, pre_k-1]
    latent_buffer: torch.Tensor      # [B, hidden, 2*lookahead]
    conv_history: torch.Tensor       # [B, hidden, post_k-1]
    kv: Dict[str, torch.Tensor]      # [L, B, H, T, hd]
    frames_done: torch.Tensor        # [B] int32


def init_state(cfg: VocoderConfig, batch: int, frames: int | None = None,
               device="cpu") -> VocoderState:
    """Zero state; `frames` bounds the KV extent when the frame count is
    known up front (one-shot decoding)."""
    tcfg = transformer_config(cfg)
    if frames is not None:
        tcfg = dataclasses.replace(
            tcfg, max_seq=max(8, min(tcfg.max_seq, frames)))

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return VocoderState(
        pre_conv_history=z(batch, cfg.embed_dim, cfg.pre_conv_kernel - 1),
        latent_buffer=z(batch, cfg.hidden, 2 * cfg.lookahead),
        conv_history=z(batch, cfg.hidden, cfg.post_conv_kernel - 1),
        kv=decoder.init_kv_cache(tcfg, batch, device=device),
        frames_done=torch.zeros(batch, dtype=torch.int32, device=device),
    )


def upsample_channels(cfg: VocoderConfig):
    """1024 -> ... -> 1, halving per stage (floor 32)."""
    chans = [cfg.hidden]
    c = cfg.hidden
    for _ in cfg.upsample_factors[:-1]:
        c = max(32, c // 2)
        chans.append(c)
    chans.append(1)
    return chans


def init_vocoder(generator: torch.Generator, cfg: VocoderConfig, *,
                 device="cpu", scale: float = 0.02) -> Dict[str, Any]:
    """Seeded random f32 weights with the JAX package's shapes."""
    _check_supported(cfg)

    def w(*shape):
        return scale * torch.randn(shape, generator=generator, device=device)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    chans = upsample_channels(cfg)
    up = [{"w": w(chans[i], s * chans[i + 1]), "b": zeros(s * chans[i + 1])}
          for i, s in enumerate(cfg.upsample_factors)]
    la = cfg.lookahead
    return {
        "embed": w(cfg.num_codebooks, cfg.code_vocab, cfg.embed_dim),
        "pre_conv": {"w": w(cfg.hidden, cfg.embed_dim, cfg.pre_conv_kernel),
                     "b": zeros(cfg.hidden)},
        "transformer": decoder.init_decoder(
            generator, transformer_config(cfg), device=device, scale=scale),
        "post_a": {"w": w(cfg.hidden, cfg.hidden, 2 * la + 1),
                   "b": zeros(cfg.hidden)},
        "post_b": {"w": w(cfg.hidden, cfg.hidden, cfg.post_conv_kernel),
                   "b": zeros(cfg.hidden)},
        "up": up,
    }


def with_dtype(params: Dict[str, Any], cfg: VocoderConfig) -> Dict[str, Any]:
    """The transformer trunk's float leaves cast to cfg.dtype (a bf16 trunk
    for serving); the convs, the upsampler and the carried state stay f32.
    Checkpoints store f32, so the engine applies this after every load."""
    dt = getattr(torch, cfg.dtype)
    if dt == torch.float32:
        return params

    def cast(node):
        if isinstance(node, dict):
            return {k: cast(v) for k, v in node.items()}
        return node.to(dt) if node.dtype == torch.float32 else node

    return dict(params, transformer=cast(params["transformer"]))


def _conv1d(x, p):
    """VALID conv, channels-first: x [B, Cin, T], w [Cout, Cin, K]."""
    return F.conv1d(x, p["w"], p["b"])


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _upsample(params, cfg: VocoderConfig, lat: torch.Tensor) -> torch.Tensor:
    """[B, M, hidden] -> [B, M*2000]: each stage one matmul + interleave."""
    B = lat.shape[0]
    z = lat
    n = len(params["up"])
    for i, (stage, s) in enumerate(zip(params["up"], cfg.upsample_factors)):
        z = z @ stage["w"] + stage["b"]
        c_out = stage["w"].shape[1] // s
        z = z.reshape(B, z.shape[1] * s, c_out)
        z = torch.tanh(z) if i == n - 1 else _gelu(z)
    return z[..., 0]


def _post_stage(params, cfg: VocoderConfig, h_new: torch.Tensor,
                state: VocoderState, is_last: torch.Tensor):
    """Lookahead post-net + upsampler. Returns (wav, valid [B],
    new latent buffer, new conv history)."""
    B, N, H = h_new.shape
    la = cfg.lookahead
    kb = cfg.post_conv_kernel
    fd = state.frames_done.long()
    dev = h_new.device

    hc = h_new.transpose(1, 2)                                 # [B, H, N]
    a_in = torch.cat([state.latent_buffer, hc,
                      torch.zeros(B, H, la, device=dev)], dim=-1)
    a_out = _gelu(_conv1d(a_in, params["post_a"]))             # [B,H,N+LA]
    g = (fd[:, None] - la) + torch.arange(N + la, device=dev)[None]
    a_out = torch.where((g >= 0)[:, None, :], a_out,
                        torch.zeros_like(a_out))

    b_in = torch.cat([state.conv_history, a_out], dim=-1)
    b_out = _gelu(_conv1d(b_in, params["post_b"]))             # [B,H,N+LA]

    shift = (la - fd).clamp(0, la)
    lat = b_out.transpose(1, 2)                                # [B,N+LA,H]
    idx = (torch.arange(N + la, device=dev)[None] + shift[:, None]) % (N + la)
    lat = torch.gather(lat, 1, idx[:, :, None].expand(B, N + la, H))

    emitted_before = (fd - la).clamp_min(0)
    total = fd + N
    fin_total = torch.where(is_last > 0, total, (total - la).clamp_min(0))
    emit_now = (fin_total - emitted_before).clamp_min(0)

    wav = _upsample(params, cfg, lat)
    valid = emit_now * cfg.frame_samples
    new_latbuf = (torch.cat([state.latent_buffer, hc], dim=-1)[..., -2 * la:]
                  if la > 0 else state.latent_buffer)
    hist_src = torch.cat([state.conv_history, a_out[..., :N]], dim=-1)
    new_hist = hist_src[..., -(kb - 1):] if kb > 1 else state.conv_history
    return wav, valid, new_latbuf, new_hist


def decode(params: Dict[str, Any], cfg: VocoderConfig, codes: torch.Tensor,
           state: VocoderState, is_last=False
           ) -> Tuple[torch.Tensor, torch.Tensor, VocoderState]:
    """Decode N frames against the carried state. Returns (wav
    [B, (N+lookahead)*2000], valid_samples [B], new state); the KV cache
    in `state` is updated in place."""
    _check_supported(cfg)
    B, N, Q = codes.shape
    if Q != cfg.num_codebooks:
        raise ValueError(
            f"codes must have {cfg.num_codebooks} codebooks, got {Q}")
    dev = codes.device
    codes = codes.long().clamp(0, cfg.code_vocab - 1)
    last_vec = torch.as_tensor(is_last, device=dev).to(torch.int32).expand(B)

    q_idx = torch.arange(Q, device=dev)
    x = params["embed"][q_idx[None, None], codes].sum(dim=2)   # [B, N, E]

    pre_in = torch.cat([state.pre_conv_history, x.transpose(1, 2)], dim=-1)
    y = _gelu(_conv1d(pre_in, params["pre_conv"]))
    kp = cfg.pre_conv_kernel
    new_pre = pre_in[..., -(kp - 1):] if kp > 1 else state.pre_conv_history

    tcfg = transformer_config(cfg)
    h_in = y.transpose(1, 2).to(getattr(torch, cfg.dtype))
    pos = state.frames_done.long()[:, None] + torch.arange(N, device=dev)[None]
    h, _, kv = decoder.forward(params["transformer"], tcfg, h_in, pos,
                               state.kv, state.frames_done, with_logits=False)

    wav, valid, new_latbuf, new_hist = _post_stage(
        params, cfg, h.float(), state, last_vec)
    new_state = VocoderState(
        pre_conv_history=new_pre, latent_buffer=new_latbuf,
        conv_history=new_hist, kv=kv,
        frames_done=state.frames_done + N)
    return wav, valid, new_state


def flush(params: Dict[str, Any], cfg: VocoderConfig, state: VocoderState
          ) -> Tuple[torch.Tensor, torch.Tensor, VocoderState]:
    """Drain the lookahead window with no new frames (the N=0 `is_last`
    call): returns (wav [B, lookahead*2000], valid [B], dead state). Used
    when a stream ends between chunks."""
    _check_supported(cfg)
    B = state.frames_done.shape[0]
    dev = state.frames_done.device
    h0 = torch.zeros(B, 0, cfg.hidden, device=dev)
    wav, valid, new_latbuf, new_hist = _post_stage(
        params, cfg, h0, state, torch.ones(B, dtype=torch.int32, device=dev))
    new_state = VocoderState(
        pre_conv_history=state.pre_conv_history, latent_buffer=new_latbuf,
        conv_history=new_hist, kv=state.kv, frames_done=state.frames_done)
    return wav, valid, new_state


def gather_row(state: VocoderState, row: int) -> VocoderState:
    """One batch row as a B=1 state, copied (a later `decode` of it writes
    its own KV cache, not the batch's)."""
    r = slice(row, row + 1)
    return VocoderState(
        pre_conv_history=state.pre_conv_history[r].clone(),
        latent_buffer=state.latent_buffer[r].clone(),
        conv_history=state.conv_history[r].clone(),
        kv={k: v[:, r].clone() for k, v in state.kv.items()},
        frames_done=state.frames_done[r].clone())


def reset_row(state: VocoderState, row: int) -> VocoderState:
    """Return one batch row to the stream-start state (zeros) and return the
    state. Unlike the JAX version, which builds a new state, this zeroes
    the row in place."""
    for t in (state.pre_conv_history, state.latent_buffer,
              state.conv_history, state.frames_done):
        t[row] = 0
    for v in state.kv.values():
        v[:, row] = 0
    return state
