"""Vocoder: 16-codebook frames -> 24 kHz waveform. Port of
`qwen3_tts_tpu/models/vocoder.py`.

  codes [B,N,16] --embed-sum--> [B,N,512]
    --causal pre-conv (K=3, history carried)--> [B,N,1024]
    --8L/16H/64hd causal transformer (KV cache, ops/attention)--> latents
    --centered conv (K=2*LA+1: LA frames of lookahead)--> [B,N+LA,1024]
    --causal conv (K=3, history carried)--> [B,N+LA,1024]
    --upsampler--> wav

Two upsampler families, as in JAX:
  * kernel == stride (the default): strides 5,5,5,4,4, each stage one
    matmul per frame and an interleave, so every latent maps to its own
    2000 samples and nothing is carried; wav [B, (N+LA)*2000];
  * general (BigVGAN/DAC lineage, `cfg.upsample_kernels` set): per stage
    a ConvTranspose1d with kernel != stride (overlap-add across frames),
    residual dilated conv units, then a final conv and tanh. Streamed by
    overlap-recompute: each call runs the stack on [the last ctx_l + ctx_r
    latents | the newly finalized ones] with per-row boundary masks at
    every layer's rate, and emits only the samples that neither the left
    edge of the window nor a future latent can change, so chunked output is
    one-shot output (`up_context`); emission lags ctx_r frames more, and
    wav is [B, (N+LA+ctx_r)*2000].

The activation of every conv site is tanh gelu (JAX's default) or, with
`cfg.activation == "snake"`, BigVGAN's per-channel x + sin^2(a x) / a;
the matmul path's last stage is tanh in both.

`decode` carries the streaming state like the JAX version: the offline
path calls it once (zero state sized to the frame count, is_last=True),
the streaming path once per 4-frame chunk against a state of `max_frames`
KV slots, and `flush` drains the lookahead window when a stream ends
between chunks. Callers keep `wav[:, :valid]`. `gather_row` and
`reset_row` take one row out of a batched state and return a row to the
stream-start state. The convolutions are torch ops (cuDNN on the card, no
Pallas kernel in JAX), run with TF32 off (`core/precision.f32_exact`).
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.config import PredictorConfig, VocoderConfig
from ..core.precision import f32_exact
from . import decoder


def transformer_config(cfg: VocoderConfig) -> PredictorConfig:
    """The vocoder transformer expressed through the shared decoder."""
    return PredictorConfig(
        hidden=cfg.hidden, n_layers=cfg.n_layers, n_q_heads=cfg.n_heads,
        n_kv_heads=cfg.n_heads, head_dim=cfg.head_dim, ffn_dim=cfg.ffn_dim,
        vocab=8, max_seq=cfg.max_frames,
        mrope_sections=(cfg.head_dim // 2, 0, 0, 0), dtype=cfg.dtype)


@dataclass
class VocoderState:
    pre_conv_history: torch.Tensor   # [B, embed_dim, pre_k-1]
    latent_buffer: torch.Tensor      # [B, hidden, 2*lookahead]
    conv_history: torch.Tensor       # [B, hidden, post_k-1]
    kv: Dict[str, torch.Tensor]      # [L, B, H, T, hd]
    frames_done: torch.Tensor        # [B] int32
    # the general upsampler's rolling latent window [B, hidden,
    # ctx_l + ctx_r] (width 0 on the kernel == stride path)
    up_hist: torch.Tensor


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
        up_hist=z(batch, cfg.hidden, sum(up_context(cfg))),
    )


def upsample_channels(cfg: VocoderConfig):
    """Matmul path: 1024 -> ... -> 1, halving per stage (floor 32)."""
    chans = [cfg.hidden]
    c = cfg.hidden
    for _ in cfg.upsample_factors[:-1]:
        c = max(32, c // 2)
        chans.append(c)
    chans.append(1)
    return chans


def up_channels(cfg: VocoderConfig):
    """General path: hidden halving per stage (floor 32) unless
    cfg.upsample_channels pins it; the final conv maps to 1."""
    if cfg.upsample_channels is not None:
        return [cfg.hidden, *cfg.upsample_channels]
    chans = [cfg.hidden]
    for _ in cfg.upsample_factors:
        chans.append(max(32, chans[-1] // 2))
    return chans


def stage_pads(cfg: VocoderConfig):
    """Per-stage (left, right) output trims of the general path's transposed
    convs; left + right == kernel - stride keeps T * stride samples (ONNX
    ConvTranspose pads)."""
    out = []
    for i, (k, s) in enumerate(zip(cfg.upsample_kernels,
                                   cfg.upsample_factors)):
        p = (cfg.upsample_pads[i] if cfg.upsample_pads is not None
             else (k - s + 1) // 2)
        out.append((p, k - s - p))
    return out


@functools.lru_cache(maxsize=None)
def up_context(cfg: VocoderConfig):
    """(ctx_l, ctx_r) in latent frames for the general upsampler: a latent
    at index i influences output samples [i*S + lo, i*S + hi], so a sample
    needs latents up to ceil(hi/S) frames back and ceil(-lo/S) frames ahead
    (the emission delay). (0, 0) on the kernel == stride path."""
    if not cfg.general_upsampler:
        return (0, 0)
    lo = hi = 0
    kr = cfg.resblock_kernel
    for (k, s), (pl, _pr) in zip(
            zip(cfg.upsample_kernels, cfg.upsample_factors),
            stage_pads(cfg)):
        lo, hi = lo * s - pl, hi * s + (k - 1 - pl)
        for d in cfg.resblock_dilations:
            reach = d * (kr - 1)
            pl_r = reach // 2
            lo, hi = lo - (reach - pl_r), hi + pl_r
    kf = cfg.final_conv_kernel
    pf = (kf - 1) // 2
    lo, hi = lo - (kf - 1 - pf), hi + pf
    S = cfg.frame_samples
    return (-(-max(hi, 0) // S), -(-max(-lo, 0) // S))


def init_vocoder(generator: Optional[torch.Generator], cfg: VocoderConfig,
                 *, device="cpu", scale: float = 0.02) -> Dict[str, Any]:
    """Seeded random f32 weights with the JAX package's tree and shapes
    (snake alphas 1.0, biases 0, matrices `scale` * normal); with
    device="meta", the skeleton a checkpoint loads into."""
    def w(*shape):
        return scale * torch.randn(shape, generator=generator, device=device)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    snake = cfg.activation == "snake"

    def alpha(c, name="alpha"):
        return {name: torch.ones(c, device=device)} if snake else {}

    extra = {}
    if cfg.general_upsampler:
        # per stage: act -> ConvTranspose (k != s) -> residual dilated
        # units; then act -> final conv -> tanh
        chans = up_channels(cfg)
        up = []
        for i, k in enumerate(cfg.upsample_kernels):
            c_in, c_out = chans[i], chans[i + 1]
            entry = {"wt": w(c_in, c_out, k),        # torch's [Cin, Cout, K]
                     "b": zeros(c_out), **alpha(c_in)}
            res = [{"w1": w(c_out, c_out, cfg.resblock_kernel),
                    "b1": zeros(c_out), "w2": w(c_out, c_out, 1),
                    "b2": zeros(c_out), **alpha(c_out, "alpha1"),
                    **alpha(c_out, "alpha2")}
                   for _ in cfg.resblock_dilations]
            if res:
                entry["res"] = res
            up.append(entry)
        extra["final"] = {"w": w(1, chans[-1], cfg.final_conv_kernel),
                          "b": zeros(1), **alpha(chans[-1])}
    else:
        chans = upsample_channels(cfg)
        n = len(cfg.upsample_factors)
        # the last stage is the tanh waveform head: no alpha
        up = [{"w": w(chans[i], s * chans[i + 1]),
               "b": zeros(s * chans[i + 1]),
               **(alpha(chans[i + 1]) if i < n - 1 else {})}
              for i, s in enumerate(cfg.upsample_factors)]
    la = cfg.lookahead
    return {
        **extra,
        "embed": w(cfg.num_codebooks, cfg.code_vocab, cfg.embed_dim),
        "pre_conv": {"w": w(cfg.hidden, cfg.embed_dim, cfg.pre_conv_kernel),
                     "b": zeros(cfg.hidden), **alpha(cfg.hidden)},
        "transformer": decoder.init_decoder(
            generator, transformer_config(cfg), device=device, scale=scale),
        "post_a": {"w": w(cfg.hidden, cfg.hidden, 2 * la + 1),
                   "b": zeros(cfg.hidden), **alpha(cfg.hidden)},
        "post_b": {"w": w(cfg.hidden, cfg.hidden, cfg.post_conv_kernel),
                   "b": zeros(cfg.hidden), **alpha(cfg.hidden)},
        "up": up,
    }


def with_dtype(params: Dict[str, Any], cfg: VocoderConfig) -> Dict[str, Any]:
    """The transformer trunk's float leaves cast to cfg.dtype (a bf16 trunk
    for serving); the convs, the upsampler, the snake alphas and the
    carried state stay f32. Checkpoints store f32, so the engine applies
    this after every load."""
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


def _snake(x, a):
    s = torch.sin(a * x)
    return x + s * s / a


def _act(cfg: VocoderConfig, entry: Dict[str, Any], x: torch.Tensor,
         channel_axis: int, key: str = "alpha") -> torch.Tensor:
    """A conv site's activation: tanh gelu, or snake with the site's
    per-channel alpha (zero-preserving, like gelu, so zero padding at
    stream start means the same in both)."""
    if cfg.activation != "snake":
        return _gelu(x)
    shape = [1] * x.ndim
    shape[channel_axis] = -1
    return _snake(x, entry[key].reshape(shape))


def _upsample(params, cfg: VocoderConfig, lat: torch.Tensor) -> torch.Tensor:
    """[B, M, hidden] -> [B, M*2000]: each stage one matmul + interleave."""
    B = lat.shape[0]
    z = lat
    n = len(params["up"])
    for i, (stage, s) in enumerate(zip(params["up"], cfg.upsample_factors)):
        z = z @ stage["w"] + stage["b"]
        c_out = stage["w"].shape[1] // s
        z = z.reshape(B, z.shape[1] * s, c_out)
        z = torch.tanh(z) if i == n - 1 else _act(cfg, stage, z, 2)
    return z[..., 0]


def _up_stack_general(params, cfg: VocoderConfig, window: torch.Tensor,
                      g0: torch.Tensor, n_total: torch.Tensor
                      ) -> torch.Tensor:
    """The general upsampler on a window, exact to one-shot decoding.

    window [B, hidden, W] latents, column j global latent g0[b] + j (g0
    may be negative at stream start: those columns are before the stream);
    n_total [B] the latents finalized so far. Every layer's output is
    zeroed outside [0, n_total) at that layer's rate, as one-shot decoding
    pads it. Returns [B, W * frame_samples]."""

    def mask(z, rate):
        pos = g0[:, None] * rate + torch.arange(z.shape[-1],
                                                device=z.device)[None]
        ok = (pos >= 0) & (pos < n_total[:, None] * rate)
        return torch.where(ok[:, None, :], z, torch.zeros_like(z))

    rate = 1
    z = mask(window, rate)
    for stage, s, (pl, pr) in zip(params["up"], cfg.upsample_factors,
                                  stage_pads(cfg)):
        z = _act(cfg, stage, z, 1)
        # torch's transposed conv, untrimmed ((T-1)*s + K), then ONNX's
        # asymmetric trim (pl, pr): torch's one `padding` is symmetric
        z = F.conv_transpose1d(z, stage["wt"], stage["b"], stride=s)
        z = z[..., pl: z.shape[-1] - pr]
        rate *= s
        z = mask(z, rate)
        for unit, d in zip(stage.get("res", ()), cfg.resblock_dilations):
            reach = d * (unit["w1"].shape[-1] - 1)
            y = _act(cfg, unit, z, 1, "alpha1")
            y = F.conv1d(F.pad(y, (reach // 2, reach - reach // 2)),
                         unit["w1"], unit["b1"], dilation=d)
            y = _act(cfg, unit, y, 1, "alpha2")
            y = F.conv1d(y, unit["w2"], unit["b2"])
            z = mask(z + y, rate)
    fin = params["final"]
    z = _act(cfg, fin, z, 1)
    kf = cfg.final_conv_kernel
    pf = (kf - 1) // 2
    z = F.conv1d(F.pad(z, (pf, kf - 1 - pf)), fin["w"], fin["b"])
    return torch.tanh(z)[:, 0, :]


def _post_stage(params, cfg: VocoderConfig, h_new: torch.Tensor,
                state: VocoderState, is_last: torch.Tensor):
    """Lookahead post-net + upsampler. Returns (wav, valid [B],
    new latent buffer, new conv history, new up_hist); wav is
    [B, (N+LA)*F] on the matmul path, [B, (N+LA+ctx_r)*F] on the general
    path."""
    B, N, H = h_new.shape
    la = cfg.lookahead
    kb = cfg.post_conv_kernel
    fd = state.frames_done.long()
    dev = h_new.device

    hc = h_new.transpose(1, 2)                                 # [B, H, N]
    a_in = torch.cat([state.latent_buffer, hc,
                      torch.zeros(B, H, la, device=dev)], dim=-1)
    a_out = _act(cfg, params["post_a"],
                 _conv1d(a_in, params["post_a"]), 1)           # [B,H,N+LA]
    g = (fd[:, None] - la) + torch.arange(N + la, device=dev)[None]
    a_out = torch.where((g >= 0)[:, None, :], a_out,
                        torch.zeros_like(a_out))

    b_in = torch.cat([state.conv_history, a_out], dim=-1)
    b_out = _act(cfg, params["post_b"],
                 _conv1d(b_in, params["post_b"]), 1)           # [B,H,N+LA]

    shift = (la - fd).clamp(0, la)
    lat = b_out.transpose(1, 2)                                # [B,N+LA,H]
    idx = (torch.arange(N + la, device=dev)[None] + shift[:, None]) % (N + la)
    lat = torch.gather(lat, 1, idx[:, :, None].expand(B, N + la, H))

    emitted_before = (fd - la).clamp_min(0)
    total = fd + N
    fin_total = torch.where(is_last > 0, total, (total - la).clamp_min(0))
    emit_now = (fin_total - emitted_before).clamp_min(0)

    if not cfg.general_upsampler:
        # every finalized latent maps to exactly its own 2000 samples
        wav = _upsample(params, cfg, lat)
        valid = emit_now * cfg.frame_samples
        new_up = state.up_hist
    else:
        # overlap-recompute: run the stack on [history | new latents], emit
        # the clean range, carry the last ctx_l + ctx_r latents
        S = cfg.frame_samples
        ctx_l, ctx_r = up_context(cfg)
        C = ctx_l + ctx_r
        window = torch.cat([state.up_hist, lat.transpose(1, 2)], dim=-1)
        g0 = emitted_before - C
        wav_full = _up_stack_general(params, cfg, window, g0, fin_total)
        prev_emit = (emitted_before - ctx_r).clamp_min(0)
        emit_end = torch.where(is_last > 0, fin_total,
                               (fin_total - ctx_r).clamp_min(0))
        emit_cnt = (emit_end - prev_emit).clamp_min(0)
        cols = torch.arange((N + la + ctx_r) * S, device=dev)[None]
        idx = (prev_emit - g0)[:, None] * S + cols
        wav = torch.gather(wav_full, 1,
                           idx.clamp(0, wav_full.shape[1] - 1))
        wav = torch.where(cols < (emit_cnt * S)[:, None], wav,
                          torch.zeros_like(wav))
        valid = emit_cnt * S
        if C > 0:
            hidx = torch.arange(C, device=dev)[None] + emit_now[:, None]
            new_up = torch.gather(window, 2,
                                  hidx[:, None, :].expand(B, H, C))
        else:
            new_up = state.up_hist

    new_latbuf = (torch.cat([state.latent_buffer, hc], dim=-1)[..., -2 * la:]
                  if la > 0 else state.latent_buffer)
    hist_src = torch.cat([state.conv_history, a_out[..., :N]], dim=-1)
    new_hist = hist_src[..., -(kb - 1):] if kb > 1 else state.conv_history
    return wav, valid, new_latbuf, new_hist, new_up


def decode(params: Dict[str, Any], cfg: VocoderConfig, codes: torch.Tensor,
           state: VocoderState, is_last=False
           ) -> Tuple[torch.Tensor, torch.Tensor, VocoderState]:
    """Decode N frames against the carried state. Returns (wav
    [B, (N + lookahead + ctx_r) * 2000] with ctx_r = 0 on the matmul path,
    valid_samples [B], new state); callers keep wav[:, :valid]. The KV
    cache in `state` is updated in place."""
    B, N, Q = codes.shape
    if Q != cfg.num_codebooks:
        raise ValueError(
            f"codes must have {cfg.num_codebooks} codebooks, got {Q}")
    dev = codes.device
    codes = codes.long().clamp(0, cfg.code_vocab - 1)
    last_vec = torch.as_tensor(is_last, device=dev).to(torch.int32).expand(B)

    with f32_exact(dev):
        q_idx = torch.arange(Q, device=dev)
        x = params["embed"][q_idx[None, None], codes].sum(dim=2)  # [B,N,E]

        pre_in = torch.cat([state.pre_conv_history, x.transpose(1, 2)],
                           dim=-1)
        y = _act(cfg, params["pre_conv"],
                 _conv1d(pre_in, params["pre_conv"]), 1)
        kp = cfg.pre_conv_kernel
        new_pre = pre_in[..., -(kp - 1):] if kp > 1 \
            else state.pre_conv_history

        tcfg = transformer_config(cfg)
        h_in = y.transpose(1, 2).to(getattr(torch, cfg.dtype))
        pos = state.frames_done.long()[:, None] \
            + torch.arange(N, device=dev)[None]
        h, _, kv = decoder.forward(params["transformer"], tcfg, h_in, pos,
                                   state.kv, state.frames_done,
                                   with_logits=False)

        wav, valid, new_latbuf, new_hist, new_up = _post_stage(
            params, cfg, h.float(), state, last_vec)
    new_state = VocoderState(
        pre_conv_history=new_pre, latent_buffer=new_latbuf,
        conv_history=new_hist, kv=kv,
        frames_done=state.frames_done + N, up_hist=new_up)
    return wav, valid, new_state


def flush(params: Dict[str, Any], cfg: VocoderConfig, state: VocoderState
          ) -> Tuple[torch.Tensor, torch.Tensor, VocoderState]:
    """Drain the lookahead window with no new frames (the N=0 `is_last`
    call): returns (wav [B, (lookahead + ctx_r) * 2000], valid [B], dead
    state). Used when a stream ends between chunks."""
    B = state.frames_done.shape[0]
    dev = state.frames_done.device
    h0 = torch.zeros(B, 0, cfg.hidden, device=dev)
    with f32_exact(dev):
        wav, valid, new_latbuf, new_hist, new_up = _post_stage(
            params, cfg, h0, state,
            torch.ones(B, dtype=torch.int32, device=dev))
    new_state = VocoderState(
        pre_conv_history=state.pre_conv_history, latent_buffer=new_latbuf,
        conv_history=new_hist, kv=state.kv, frames_done=state.frames_done,
        up_hist=new_up)
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
        frames_done=state.frames_done[r].clone(),
        up_hist=state.up_hist[r].clone())


def reset_row(state: VocoderState, row: int) -> VocoderState:
    """Return one batch row to the stream-start state (zeros) and return the
    state. Unlike the JAX version, which builds a new state, this zeroes
    the row in place."""
    for t in (state.pre_conv_history, state.latent_buffer,
              state.conv_history, state.frames_done, state.up_hist):
        t[row] = 0
    for v in state.kv.values():
        v[:, row] = 0
    return state
