"""The plain float32 reference of Qwen3-TTS's served path.

Plain PyTorch, TF32 off, no kernels and no cache: the prompt
embedding, the talker (a Qwen3 decoder over embedding inputs: RMSNorm,
QK-norm, GQA with rotate-half RoPE, SwiGLU), the predictor's 16-code
expansion of a frame, and the vocoder (code embedding sum, causal pre-conv,
a causal transformer, a centred lookahead conv, a causal post conv and the
kernel == stride upsampler). It imports nothing of the program: it reads
the master weights that `tts_bench/weights.py` makes from the seed, and
works out the int8 / int4 weight quantisation again itself (`quant.py`).

Every function runs teacher-forced: given the prompt and the codes the
program served, it returns the logits the served tokens were drawn from.

Departures from the model as published, which the program shares:
  * the predictor's head is one [hidden, 16 x 2048] matrix whose slice
    q - 1 scores codebook q (the reference GGUF's layout);
  * M-RoPE with t == h == w == the sequence index reduces to RoPE over
    the sections that are not the channel stream.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from . import quant

# generation protocol ids (the reference's `src/tts/prompt.rs:5-16`)
PAD, BOS, THINK, THINK_BOS, THINK_EOS = 2148, 2149, 2154, 2156, 2157
BOS_TOKEN, EOS_TOKEN, TEXT_AUDIO_MARKER = 151672, 151673, 151671
IM_START, ROLE_ASSISTANT, NEWLINE = 151644, 77091, 198
NUM_CODEBOOKS, CODE_VOCAB, SAMPLE_LIMIT = 16, 2048, 2160
FRAME_SAMPLES = 2000


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 on or off for cuBLAS and cuDNN inside the block (off: float32
    means float32)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, sections, theta: float):
    """x [B, S, heads, hd], rotate-half; rotary index i takes the position
    of its section's stream (streams 0-2: the sequence index, 3: 0)."""
    hd = x.shape[-1]
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) * 2.0 / hd)
    stream = torch.cat([torch.full((w,), s, device=x.device)
                        for s, w in enumerate(sections)])
    p = pos.float()[:, None] * (stream < 3).float()[None]       # [S, half]
    ang = torch.cat([p * inv, p * inv], dim=-1)[:, None]          # [S,1,hd]
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * torch.cos(ang) + rot * torch.sin(ang)


def decoder(layer: Callable[[int], Dict[str, torch.Tensor]], cfg: dict,
            final_norm: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Causal decoder over embedding inputs x [B, S, H], positions 0..S-1
    in every row. `layer(l)` gives layer l's f32 weights ([in, out]
    matrices). Returns the final-normed hidden [B, S, H]."""
    B, S, _ = x.shape
    nq, nk, hd = cfg["n_q_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    eps, F_ = cfg["rms_eps"], cfg["ffn_dim"]
    pos = torch.arange(S, device=x.device)
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    h = x
    for l in range(cfg["n_layers"]):
        w = layer(l)
        qkv = rms(h, w["ln1"], eps) @ w["wqkv"]
        q = qkv[..., : nq * hd].reshape(B, S, nq, hd)
        k = qkv[..., nq * hd: (nq + nk) * hd].reshape(B, S, nk, hd)
        v = qkv[..., (nq + nk) * hd:].reshape(B, S, nk, hd)
        q = rope(rms(q, w["q_norm"], eps), pos, cfg["mrope_sections"],
                 cfg["rope_theta"])
        k = rope(rms(k, w["k_norm"], eps), pos, cfg["mrope_sections"],
                 cfg["rope_theta"])
        k = k.repeat_interleave(nq // nk, dim=2)
        v = v.repeat_interleave(nq // nk, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        s = s.masked_fill(~mask, float("-inf"))
        a = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
        h = h + a.reshape(B, S, nq * hd) @ w["wo"]
        gu = rms(h, w["ln2"], eps) @ w["w_gu"]
        h = h + (F.silu(gu[..., :F_]) * gu[..., F_:]) @ w["w_down"]
    return rms(h, final_norm, eps)


def layer_fn(tree: dict, kind: str):
    """Layer l's f32 weights from a master decoder tree, each product's
    weight quantised and dequantised as `kind` says ("dense", "int8",
    "int4"): made one layer at a time."""
    def get(l):
        lw = tree["layers"]
        out = {}
        for name in ("ln1", "q_norm", "k_norm", "ln2"):
            out[name] = lw[name][l].float()
        for name in ("wqkv", "wo", "w_gu", "w_down"):
            out[name] = quant.weight(lw[name][l], kind, layer=True)
        return out
    return get


def head_weight(tree: dict, kind: str) -> torch.Tensor:
    return quant.weight(tree["head"], kind, layer=False)


# ------------------------------------------------------------------ prompt
def text_rows(tables, ids) -> torch.Tensor:
    ids = torch.as_tensor(ids, dtype=torch.long,
                          device=tables["text_table"].device)
    return tables["text_table"][ids].float()


def codec_row(tables, q: int, code: int) -> torch.Tensor:
    ct = tables["codec_tables"]
    if code < 0:
        code = 0
    if code >= ct.shape[1]:
        return torch.zeros(ct.shape[2], device=ct.device)
    return ct[q, code].float()


def prompt(tables, text_ids, spk_emb: torch.Tensor,
           lang_id: int) -> torch.Tensor:
    """The preset-speaker prompt [P, dim] (the reference's `build_core`
    with a speaker embedding): role block, control block, speaker, task
    text, activation; every codec row carries the tts_pad marker."""
    marker = text_rows(tables, [TEXT_AUDIO_MARKER])[0]
    rows = [text_rows(tables, [IM_START, ROLE_ASSISTANT, NEWLINE])]
    rows.append(torch.stack([marker + codec_row(tables, 0, c)
                             for c in (THINK, THINK_BOS, lang_id,
                                       THINK_EOS)]))
    dim = marker.shape[0]
    emb = torch.zeros(dim, device=marker.device)
    n = min(dim, spk_emb.numel())
    emb[:n] = spk_emb.reshape(-1)[:n].float()
    rows.append((marker + emb)[None])
    task = [BOS_TOKEN, *text_ids, EOS_TOKEN]
    rows.append(text_rows(tables, task) + codec_row(tables, 0, PAD)[None])
    rows.append((marker + codec_row(tables, 0, BOS))[None])
    return torch.cat(rows, dim=0)


def frame_sum(tables, codes: torch.Tensor) -> torch.Tensor:
    """Sum over q of codec row q of each frame's code q: [F, 16] -> [F, dim]."""
    ct = tables["codec_tables"]
    c = codes.long().clamp_min(0)
    ok = c < ct.shape[1]
    rows = ct[torch.arange(NUM_CODEBOOKS, device=ct.device)[None],
              c.clamp_max(ct.shape[1] - 1)].float()
    return torch.where(ok[..., None], rows, 0.0).sum(dim=1)


def project(tables, x: torch.Tensor) -> torch.Tensor:
    return x @ tables["proj_weight"].float().T + tables["proj_bias"].float()


# -------------------------------------------------------- talker, predictor
def talker(master: dict, cfg: dict, kind: str, prompt_rows: torch.Tensor,
           codes: torch.Tensor):
    """Teacher-forced talker over the prompt and the served frames' feedback
    (each frame's codebook sum plus tts_pad, fed at the next position).
    Returns (code_0 logits [F, 2160], hidden [F, H]) of frames 0..F-1."""
    tables = master["assets"]
    H = cfg["hidden"]
    n = codes.shape[0]
    fb = frame_sum(tables, codes[: n - 1]) \
        + text_rows(tables, [TEXT_AUDIO_MARKER])[0]
    x = torch.cat([prompt_rows, fb], dim=0)[:, :H]
    h = decoder(layer_fn(master["talker"], kind), cfg,
                master["talker"]["final_norm"].float(), x[None])[0]
    h = h[prompt_rows.shape[0] - 1:]
    logits = h @ head_weight(master["talker"], kind)[:, :SAMPLE_LIMIT]
    return logits, h


def predictor(master: dict, cfg: dict, kind: str, h1024: torch.Tensor,
              codes: torch.Tensor) -> torch.Tensor:
    """Teacher-forced predictor over every frame: position 0 the projected
    talker hidden, position q the projected codec row q - 1 of the served
    code q - 1; codebook q's logits are head slice q - 1 at position q.
    Returns [F, 15, 2048]."""
    tables = master["assets"]
    tree = master["predictor"]
    ct = tables["codec_tables"]
    c = codes[:, :-1].long().clamp_min(0)                          # [F, 15]
    q_idx = torch.arange(NUM_CODEBOOKS - 1, device=ct.device)[None]
    rows = torch.where((c < ct.shape[1])[..., None],
                       ct[q_idx, c.clamp_max(ct.shape[1] - 1)].float(), 0.0)
    x = torch.cat([h1024[:, None], project(tables, rows)], dim=1)  # [F,16,.]
    h = decoder(layer_fn(tree, kind), cfg, tree["final_norm"].float(), x)
    head = head_weight(tree, kind)
    return torch.stack([h[:, q] @ head[:, (q - 1) * CODE_VOCAB:
                                       q * CODE_VOCAB]
                        for q in range(1, NUM_CODEBOOKS)], dim=1)


# ------------------------------------------------------------------ vocoder
def gelu(x):
    return F.gelu(x, approximate="tanh")


def vocoder(vw: dict, vcfg: dict, codes: torch.Tensor) -> torch.Tensor:
    """One-shot vocoding of all frames [F, 16] -> waveform [F * 2000]: the
    stream's samples once its last frame has been flushed."""
    n = codes.shape[0]
    la = vcfg["lookahead"]
    c = codes.long().clamp(0, vcfg["code_vocab"] - 1)
    x = vw["embed"][torch.arange(NUM_CODEBOOKS, device=c.device)[None], c]
    x = x.float().sum(dim=1).T[None]                              # [1,E,F]

    def causal(x, p, k):
        return gelu(F.conv1d(F.pad(x, (k - 1, 0)), p["w"], p["b"]))

    y = causal(x, vw["pre_conv"], vcfg["pre_conv_kernel"])        # [1,H,F]
    tcfg = dict(hidden=vcfg["hidden"], n_layers=vcfg["n_layers"],
                n_q_heads=vcfg["n_heads"], n_kv_heads=vcfg["n_heads"],
                head_dim=vcfg["head_dim"], ffn_dim=vcfg["ffn_dim"],
                rms_eps=vcfg["rms_eps"], rope_theta=1_000_000.0,
                mrope_sections=(vcfg["head_dim"] // 2, 0, 0, 0))
    tw = vw["transformer"]

    def layer(l):
        return {k: v[l].float() for k, v in tw["layers"].items()}

    lat = decoder(layer, tcfg, tw["final_norm"].float(),
                  y.transpose(1, 2))[0]                            # [F, H]
    # the centred conv sees la frames either side, zeros past both ends
    a = gelu(F.conv1d(F.pad(lat.T[None], (la, la)), vw["post_a"]["w"],
                      vw["post_a"]["b"]))
    b = causal(a, vw["post_b"], vcfg["post_conv_kernel"])[0].T    # [F, H]
    z = b
    stages = vw["up"]
    for i, (st, s) in enumerate(zip(stages, vcfg["upsample_factors"])):
        z = z @ st["w"] + st["b"]
        z = z.reshape(z.shape[0] * s, -1)
        z = torch.tanh(z) if i == len(stages) - 1 else gelu(z)
    return z[:, 0][: n * FRAME_SAMPLES]
