"""Predictor: per-frame autoregressive codebook expansion.

Port of `qwen3_tts_tpu/models/predictor.py`: the reference's 16 sequential
predictor decodes of a frame (`src/tts/engine.rs:564-611`) through
`models/decoder.forward`, and Jacobi decoding of the same chain.

  * `frame_codes`: the KV clear, the 2-token prefill
    `[proj(talker_hidden), codec_emb_1024(0, code_0)]`, then greedy
    single-token decodes. Codebook q is greedy over the head's column slice
    `[(q-1)*2048, q*2048)` (`src/tts/engine.rs:587-597`; the predictor's
    sampler is greedy, `src/tts/engine.rs:470`).
  * `frame_codes_jacobi`: the same codes from 16-token parallel passes,
    each verifying a prefix of a draft (see its docstring).

The generation loop's default path is `ops/fused_predictor.py` (one
persistent kernel a frame, or the chain); these are the reference's
formulation, which `tts/generate.py` takes for Jacobi decoding and
`tools/validate_release.py` for its quant-agreement check. On CUDA tensors
their products and attention run the port's kernels through the wrappers
`decoder.forward` calls: kernel A (`ops/quant.qmatmul_kernel`) for int8
weights, decode attention (`ops/flash_decode`) in `frame_codes`'s
single-token steps.

Deliberate divergences from the JAX package:
  * `lax.scan` is a Python loop over device tensors. It reads nothing back
    to the host, and it stops after the 15th code: the scan runs one more
    decode whose output is unused (the reference skips it too);
  * Jacobi's `lax.while_loop` is a host loop that reads the rows'
    verified frontier back once a pass: at most 15 reads a frame, on an
    opt-in path. A fixed 15 passes under a device mask would need no read
    but would always cost 15 passes, which defeats the method. The passes
    of the last call are in `frame_codes_jacobi.passes`, their sum since
    it was last set to 0 in `frame_codes_jacobi.passes_total`.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..assets.tables import Assets
from ..core import protocol
from . import decoder


def frame_codes(params: decoder.DecoderParams, cfg, assets: Assets,
                talker_hidden_1024: torch.Tensor,
                code_0: torch.Tensor, tp=None) -> torch.Tensor:
    """Expand code_0 [B] into the full 16-code frame from the projected
    talker hidden [B, 1024] f32. Returns [B, 16] int32. With `tp` (the
    mesh's model group) `params` is this rank's shard: each codebook's
    head slice comes from the rank that holds it (`decoder.head_logits`),
    so every rank of the group draws the same codes."""
    B = code_0.shape[0]
    NB, CV = protocol.NUM_CODEBOOKS, protocol.CODE_VOCAB
    dev = talker_hidden_1024.device
    dt = getattr(torch, cfg.dtype)
    # codebook indices and positions on the device, made once: a Python
    # int handed to a CUDA op would be a copy that waits for the stream
    qs = torch.arange(NB + 1, device=dev)
    pos = qs[None].expand(B, NB + 1)
    code_0 = code_0.to(torch.int32)
    cache = decoder.init_kv_cache(cfg, B, device=dev, tp=tp)

    # prefill: [proj(m_hidden), codec_emb_1024(0, code_0)] at positions 0, 1
    c0_emb = assets.codec_embedding_1024(qs[0], code_0)
    x = torch.stack([talker_hidden_1024, c0_emb], dim=1)       # [B, 2, H]
    h, _, cache = decoder.forward(params, cfg, x.to(dt), pos[:, :2], cache,
                                  qs[0], with_logits=False, tp=tp)
    # only codebook 1's head slice is needed from the prefill
    row_logits = decoder.head_logits(params, h[:, -1], 0, CV,
                                     tp)                        # [B, 2048]

    codes = torch.empty(B, NB, dtype=torch.int32, device=dev)
    codes[:, 0] = code_0
    for q in range(1, NB):
        # greedy over head slice [(q-1)*2048, q*2048), offset removed
        code_q = torch.argmax(row_logits, dim=-1).to(torch.int32)
        codes[:, q] = code_q
        if q == NB - 1:
            break
        # feed codec_emb_1024(q, code_q) at position q + 1
        emb = assets.codec_embedding_1024(qs[q], code_q)
        h, _, cache = decoder.forward(params, cfg, emb[:, None].to(dt),
                                      pos[:, q + 1:q + 2], cache, qs[q + 1],
                                      with_logits=False, tp=tp)
        row_logits = decoder.head_logits(params, h[:, -1], q * CV, CV, tp)
    return codes


def jacobi_pass(params: decoder.DecoderParams, cfg, assets: Assets,
                talker_hidden_1024: torch.Tensor,
                codes: torch.Tensor) -> torch.Tensor:
    """One parallel pass over a draft frame `codes` [B, 16]: the sequence
    [h1024, emb(0, c_0), emb(1, c_1), .., emb(14, c_14)] (emb(15, *) feeds
    nothing that is read) through a fresh 16-slot cache, then codebook q's
    argmax from the hidden at position q, q = 1..15. Returns [B, 15]
    int32. It reads nothing back to the host."""
    B = codes.shape[0]
    NB, CV = protocol.NUM_CODEBOOKS, protocol.CODE_VOCAB
    dev = talker_hidden_1024.device
    q_idx = torch.arange(NB - 1, device=dev)                   # 0..14
    pos = torch.arange(NB, device=dev)[None].expand(B, NB)
    embs = assets.codec_embedding_1024(q_idx[None], codes[:, :NB - 1])
    x = torch.cat([talker_hidden_1024[:, None], embs], dim=1)
    cache = decoder.init_kv_cache(cfg, B, length=NB, device=dev)
    h, _, _ = decoder.forward(params, cfg, x.to(getattr(torch, cfg.dtype)),
                              pos, cache, q_idx[0], with_logits=False)
    return torch.stack([
        torch.argmax(decoder.head_logits(params, h[:, q], (q - 1) * CV, CV),
                     dim=-1)
        for q in range(1, NB)], dim=1).to(torch.int32)


def frame_codes_jacobi(params: decoder.DecoderParams, cfg, assets: Assets,
                       talker_hidden_1024: torch.Tensor,
                       code_0: torch.Tensor,
                       draft: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Jacobi / self-speculative frame expansion: the greedy codes of
    `frame_codes` (exact up to argmax ties), in as few parallel passes as
    the draft [B, 15] allows (None: zeros).

    The AR chain `c_q = argmax(head_q(h(positions <= q)))` is a fixed
    point of the parallel map "forward all 16 positions at once, read every
    codebook's argmax". One pass over [h1024, emb(0, c_0), emb(1, d_1), ...,
    emb(14, d_14)] gives pred_q for q = 1..15; pred_q is the true code for
    every q up to and including the first draft mismatch (its inputs were
    all correct), so each pass verifies a prefix and proposes the next
    draft: at least one new code is fixed a pass, and a perfect draft
    finishes in one 16-token pass. The natural draft in the generation loop
    is the previous frame's codes; the loop keeps the default path unless
    QWEN3_TTS_PRED_JACOBI=1 (`tts/generate.py`).
    """
    B = code_0.shape[0]
    NB = protocol.NUM_CODEBOOKS
    dev = talker_hidden_1024.device
    if draft is None:
        draft = torch.zeros(B, NB - 1, dtype=torch.int32, device=dev)
    codes = torch.cat([code_0.to(torch.int32)[:, None],
                       draft.to(device=dev, dtype=torch.int32)], dim=1)
    qpos = torch.arange(1, NB, device=dev)[None]               # [1, 15]

    # verified[b]: the largest code index known true; only c_0 at the start
    verified = torch.zeros(B, dtype=torch.long, device=dev)
    passes = 0
    while passes < NB - 1:
        preds = jacobi_pass(params, cfg, assets, talker_hidden_1024,
                            codes)
        # pred_q is true for q <= the first mismatch against the draft
        mism = preds != codes[:, 1:]
        first_mism = torch.where(mism, qpos, NB).amin(dim=1)
        # a frontier at the last index means the row is done
        new_verified = torch.maximum(
            verified, torch.where(first_mism >= NB - 1, NB, first_mism))
        # verified codes freeze; the rest take this pass's preds as the
        # next draft
        keep = qpos <= verified[:, None]
        codes = torch.cat([codes[:, :1],
                           torch.where(keep, codes[:, 1:], preds)], dim=1)
        verified = new_verified
        passes += 1
        if bool((verified >= NB).all()):        # the pass's one host read
            break
    frame_codes_jacobi.passes = passes
    frame_codes_jacobi.passes_total += passes
    return codes


frame_codes_jacobi.passes = 0
frame_codes_jacobi.passes_total = 0
