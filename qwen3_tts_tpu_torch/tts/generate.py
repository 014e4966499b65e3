"""The autoregressive generation loop (talker -> predictor -> feedback).

Port of `qwen3_tts_tpu/tts/generate.py`: the offline path
(`generate_codes`, `generate_audio`) and the streaming pair
(`make_stream_fns`), both over one frame body. Per frame: sample
code_0 from talker logits [0, 2160), stop rows on EOS (code_0 in
{2150, 151673}; the EOS frame is not emitted), project the talker hidden to
1024, expand the frame to 16 codes with the fused predictor, and feed the
sum of the 16 codec rows plus `tts_pad` through one fused talker step.

Deliberate divergences from the JAX package:
  * the device `while_loop` is a host loop over device tensors. The loop
    reads `done` back to the host at most once every DONE_CHECK_EVERY
    frames, not on every frame. Frames run after every row is done only
    step rows that are already done, whose codes are zeroed and not
    counted, so the output is the same as stopping at once;
  * the streaming step is a host loop of `frames_per_call` frame bodies
    (JAX: one jitted scan); the caller reads `active` and `done` back once
    per call;
  * the cache slot is a host int where the rows share it (the offline and
    stream paths: JAX's scalar slot) and a device int32 [B] where each row
    has its own (serving: JAX's [B] slot); `_frame_body` clamps the int
    with `min` and the tensor with `torch.clamp`, so the int paths make no
    host read for it;
  * `make_stream_fns` has no `fused_rows`: that is the TPU kernel's VMEM
    placement of the predictor's int8 weights, which the port does not
    have (see `ops/fused_predictor.py`);
  * there is no Jacobi predictor path yet (ROADMAP queue 1, still to
    port: `predictor.frame_codes` and Jacobi decoding).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..assets.tables import Assets
from ..core import protocol, sampling
from ..models import decoder, talker
from ..ops import fused_predictor

GenState = Dict[str, Any]
DONE_CHECK_EVERY = 4


def _sample_code0(logits, generator, temperature: float, top_k: int,
                  top_p: float) -> torch.Tensor:
    sliced = logits[..., : protocol.TALKER_SAMPLE_LIMIT]
    return sampling.sample(sliced, generator, temperature, top_k, top_p)


def _is_eos(code0: torch.Tensor) -> torch.Tensor:
    eos = torch.zeros_like(code0, dtype=torch.bool)
    for e in protocol.TALKER_EOS_IDS:
        eos |= code0 == e
    return eos


def _feedback_embedding(assets: Assets, codes: torch.Tensor,
                        hidden: int) -> torch.Tensor:
    """Sum of the 16 codec rows + tts_pad, resized to the talker width."""
    fb = assets.frame_embedding_sum(codes) + assets.tts_pad
    dim = fb.shape[-1]
    if dim >= hidden:
        return fb[..., :hidden]
    return torch.nn.functional.pad(fb, (0, hidden - dim))


def predictor_tables(models: Dict[str, Any], pred_cfg):
    """(ptab, real rows): the fused predictor's pre-projected codebook
    tables, built at first use and kept in `models`."""
    if "pred_ptab" not in models:
        models["pred_ptab"], models["pred_rows"] = fused_predictor.make_ptab(
            models["assets"], pred_cfg)
    return models["pred_ptab"], models["pred_rows"]


def _frame_body(models: Dict[str, Any], talker_cfg, pred_cfg, top_k: int,
                state: GenState, ignore_eos: bool = False,
                plain: bool = False
                ) -> Tuple[GenState, torch.Tensor, torch.Tensor]:
    """One frame. Returns (state, frame codes [B, 16], active [B] bool).
    `plain` runs the fused steps' plain versions (the on-card baseline)."""
    code0 = _sample_code0(state["logits"], state["generator"],
                          state["temperature"], top_k, state["top_p"])
    eos = torch.zeros_like(code0, dtype=torch.bool) if ignore_eos \
        else _is_eos(code0)
    # context cap: a frame needs a cache slot for its feedback token
    cache_cap = state["cache"]["k"].shape[3]
    ctx_full = state["slot"] >= cache_cap
    done = state["done"] | eos | ctx_full
    active = ~done

    assets = models["assets"]
    h1024 = assets.project(state["hidden"].float())
    ptab, rows = predictor_tables(models, pred_cfg)
    expand = fused_predictor.frame_codes_fused_plain if plain \
        else fused_predictor.frame_codes_fused
    codes = expand(models["predictor"], pred_cfg, ptab, rows, h1024, code0)
    codes = torch.where(active[:, None], codes, torch.zeros_like(codes))

    fb = _feedback_embedding(assets, codes, talker_cfg.hidden)
    # done rows keep being stepped; their write slot is clamped to the last
    # one, which only ever touches rows that are already done. The slot is
    # a host int (offline, stream) or a device int32 [B] (serving): the
    # int keeps host arithmetic, so neither path reads the device here
    slot = state["slot"]
    if isinstance(slot, torch.Tensor):
        write_slot = torch.clamp(slot, max=cache_cap - 1)
        next_slot = torch.clamp(slot + 1, max=cache_cap)
    else:
        write_slot = min(slot, cache_cap - 1)
        next_slot = min(slot + 1, cache_cap)
    hidden, logits, cache = talker.step(
        models["talker"], talker_cfg, fb.to(getattr(torch, talker_cfg.dtype)),
        write_slot, state["pad_offset"], state["cache"], plain)
    new_state = dict(
        state,
        hidden=hidden,
        logits=logits,
        cache=cache,
        slot=next_slot,
        step=state["step"] + 1,
        done=done,
        n_frames=state["n_frames"] + active.to(torch.int32),
    )
    return new_state, codes, active


def cache_window(talker_cfg, prompt_len: int, max_steps: int) -> int:
    """Talker KV extent for a bounded generation: prompt + frame budget,
    256-aligned, capped at max_seq."""
    need = prompt_len + max_steps + 1
    return min(talker_cfg.max_seq, -(-need // 256) * 256)


def init_state(models: Dict[str, Any], talker_cfg,
               prompt_embeds: torch.Tensor, pad_offset: torch.Tensor,
               generator: torch.Generator | None, temperature: float,
               top_p: float, cache_len: int | None = None) -> GenState:
    """Talker prefill -> the initial generation state."""
    B, S, _ = prompt_embeds.shape
    dev = prompt_embeds.device
    cache = decoder.init_kv_cache(talker_cfg, B, length=cache_len, device=dev)
    hidden, logits, cache = talker.prefill(
        models["talker"], talker_cfg,
        prompt_embeds.to(getattr(torch, talker_cfg.dtype)), pad_offset, cache)
    return dict(
        generator=generator,
        hidden=hidden,
        logits=logits,
        cache=cache,
        slot=S,
        step=0,
        pad_offset=pad_offset.to(torch.int32),
        done=torch.zeros(B, dtype=torch.bool, device=dev),
        n_frames=torch.zeros(B, dtype=torch.int32, device=dev),
        temperature=float(temperature),
        top_p=float(top_p),
    )


def generate_codes(models: Dict[str, Any], talker_cfg, pred_cfg,
                   prompt_embeds: torch.Tensor, pad_offset: torch.Tensor,
                   generator: torch.Generator | None, temperature: float,
                   top_k: int, top_p: float, max_steps: int,
                   ignore_eos: bool = False, step_cap: int | None = None,
                   plain: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Offline generation. Returns (codes [B, max_steps, 16] int32, rows
    zero past each utterance's EOS, and n_frames [B] int32). `step_cap`
    (<= max_steps) stops the loop early. `ignore_eos` (measurement only)
    never stops on EOS, so every run covers `step_cap` frames; `plain`
    (measurement only) runs the plain versions of the kernels."""
    B = prompt_embeds.shape[0]
    cap = min(max_steps if step_cap is None else int(step_cap), max_steps)
    state = init_state(
        models, talker_cfg, prompt_embeds, pad_offset, generator,
        temperature, top_p,
        cache_len=cache_window(talker_cfg, prompt_embeds.shape[1], max_steps))
    codes_buf = torch.zeros(B, max_steps, protocol.NUM_CODEBOOKS,
                            dtype=torch.int32, device=prompt_embeds.device)
    while state["step"] < cap:
        step = state["step"]
        state, codes, _ = _frame_body(models, talker_cfg, pred_cfg, top_k,
                                      state, ignore_eos, plain)
        codes_buf[:, step] = codes
        if state["step"] % DONE_CHECK_EVERY == 0 \
                and bool(state["done"].all()):
            break
    return codes_buf, state["n_frames"]


def make_stream_fns(talker_cfg, pred_cfg, top_k: int,
                    frames_per_call: int = 1, cache_len: int | None = None):
    """(prefill_fn, step_fn) for streaming generation.

    prefill_fn(models, prompt_embeds, pad_offset, generator, temperature,
    top_p) -> state: the talker prefill into a KV cache of `cache_len`
    slots (None: talker_cfg.max_seq, as in JAX).
    step_fn(models, state) -> (state, codes [B, frames_per_call, 16] int32,
    active [B, frames_per_call] bool): `frames_per_call` frames of the
    offline loop's frame body, with its EOS / done / context-cap semantics;
    codes are zero where a row is not active. It reads nothing back to the
    host: the caller checks `active` and `done` once per call."""

    def prefill_fn(models, prompt_embeds, pad_offset, generator,
                   temperature, top_p):
        return init_state(models, talker_cfg, prompt_embeds, pad_offset,
                          generator, temperature, top_p, cache_len=cache_len)

    def step_fn(models, state):
        codes, active = [], []
        for _ in range(frames_per_call):
            state, c, a = _frame_body(models, talker_cfg, pred_cfg, top_k,
                                      state)
            codes.append(c)
            active.append(a)
        return state, torch.stack(codes, dim=1), torch.stack(active, dim=1)

    return prefill_fn, step_fn


def generate_audio(models: Dict[str, Any], voc_params: Dict[str, Any],
                   talker_cfg, pred_cfg, voc_cfg,
                   prompt_embeds: torch.Tensor, pad_offset: torch.Tensor,
                   generator: torch.Generator | None, temperature: float,
                   top_k: int, top_p: float, max_steps: int,
                   ignore_eos: bool = False, step_cap: int | None = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Offline synthesis: generation, then the vocoder's one-shot decode.
    Returns (wav [B, (max_steps + lookahead + ctx_r) * frame_samples] f32,
    with ctx_r the general upsampler's emission delay (0 on the kernel ==
    stride path), and n_frames [B]); callers trim each row to n_frames *
    frame_samples."""
    from ..models import vocoder

    codes, n_frames = generate_codes(
        models, talker_cfg, pred_cfg, prompt_embeds, pad_offset, generator,
        temperature, top_k, top_p, max_steps, ignore_eos, step_cap)
    B = codes.shape[0]
    wav, _, _ = vocoder.decode(
        voc_params, voc_cfg, codes,
        vocoder.init_state(voc_cfg, B, frames=max_steps,
                           device=codes.device), True)
    return wav, n_frames
