"""Prompt assembly. Port of `qwen3_tts_tpu/tts/prompt.py`.

The prompt is a sequence of dim-wide vectors, each the sum of a text-table
row and a codec-table row (or a raw speaker embedding):

  1. optional instruct block  <|im_start|>user\\n ... <|im_end|>\\n
  2. role block               <|im_start|>assistant\\n
  3. control block            marker + codec0[{THINK, THINK_BOS, lang,
                              THINK_EOS}] (or the NOTHINK variant)
  4. speaker                  marker + codec0[spk_id]  |  marker + spk_emb
     clone mid block          (cloning only) reference text, codec BOS,
                              the reference's frames, a PAD terminator
  5. task text                BOS_TOKEN/ids/EOS_TOKEN each + codec0[PAD]
  6. activation               marker + codec0[BOS]
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..assets.tables import Assets
from ..core import protocol as P


@dataclass
class PromptData:
    embeds: torch.Tensor         # [S, dim]
    text_ids: np.ndarray         # task-text token ids
    spk_emb: np.ndarray          # [dim] (zeros when generating by spk_id)


def _text_rows(assets: Assets, ids) -> torch.Tensor:
    return assets.text_embedding(np.asarray(ids, np.int64))


def _codec0_rows(assets: Assets, ids) -> torch.Tensor:
    ids = np.asarray(ids, np.int64)
    return assets.codec_embedding(np.zeros_like(ids), ids)


def build_core(
    assets: Assets,
    text_ids: Sequence[int],
    lang_id: Optional[int] = None,
    spk_id: Optional[int] = None,
    spk_emb: Optional[np.ndarray] = None,
    instruct_ids: Optional[Sequence[int]] = None,
    mid_embeds: Optional[torch.Tensor] = None,
) -> PromptData:
    dim = assets.text_table.shape[1]
    parts = []
    if instruct_ids is not None:
        ins = [P.IM_START, P.ROLE_USER, P.NEWLINE, *instruct_ids,
               P.IM_END, P.NEWLINE]
        parts.append(_text_rows(assets, ins))
    parts.append(_text_rows(assets, [P.IM_START, P.ROLE_ASSISTANT, P.NEWLINE]))

    marker = assets.text_embedding(P.TEXT_AUDIO_MARKER)
    if lang_id is not None:
        ctrl = [P.THINK, P.THINK_BOS, lang_id, P.THINK_EOS]
    else:
        ctrl = [P.NOTHINK, P.THINK_BOS, P.THINK_EOS]
    parts.append(marker[None] + _codec0_rows(assets, ctrl))

    if spk_id is not None:
        parts.append(marker[None] + _codec0_rows(assets, [spk_id]))
    elif spk_emb is not None:
        emb = torch.as_tensor(np.asarray(spk_emb, np.float32),
                              device=assets.device)
        parts.append(marker[None] + emb[None])
    if mid_embeds is not None:
        parts.append(mid_embeds)

    pad0 = assets.codec_embedding(0, P.PAD)
    task = [P.BOS_TOKEN, *text_ids, P.EOS_TOKEN]
    parts.append(_text_rows(assets, task) + pad0[None])
    parts.append((marker + _codec0_rows(assets, [P.BOS])[0])[None])

    return PromptData(
        embeds=torch.cat(parts, dim=0),
        text_ids=np.asarray(list(text_ids), np.int32),
        spk_emb=(np.asarray(spk_emb, np.float32) if spk_emb is not None
                 else np.zeros((dim,), np.float32)),
    )


def build_clone_mid_block(
    assets: Assets,
    ref_codes: np.ndarray,           # [n_frames, 16] (or flat multiple of 16)
    ref_text_ids: Sequence[int],
) -> torch.Tensor:
    """The clone prompt's identity block (src/tts/prompt.rs:28-106): the
    reference text (BOS/ids/EOS each + codec0[PAD]), then codec BOS, the
    sum of each reference frame's 16 code rows and a PAD terminator, every
    audio row with the marker added."""
    marker = assets.text_embedding(P.TEXT_AUDIO_MARKER)
    pad0 = assets.codec_embedding(0, P.PAD)
    ref_codes = np.asarray(ref_codes, np.int64).reshape(-1, P.NUM_CODEBOOKS)

    ids = [P.BOS_TOKEN, *ref_text_ids, P.EOS_TOKEN]
    text_part = _text_rows(assets, ids) + pad0[None]
    codec_bos = (marker + assets.codec_embedding(0, P.CODEC_BOS))[None]
    frames = marker[None] + assets.frame_embedding_sum(
        torch.as_tensor(ref_codes, device=assets.device))
    terminator = (marker + pad0)[None]
    return torch.cat([text_part, codec_bos, frames, terminator], dim=0)


def build_clone_prompt(
    assets: Assets,
    text_ids: Sequence[int],
    ref_codes: np.ndarray,
    ref_text_ids: Sequence[int],
    spk_emb: np.ndarray,
    lang_id: Optional[int] = P.DEFAULT_LANG_ID,
    instruct_ids: Optional[Sequence[int]] = None,
) -> PromptData:
    """Reference `build_clone_prompt` (src/tts/prompt.rs:28-118): the core
    prompt with the speaker embedding and the clone mid block."""
    mid = build_clone_mid_block(assets, ref_codes, ref_text_ids)
    return build_core(assets, text_ids, lang_id=lang_id, spk_emb=spk_emb,
                      instruct_ids=instruct_ids, mid_embeds=mid)


def build_custom_prompt(
    assets: Assets,
    text_ids: Sequence[int],
    spk_id: int,
    lang_id: Optional[int] = P.DEFAULT_LANG_ID,
    instruct_ids: Optional[Sequence[int]] = None,
) -> PromptData:
    """A preset speaker by its codec id instead of an embedding."""
    return build_core(assets, text_ids, lang_id=lang_id, spk_id=spk_id,
                      instruct_ids=instruct_ids)


PROMPT_BUCKET = 64


def pad_batch(prompts: Sequence[torch.Tensor], bucket: int = PROMPT_BUCKET,
              cap: int | None = None):
    """LEFT-pad [S_i, dim] prompts to one [B, S_max, dim] f32 batch plus the
    pad offsets [B] int32, on the prompts' device. S_max rounds up to a
    multiple of `bucket`; `cap` bounds it from above but never below the
    longest prompt."""
    s_raw = max(int(p.shape[0]) for p in prompts)
    s_max = -(-s_raw // bucket) * bucket if bucket > 1 else s_raw
    if cap is not None:
        s_max = max(s_raw, min(s_max, cap))
    dev = prompts[0].device
    dim = int(prompts[0].shape[1])
    out = torch.zeros(len(prompts), s_max, dim, dtype=torch.float32,
                      device=dev)
    offs = []
    for i, p in enumerate(prompts):
        s = int(p.shape[0])
        out[i, s_max - s:] = p.float()
        offs.append(s_max - s)
    return out, torch.tensor(offs, dtype=torch.int32, device=dev)
