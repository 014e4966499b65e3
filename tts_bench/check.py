"""The comparison that decides `correct`: what the timed window served,
held against the plain float32 reference.

Once the window has closed and the program's state is freed, a sample of
the requests it finished (drawn from the seed: the longest, then one from
each batch row not yet covered) is run through the reference
teacher-forced on the served codes (`reference/model.py`, weights made
again from the seed). Every served token is held to the set that the
reference's sampler could have drawn it from: the predictor's 15 codes of
every frame to the best logit (its sampler is greedy), the talker's
code_0 to the reference's top_k best (the traffic's sampler draws it from
its top_k, then top_p). Through the talker's hidden (the predictor's
input) the codes also hold the prompt, the prefill and every talker step.
Numbers:

  gap_max   the widest gap by which a served token's reference logit lies
            below the least the reference's sampler could have drawn at
            its position (the best for a predictor code, the top_k-th best
            for code_0; 0 where it lies within);
  gap_mean  the mean of those gaps over every token checked;
  wav_err   the largest absolute difference between the served waveform
            and the reference's one-shot vocoding of the served codes,
            over the reference waveform's largest magnitude; 1e30 where
            the served waveform is not one frame's samples a frame;

and `failed`, the requests that raised or delivered no audio (limit 0).
A cell's workload file names the numbers it compares and their limits.

The control (`control=True`, not run by the benchmark's runs) puts the
reference in the program's place one precision below the configuration:
each decoder's weights one rung lower (`reference/quant.py LOWER`), the
vocoder at TF32. It reads the gaps of the tokens the lower precision puts
first at the same positions, held as above, and wav_err of its waveform.
"""

from __future__ import annotations

import json
import math
import os
import random
from typing import Dict, List

import numpy as np
import torch

from .reference import model as ref
from .reference import quant as rq
from .system import SPEAKERS


def sample(requests, n: int, seed: int) -> List:
    """`n` finished requests drawn from the seed: the longest (most frames
    served, the earliest of those), then in a seeded order first one from
    each batch row not yet covered, then any."""
    done = [r for r in requests if r.error is None and r.pieces]
    if not done:
        return []
    picks = [max(done, key=lambda r: (len(r.served_codes()), -r.index))]
    rest = [r for r in done if all(r is not p for p in picks)]
    random.Random(f"tts_bench.check:{seed}").shuffle(rest)
    rows = {p.row for p in picks}
    fresh = []
    for r in rest:
        if r.row not in rows:
            rows.add(r.row)
            fresh.append(r)
    rest = fresh + [r for r in rest if all(r is not f for f in fresh)]
    return picks + rest[: max(0, n - len(picks))]


def speaker_embedding(name: str, device) -> torch.Tensor:
    with open(os.path.join(SPEAKERS, name + ".json"), encoding="utf-8") as f:
        d = json.load(f)
    emb = d.get("speaker_embedding", d.get("spk_emb"))
    return torch.tensor(emb, dtype=torch.float32, device=device)


def _gaps(logits: torch.Tensor, tokens: torch.Tensor,
          k: int = 1) -> torch.Tensor:
    """Each token's reference logit below the k-th best at its position,
    0 where it lies within the k best."""
    chosen = logits.gather(-1, tokens.long()[..., None])[..., 0]
    kth = logits.topk(min(k, logits.shape[-1]), dim=-1).values[..., -1]
    return (kth - chosen).clamp_min(0.0).reshape(-1)


def measure(config: dict, traffic: dict, master: dict, reqs, device,
            control: bool = False) -> Dict[str, float]:
    """gap_max, gap_mean and wav_err over `reqs` (see the module), with
    code_0 held to the top_k of `traffic`'s sampler."""
    stated = dict(config["weights"])
    lower = {k: rq.LOWER[v] for k, v in stated.items()}
    tcfg, pcfg, vcfg = (config["talker"], config["predictor"],
                        config["vocoder"])
    tables = master["assets"]
    sc = traffic["sampler"]      # the program's sampler: top_k <= 0 is all
    top_k = 1 if sc["temperature"] <= 0 else sc["top_k"] if sc["top_k"] > 0 \
        else 1 << 30
    gaps, wav_err = [], 0.0
    with torch.no_grad():
        for r in reqs:
            codes = torch.as_tensor(r.served_codes(), device=device)
            p = ref.prompt(tables, list(r.text.encode()),
                           speaker_embedding(r.voice, device),
                           config["lang_id"])
            with ref.tf32(False):
                l0, h = ref.talker(master, tcfg, stated["talker"], p, codes)
                plog = ref.predictor(master, pcfg, stated["predictor"],
                                     ref.project(tables, h), codes)
                wav_ref = ref.vocoder(master["vocoder"], vcfg, codes)
            wav_ref = wav_ref.cpu().numpy()
            if control:
                with ref.tf32(False):
                    l0c, hc = ref.talker(master, tcfg, lower["talker"], p,
                                         codes)
                    pc = ref.predictor(master, pcfg, lower["predictor"],
                                       ref.project(tables, hc), codes)
                tokens, tokens0 = pc.argmax(-1), l0c.argmax(-1)
                with ref.tf32(True):
                    wav = ref.vocoder(master["vocoder"], vcfg, codes)
                wav = wav.cpu().numpy()
            else:
                tokens, tokens0 = codes[:, 1:], codes[:, 0]
                wav = r.served_wav()
            gaps += [_gaps(plog, tokens), _gaps(l0, tokens0, top_k)]
            if wav.shape != wav_ref.shape:
                err = float("inf")
            else:
                err = float(np.abs(wav - wav_ref).max()
                            / max(float(np.abs(wav_ref).max()), 1e-30))
            wav_err = max(wav_err, err)
    g = torch.cat(gaps) if gaps else torch.zeros(0)
    return {"gap_max": float(g.max()) if g.numel() else 0.0,
            "gap_mean": float(g.mean()) if g.numel() else 0.0,
            "wav_err": wav_err}


def verdict(numbers: Dict[str, float], limits: Dict[str, float],
            failed: int, attempted: int):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, no request failed, at least one attempted."""
    def finite(v):      # a missing or non-finite reading fails as 1e30
        return v if math.isfinite(v) else 1e30

    checks = {k: {"value": finite(numbers[k]), "limit": limits[k]}
              for k in limits}
    checks["failed"] = {"value": failed, "limit": 0}
    ok = attempted > 0 and all(c["value"] <= c["limit"]
                               for c in checks.values())
    return ok, checks
