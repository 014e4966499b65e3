"""The master weights of a configuration, made on the device from the seed.

One `torch.Generator` on the device fills one flat buffer per type in a
single call (bfloat16 for the talker's and the predictor's matrices,
float32 for the embedding tables and the vocoder), and every leaf is a
view of it, in the engine's parameter layout: [in, out] matrices stacked
[L, ...] per decoder, RMSNorm weights 1, biases 0, matrices 0.02 times a
standard normal. The benchmark hands the same tree to the program and to
the reference; it imports nothing of the program.

The talker head's EOS column (code 2150, the only end-of-speech id inside
the sampled slice [0, 2160)) is zero: its logit is then 0 while the
sampler keeps the top 40 of 2160 logits spread around 0, so a stream ends
at its frame budget and every seed does the same work.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

EOS = 2150
NUM_CODEBOOKS, CODE_VOCAB = 16, 2048


def _decoder_shapes(c: dict, prefix: str) -> List[Tuple[str, tuple]]:
    L, H, Fd = c["n_layers"], c["hidden"], c["ffn_dim"]
    nq, nk, hd = c["n_q_heads"], c["n_kv_heads"], c["head_dim"]
    return [(f"{prefix}.wqkv", (L, H, (nq + 2 * nk) * hd)),
            (f"{prefix}.wo", (L, nq * hd, H)),
            (f"{prefix}.w_gu", (L, H, 2 * Fd)),
            (f"{prefix}.w_down", (L, Fd, H)),
            (f"{prefix}.head", (H, c["vocab"]))]


def _vocoder_shapes(v: dict) -> List[Tuple[str, tuple]]:
    E, H = v["embed_dim"], v["hidden"]
    la = v["lookahead"]
    chans = [H]
    for _ in v["upsample_factors"][:-1]:
        chans.append(max(32, chans[-1] // 2))
    chans.append(1)
    t = dict(hidden=H, n_layers=v["n_layers"], n_q_heads=v["n_heads"],
             n_kv_heads=v["n_heads"], head_dim=v["head_dim"],
             ffn_dim=v["ffn_dim"], vocab=8)
    out = [("voc.embed", (v["num_codebooks"], v["code_vocab"], E)),
           ("voc.pre_conv", (H, E, v["pre_conv_kernel"])),
           ("voc.post_a", (H, H, 2 * la + 1)),
           ("voc.post_b", (H, H, v["post_conv_kernel"]))]
    out += [(f"voc.up.{i}", (chans[i], s * chans[i + 1]))
            for i, s in enumerate(v["upsample_factors"])]
    return out + _decoder_shapes(t, "voc.t")


def _carve(buf: torch.Tensor, shapes) -> Dict[str, torch.Tensor]:
    out, at = {}, 0
    for name, shape in shapes:
        n = 1
        for s in shape:
            n *= s
        out[name] = buf[at: at + n].view(shape)
        at += n
    return out


def _numel(shapes) -> int:
    total = 0
    for _, shape in shapes:
        n = 1
        for s in shape:
            n *= s
        total += n
    return total


def _decoder(views: Dict[str, torch.Tensor], c: dict, prefix: str,
             dtype, device) -> dict:
    L, H, hd = c["n_layers"], c["hidden"], c["head_dim"]

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return {"layers": {"ln1": ones(L, H),
                       "wqkv": views[f"{prefix}.wqkv"],
                       "q_norm": ones(L, hd), "k_norm": ones(L, hd),
                       "wo": views[f"{prefix}.wo"],
                       "ln2": ones(L, H),
                       "w_gu": views[f"{prefix}.w_gu"],
                       "w_down": views[f"{prefix}.w_down"]},
            "final_norm": ones(H), "head": views[f"{prefix}.head"]}


def make(config: dict, seed: int, device, scale: float = 0.02) -> dict:
    """{"talker", "predictor": decoder trees in the talker's dtype,
    "assets": {text_table, codec_tables, proj_weight, proj_bias} f32,
    "vocoder": the vocoder tree f32} for `config` (a configs/*.json)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    t, p, v, a = (config["talker"], config["predictor"], config["vocoder"],
                  config["assets"])
    dt = getattr(torch, t["dtype"])
    if p["dtype"] != t["dtype"]:
        raise ValueError("talker and predictor must share a dtype")
    low = _decoder_shapes(t, "talker") + _decoder_shapes(p, "predictor")
    dim = a["dim"]
    f32 = [("text_table", (a["text_vocab"], dim)),
           ("codec_tables", (NUM_CODEBOOKS, a["codec_rows"], dim)),
           ("proj_weight", (a["proj_dim"], dim)),
           ("proj_bias", (a["proj_dim"],))] + _vocoder_shapes(v)
    with torch.no_grad():
        lbuf = torch.randn(_numel(low), generator=g, dtype=dt,
                           device=device).mul_(scale)
        fbuf = torch.randn(_numel(f32), generator=g, dtype=torch.float32,
                           device=device).mul_(scale)
        lv, fv = _carve(lbuf, low), _carve(fbuf, f32)
        lv["talker.head"][:, EOS] = 0
    tree = {"talker": _decoder(lv, t, "talker", dt, device),
            "predictor": _decoder(lv, p, "predictor", dt, device),
            "assets": {k: fv[k] for k in ("text_table", "codec_tables",
                                          "proj_weight", "proj_bias")}}

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    H = v["hidden"]
    n_up = len(v["upsample_factors"])
    tcfg = dict(n_layers=v["n_layers"], hidden=H, head_dim=v["head_dim"])
    tree["vocoder"] = {
        "embed": fv["voc.embed"],
        "pre_conv": {"w": fv["voc.pre_conv"], "b": zeros(H)},
        "transformer": _decoder(fv, tcfg, "voc.t", torch.float32, device),
        "post_a": {"w": fv["voc.post_a"], "b": zeros(H)},
        "post_b": {"w": fv["voc.post_b"], "b": zeros(H)},
        "up": [{"w": fv[f"voc.up.{i}"],
                "b": zeros(fv[f"voc.up.{i}"].shape[1])}
               for i in range(n_up)],
    }
    return tree
