"""`linear`: the single matmul entry point of the decoder stacks.

Port of `qwen3_tts_tpu/ops/quant.py::linear`, dense weights only. The int8
`{q, scale}` and int4 `{q4, m8, scale}` layouts, with their Hopper kernel
(the port of `_pallas_qmatmul` and of `panel_matmul4`), are ROADMAP queue 2
item 1 and raise here until then.
"""

from __future__ import annotations

from typing import Dict, Union

import torch

Weight = Union[torch.Tensor, Dict[str, torch.Tensor]]


def require_dense(w: Weight) -> torch.Tensor:
    if isinstance(w, dict):
        raise NotImplementedError(
            "quantized (int8/int4) weights are not ported yet: ROADMAP "
            "queue 2 item 1 (_pallas_qmatmul and panel_matmul4)")
    return w


def linear(x: torch.Tensor, w: Weight) -> torch.Tensor:
    """x [..., in] @ w [in, out] in x.dtype (dense only)."""
    return x @ require_dense(w)
