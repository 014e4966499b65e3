"""f32 that means f32 on the card: TF32 off around the f32 modules.

cuDNN's convolutions run f32 inputs at TF32 by default
(`torch.backends.cudnn.allow_tf32` is True), and a user may have set
`torch.set_float32_matmul_precision("high")` for cuBLAS. The vocoder's
convolutions and upsampler and the audio encoders are f32 modules (their
configs' `dtype`, as in the JAX package): at TF32 their outputs move by
~1e-3, RVQ argmaxes can flip and chunked decoding stops matching one-shot
decoding. `f32_exact(device)` turns both TF32 switches off for the calls it
wraps and restores them after.

The switches are process-global, and the vocoder runs on a worker thread
(`parallel/pipeline.py`) while generation runs on another, so the scope is
counted under a lock: the first entry saves and clears the switches, the
last exit restores them. On the CPU it does nothing.

Because they are process-global, the switches change for every thread
while any scope is open, not only for the wrapped calls: a caller's own
f32 matmuls on another thread run at "highest" instead of a "high" it set,
and a value it sets while a scope is open is overwritten by the one saved
at the first entry. With torch's defaults nothing else changes. So the
scope stays as narrow as it is: the vocoder's `decode` and `flush`,
mel and the encoders; no other module uses it.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_lock = threading.Lock()
_depth = 0
_saved = None


@contextlib.contextmanager
def f32_exact(device):
    """TF32 off (cuBLAS and cuDNN) for f32 work on a CUDA `device`."""
    global _depth, _saved
    if torch.device(device).type != "cuda":
        yield
        return
    with _lock:
        if _depth == 0:
            _saved = (torch.get_float32_matmul_precision(),
                      torch.backends.cudnn.allow_tf32)
            torch.set_float32_matmul_precision("highest")
            torch.backends.cudnn.allow_tf32 = False
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                torch.set_float32_matmul_precision(_saved[0])
                torch.backends.cudnn.allow_tf32 = _saved[1]
