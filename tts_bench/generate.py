"""The one traffic generator: requests from a traffic file's parameters and
the seed.

Every block of `block` requests holds the same sizes: text lengths evenly
spaced over `text_bytes` and frame budgets evenly spaced over `frames`,
paired and ordered by the seed. So every seed sends the same sizes in
another order, and only the words, the voices and the sampled tokens
differ. Texts are ASCII words drawn from WORDS, cut to the exact byte
length; voices cycle through the traffic's preset speakers in an order
drawn from the seed. Every request is sampled with the traffic's
`sampler` (temperature, top_k, top_p) and carries its own sampler seed.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Iterator, List, Optional

import numpy as np

WORDS = (
    "the of and to in is was for that with on as by at from his her they "
    "this which are have not but had one all were she when there an been "
    "their more would will other into time about what some could then "
    "them these two first than only way made over new after also did many "
    "before must through back years where much your down should because "
    "each just those people how too little state good very make world "
    "still own see men work long here between both life being under never "
    "day same another know while last might great old year off come since "
    "against go came right used take three small morning river window "
    "garden letter station music quiet bright evening summer market paper "
    "number question answer story voice travel open close light water"
).split()


@dataclasses.dataclass
class Request:
    index: int
    text: str
    voice: str
    frames: int                  # frame budget
    sampler_seed: int
    row: int = 0                 # the device batch row that served it
    t_send: float = float("nan")
    chunk_t: List[float] = dataclasses.field(default_factory=list)
    pieces: List[np.ndarray] = dataclasses.field(default_factory=list)
    codes: List[np.ndarray] = dataclasses.field(default_factory=list)
    error: Optional[str] = None

    @property
    def prompt_rows(self) -> int:
        """Rows of the preset-speaker prompt: role 3, control 4, speaker 1,
        BOS + text + EOS, activation 1."""
        return len(self.text.encode()) + 11

    def on_chunk(self, piece: np.ndarray, clock) -> None:
        self.chunk_t.append(clock())
        self.pieces.append(np.asarray(piece, np.float32))

    @property
    def samples(self) -> int:
        return sum(p.size for p in self.pieces)

    def served_codes(self) -> np.ndarray:
        if not self.codes:
            return np.zeros((0, 16), np.int32)
        return np.concatenate(self.codes).astype(np.int32)

    def served_wav(self) -> np.ndarray:
        if not self.pieces:
            return np.zeros(0, np.float32)
        return np.concatenate(self.pieces)


def _spread(lo: int, hi: int, n: int) -> List[int]:
    if n == 1:
        return [lo]
    return [lo + round((hi - lo) * i / (n - 1)) for i in range(n)]


def _text(rng: random.Random, n: int) -> str:
    words = []
    size = 0
    while size < n + 1:
        w = rng.choice(WORDS)
        words.append(w)
        size += len(w) + 1
    s = " ".join(words)[:n]
    return s[:-1] + "." if s.endswith(" ") else s


def requests(traffic: dict, seed: int) -> Iterator[Request]:
    """An endless stream of requests for `traffic` (a traffic/*.json)."""
    rng = random.Random(f"tts_bench:{seed}")
    block = traffic["block"]
    lengths = _spread(*traffic["text_bytes"], block)
    budgets = _spread(*traffic["frames"], block)
    voices = list(traffic["voices"])
    i = 0
    while True:
        rng.shuffle(lengths)
        rng.shuffle(budgets)
        order = voices[:]
        rng.shuffle(order)
        for k in range(block):
            yield Request(index=i, text=_text(rng, lengths[k]),
                          voice=order[k % len(order)], frames=budgets[k],
                          sampler_seed=rng.getrandbits(62))
            i += 1
