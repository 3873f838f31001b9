"""Byte-level toy tokenizer (quickstart / smoke prompts); the port's own
copy of ``repro.data.tokenizer``."""
from __future__ import annotations

from typing import List

import numpy as np


class ByteTokenizer:
    """Bytes + BOS/EOS; vocab 258.  Enough for runnable examples."""
    BOS = 256
    EOS = 257
    vocab_size = 258

    def encode(self, text: str, bos: bool = True) -> np.ndarray:
        ids = list(text.encode("utf-8"))
        if bos:
            ids = [self.BOS] + ids
        return np.array(ids, np.int32)

    def decode(self, ids) -> str:
        bs = bytes(int(i) for i in ids if int(i) < 256)
        return bs.decode("utf-8", errors="replace")

    def encode_batch(self, texts: List[str], pad_to: int = 0) -> np.ndarray:
        enc = [self.encode(t) for t in texts]
        n = pad_to or max(len(e) for e in enc)
        out = np.zeros((len(enc), n), np.int32)
        for i, e in enumerate(enc):
            out[i, -len(e):] = e[:n]          # left-pad (decode-friendly)
        return out
