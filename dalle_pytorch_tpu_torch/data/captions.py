"""Caption-file parsing and padded text batching.

The port's own copy of ``dalle_pytorch_tpu/data/captions.py`` (the
port imports nothing of the JAX package); encodings are identical.

File contracts (reference trainDALLE.py:92-163, SURVEY.md §5 "data
contract"):

* ``od-captionsonly.txt`` — one caption per line; builds the vocabulary in
  line order (reference trainDALLE.py:96-111).
* ``od-captions.txt`` — lines of ``image_filename : caption``; filenames are
  resolved under ``{data_path}/0/{filename}`` by the image loader
  (reference trainDALLE.py:113-125,185).
* captions are tokenized by splitting on single spaces, '' tokens skipped,
  and padded with PAD=0 to ``text_seq_len`` (reference
  trainDALLE.py:118-122,155-157).

``CaptionDataset`` replaces the reference's ``ImageCaptions`` iterator
(reference trainDALLE.py:135-163): it yields fixed-size ``(paths, int32
token array)`` minibatches, the ragged final batch dropped or wrapped, in
the same order as the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from dalle_pytorch_tpu_torch.data.vocabulary import PAD_TOKEN, Vocabulary


def read_captions_only(path: str) -> List[str]:
    """Lines of the captions-only corpus, newline kept off. The reference
    appends raw lines (with '\\n') to the vocab — split(' ') then treats
    'word\\n' as a distinct token; we strip instead (deliberate fix, flagged:
    strips trailing newlines so 'dog' == 'dog\\n')."""
    with open(path) as f:
        return [line.rstrip("\n") for line in f if line.strip()]


def read_caption_pairs(path: str) -> List[Tuple[str, str]]:
    """``filename : caption`` pairs (reference trainDALLE.py:113-125).
    Splits on the FIRST ':' (filenames with colons are not supported by the
    reference either) and strips surrounding whitespace."""
    pairs = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            fn, _, txt = line.partition(":")
            pairs.append((fn.strip(), txt.strip("\n")))
    return pairs


def encode_pairs(pairs: Sequence[Tuple[str, str]], vocab: Vocabulary,
                 text_seq_len: int) -> List[Tuple[str, List[int]]]:
    """(filename, caption) -> (filename, padded ids). OOV raises KeyError —
    same hard failure as the reference (Vocabulary.py:43)."""
    return [(fn, vocab.encode(txt, pad_to=text_seq_len)) for fn, txt in pairs]


@dataclasses.dataclass
class CaptionDataset:
    """Deterministic epoch iterator over (paths, padded-token) minibatches.

    Unlike the reference iterator (trainDALLE.py:135-163) every yielded batch
    has exactly ``batch_size`` rows: when ``drop_last`` is False the tail
    batch wraps around to the epoch head so the jit step never sees a new
    batch shape. ``shuffle`` uses a seeded numpy Generator (stateless across
    epochs via ``epoch`` salt) — host-side RNG, never device RNG.
    """

    data: List[Tuple[str, List[int]]]
    batch_size: int = 4
    shuffle: bool = False
    seed: int = 0
    drop_last: bool = False

    def __len__(self) -> int:
        n = len(self.data)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch(self, epoch: int = 0):
        """Yields (list of paths, (batch_size, text_seq_len) int32 array)."""
        order = np.arange(len(self.data))
        if self.shuffle:
            rng = np.random.default_rng((self.seed, epoch))
            rng.shuffle(order)
        n_batches = len(self)
        for b in range(n_batches):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            if len(idx) < self.batch_size:  # wrap the ragged tail
                idx = np.concatenate(
                    [idx, order[:self.batch_size - len(idx)]])
            paths = [self.data[i][0] for i in idx]
            toks = np.asarray([self.data[i][1] for i in idx],
                              dtype=np.int32)
            yield paths, toks

    def __iter__(self):
        return self.epoch(0)


def load_caption_data(captions_only_path: str, caption_pairs_path: str,
                      text_seq_len: int,
                      vocab: Optional[Vocabulary] = None):
    """One-call data setup mirroring trainDALLE's preamble (reference
    trainDALLE.py:92-133): build (or reuse) the vocab from the captions-only
    corpus, then encode the (filename, caption) pairs.

    Returns (vocab, [(filename, padded ids), ...]).
    """
    if vocab is None:
        vocab = Vocabulary.from_captions(
            read_captions_only(captions_only_path))
    pairs = read_caption_pairs(caption_pairs_path)
    return vocab, encode_pairs(pairs, vocab, text_seq_len)


def text_mask(tokens: np.ndarray) -> np.ndarray:
    """Padding mask (True = real token). The reference passes an all-True
    mask in training (trainDALLE.py:192) — callers choose; this gives the
    semantically-correct mask for PAD=0 padded batches."""
    return tokens != PAD_TOKEN
