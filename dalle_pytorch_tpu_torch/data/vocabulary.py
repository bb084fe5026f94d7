"""Word-level vocabulary with reserved PAD/SOS/EOS ids.

The port's own copy of ``dalle_pytorch_tpu/data/vocabulary.py``; its
encodings and JSON files are identical.

Behavior parity with the reference ``Vocabulary`` (reference
Vocabulary.py:3-43): PAD=0, SOS=1, EOS=2 reserved, real words numbered from 3
in first-seen order; ``to_index`` raises ``KeyError`` on out-of-vocabulary
words (the reference's documented hard failure mode, SURVEY.md §5.3).

Additions over the reference (cross-CLI reproducibility): deterministic
round-trip ``save``/``load`` to JSON so the generation CLI can rebuild the
exact training vocab from a file instead of re-reading the caption corpus,
and ``encode``/``decode`` helpers for padded id sequences.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

PAD_TOKEN = 0
SOS_TOKEN = 1
EOS_TOKEN = 2
_RESERVED = {PAD_TOKEN: "PAD", SOS_TOKEN: "SOS", EOS_TOKEN: "EOS"}


class Vocabulary:
    """Maps words <-> integer ids (reference Vocabulary.py:3-43)."""

    def __init__(self, name: str = "captions"):
        self.name = name
        self.word2index: Dict[str, int] = {}
        self.word2count: Dict[str, int] = {}
        self.index2word: Dict[int, str] = dict(_RESERVED)
        self.num_words = 3
        self.num_sentences = 0
        self.longest_sentence = 0

    def add_word(self, word: str) -> None:
        if word not in self.word2index:
            self.word2index[word] = self.num_words
            self.word2count[word] = 1
            self.index2word[self.num_words] = word
            self.num_words += 1
        else:
            self.word2count[word] += 1

    def add_sentence(self, sentence: str) -> None:
        """Split on single spaces, exactly like the reference tokenizer
        (reference trainDALLE.py:107-108, Vocabulary.py:28-37)."""
        words = sentence.split(" ")
        for word in words:
            self.add_word(word)
        if len(words) > self.longest_sentence:
            self.longest_sentence = len(words)
        self.num_sentences += 1

    def to_word(self, index: int) -> str:
        return self.index2word[index]

    def to_index(self, word: str) -> int:
        """KeyError on OOV — reference contract (Vocabulary.py:43)."""
        return self.word2index[word]

    def __len__(self) -> int:
        return self.num_words

    def __contains__(self, word: str) -> bool:
        return word in self.word2index

    # -- id-sequence helpers -------------------------------------------------

    def encode(self, text: str, pad_to: Optional[int] = None,
               skip_empty: bool = True) -> List[int]:
        """Text -> ids; pads with PAD=0 to ``pad_to`` when given.

        ``skip_empty`` drops the '' tokens double spaces produce, as the
        training-script tokenizer loop does (reference trainDALLE.py:118-122).
        OOV raises KeyError like ``to_index``.
        """
        ids = [self.to_index(w) for w in text.split(" ")
               if not (skip_empty and w == "")]
        if pad_to is not None:
            if len(ids) > pad_to:
                raise ValueError(
                    f"caption has {len(ids)} tokens > pad_to={pad_to}")
            ids = ids + [PAD_TOKEN] * (pad_to - len(ids))
        return ids

    def decode(self, ids, strip_pad: bool = True) -> str:
        words = [self.to_word(int(i)) for i in ids
                 if not (strip_pad and int(i) == PAD_TOKEN)]
        return " ".join(words)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        """JSON round-trip; word order (= id order) is preserved because
        word2index insertion order is id order."""
        payload = {
            "name": self.name,
            "words": sorted(self.word2index, key=self.word2index.get),
            "counts": self.word2count,
            "num_sentences": self.num_sentences,
            "longest_sentence": self.longest_sentence,
        }
        with open(path, "w") as f:
            json.dump(payload, f)

    @classmethod
    def load(cls, path: str) -> "Vocabulary":
        with open(path) as f:
            payload = json.load(f)
        vocab = cls(payload["name"])
        for word in payload["words"]:
            vocab.add_word(word)
        vocab.word2count = {k: int(v) for k, v in payload["counts"].items()}
        vocab.num_sentences = int(payload["num_sentences"])
        vocab.longest_sentence = int(payload["longest_sentence"])
        return vocab

    @classmethod
    def from_captions(cls, captions, name: str = "captions") -> "Vocabulary":
        """Build from an iterable of caption strings — the trainDALLE
        vocabulary construction (reference trainDALLE.py:96-111)."""
        vocab = cls(name)
        for caption in captions:
            vocab.add_sentence(caption)
        return vocab
