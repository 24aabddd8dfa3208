"""CLIP's byte-pair-encoding tokenizer (the port's counterpart of the JAX
package's `models/clip_bpe.py`).

Byte-level BPE with `</w>` word terminals, lowercasing and whitespace
collapse, framed as `<|startoftext|> ids <|endoftext|>` and zero-padded to
77. The learned merges (`bpe_simple_vocab_16e6.txt.gz`) are data that the
caller passes; they are not in the repo.

The word pattern is written in the standard library's `re`, not the
`regex` package: `\\p{L}` and `\\p{N}` become character classes built once
from `unicodedata` (categories L* and N*), so the classes are the Unicode
letter and number categories of the interpreter's Unicode database, and
`\\s` becomes the Unicode White_Space set that `regex` uses (`re`'s `\\s`
also takes the separators U+001C-U+001F). Over every code point the two
patterns split alike except (a) code points that the interpreter's Unicode
database leaves unassigned and `regex`'s newer one assigns (9661 under
Python 3.12, whose database is Unicode 15.0), and (b) U+0345, a combining mark whose case
fold is a letter, which `regex` drops and `re` takes as a letter under
IGNORECASE. `ftfy.fix_text` runs only where ftfy is installed; it is the
identity on ASCII text.
"""
from __future__ import annotations

import gzip
import html
import re
import sys
import unicodedata
from functools import lru_cache
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

# the Unicode White_Space property, `regex`'s \s
_WS = "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"
SOT = "<|startoftext|>"
EOT = "<|endoftext|>"


def _category_class(prefix: str) -> str:
    """A character class body (no brackets) of every code point whose
    Unicode general category starts with `prefix`, as \\U ranges."""
    out, start, prev = [], None, None
    for cp in range(sys.maxunicode + 1):
        if unicodedata.category(chr(cp)).startswith(prefix):
            if start is None:
                start = cp
            prev = cp
        elif start is not None:
            out.append(f"\\U{start:08x}" if start == prev
                       else f"\\U{start:08x}-\\U{prev:08x}")
            start = None
    if start is not None:
        out.append(f"\\U{start:08x}-\\U{prev:08x}")
    return "".join(out)


@lru_cache()
def word_pattern() -> "re.Pattern":
    """CLIP's word-splitting pattern: special tokens, common English
    contractions, letter runs, single digits, punctuation runs."""
    letters, numbers = _category_class("L"), _category_class("N")
    return re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        f"|[{letters}]+|[{numbers}]|[^{_WS}{letters}{numbers}]+",
        re.IGNORECASE)


@lru_cache()
def byte_to_unicode() -> Dict[int, str]:
    """GPT-2 style reversible byte -> printable-unicode map (no whitespace or
    control characters among the values, so BPE never merges across real
    spaces)."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    table: Dict[int, str] = {b: chr(b) for b in keep}
    fill = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + fill)
            fill += 1
    return table


def _clean(text: str) -> str:
    try:  # mojibake repair if available; the identity for well-formed text
        import ftfy
        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    return re.sub(f"[{_WS}]+", " ", text).strip().lower()


class ClipBPETokenizer:
    """Byte-level BPE with `</w>` end-of-word markers in CLIP's vocabulary
    layout: 256 byte tokens, 256 `byte</w>` tokens, one token per merge,
    then SOT and EOT (ids 49406 / 49407 with the standard 48894 merges)."""

    def __init__(self, merges: Sequence[Tuple[str, str]]):
        b2u = byte_to_unicode()
        units = list(b2u.values())
        tokens: List[str] = units + [u + "</w>" for u in units]
        tokens += ["".join(pair) for pair in merges]
        tokens += [SOT, EOT]
        self.rank = {pair: i for i, pair in enumerate(merges)}
        self.token_to_id = {tok: i for i, tok in enumerate(tokens)}
        self.id_to_token = tokens
        self._b2u = b2u
        self._cache: Dict[str, List[str]] = {SOT: [SOT], EOT: [EOT]}

    @classmethod
    def from_file(cls, path: str, n_merges: int = 49152 - 256 - 2) -> "ClipBPETokenizer":
        """Load `bpe_simple_vocab_16e6.txt.gz` (or a plain-text merges file
        whose first line is a header)."""
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(line.split()) for line in lines[1:n_merges + 1] if line.strip()]
        return cls(merges)  # type: ignore[arg-type]

    @property
    def vocab_size(self) -> int:
        return len(self.id_to_token)

    @property
    def sot_id(self) -> int:
        return self.token_to_id[SOT]

    @property
    def eot_id(self) -> int:
        return self.token_to_id[EOT]

    def _bpe(self, word: str) -> List[str]:
        """Merge the unicode-mapped characters of one word (the last one
        carries `</w>`) greedily by merge rank."""
        if word in self._cache:
            return self._cache[word]
        parts: List[str] = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            pairs = zip(parts[:-1], parts[1:])
            best = min(pairs, key=lambda p: self.rank.get(p, float("inf")))
            if best not in self.rank:
                break
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if i + 1 < len(parts) and (parts[i], parts[i + 1]) == best:
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._cache[word] = parts
        return parts

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for chunk in word_pattern().findall(_clean(text)):
            mapped = "".join(self._b2u[b] for b in chunk.encode("utf-8"))
            ids.extend(self.token_to_id[t] for t in self._bpe(mapped))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.id_to_token[i] for i in ids)
        u2b = {u: b for b, u in self._b2u.items()}
        raw = bytes(u2b[c] for c in text if c in u2b)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def tokenize(self, texts, context_length: int = 77, truncate: bool = True) -> np.ndarray:
        """(B, context_length) int32 with SOT/EOT framing and zero padding
        (EOT is the largest id, which the text tower's pooling relies on)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot_id] + self.encode(t) + [self.eot_id]
            if len(ids) > context_length:
                if not truncate:
                    raise ValueError(f"'{t}' needs {len(ids)} > {context_length} tokens")
                ids = ids[:context_length - 1] + [self.eot_id]
            out[i, :len(ids)] = ids
        return out

    def vocab_dict(self) -> Dict[str, int]:
        """token -> id."""
        return dict(self.token_to_id)
