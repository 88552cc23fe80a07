"""CLIP byte-pair-encoding tokenizer (pure Python).

Port of videovanish_tpu/models/diffueraser/tokenizer.py: the published
algorithm of SD1.5's CLIPTokenizer (Radford et al. 2021,
simple_tokenizer): whitespace collapsed, lowercased, pre-tokenized,
bytes remapped to printable characters, BPE merges with a ``</w>``
end-of-word marker, then ``<|startoftext|>`` / ``<|endoftext|>`` framing
padded to 77 with the EOS id (SD1.5's pad token).

The JAX package pre-tokenizes with the `regex` package's pattern

    <|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d
    |[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+          (case-insensitive)

which the standard library's `re` cannot express (`\\d` misses "²" and
"Ⅻ"; `[^\\W\\d_]` takes them for letters). `pre_tokenize` is a scanner
that takes the same alternatives in the same order, with the letter and
number classes read off `unicodedata.category` (L*, N*), `regex`'s `\\s`
(Python's whitespace less U+001C-U+001F), and its case-insensitive match
of the literals ("ſ" matches "s"). Characters assigned after the Unicode
version of Python's `unicodedata` are outside both classes here.

`null_text_ids` needs no vocab: the empty prompt is special tokens only.
"""
from __future__ import annotations

import functools
import json
import re
import unicodedata

import numpy as np

BOS_ID = 49406   # <|startoftext|> in the published CLIP vocab
EOS_ID = 49407   # <|endoftext|>; SD1.5 also pads with it
MAX_LEN = 77

_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
_NOT_REGEX_SPACE = "\x1c\x1d\x1e\x1f"
_WS_RUN = re.compile(r"[^\S\x1c-\x1f]+")


@functools.lru_cache()
def bytes_to_unicode():
    """GPT-2/CLIP reversible byte -> printable-unicode map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _is_space(ch: str) -> bool:
    return ch.isspace() and ch not in _NOT_REGEX_SPACE


def _cls(ch: str) -> str:
    """"L" (letter), "N" (number), " " (whitespace) or "P" (anything
    else)."""
    cat = unicodedata.category(ch)[0]
    if cat in "LN":
        return cat
    return " " if _is_space(ch) else "P"


def _literal_at(text: str, i: int, lit: str) -> bool:
    """Whether `text` holds `lit` at i, matched as the JAX package's
    case-insensitive pattern matches it on lowercased text."""
    seg = text[i:i + len(lit)]
    return len(seg) == len(lit) and all(
        a == b or (b == "s" and a == "ſ") for a, b in zip(seg, lit))


def pre_tokenize(text: str) -> list:
    """The pattern's matches in `text`, left to right."""
    out, i, n = [], 0, len(text)
    while i < n:
        lit = next((s for s in _SPECIALS + _CONTRACTIONS
                    if _literal_at(text, i, s)), None)
        if lit is not None:
            out.append(text[i:i + len(lit)])
            i += len(lit)
            continue
        cls = _cls(text[i])
        if cls == " ":
            i += 1
            continue
        j = i + 1
        if cls == "L":
            while j < n and _cls(text[j]) == "L":
                j += 1
        elif cls == "P":
            while j < n and _cls(text[j]) == "P":
                j += 1
        out.append(text[i:j])
        i = j
    return out


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class CLIPTokenizer:
    """CLIP BPE tokenizer over a vocab and merges list."""

    def __init__(self, vocab: dict, merges: list):
        self.encoder = dict(vocab)
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.bos_id = self.encoder.get("<|startoftext|>", BOS_ID)
        self.eos_id = self.encoder.get("<|endoftext|>", EOS_ID)
        self.cache = {s: s for s in _SPECIALS}

    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str):
        """From an SD checkpoint's tokenizer/vocab.json and merges.txt."""
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_txt, encoding="utf-8") as f:
            lines = f.read().split("\n")
        # the first line is the "#version" header; blank lines at the end
        merges = [tuple(ln.split()) for ln in lines
                  if ln and not ln.startswith("#version")
                  and len(ln.split()) == 2]
        return cls(vocab, merges)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def tokenize(self, text: str) -> list:
        text = _WS_RUN.sub(" ", text).strip().lower()
        toks = []
        for tok in pre_tokenize(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            toks.extend(self.bpe(tok).split(" "))
        return toks

    def encode(self, text: str) -> list:
        """Token ids without framing or padding."""
        return [self.encoder[t] for t in self.tokenize(text)]

    def __call__(self, text: str, max_length: int = MAX_LEN) -> np.ndarray:
        """SD-style ids: BOS + tokens (truncated) + EOS, padded with EOS
        to max_length. Returns (max_length,) int32."""
        ids = self.encode(text)[: max_length - 2]
        ids = [self.bos_id] + ids + [self.eos_id]
        ids += [self.eos_id] * (max_length - len(ids))
        return np.asarray(ids, np.int32)


def null_text_ids(max_length: int = MAX_LEN,
                  vocab_size: int = EOS_ID + 1) -> np.ndarray:
    """Token ids of the empty prompt "": special tokens only, so no vocab
    files are needed. CLIP vocabs put the specials at the end (BOS = V - 2,
    EOS = V - 1: 49406 and 49407 in the published one), which holds for
    small test vocabs too."""
    return np.asarray([vocab_size - 2] + [vocab_size - 1] * (max_length - 1),
                      np.int32)
