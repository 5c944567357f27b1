"""Pure-python BERT WordPiece tokenizer (host-side, no torch/tf deps; the
PyTorch port's own copy of uvltrack_tpu/core/tokenizer.py).

Implements the standard BERT uncased tokenization algorithm (basic tokenizer:
unicode cleanup, CJK spacing, lowercasing + accent stripping, punctuation
splitting; then greedy longest-match WordPiece). Replaces the reference's
pytorch_pretrained_bert.BertTokenizer usage (lib/test/tracker/uvltrack.py:40,
lib/train/data/sampler.py:623-660).
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Tuple


def load_vocab(vocab_file: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(vocab_file, encoding="utf-8") as f:
        for idx, line in enumerate(f):
            token = line.rstrip("\n")
            vocab[token] = idx
    return vocab


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class BertTokenizer:
    def __init__(self, vocab_file: str, do_lower_case: bool = True,
                 unk_token: str = "[UNK]", max_chars_per_word: int = 100):
        self.vocab = load_vocab(vocab_file)
        self.do_lower_case = do_lower_case
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word

    # ---------------------------------------------------------------- basic
    def _clean_text(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _tokenize_cjk(self, text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    def _strip_accents(self, text: str) -> str:
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text if unicodedata.category(ch) != "Mn")

    def _split_punct(self, word: str) -> List[str]:
        parts: List[str] = []
        current: List[str] = []
        for ch in word:
            if _is_punctuation(ch):
                if current:
                    parts.append("".join(current))
                    current = []
                parts.append(ch)
            else:
                current.append(ch)
        if current:
            parts.append("".join(current))
        return parts

    def basic_tokenize(self, text: str) -> List[str]:
        text = self._clean_text(text)
        text = self._tokenize_cjk(text)
        tokens: List[str] = []
        for word in text.strip().split():
            if self.do_lower_case:
                word = self._strip_accents(word.lower())
            tokens.extend(self._split_punct(word))
        return [t for t in tokens if t]

    # ------------------------------------------------------------ wordpiece
    def wordpiece_tokenize(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic_tokenize(text):
            out.extend(self.wordpiece_tokenize(word))
        return out

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        unk = self.vocab.get(self.unk_token, 0)
        return [self.vocab.get(t, unk) for t in tokens]

    # --------------------------------------------------------------- helper
    def encode_query(self, text: str, seq_length: int) -> Tuple[List[int], List[int]]:
        """[CLS] tokens... [SEP], zero-padded to seq_length; returns ids, mask.

        Mirrors the reference extract_token_from_nlp
        (lib/test/tracker/uvltrack.py:197-233).
        """
        tokens = self.tokenize(text)
        if len(tokens) > seq_length - 2:
            tokens = tokens[: seq_length - 2]
        tokens = ["[CLS]"] + tokens + ["[SEP]"]
        ids = self.convert_tokens_to_ids(tokens)
        mask = [1] * len(ids)
        while len(ids) < seq_length:
            ids.append(0)
            mask.append(0)
        return ids, mask
