"""Tokenization — the port's copy of ``deeplearning4j_tpu/nlp/
tokenization.py`` (ref: ``deeplearning4j-nlp`` tokenization package:
``TokenizerFactory``/``Tokenizer`` + ``TokenPreProcess``). Host-side text
processing; the device never sees strings."""

from __future__ import annotations

import re
from typing import List, Optional


class TokenPreProcess:
    """ref: org.deeplearning4j.text.tokenization.tokenizer.TokenPreProcess."""

    def preProcess(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/digits (ref: CommonPreprocessor)."""

    _PUNCT = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def preProcess(self, token: str) -> str:
        return self._PUNCT.sub("", token.lower())


class LowCasePreProcessor(TokenPreProcess):
    def preProcess(self, token: str) -> str:
        return token.lower()


class Tokenizer:
    """ref: tokenizer.Tokenizer — iterator over one sentence's tokens."""

    def __init__(self, tokens: List[str], pre: Optional[TokenPreProcess]):
        self._tokens = tokens
        self._pre = pre
        self._pos = 0

    def countTokens(self) -> int:
        return len(self._tokens)

    def hasMoreTokens(self) -> bool:
        return self._pos < len(self._tokens)

    def nextToken(self) -> str:
        t = self._tokens[self._pos]
        self._pos += 1
        return self._pre.preProcess(t) if self._pre else t

    def getTokens(self) -> List[str]:
        out = []
        while self.hasMoreTokens():
            t = self.nextToken()
            if t:
                out.append(t)
        return out


class TokenizerFactory:
    def create(self, sentence: str) -> Tokenizer:
        raise NotImplementedError

    def setTokenPreProcessor(self, pre: TokenPreProcess):
        self._pre = pre


class DefaultTokenizerFactory(TokenizerFactory):
    """Whitespace/word-boundary tokenizer (ref: DefaultTokenizerFactory)."""

    def __init__(self):
        self._pre: Optional[TokenPreProcess] = None

    def create(self, sentence: str) -> Tokenizer:
        return Tokenizer(sentence.split(), self._pre)


class NGramTokenizerFactory(TokenizerFactory):
    """Word n-grams (ref: NGramTokenizerFactory)."""

    def __init__(self, n: int = 2):
        self.n = n
        self._pre: Optional[TokenPreProcess] = None

    def create(self, sentence: str) -> Tokenizer:
        words = sentence.split()
        grams = [" ".join(words[i:i + self.n])
                 for i in range(len(words) - self.n + 1)]
        return Tokenizer(grams, self._pre)
