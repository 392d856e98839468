"""Tokenizer pipeline.

Analog of the reference's text/tokenization/{tokenizer,tokenizerfactory}
(deeplearning4j-nlp, SURVEY §2.7): a TokenizerFactory produces a Tokenizer
per sentence; an optional TokenPreProcess normalises each token.
"""

from __future__ import annotations

import re
from typing import Iterator, List, Optional


class TokenPreProcess:
    """Token normaliser SPI (reference: tokenization/tokenizer/
    TokenPreProcess.java)."""

    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/digits (reference:
    tokenizer/preprocessor/CommonPreprocessor.java)."""

    _PUNCT = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token).lower()


class LowCasePreProcessor(TokenPreProcess):
    def pre_process(self, token: str) -> str:
        return token.lower()


class EndingPreProcessor(TokenPreProcess):
    """Crude stemmer dropping common English endings (reference:
    tokenizer/preprocessor/EndingPreProcessor.java)."""

    def pre_process(self, token: str) -> str:
        for ending in ("sses", "ies", "ing", "ed", "s"):
            if token.endswith(ending) and len(token) > len(ending) + 2:
                if ending == "sses":
                    return token[:-2]
                if ending == "ies":
                    return token[:-3] + "y"
                return token[: -len(ending)]
        return token


class Tokenizer:
    """One sentence's token stream (reference: tokenizer/Tokenizer.java)."""

    def __init__(self, tokens: List[str],
                 preprocessor: Optional[TokenPreProcess] = None):
        self._tokens = tokens
        self._pre = preprocessor
        self._idx = 0

    def has_more_tokens(self) -> bool:
        return self._idx < len(self._tokens)

    def count_tokens(self) -> int:
        return len(self._tokens)

    def next_token(self) -> str:
        tok = self._tokens[self._idx]
        self._idx += 1
        return self._pre.pre_process(tok) if self._pre else tok

    def get_tokens(self) -> List[str]:
        out = []
        while self.has_more_tokens():
            tok = self.next_token()
            if tok:
                out.append(tok)
        return out

    def __iter__(self) -> Iterator[str]:
        return iter(self.get_tokens())


class TokenizerFactory:
    """Factory SPI (reference: tokenizerfactory/TokenizerFactory.java)."""

    def __init__(self):
        self._pre: Optional[TokenPreProcess] = None

    def set_token_pre_processor(self, pre: TokenPreProcess):
        self._pre = pre
        return self

    def create(self, sentence: str) -> Tokenizer:
        raise NotImplementedError


class DefaultTokenizerFactory(TokenizerFactory):
    """Whitespace tokenizer (reference: tokenizerfactory/
    DefaultTokenizerFactory.java wraps DefaultTokenizer, a
    StringTokenizer on whitespace)."""

    def create(self, sentence: str) -> Tokenizer:
        return Tokenizer(sentence.split(), self._pre)


class NGramTokenizerFactory(TokenizerFactory):
    """Word n-grams over a base tokenizer (reference: tokenizerfactory/
    NGramTokenizerFactory.java)."""

    def __init__(self, base: Optional[TokenizerFactory] = None,
                 min_n: int = 1, max_n: int = 2):
        super().__init__()
        self._base = base or DefaultTokenizerFactory()
        self.min_n = min_n
        self.max_n = max_n

    def create(self, sentence: str) -> Tokenizer:
        words = self._base.create(sentence).get_tokens()
        grams: List[str] = []
        for n in range(self.min_n, self.max_n + 1):
            for i in range(len(words) - n + 1):
                grams.append(" ".join(words[i:i + n]))
        return Tokenizer(grams, self._pre)


# reference: deeplearning4j-nlp/src/main/resources/stopwords (vendored list);
# a compact English subset serves the same role for vocab filtering.
DEFAULT_STOP_WORDS = frozenset(
    """a an and are as at be but by for if in into is it no not of on or such
    that the their then there these they this to was will with""".split())
