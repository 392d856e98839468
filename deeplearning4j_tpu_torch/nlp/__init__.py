"""NLP stack: embeddings (Word2Vec/ParagraphVectors/GloVe), text pipeline.

The port of the JAX package's ``nlp/`` (analog of deeplearning4j-nlp-parent,
SURVEY §2.7). The reference's hot loop delegates per-pair updates to
native "aggregate" ops (SkipGram.java:176); here pairs are batched on the
host (``nlp/pairgen.py``, native when built) and applied by PyTorch steps
on the model's device (``nlp/skipgram.py``).
"""

from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    NGramTokenizerFactory,
    CommonPreprocessor,
)
from deeplearning4j_tpu_torch.nlp.sentence_iterators import (
    BasicLineIterator,
    CollectionSentenceIterator,
    FileSentenceIterator,
    LabelledDocument,
    CollectionLabelledDocumentIterator,
)
from deeplearning4j_tpu_torch.nlp.vocab import (
    VocabWord,
    VocabCache,
    VocabConstructor,
    Huffman,
)
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import ParagraphVectors
from deeplearning4j_tpu_torch.nlp.glove import Glove
from deeplearning4j_tpu_torch.nlp import serializer as WordVectorSerializer

__all__ = [
    "DefaultTokenizerFactory", "NGramTokenizerFactory", "CommonPreprocessor",
    "BasicLineIterator", "CollectionSentenceIterator", "FileSentenceIterator",
    "LabelledDocument", "CollectionLabelledDocumentIterator",
    "VocabWord", "VocabCache", "VocabConstructor", "Huffman",
    "Word2Vec", "SequenceVectors", "ParagraphVectors", "Glove",
    "WordVectorSerializer",
]
