"""NLP — the port of ``deeplearning4j_tpu/nlp`` (ref:
deeplearning4j-nlp-parent): tokenization, Word2Vec/SequenceVectors/
ParagraphVectors trained on the card with counter-hash negative sampling,
and the word2vec text serializer."""

from deeplearning4j_tpu_torch.nlp.tokenization import (CommonPreprocessor,
                                                       DefaultTokenizerFactory,
                                                       LowCasePreProcessor,
                                                       NGramTokenizerFactory,
                                                       TokenizerFactory)
from deeplearning4j_tpu_torch.nlp.word2vec import (ParagraphVectors,
                                                   SequenceVectors,
                                                   VocabCache, Word2Vec,
                                                   WordVectorSerializer)

__all__ = ["Word2Vec", "SequenceVectors", "ParagraphVectors", "VocabCache",
           "WordVectorSerializer", "TokenizerFactory",
           "DefaultTokenizerFactory", "NGramTokenizerFactory",
           "CommonPreprocessor", "LowCasePreProcessor"]
