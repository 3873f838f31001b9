from .synthetic import (SyntheticConfig, batch_iterator, markov_tokens,
                        pack_documents)
from .tokenizer import ByteTokenizer

__all__ = ["SyntheticConfig", "batch_iterator", "markov_tokens",
           "pack_documents", "ByteTokenizer"]
