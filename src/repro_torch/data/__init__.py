from repro_torch.data.corpus import ByteTokenizer, build_corpus, corpus_tokens
from repro_torch.data.pipeline import Batches

__all__ = ["ByteTokenizer", "build_corpus", "corpus_tokens", "Batches"]
