from .pipeline import DataState, TokenStream, make_batch_iterator, synthetic_corpus

__all__ = ["DataState", "TokenStream", "make_batch_iterator",
           "synthetic_corpus"]
