"""Deterministic, restartable, host-sharded data pipeline: the port's own
copy of ``repro.data.pipeline`` (numpy only), so that both packages train
on the same token stream from the same seed.

The pipeline consumes any token source (a synthetic Zipfian LM corpus by
default), packs it into fixed-length sequences, and yields next-token
batches of numpy int32 arrays. Iteration state is a :class:`DataState`
(epoch, cursor, seed); a stream restored from it sees exactly the tokens
it would have seen. Host sharding slices each global batch by
``(host_index, host_count)``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class DataState:
    epoch: int = 0
    cursor: int = 0
    seed: int = 0

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


def synthetic_corpus(vocab: int, n_tokens: int, seed: int = 0) -> np.ndarray:
    """Zipfian token stream with local n-gram structure (so loss can drop)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(vocab, size=n_tokens, p=probs).astype(np.int32)
    # bigram structure: every odd position repeats the one before it + 1
    toks[1::2] = (toks[0::2][: len(toks[1::2])] + 1) % vocab
    return toks


class TokenStream:
    """Packs a flat token array into [batch, seq+1] windows, restartable."""

    def __init__(self, tokens: np.ndarray, seq_len: int, batch: int,
                 state: Optional[DataState] = None):
        self.tokens = tokens
        self.seq_len = seq_len
        self.batch = batch
        self.state = state or DataState()
        self._per_step = batch * (seq_len + 1)
        self._offset = 0
        if len(tokens) < self._per_step:
            reps = -(-self._per_step // len(tokens))
            self.tokens = np.tile(tokens, reps)

    def __iter__(self):
        return self

    def __next__(self):
        n = len(self.tokens)
        if self.state.cursor + self._per_step > n:
            self.state.epoch += 1
            self.state.cursor = 0
            # deterministic per-epoch shift of the window offsets
            rng = np.random.default_rng(self.state.seed + self.state.epoch)
            self._offset = int(rng.integers(0, self.seq_len))
        start = min(self.state.cursor + self._offset, n - self._per_step)
        chunk = self.tokens[start:start + self._per_step]
        self.state.cursor += self._per_step
        arr = chunk.reshape(self.batch, self.seq_len + 1)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}


def make_batch_iterator(vocab: int, seq_len: int, global_batch: int, *,
                        host_index: int = 0, host_count: int = 1,
                        n_tokens: int = 1 << 20, seed: int = 0,
                        state: Optional[DataState] = None,
                        corpus: Optional[np.ndarray] = None) -> TokenStream:
    """Host-sharded iterator: each host gets global_batch / host_count rows."""
    if global_batch % host_count:
        raise ValueError(f"global_batch {global_batch} must divide over "
                         f"{host_count} hosts")
    local_batch = global_batch // host_count
    toks = corpus if corpus is not None else synthetic_corpus(
        vocab, n_tokens, seed)
    # disjoint host shards of the corpus: no sample on two hosts
    shard = len(toks) // host_count
    local = toks[host_index * shard:(host_index + 1) * shard]
    return TokenStream(local, seq_len, local_batch, state=state)
