"""The stub decode step of JAX's SLO tests (tests/test_serve_slo.py:25),
for the port's engine and replica tests: next token = (last token + 1)
% vocab, no model. Deterministic like the real step, so requeue-replay
still reproduces."""

import numpy as np


class StubStep:
    def __init__(self, buckets=(8, 16), vocab=64):
        self.buckets = tuple(buckets)
        self.vocab = vocab
        self.prefill = {b: self._prefill for b in self.buckets}

    def pick_bucket(self, plen):
        for b in self.buckets:
            if plen <= b:
                return b
        raise ValueError(f"prompt of {plen} exceeds buckets {self.buckets}")

    def _prefill(self, params, k, v, toks, dest, last):
        toks = np.asarray(toks)
        logits = np.zeros((self.vocab,), np.float32)
        logits[(int(toks[0, int(last)]) + 1) % self.vocab] = 1.0
        return logits, k, v

    def decode(self, params, k, v, tokens, lengths, tables):
        tokens = np.asarray(tokens)
        logits = np.zeros((tokens.shape[0], self.vocab), np.float32)
        for i in range(tokens.shape[0]):
            logits[i, (int(tokens[i, 0]) + 1) % self.vocab] = 1.0
        return logits, k, v
