"""Block-sync traffic with one fresh key per signature (Zcash JoinSplit
signatures, each under its transaction's own `joinSplitPubKey`).

A pool of `pool_keys` distinct keys, each with one signed `message_bytes`
digest, is made from the seed.  The pool is read as one stream in its
seeded order, cyclically, so a key recurs only after every other pool key
has been used once.  Batch j takes the `batch_size - matrix_per_batch`
stream entries starting at j times that count, plus `matrix_per_batch`
cases of the ZIP 215 small-order matrix drawn for j.  With the pool size
prime to the entries a batch takes, batch j's keyset is one of `pool_keys`
different ones, so no keyset repeats within a run.  Batches j >= 0 are the
measured window's (the warm-up takes j < 0).  `tampered` of them, placed
among the window's first `tamper_within_calls` calls by
`signer.window_tampering`, have one pool signature's s moved to another
value below l; every other batch is valid, as a synced chain's are.

Parameters (the workload's `traffic` object): pool_keys, batch_size,
matrix_per_batch, tampered, tamper_within_calls, message_bytes,
batches_per_call."""

import random

from portbench.traffic import signer

IDENTITY = (1).to_bytes(32, "little")


class Traffic:
    """Batches as (entries, tampered index or None), entries being
    (A_bytes, sig_bytes, msg) in batch order."""

    def __init__(self, params: dict, seed: int):
        self.pool_keys = int(params["pool_keys"])
        self.batch_size = int(params["batch_size"])
        self.matrix_per_batch = int(params["matrix_per_batch"])
        self.batches_per_call = int(params["batches_per_call"])
        self.per_batch = self.batch_size - self.matrix_per_batch
        self.seed = int(seed)
        rng = random.Random(self.seed)
        keys = signer.KeyRange(rng, self.pool_keys)
        nonces = signer.NonceRange(rng, self.pool_keys)
        nb = int(params["message_bytes"])
        blob = rng.randbytes(nb * self.pool_keys)
        self.pool = []
        for i in range(self.pool_keys):
            msg = blob[nb * i: nb * (i + 1)]
            A = keys.public[i]
            self.pool.append((A, signer.sign_with(
                keys.scalar(i), A, nonces.scalar(i), nonces.public[i], msg),
                msg))
        self.keys = keys
        self._shift = None
        self.matrix = signer.zip215_matrix()
        self.start = rng.randrange(self.pool_keys)
        self.tampered = signer.window_tampering(
            rng, int(params["tampered"]), int(params["tamper_within_calls"]),
            self.batches_per_call)

    def shift128(self, A: bytes) -> bytes:
        """The encoding of [2^128]A for a key of the traffic (the identity
        for the matrix's small-order keys)."""
        if self._shift is None:
            self._shift = dict(zip(self.keys.public,
                                   self.keys.shift128_public()))
        return self._shift.get(A, IDENTITY)

    def unit_key(self, j: int) -> int:
        return j

    def pool_positions(self, j: int) -> range:
        """Stream positions of batch j's pool entries (mod pool_keys)."""
        first = self.start + j * self.per_batch
        return range(first, first + self.per_batch)

    def batch(self, j: int):
        n = self.pool_keys
        entries = [self.pool[t % n] for t in self.pool_positions(j)]
        rng = random.Random(self.seed * 0x9E3779B1 + j)
        entries += [self.matrix[rng.randrange(len(self.matrix))]
                    for _ in range(self.matrix_per_batch)]
        bad = None
        if j in self.tampered:
            bad = signer.tampered_at(entries, self.tampered[j],
                                     self.per_batch, rng)
        return entries, bad

    def call_units(self, call: int) -> list:
        """The batch indices of closed-loop call `call`."""
        k = self.batches_per_call
        return list(range(call * k, (call + 1) * k))
