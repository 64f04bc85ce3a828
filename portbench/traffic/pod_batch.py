"""Pod-batch traffic: each unit is one batch of `batch_size` signatures by
one validator set of `signers` keys, signature i by signer i mod
`signers`, each over a message of its own (`message_bytes` bytes, a
transaction digest).

A pool of `pool_batches` batches is signed from the seed, every one valid,
and unit q replays pool batch q mod `pool_batches`.  A call holds one unit,
so call c is unit c; units q >= 0 are the measured window's (the warm-up
takes q < 0).  `tampered` of them, placed among the window's first
`tamper_within_calls` calls by `signer.window_tampering`, carry their pool
batch with one signature's s moved to another value below l, in the half
of the batch that window_tampering names: units of their own, which the
replay never repeats.

Parameters (the configuration's sizes and the workload's `traffic`
object): batch_size, signers, message_bytes, pool_batches, tampered,
tamper_within_calls."""

import random

from portbench.traffic import signer


class Traffic:
    """Batches as (entries, tampered index or None), entries being
    (A_bytes, sig_bytes, msg) in batch order."""

    def __init__(self, params: dict, seed: int):
        self.batch_size = int(params["batch_size"])
        self.signers = int(params["signers"])
        self.pool_batches = int(params["pool_batches"])
        self.seed = int(seed)
        rng = random.Random(self.seed)
        keys = signer.KeyRange(rng, self.signers)
        n = self.pool_batches * self.batch_size
        nonces = signer.NonceRange(rng, n)
        nb = int(params["message_bytes"])
        blob = rng.randbytes(nb * n)
        self.pool = []
        for b in range(self.pool_batches):
            entries = []
            for i in range(self.batch_size):
                j = b * self.batch_size + i
                v = i % self.signers
                msg = blob[nb * j: nb * (j + 1)]
                A = keys.public[v]
                entries.append((A, signer.sign_with(
                    keys.scalar(v), A, nonces.scalar(j), nonces.public[j],
                    msg), msg))
            self.pool.append(entries)
        self.keys = keys
        self.tampered = {}
        for q, half in signer.window_tampering(
                rng, int(params["tampered"]),
                int(params["tamper_within_calls"]), 1).items():
            entries = list(self._pool_batch(q))
            self.tampered[q] = (entries, signer.tampered_at(
                entries, half, len(entries), rng))

    def _pool_batch(self, q: int) -> list:
        return self.pool[q % self.pool_batches]

    def unit_key(self, q: int):
        """What makes two units the same batch (a tampered unit is one of
        its own)."""
        if q in self.tampered:
            return ("tampered", q)
        return q % self.pool_batches

    def batch(self, q: int):
        """(entries, index of the altered signature or None)."""
        if q in self.tampered:
            return self.tampered[q]
        return self._pool_batch(q), None

    def call_units(self, call: int) -> list:
        return [call]
