"""CometBFT commit traffic: each unit is one commit, the precommit votes
of a chain's whole validator set at one height.

Every chain has its own set of `validators` keys, the same at every height.
Each vote signs its canonical vote sign-bytes (CometBFT `VoteSignBytes`:
the length-delimited protobuf `CanonicalVote`, about 110 bytes), which
differ per validator through the vote's timestamp.  A pool of `heights`
signed heights is made per chain from the seed, every commit valid.

Unit q is chain `order[q % chains]` at height `(q // chains) % heights`,
so a commit recurs only after all `chains * heights` others.  With one
chain that is a node replaying its chain's heights in order.  Units q >= 0
are the measured window's (the warm-up takes q < 0).  `tampered` of them,
placed among the window's first `tamper_within_calls` calls by
`signer.window_tampering`, carry their pool commit with one vote's s moved
to another value below l: a unit of its own, not a pool entry, so the
replay never repeats it.

Parameters (the workload's `traffic` object): chains, validators, heights,
tampered, tamper_within_calls, batches_per_call."""

import random

from portbench.traffic import signer

PRECOMMIT = 2


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(tag: int, payload: bytes) -> bytes:
    """A length-delimited protobuf field (wire type 2)."""
    return _varint(tag << 3 | 2) + _varint(len(payload)) + payload


def vote_sign_bytes(chain_id: str, height: int, block_hash: bytes,
                    parts_hash: bytes, seconds: int, nanos: int) -> bytes:
    """The length-delimited CanonicalVote of a round-0 precommit (proto3:
    the zero round is left out)."""
    part_set = _varint(1 << 3) + _varint(1) + _field(2, parts_hash)
    block_id = _field(1, block_hash) + _field(2, part_set)
    stamp = (_varint(1 << 3) + _varint(seconds)
             + _varint(2 << 3) + _varint(nanos))
    body = (_varint(1 << 3) + _varint(PRECOMMIT)
            + _varint(2 << 3 | 1) + height.to_bytes(8, "little")
            + _field(4, block_id) + _field(5, stamp)
            + _field(6, chain_id.encode()))
    return _varint(len(body)) + body


class Traffic:
    def __init__(self, params: dict, seed: int):
        self.chains = int(params["chains"])
        self.validators = int(params["validators"])
        self.heights = int(params["heights"])
        self.batches_per_call = int(params["batches_per_call"])
        self.seed = int(seed)
        rng = random.Random(self.seed)
        n_votes = self.chains * self.heights * self.validators
        nonces = signer.NonceRange(rng, n_votes)
        self.commits = []  # [chain][height] -> entries
        self.keys = []
        self._shift = None
        j = 0
        for c in range(self.chains):
            keys = signer.KeyRange(rng, self.validators)
            self.keys.append(keys)
            chain_id = f"chain-{c:02d}"
            h0 = rng.randrange(1, 1 << 24)
            t0 = 1_700_000_000 + rng.randrange(1 << 24)
            rows = []
            for h in range(self.heights):
                block_hash = rng.randbytes(32)
                parts_hash = rng.randbytes(32)
                entries = []
                for v in range(self.validators):
                    msg = vote_sign_bytes(
                        chain_id, h0 + h, block_hash, parts_hash,
                        t0 + 6 * h, rng.randrange(10 ** 9))
                    A = keys.public[v]
                    entries.append((A, signer.sign_with(
                        keys.scalar(v), A, nonces.scalar(j),
                        nonces.public[j], msg), msg))
                    j += 1
                rows.append(entries)
            self.commits.append(rows)
        self.order = list(range(self.chains))
        rng.shuffle(self.order)
        self.tampered = {}
        for q, half in signer.window_tampering(
                rng, int(params["tampered"]),
                int(params["tamper_within_calls"]),
                self.batches_per_call).items():
            entries = list(self._pool_commit(q))
            self.tampered[q] = (entries, signer.tampered_at(
                entries, half, len(entries), rng))

    def chain_of(self, q: int) -> int:
        return self.order[q % self.chains]

    def shift128(self, A: bytes) -> bytes:
        """The encoding of [2^128]A for a validator key."""
        if self._shift is None:
            self._shift = {}
            for keys in self.keys:
                self._shift.update(zip(keys.public, keys.shift128_public()))
        return self._shift[A]

    def _pool_commit(self, q: int) -> list:
        return self.commits[self.chain_of(q)][(q // self.chains)
                                              % self.heights]

    def unit_key(self, q: int):
        """What makes two units the same commit (a tampered unit is one
        of its own)."""
        if q in self.tampered:
            return ("tampered", q)
        return (self.chain_of(q), (q // self.chains) % self.heights)

    def batch(self, q: int):
        """(entries, index of the altered vote or None)."""
        if q in self.tampered:
            return self.tampered[q]
        return self._pool_commit(q), None

    def call_units(self, call: int) -> list:
        k = self.batches_per_call
        return list(range(call * k, (call + 1) * k))
