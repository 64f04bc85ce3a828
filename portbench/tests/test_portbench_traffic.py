"""The benchmark's traffic: signatures that verify under the plain
reference, the zcash pool's lap property, the tampered units of each
window, the ZIP 215 matrix entries, and the same bytes from the same
seed."""

import random

import pytest

from portbench.reference import ed25519_ref as ref
from portbench.traffic import signer
from portbench.traffic.distinct_key_pool import Traffic as PoolTraffic
from portbench.traffic.validator_commits import Traffic as CommitTraffic

ZCASH_FULL = {"pool_keys": 131075, "batch_size": 10000,
              "matrix_per_batch": 16, "tampered": 2,
              "tamper_within_calls": 2, "message_bytes": 32,
              "batches_per_call": 1}
ZCASH_SMALL = dict(ZCASH_FULL, pool_keys=97, batch_size=40,
                   batches_per_call=4)
COMMITS_SMALL = {"chains": 3, "validators": 8, "heights": 8,
                 "tampered": 2, "tamper_within_calls": 3,
                 "batches_per_call": 4}


def _ref(entries):
    return [(A, sig[:32], sig[32:], m) for A, sig, m in entries]


@pytest.fixture(scope="module")
def zcash_small():
    return PoolTraffic(ZCASH_SMALL, seed=2**31 + 11)


@pytest.fixture(scope="module")
def commits_small():
    return CommitTraffic(COMMITS_SMALL, seed=2**33 + 3)


def test_matrix_is_the_196_zip215_cases():
    m = signer.zip215_matrix()
    assert len(m) == 196 and len({(a, s) for a, s, _ in m}) == 196
    encs = {a for a, _, _ in m}
    assert len(encs) == 14
    for a, sig, msg in m:
        assert sig[32:] == bytes(32) and msg == b"Zcash"
        assert ref.verify_single(a, sig[:32], sig[32:], msg)


def test_matrix_encodings_match_the_port_fixtures():
    from ed25519_consensus_tpu_torch.ops import edwards
    from ed25519_consensus_tpu_torch.utils import fixtures

    want = {p.compress() for p in edwards.eight_torsion()}
    want |= set(fixtures.non_canonical_point_encodings()[:6])
    assert {a for a, _, _ in signer.zip215_matrix()} == want


def test_cofactorless_rule_rejects_matrix_entries():
    """The control's rule fails ZIP 215's small-order entries."""
    m = signer.zip215_matrix()
    bad = [e for e in m
           if not ref.verify_single(e[0], e[1][:32], e[1][32:], e[2],
                                    cofactored=False)]
    assert len(bad) > 100


@pytest.mark.parametrize("which", ["zcash", "commits"])
def test_signatures_verify_under_reference(which, zcash_small,
                                           commits_small):
    traffic = zcash_small if which == "zcash" else commits_small
    for unit in range(8):
        entries, bad = traffic.batch(unit)
        for i, e in enumerate(_ref(entries)):
            assert ref.verify_single(*e) == (i != bad)
        assert ref.verify_batch(_ref(entries), random.Random(unit)) == (
            bad is None)


def test_zcash_batch_shape_and_tampered_share(zcash_small):
    t = zcash_small
    tampered = []
    for j in range(-8, 64):
        entries, bad = t.batch(j)
        assert len(entries) == t.batch_size
        assert all(e in t.matrix for e in entries[t.per_batch:])
        if bad is not None:
            tampered.append((j, bad))
            assert bad < t.per_batch
            s = int.from_bytes(entries[bad][1][32:], "little")
            assert s < ref.L
    # the window's two tampered units: in calls of their own among its
    # first two, the first in each half's first, the second in the second
    (j0, bad0), (j1, bad1) = tampered
    k = t.batches_per_call
    assert (j0 // k, j1 // k) == (0, 1)
    assert j0 % k < k // 2 <= j1 % k
    assert bad0 < t.batch_size // 2 <= bad1


@pytest.mark.parametrize("seed", range(40))
def test_window_tampering_places_units_in_both_halves(seed):
    rng = random.Random(seed)
    for n in (1, 2, 7, 64):
        got = signer.window_tampering(rng, 2, 8, n)
        (u0, h0), (u1, h1) = sorted(got.items())
        assert (h0, h1) == (0, 1)
        assert u0 // n != u1 // n and u1 < 8 * n
        if n > 1:
            assert u0 % n < n // 2 <= u1 % n


def test_zcash_pool_lap_property_full_size():
    """At the cell's sizes: a pool key recurs only after every other pool
    key (>= 131,071 pool entries between two uses), and no batch keyset
    repeats over 20 million signatures."""
    p = ZCASH_FULL
    n, per = p["pool_keys"], p["batch_size"] - p["matrix_per_batch"]
    assert n >= 2 * 65536
    t = PoolTraffic.__new__(PoolTraffic)
    t.pool_keys, t.per_batch, t.start = n, per, 12345
    # The stream is contiguous: each batch starts where the last ended.
    prev = None
    for j in range(40):
        r = t.pool_positions(j)
        if prev is not None:
            assert r.start == prev.stop
        prev = r
    # So a pool position recurs exactly every n stream entries.
    last = {}
    for t_pos in range(prev.stop):
        k = t_pos % n
        if k in last:
            assert t_pos - last[k] - 1 >= 131071
        last[k] = t_pos
    # A batch's pool keyset is fixed by its start mod n; 2,000 batches of
    # 10,000 signatures start at 2,000 different places.
    batches = 20_000_000 // p["batch_size"]
    starts = {t.pool_positions(j).start % n for j in range(batches)}
    assert len(starts) == batches


def test_commit_traffic_shape(commits_small):
    t = commits_small
    n = t.chains * t.heights
    seen = {}
    for q in range(3 * n):
        key = t.unit_key(q)
        if key in seen:
            assert q - seen[key] == n  # recurs only after all the others
        seen[key] = q
        entries, bad = t.batch(q)
        assert len(entries) == t.validators
        assert len({A for A, _, _ in entries}) == t.validators
        assert 90 <= len(entries[0][2]) <= 130
    tampered = sorted(q for q in range(-n, 3 * n) if t.batch(q)[1]
                      is not None)
    assert tampered == sorted(t.tampered)
    k = t.batches_per_call
    (q0, q1), (bad0, bad1) = tampered, [t.batch(q)[1] for q in tampered]
    assert q0 // k < q1 // k < COMMITS_SMALL["tamper_within_calls"]
    assert q0 % k < k // 2 <= q1 % k
    assert bad0 < t.validators // 2 <= bad1
    for q in tampered:  # a unit of its own; its pool commit stays valid
        assert t.unit_key(q) not in {t.unit_key(p) for p in range(3 * n)
                                     if p != q}
        assert t.batch(q + n)[1] is None


@pytest.mark.parametrize("which", ["zcash", "commits"])
def test_same_seed_same_bytes(which):
    make = ((lambda s: PoolTraffic(ZCASH_SMALL, s)) if which == "zcash"
            else (lambda s: CommitTraffic(COMMITS_SMALL, s)))
    a, b, c = make(7), make(7), make(8)
    assert [a.batch(u) for u in range(12)] == [b.batch(u) for u in range(12)]
    assert [a.batch(u) for u in range(12)] != [c.batch(u) for u in range(12)]
