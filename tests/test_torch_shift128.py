"""[2^128]A on the card: K7 (`shift128_lanes`, csrc/shift128_lanes.cu) and the
deferred cold-path wire that feeds it
(`StagedBatch.device_operands(defer=True)`).

On the CPU, through the kernels' plain versions:

* plain K7 against the host's `edwards.shift128`, on random keys, on every
  encoding of the ZIP215 matrix (the 8 torsion points, the non-canonical
  encodings, small-order and not) and on the identity: the same projective
  point, and in fact the same coordinates (the same doubling formula);
* plain K1 ignores hint bit 2 (both arithmetics), so the flag changes
  nothing but K7's work;
* the deferred operands expanded by plain K1 + K7 equal `device_operands`
  expanded by plain K1, lane for lane as projective points, with the same
  digits, on fresh keysets, a half-cached keyset, padded lanes and B > 1;
* `verify_many(device="cpu")` gives the verdicts of the benchmark's plain
  reference (portbench/reference/ed25519_ref.py) on the ZIP215 matrix and
  on tampered batches, and on the deferred paths every staged key is a
  cache hit or a key left to the card (`shift128_hits + shift128_device
  == shift128_lookups`);
* the sentinel's host re-computation reads a flagged lane as [2^128] of
  its encoding's point.

The card holds K7 against the same plain version (tests/test_torch_cuda.py,
chip_smoke.py --shift128).  Tolerance: exact."""

import random

import numpy as np
import pytest
import torch

from ed25519_consensus_tpu_torch import SigningKey, batch
from ed25519_consensus_tpu_torch.ops import edwards, limbs, msm
from ed25519_consensus_tpu_torch.ops import torch_decompress as TD
from ed25519_consensus_tpu_torch.ops.field import P
from ed25519_consensus_tpu_torch.utils import fixtures
from portbench.reference import ed25519_ref as ref

from torch_threads import _one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    """Every test starts with no [2^128]A cached, so staging defers every
    key it is not handed, and with the device lane's health reset.  A
    call's budget is 3 × the turnaround prior × its padded batches once
    its shape has run: a loaded CPU running the plain kernels must not
    read as a seized device."""
    monkeypatch.setattr(batch, "_shift128_cache", {})
    monkeypatch.setenv("ED25519_TPU_EMA_PRIOR", "10.0")
    batch.reset_device_health()
    yield
    batch.reset_device_health()
    batch.last_run_stats.clear()


def _matrix_encodings():
    """The 14 encodings of the ZIP215 small-order matrix (8 torsion points,
    6 non-canonical low-order ones), then the other non-canonical ones."""
    encs = [p.compress() for p in edwards.eight_torsion()]
    return encs + fixtures.non_canonical_point_encodings()


def _random_encodings(n, seed):
    rng = random.Random(seed)
    out = []
    while len(out) < n:
        e = rng.getrandbits(256).to_bytes(32, "little")
        if edwards.decompress(e) is not None:
            out.append(e)
    return out


def _wire(encs, flag_every=1):
    """(1, 33, n) wire of `encs` with their host hints, every
    `flag_every`-th lane carrying the shift flag."""
    w = np.zeros((1, 33, len(encs)), dtype=np.uint8)
    for i, e in enumerate(encs):
        w[0, :32, i] = np.frombuffer(e, dtype=np.uint8)
        w[0, 32, i] = edwards.decompress_with_hint(e)[1]
    w[0, 32, ::flag_every] |= TD.SHIFT128_FLAG
    return torch.from_numpy(w)


def _lane_point(pts, b, i):
    return edwards.Point(*(limbs.limbs_to_int(pts[b, k, :, i].numpy()) % P
                           for k in range(4)))


ENCODINGS = {
    "random": lambda: _random_encodings(24, 0x128),
    "zip215-matrix": _matrix_encodings,
    "identity": lambda: [edwards.Point(0, 1, 1, 0).compress()],
}


@pytest.mark.parametrize("case", sorted(ENCODINGS))
def test_plain_k7_equals_host_shift128(case):
    """Every flagged lane holds the host's shift128 of its encoding's
    point, coordinate for coordinate mod p (so projectively too); every
    unflagged lane keeps K1's point."""
    encs = ENCODINGS[case]()
    wire = _wire(encs, flag_every=2 if len(encs) > 1 else 1)
    pts = TD.expand_compressed_points(wire)
    out = TD.shift128_lanes(wire, pts)
    assert out.dtype == torch.int16 and out.shape == pts.shape
    for i, e in enumerate(encs):
        pt = edwards.decompress(e)
        got = _lane_point(out, 0, i)
        if wire[0, 32, i] & TD.SHIFT128_FLAG:
            want = edwards.shift128(pt)
            assert got == want, i
            assert [got.X, got.Y, got.Z, got.T] == [
                c % P for c in (want.X, want.Y, want.Z, want.T)], i
        else:
            assert torch.equal(out[0, ..., i], pts[0, ..., i])
            assert got == pt


@pytest.mark.parametrize("arith", ["u32", "l20"])
def test_plain_k1_ignores_the_shift_flag(arith):
    encs = _matrix_encodings() + _random_encodings(8, 0xB17)
    plain = _wire(encs, flag_every=len(encs) + 1)  # lane 0 flagged only
    plain[0, 32] &= 3
    flagged = plain.clone()
    flagged[0, 32] |= TD.SHIFT128_FLAG
    assert torch.equal(
        TD.expand_compressed_points_plain(flagged, arith=arith),
        TD.expand_compressed_points_plain(plain, arith=arith))


def test_shift128_flagged_reads_the_hint_row():
    w = limbs.identity_wire_batch(70)[None]
    assert not TD.shift128_flagged(w)
    assert not TD.shift128_flagged(torch.from_numpy(w))
    w[0, 32, 69] |= TD.SHIFT128_FLAG
    assert TD.shift128_flagged(w)
    assert TD.shift128_flagged(torch.from_numpy(w))


def _verifier(n_keys, sigs_per_key, seed, tamper=None):
    rng = random.Random(seed)
    ents = []
    for k in range(n_keys):
        sk = SigningKey.new(rng)
        for i in range(sigs_per_key):
            msg = b"shift128-%d-%d-%d" % (seed, k, i)
            sig = sk.sign(b"other" if tamper == (k, i) else msg)
            ents.append((sk.verification_key_bytes(), sig, msg))
    v = batch.Verifier()
    v.queue_bulk(ents)
    return v, ents


def _expanded_points(wire):
    return msm.expand_points(torch.from_numpy(np.ascontiguousarray(wire)))


def _same_lanes(got, want):
    for b in range(want.shape[0]):
        for i in range(want.shape[-1]):
            assert _lane_point(got, b, i) == _lane_point(want, b, i), (b, i)


@pytest.mark.parametrize("case", ["fresh", "half-cached", "padded-stack"])
def test_deferred_operands_expand_to_device_operands(case):
    """device_operands(defer=True), expanded by plain K1 + K7, against
    device_operands expanded by plain K1: equal digits, and every lane the
    same projective point.  `half-cached` stages with half the keys'
    [2^128]A cached (their lanes carry the host encoding, unflagged);
    `padded-stack` stacks two batches into a padded B = 2 dispatch."""
    seeds = (11, 12) if case == "padded-stack" else (10,)
    staged = []
    for seed in seeds:
        v, _ = _verifier(6, 2, seed)
        if case == "half-cached":
            # the read computes and caches all six; keep keys 0..2 only
            v._stage(random.Random(1)).coeff_shifts  # noqa: B018
            assert len(batch._shift128_cache) == 6
            for kb in list(batch._shift128_cache)[3:]:
                del batch._shift128_cache[kb]
        staged.append(v._stage(random.Random(seed)))
    pad = max(msm.pad_lanes(s.n_device_terms) for s in staged) + (
        64 if case == "padded-stack" else 0)
    deferred = [s.device_operands(lambda n: pad, defer=True) for s in staged]
    hits = 3 if case == "half-cached" else 0
    for s in staged:
        assert s.shift128_hits == hits
    flags = [int(((w[32] & TD.SHIFT128_FLAG) != 0).sum()) for _, w in
             deferred]
    assert flags == [6 - hits] * len(staged)
    full = [s.device_operands(lambda n: pad) for s in staged]
    for (dd, _), (df, _) in zip(deferred, full):
        assert np.array_equal(dd, df)
    got = _expanded_points(np.stack([w for _, w in deferred]))
    want = _expanded_points(np.stack([w for _, w in full]))
    assert not TD.shift128_flagged(np.stack([w for _, w in full]))
    _same_lanes(got, want)


def test_reading_coeff_shifts_fills_and_caches_the_deferred_keys():
    v, _ = _verifier(4, 1, 20)
    s = v._stage(random.Random(2))
    assert s.shift128_hits == 0 and batch._shift128_cache == {}
    shifts = s.coeff_shifts
    assert all(sp is not None for sp in shifts)
    assert len(batch._shift128_cache) == 4
    for j, sp in enumerate(shifts[1:], start=1):
        A = batch._point_from_row(s.raw_points[j])
        assert sp[0] == edwards.shift128(A) and sp[0].Z == 1
    # the deferred wire still flags what staging left out
    _, w = s.device_operands(msm.pad_lanes, defer=True)
    assert int(((w[32] & TD.SHIFT128_FLAG) != 0).sum()) == 4


def test_operands_do_not_depend_on_the_builds_before():
    """device_operands leaves nothing on the staged batch: a plain build
    between two deferred ones (which reads, and so caches, every key's
    [2^128]A) changes neither the digits nor the flags, and the count of
    keys left to the card is read off the wire, not kept."""
    v, _ = _verifier(4, 2, 60)
    s = v._stage(random.Random(9))
    d1, w1 = s.device_operands(msm.pad_lanes, defer=True)
    s.device_operands(msm.pad_lanes)
    d2, w2 = s.device_operands(msm.pad_lanes, defer=True)
    assert np.array_equal(d1, d2) and np.array_equal(w1, w2)
    assert int(((w2[32] & TD.SHIFT128_FLAG) != 0).sum()) == 4
    assert not hasattr(s, "shift128_device")


def _matrix_batches(tampered: bool):
    """The 196 (A, R) pairs of the ZIP215 matrix with s = 0 (all valid
    under ZIP215) as one batch, and one batch of 8 fresh keys, with one
    signature of the second signing another message when `tampered`."""
    encs = _matrix_encodings()[:14]
    m = [(A, R + b"\x00" * 32, b"Zcash") for A in encs for R in encs]
    v, ents = _verifier(8, 2, 30, tamper=(5, 1) if tampered else None)
    return [m, [(bytes(vk), bytes(sig), msg) for vk, sig, msg in ents]]


def _verifiers(batches):
    from ed25519_consensus_tpu_torch.signature import Signature

    out = []
    for ents in batches:
        v = batch.Verifier()
        v.queue_bulk([(A, Signature.from_bytes(s), m) for A, s, m in ents])
        out.append(v)
    return out


@pytest.mark.parametrize("tampered", [False, True])
def test_verify_many_on_the_cpu_matches_the_reference(tampered):
    batches = _matrix_batches(tampered)
    out = batch.verify_many(_verifiers(batches), rng=random.Random(4),
                            device="cpu", hybrid=False, merge="never",
                            chunk=2)
    want = [ref.verify_batch([(A, s[:32], s[32:], m) for A, s, m in ents],
                             random.Random(5)) for ents in batches]
    assert want == [True, not tampered]
    assert out == want
    st = batch.last_run_stats
    assert st["shift128_lookups"] == 14 + 8
    assert st["shift128_hits"] == 0
    assert st["shift128_hits"] + st["shift128_device"] == \
        st["shift128_lookups"]


def test_counters_add_up_with_some_keys_cached():
    """A call whose batches share some keys with an earlier staging: the
    cached ones are hits, the rest go to the card."""
    v1, ents1 = _verifier(3, 2, 40)
    v2, ents2 = _verifier(3, 2, 41)
    v1._stage(random.Random(3)).coeff_shifts  # noqa: B018 (caches 3 keys)
    both = batch.Verifier()
    both.queue_bulk(ents1 + ents2)
    out = batch.verify_many([both, _verifier(3, 2, 41)[0]],
                            rng=random.Random(6), device="cpu",
                            hybrid=False, merge="never", chunk=2)
    assert out == [True, True]
    st = batch.last_run_stats
    assert st["shift128_lookups"] == 6 + 3
    assert st["shift128_hits"] == 3
    assert st["shift128_device"] == 6
    assert st["shift128_hits"] + st["shift128_device"] == \
        st["shift128_lookups"]


def test_sentinel_rows_read_a_flagged_lane_shifted():
    v, _ = _verifier(3, 1, 50)
    s = v._stage(random.Random(7))
    _, w = s.device_operands(msm.pad_lanes, defer=True)
    lanes = list(range(len(s.coeffs) + 3))
    rows = batch._sentinel_lane_rows(w, lanes)
    flagged = set(np.flatnonzero(w[32] & TD.SHIFT128_FLAG).tolist())
    assert len(flagged) == 3
    for r, lane in zip(rows, lanes):
        pt = batch._point_from_row(r)
        enc_pt = edwards.decompress(bytes(w[:32, lane]))
        assert pt == (edwards.shift128(enc_pt) if lane in flagged
                      else enc_pt)
