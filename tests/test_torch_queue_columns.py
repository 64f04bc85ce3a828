"""The port's columnar queue (`batch.Verifier`): `queue_bulk` keeps each
entry only as bytes in the queue-order columns (R, s, challenge, group id)
and the raw-key index, and the coalescing map is rebuilt from them on
demand.  Every way of building a batch must leave the same record,
content payload, staged operands and verdict as the one-entry `queue`
loop, and agree with the JAX package on the CPU; `Signature.from_bytes`
keeps its public behaviour; a queued batch retains no per-signature
object; and `verify_many` counts the signatures queued in one native
call."""

import gc
import random

import pytest

import ed25519_consensus_tpu as J
import ed25519_consensus_tpu_torch as T
from ed25519_consensus_tpu import batch as jbatch
from ed25519_consensus_tpu_torch import batch, native
from ed25519_consensus_tpu_torch.error import InvalidSliceLength
from ed25519_consensus_tpu_torch.ops import edwards
from ed25519_consensus_tpu_torch.ops.scalar import L
from ed25519_consensus_tpu_torch.signature import Signature
from ed25519_consensus_tpu_torch.utils import fixtures

from torch_threads import _one_torch_thread  # noqa: F401


def _signed(n, n_keys, seed):
    rng = random.Random(seed)
    keys = [T.SigningKey.new(rng) for _ in range(n_keys)]
    out = []
    for i in range(n):
        sk = keys[i % n_keys]
        msg = b"col-%d" % i
        out.append((bytes(sk.verification_key_bytes()), bytes(sk.sign(msg)),
                    msg))
    return out


def _low_order():
    return ([p.compress() for p in edwards.eight_torsion()]
            + fixtures.non_canonical_point_encodings()[:6])


def _stream(name):
    """(vk bytes, sig bytes, msg) entries of one named stream."""
    if name == "zip215_matrix":  # 196 small-order pairs, s = 0: accept
        encs = _low_order()
        return [(A, R + bytes(32), b"Zcash") for A in encs for R in encs]
    if name == "non_canonical":  # every non-canonical A and R: stages
        encs = fixtures.non_canonical_point_encodings()
        return [(A, encs[i % 6] + bytes(32), b"nc-%d" % i)
                for i, A in enumerate(encs)]
    if name == "repeated_keys":
        ents = _signed(40, 3, seed=7)
        return ents + [ents[0], ents[5]]
    if name == "s_at_l":  # staging rejects
        ents = _signed(12, 2, seed=9)
        vk, sig, msg = ents[4]
        return ents[:4] + [(vk, sig[:32] + L.to_bytes(32, "little"), msg)] \
            + ents[5:]
    if name == "empty":
        return []
    if name == "one_entry":
        return _signed(1, 1, seed=3)
    raise ValueError(name)


STREAMS = ["zip215_matrix", "non_canonical", "repeated_keys", "s_at_l",
           "empty", "one_entry"]


def _entries(raw):
    return [(vk, Signature.from_bytes(sig), msg) for vk, sig, msg in raw]


def _halves(ents):
    return ents[:len(ents) // 2], ents[len(ents) // 2:]


def _queue_each(v, ents):
    for e in ents:
        v.queue(e)


def _build(way, ents, monkeypatch):
    """The batch built one way, and whether its map ends handed out."""
    first, second = _halves(ents)
    v = batch.Verifier()
    if way == "queue_bulk":
        v.queue_bulk(ents)
    elif way == "queue":
        _queue_each(v, ents)
    elif way == "bulk_then_queue":
        v.queue_bulk(first)
        _queue_each(v, second)
    elif way == "queue_then_bulk":
        _queue_each(v, first)
        v.queue_bulk(second)
    elif way == "signatures_midway":
        v.queue_bulk(first)
        assert sum(map(len, v.signatures.values())) == len(first)
        v.queue_bulk(second)
        return v, True
    elif way == "materialized_midway":
        v.queue_bulk(first)
        v._materialized()
        v.queue_bulk(second)
    elif way == "clone":
        v.queue_bulk(first)
        c = v.clone()
        c.queue_bulk(second)
        assert v.batch_size == len(first)  # the source is untouched
        return c, False
    elif way == "merge":
        parts = [ents[0::3], ents[1::3], ents[2::3]]
        members = []
        for p in parts:
            m = batch.Verifier()
            m.queue_bulk(p)
            members.append(m)
        # Member order, not entry order: the reference queues the same.
        return batch.merge_verifiers(members), False
    elif way == "merge_exposed":
        a, b = batch.Verifier(), batch.Verifier()
        a.queue_bulk(first)
        b.queue_bulk(second)
        b.signatures  # an exposed member: the union takes the map walk
        return batch.merge_verifiers([a, b]), bool(ents)
    elif way == "no_native":
        monkeypatch.setenv("ED25519_TPU_DISABLE_NATIVE", "1")
        v.queue_bulk(ents)
        monkeypatch.delenv("ED25519_TPU_DISABLE_NATIVE")
        assert v._columnar_sigs == 0
    else:
        raise ValueError(way)
    return v, False


WAYS = ["queue_bulk", "queue", "bulk_then_queue", "queue_then_bulk",
        "signatures_midway", "materialized_midway", "clone", "merge",
        "merge_exposed", "no_native"]


def _reference_order(way, ents):
    return (ents[0::3] + ents[1::3] + ents[2::3] if way == "merge"
            else ents)


def _record(v):
    return (v.batch_size, bytes(v._r_buf), bytes(v._s_buf), bytes(v._k_buf),
            v._gid.tobytes(), list(v._key_index.items()))


def _map(v):
    return [(k.to_bytes(), [(bytes(c), s) for c, s in lst])
            for k, lst in v._materialized().items()]


def _staged(v):
    try:
        s = v._stage(random.Random(5))
    except T.InvalidSignature:
        return "rejected"
    return (s.coeffs, s.z_blob, s.raw_points.tobytes(), s.enc32.tobytes(),
            s.hints.tobytes(), s.keyset_blob, s.coeff_shifts)


def _verdict(v):
    try:
        v.verify(rng=random.Random(11), backend="host")
    except (T.InvalidSignature, J.InvalidSignature):
        return False
    return True


@pytest.mark.parametrize("way", WAYS)
@pytest.mark.parametrize("stream", STREAMS)
def test_columnar_queue_matches_the_queue_loop(stream, way, monkeypatch):
    raw = _stream(stream)
    ents = _entries(raw)
    v, exposed = _build(way, ents, monkeypatch)
    order = _reference_order(way, ents)
    ref = batch.Verifier()
    _queue_each(ref, order)
    jv = jbatch.Verifier()
    for vk, sig, msg in order:
        jv.queue((vk, J.Signature(sig.R_bytes, sig.s_bytes), msg))
    if way != "merge_exposed":  # that union's record is its map alone
        assert _record(v) == _record(ref)
    assert _map(v) == _map(ref)
    if exposed:
        ref.signatures
        assert v.content_payload() is None and v.content_digest() is None
    else:
        assert v._buffers_live()
        assert v.content_payload() == ref.content_payload()
        assert v.content_digest() == ref.content_digest() == \
            jv.content_digest()
    assert _staged(v) == _staged(ref)
    assert _verdict(v) == _verdict(ref) == _verdict(jv)


@pytest.mark.parametrize("make", ["bytes", "bytearray", "memoryview"])
@pytest.mark.parametrize("size", [64, 0, 63, 65, 128])
def test_signature_from_bytes(make, size):
    raw = bytes(range(64)) + bytes(range(64, 128))
    data = {"bytes": bytes, "bytearray": bytearray,
            "memoryview": memoryview}[make](raw[:size])
    if size != 64:
        with pytest.raises(InvalidSliceLength):
            Signature.from_bytes(data)
        return
    sig = Signature.from_bytes(data)
    assert type(sig.R_bytes) is bytes and type(sig.s_bytes) is bytes
    assert sig.R_bytes == raw[:32] and sig.s_bytes == raw[32:64]
    assert sig.to_bytes() == bytes(sig) == raw[:64]
    same = Signature(raw[:32], raw[32:64])
    assert sig == same and hash(sig) == hash(same)
    assert sig != Signature(raw[:32], bytes(32))
    assert repr(sig) == repr(same) == (
        f"Signature(R_bytes={raw[:32].hex()!r}, "
        f"s_bytes={raw[32:64].hex()!r})")
    assert repr(sig) == repr(J.Signature.from_bytes(raw[:64]))


def _tracked_reachable(root) -> int:
    """GC-tracked objects reachable from `root`, itself included, short
    of its class (and through it the module)."""
    seen, todo = {id(root)}, [root]
    while todo:
        for r in gc.get_referents(todo.pop()):
            if (gc.is_tracked(r) and not isinstance(r, type)
                    and id(r) not in seen):
                seen.add(id(r))
                todo.append(r)
    return len(seen)


def test_queue_bulk_retains_no_per_signature_object():
    if native.load() is None:
        pytest.skip("the native runtime did not load")
    rng = random.Random(4)
    keys = [rng.randbytes(32) for _ in range(64)]

    def queued(n):
        ents = [(keys[i % 64], Signature.from_bytes(rng.randbytes(64)),
                 rng.randbytes(32)) for i in range(n)]
        v = batch.Verifier()
        v.queue_bulk(ents)
        del ents
        return v

    small, large = queued(1_000), queued(10_000)
    assert large.batch_size == 10_000
    assert _tracked_reachable(large) == _tracked_reachable(small)


def test_verify_many_counts_columnar_sigs(monkeypatch):
    monkeypatch.setenv("ED25519_TPU_DISABLE_DEVICE", "1")  # the host lane
    ents = _entries(_signed(24, 4, seed=21))

    def run(sizes, **kw):
        vs, at = [], 0
        for n in sizes:
            v = batch.Verifier()
            v.queue_bulk(ents[at: at + n])
            vs.append(v)
            at += n
        assert batch.verify_many(vs, rng=random.Random(1), device="cpu",
                                 **kw) == [True] * len(sizes)
        return batch.last_run_stats["queue_columnar_sigs"]

    if native.load() is not None:
        assert run([10, 6, 8], merge="never") == 24
        assert run([10, 6, 8], merge="always") == 24
        assert run([7]) == 7
    monkeypatch.setenv("ED25519_TPU_DISABLE_NATIVE", "1")
    assert run([10, 6, 8], merge="never") == 0
    assert run([10, 6, 8], merge="always") == 0
