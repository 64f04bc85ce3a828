"""The port's verdict memo (verdictcache.py) and `Verifier.content_payload`
held against the JAX package on the same queue streams:

* `content_payload()` and `content_digest()` are byte-identical across
  the packages (queue and queue_bulk, one and many keys), the digest is
  bitwise sha256(payload), and both are None in both packages for an
  exposed map or an `invalidate()`d batch;
* the 196-case ZIP215 small-order × non-canonical matrix (plus honest
  and tampered signatures) replayed through a service with each
  package's cache in every cache state — miss, hit, stale, corrupt
  stored verdict, evict storm, quota-refused — gives bit-identical
  verdicts and equal memo counters in both;
* the cache's own contract (seal re-hash, epoch pins, companion
  rotation, the device-trust forfeit, LRU and quota accounting) gives
  the JAX cache's answers call for call;
* `carry.verdict_cache_from_reference` absorbs the JAX store through the
  port's re-hash gate, so both packages answer the same lookups.

The memo sits above routing, so every service here runs its host lane
(ED25519_TPU_DISABLE_DEVICE=1, which both packages read)."""

import hashlib
import random

import pytest

import ed25519_consensus_tpu as J
from ed25519_consensus_tpu import batch as jbatch
from ed25519_consensus_tpu import devcache as jdevcache
from ed25519_consensus_tpu import faults as jfaults
from ed25519_consensus_tpu import health as jhealth
from ed25519_consensus_tpu import service as jservice
from ed25519_consensus_tpu import verdictcache as jverdictcache
import ed25519_consensus_tpu_torch as T
from ed25519_consensus_tpu_torch import (
    batch,
    carry,
    devcache,
    faults,
    health,
    service,
    verdictcache,
)
from ed25519_consensus_tpu_torch.ops import edwards
from ed25519_consensus_tpu_torch.utils import fixtures

from torch_threads import _one_torch_thread  # noqa: F401


PKGS = {
    "port": (T, batch, devcache, faults, health, service, verdictcache),
    "jax": (J, jbatch, jdevcache, jfaults, jhealth, jservice,
            jverdictcache),
}
KEYS = [T.SigningKey.new(random.Random(0x3E6D1 + i)) for i in range(4)]
MSG = b"Zcash"


@pytest.fixture(autouse=True)
def host_only(monkeypatch):
    monkeypatch.setenv("ED25519_TPU_DISABLE_DEVICE", "1")
    yield
    for name, (_, b, dc, f, _h, _s, vc) in PKGS.items():
        if f.active_plan() is not None:
            f.uninstall()
        dc.set_default_cache(None)
        vc.set_default_cache(None)
        b.last_run_stats.clear()


def entries_for(tag: bytes, n: int = 2, bad: bool = False):
    out = []
    for i in range(n):
        sk = KEYS[i % len(KEYS)]
        msg = b"vc-%s-%d" % (tag, i)
        sig = sk.sign(msg)
        if bad and i == 0:
            msg += b"!"
        out.append((sk.verification_key_bytes().to_bytes(), sig.to_bytes(),
                    msg))
    return out


def verifier(pkg: str, entries, bulk: bool = True):
    P, b = PKGS[pkg][0], PKGS[pkg][1]
    ents = [(P.VerificationKeyBytes(vk), P.Signature.from_bytes(sig), m)
            for vk, sig, m in entries]
    v = b.Verifier()
    if bulk:
        v.queue_bulk(ents)
    else:
        for e in ents:
            v.queue(e)
    return v


# -- the content address ---------------------------------------------------

@pytest.mark.parametrize("n,bulk", [(1, True), (5, True), (5, False),
                                    (9, False)])
def test_content_payload_and_digest_equal_across_packages(n, bulk):
    ents = entries_for(b"cp%d" % n, n=n, bad=n == 5)
    tv, jv = verifier("port", ents, bulk), verifier("jax", ents, bulk)
    payload = tv.content_payload()
    assert payload == jv.content_payload()
    assert tv.content_digest() == jv.content_digest() == \
        hashlib.sha256(payload).digest()
    # the two queue paths address the same content
    assert verifier("port", ents, not bulk).content_payload() == payload


def test_content_address_is_none_when_content_cannot_vouch():
    for pkg in PKGS:
        v = verifier(pkg, entries_for(b"none"))
        v.invalidate("test")
        assert v.content_payload() is None and v.content_digest() is None
        v = verifier(pkg, entries_for(b"none"))
        v.signatures  # exposing the map retires the address
        assert v.content_payload() is None and v.content_digest() is None


# -- the matrix through every cache state -----------------------------------

def _matrix_entries():
    encs = [p.compress() for p in edwards.eight_torsion()]
    encs += fixtures.non_canonical_point_encodings()[:6]
    cases = [(A, R + b"\x00" * 32, MSG, True) for A in encs for R in encs]
    for i in range(4):
        sk = KEYS[i % len(KEYS)]
        m = b"matrix-mix-%d" % i
        good = i % 2 == 0
        sig = sk.sign(m if good else b"evil")
        cases.append((sk.verification_key_bytes().to_bytes(),
                      sig.to_bytes(), m, good))
    return cases


MATRIX = _matrix_entries()


def _cache(pkg, **kw):
    kw.setdefault("budget_bytes", 1 << 20)
    kw.setdefault("enabled", True)
    kw.setdefault("tenant_quota_bytes", 0)
    return PKGS[pkg][6].VerdictCache(**kw)


def _service(pkg, vc, **kw):
    svc_mod, h = PKGS[pkg][5], PKGS[pkg][4]
    return svc_mod.VerifyService(capacity_sigs=1 << 16, auto_start=False,
                                 clock=h.FakeClock(), verdict_cache=vc,
                                 **kw)


def _replay(pkg, svc):
    tickets = [svc.submit(verifier(pkg, [(A, sig, m)]))
               for A, sig, m, _want in MATRIX]
    while svc.process_once():
        pass
    return [t.result(10) for t in tickets]


_COUNTERS = ("hits", "misses", "stores", "evictions", "rehash_mismatch",
             "stale_epoch", "drops", "quota_rejected", "budget_rejected")


def _matrix_run(pkg, path):
    f = PKGS[pkg][3]
    vc = _cache(pkg, tenant_quota_bytes=8 if path == "quota-refused" else 0)
    svc = _service(pkg, vc)
    first = _replay(pkg, svc)
    plan = None
    if path == "stale":
        vc.bump_epoch("matrix")
    elif path == "corrupt":
        plan = f.install(f.verdictcache_plan(0x215, "corrupt-verdict",
                                             at=0, length=1 << 12))
    elif path == "evict":
        plan = f.install(f.verdictcache_plan(0x216, "evict", at=0,
                                             length=1 << 12))
    try:
        second = _replay(pkg, svc)
    finally:
        if plan is not None:
            f.uninstall()
    svc.close()
    return (first, second, {k: vc.counters[k] for k in _COUNTERS},
            svc.totals["verdict_cache_hits"],
            svc.totals["verdict_cache_stores"])


@pytest.mark.parametrize("path", ["miss", "hit", "stale", "corrupt",
                                  "evict", "quota-refused"])
def test_zip215_matrix_bit_identical_in_every_cache_state(path):
    port = _matrix_run("port", path)
    ref = _matrix_run("jax", path)
    want = [w for *_e, w in MATRIX]
    assert port[0] == port[1] == want
    assert port == ref
    counters, hits = port[2], port[3]
    expect = {"hit": hits == 200, "miss": hits == 200,
              "stale": counters["stale_epoch"] == 200 and hits == 0,
              "corrupt": counters["rehash_mismatch"] == 200 and hits == 0,
              "evict": hits == 0,
              "quota-refused": counters["quota_rejected"] > 0 and hits == 0}
    assert expect[path], (path, counters, hits)


# -- the cache contract, call for call --------------------------------------

def _contract(pkg):
    """A sequence of direct cache calls; returns what each answered."""
    dc_mod, vc_mod = PKGS[pkg][2], PKGS[pkg][6]
    comp = dc_mod.DeviceOperandCache(budget_bytes=1 << 20, enabled=True)
    one = len(verifier(pkg, entries_for(b"a")).content_payload()) + 96
    vc = vc_mod.VerdictCache(budget_bytes=3 * one + 10, enabled=True,
                             tenant_quota_bytes=0, companion=comp)
    out = []

    def look(tag, tenant=None, bad=False):
        v = verifier(pkg, entries_for(tag, bad=bad))
        e = vc.lookup(v.content_digest(), tenant=tenant)
        return None if e is None else e.verdict

    for tag, bad, t in ((b"a", False, "x"), (b"b", True, "x"),
                        (b"c", False, "y"), (b"a", False, "y")):
        out.append(vc.store(verifier(pkg, entries_for(tag, bad=bad)),
                            not bad, tenant=t))
    out.append([look(b"a", "x"), look(b"b", "x"), look(b"a", "y"),
                look(b"c", "x")])
    out.append(vc.store(verifier(pkg, entries_for(b"d")), True, tenant="x"))
    out.append([look(b"a", "x"), look(b"b", "x", bad=True),
                look(b"d", "x")])
    out.append(vc.rotate_tenant("y"))
    out.append(look(b"c", "y"))
    comp.rotate_tenant("x")
    out.append([look(b"b", "x", bad=True), look(b"d", "x")])
    pins = vc.epoch_pins("x")
    out.append(pins)
    v = verifier(pkg, entries_for(b"e"))
    comp.bump_epoch("mid-flight")
    out.append(vc.store(v, True, tenant="x", expected_pins=pins))
    out.append(vc.store(verifier(pkg, entries_for(b"f", bad=True)), False,
                        tenant="x"))
    out.append(vc.store(verifier(pkg, entries_for(b"g")), True, tenant="x"))
    out.append(vc.forfeit_device_trust("lane-death"))
    out.append([look(b"f", "x", bad=True), look(b"g", "x")])
    out.append(vc.drop_all("test"))
    st = vc.stats()
    out.append({k: st[k] for k in ("hits", "misses", "stores", "evictions",
                                   "stale_epoch", "drops", "forfeits",
                                   "tenant_rotations", "resident_bytes",
                                   "resident_verdicts", "epoch")})
    out.append(sorted(vc.tenant_stats().items()))
    return out


def test_cache_contract_equals_reference():
    assert _contract("port") == _contract("jax")


def test_seal_is_the_reference_seal():
    d = hashlib.sha256(b"x").digest()
    for verdict in (True, False):
        assert verdictcache.verdict_seal(d, verdict) == \
            jverdictcache.verdict_seal(d, verdict)


# -- carrying the store across ----------------------------------------------

def _reference_store():
    """A JAX service's memo after a few waves (accepts and rejects, two
    tenants, one entry staled by a rotation)."""
    vc = _cache("jax")
    svc = _service("jax", vc)
    tickets = []
    for i in range(6):
        tickets.append(svc.submit(verifier("jax", entries_for(
            b"carry%d" % i, bad=i % 3 == 0)), tenant=("t0", "t1")[i % 2]))
    while svc.process_once():
        pass
    svc.close()
    return vc, [t.result(1) for t in tickets]


def _exported(vc):
    return [(e.digest, e.payload, e.verdict, e.tenant,
             (e.epoch, e.tenant_epoch, e.companion_epoch,
              e.companion_tenant_epoch), e.seal)
            for e in vc.export_entries()]


def test_carried_store_answers_the_same_lookups():
    jvc, verdicts = _reference_store()
    jvc.rotate_tenant("t1")  # t1's memos are stale in the reference
    tvc = _cache("port")
    pins = {t: jvc.epoch_pins(t) for t in ("t0", "t1")}
    assert carry.verdict_cache_from_reference(
        _exported(jvc), current_pins=pins, cache=tvc) == (3, 0, 3)
    svc = _service("port", tvc)
    for i in range(6):
        t = svc.submit(verifier("port", entries_for(
            b"carry%d" % i, bad=i % 3 == 0)), tenant=("t0", "t1")[i % 2])
        hit = t.done()
        assert hit == (i % 2 == 0)  # t0's memos carried, t1's did not
        while svc.process_once():
            pass
        assert t.result(1) == verdicts[i]
        jhit = jvc.lookup(verifier("jax", entries_for(
            b"carry%d" % i, bad=i % 3 == 0)).content_digest(),
            tenant=("t0", "t1")[i % 2])
        assert (jhit is not None) == hit
        if hit:
            assert jhit.verdict == verdicts[i]
    svc.close()


def test_carry_refuses_what_the_gate_refuses():
    jvc, _ = _reference_store()
    rows = _exported(jvc)
    tvc = _cache("port")
    d, payload, verdict, tenant, pins, seal = rows[0]
    flipped = (d, payload, not verdict, tenant, pins, seal)
    rotted = (d, payload[:-1] + bytes([payload[-1] ^ 1]), verdict, tenant,
              pins, seal)
    assert carry.verdict_cache_from_reference([flipped, rotted],
                                              cache=tvc) == (0, 2, 0)
    assert tvc.counters["absorb_refused"] == 2
    assert carry.verdict_cache_from_reference(rows, cache=tvc) == (6, 0, 0)
    assert tvc.counters["absorbed"] == 6
