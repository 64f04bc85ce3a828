"""The port's durable verdict state (persist.py, the journal hooks of the
verdict memo and the service, the persistence storms of faults.py) on the
CPU, held against the JAX package:

* the journal's contract, as tests/test_persist.py pins it for the JAX
  package (its federation tests wait for the port's federation): the
  round trip through a hard kill, the whole-file gates (namespace, knob
  fingerprint, version skew, stale pins), the per-record gates (torn tail,
  bit rot, a re-sealed flipped verdict), the absorb gate, the fsync policy,
  compaction, the SITE_PERSIST seam, the service's `persist_dir`, and the
  196-case ZIP215 matrix through a restart under every corruption kind —
  each kind also run through the JAX package, with equal load reports and
  hits;
* the codecs byte for byte (`_encode_header`, `_encode_record`,
  `knob_fingerprint`);
* a journal either package writes recovers in the other with the same
  load report and the same 200 verdicts served from it;
* FlappingLink, randomized_plan(flap_period=) and persist_plan decide as
  the JAX plans do for call indices 0–63 at three seeds, and the storms
  corrupt a file byte for byte alike.

The memo sits above routing: every service here runs its host lane
(ED25519_TPU_DISABLE_DEVICE=1, which both packages read)."""

import os
import random
import shutil

import pytest

from ed25519_consensus_tpu import faults as jfaults
from ed25519_consensus_tpu import persist as jpersist
from ed25519_consensus_tpu_torch import (
    batch,
    faults,
    health,
    persist,
    service,
    verdictcache,
)

import test_torch_verdictcache as tvc  # noqa: E402  (matrix, helpers)

from torch_threads import _one_torch_thread  # noqa: F401


PKGS = {"port": (persist, faults), "jax": (jpersist, jfaults)}


@pytest.fixture(autouse=True)
def host_only(monkeypatch):
    monkeypatch.setenv("ED25519_TPU_DISABLE_DEVICE", "1")
    yield
    for name, (_p, _b, dc, f, _h, _s, vc) in tvc.PKGS.items():
        if f.active_plan() is not None:
            f.uninstall()
        dc.set_default_cache(None)
        vc.set_default_cache(None)
    batch.reset_device_health()
    batch.last_run_stats.clear()


def make_cache(pkg="port", **kw):
    return tvc._cache(pkg, **kw)


def attach(vc, directory, pkg="port"):
    journal = PKGS[pkg][0].attach(vc, directory=str(directory))
    assert journal is not None
    return journal


def verifier_for(tag: bytes, bad: bool = False, pkg: str = "port"):
    return tvc.verifier(pkg, tvc.entries_for(tag, bad=bad))


def store_some(vc, tags=((b"p-acc", True), (b"p-rej", False)),
               pkg="port"):
    for tag, verdict in tags:
        assert vc.store(verifier_for(tag, not verdict, pkg), verdict) is True


def digest_of(tag: bytes, bad: bool = False) -> bytes:
    return verifier_for(tag, bad).content_digest()


# -- the journal round trip ------------------------------------------------


def test_attach_store_kill_reload_roundtrip(tmp_path):
    vc1 = make_cache()
    attach(vc1, tmp_path)
    store_some(vc1)
    # Hard kill: vc1 simply abandoned — no flush, no close.
    vc2 = make_cache()
    journal = attach(vc2, tmp_path)
    rep = journal.last_load_report
    assert rep["file_dropped"] is None
    assert rep["absorbed"] == 2
    assert sum(rep["dropped"].values()) == 0
    for tag, verdict in ((b"p-acc", True), (b"p-rej", False)):
        hit = vc2.lookup(digest_of(tag, not verdict))
        assert hit is not None and hit.verdict is verdict
    assert vc2.counters["absorbed"] == 2


def test_journal_path_is_namespaced(tmp_path):
    assert persist.journal_path(str(tmp_path)).endswith(
        "verdicts-default.vjournal")
    assert persist.journal_path(str(tmp_path), "r2").endswith(
        "verdicts-r2.vjournal")
    vc = make_cache(namespace="r2")
    attach(vc, tmp_path)
    store_some(vc)
    assert os.path.exists(persist.journal_path(str(tmp_path), "r2"))


def test_attach_is_idempotent_and_fail_open(tmp_path):
    vc = make_cache()
    j1 = attach(vc, tmp_path)
    assert persist.attach(vc, directory=str(tmp_path)) is j1
    # No directory resolved → persistence off, cache fully usable.
    off = make_cache()
    assert persist.attach(off) is None
    store_some(off)
    # Disabled cache → never journaled.
    disabled = make_cache(enabled=False)
    assert persist.attach(disabled, directory=str(tmp_path)) is None


def test_persist_dir_knob_attaches(tmp_path, monkeypatch):
    monkeypatch.setenv("ED25519_TPU_PERSIST_DIR", str(tmp_path))
    vc = make_cache()
    assert persist.attach(vc) is not None
    monkeypatch.setenv("ED25519_TPU_PERSIST_DIR", "")
    assert persist.attach(make_cache()) is None


def test_reload_reabsorbs_a_dropped_store(tmp_path):
    vc = make_cache()
    attach(vc, tmp_path)
    store_some(vc)
    vc.drop_all("simulated crash of the store")
    assert vc.lookup(digest_of(b"p-acc")) is None
    report = persist.reload(vc)
    assert report["absorbed"] == 2
    assert vc.lookup(digest_of(b"p-acc")).verdict is True
    assert persist.reload(make_cache()) is None


def test_append_failure_costs_durability_not_the_verdict(tmp_path):
    vc = make_cache()
    journal = attach(vc, tmp_path)
    shutil.rmtree(tmp_path)
    store_some(vc)  # appends fail: directory is gone
    assert journal.counters["append_errors"] >= 2
    # the in-memory store is untouched — served as usual
    assert vc.lookup(digest_of(b"p-acc")) is not None


# -- whole-file trust gates ------------------------------------------------


def test_namespace_mismatch_drops_whole_file(tmp_path):
    vc1 = make_cache(namespace="alpha")
    attach(vc1, tmp_path)
    store_some(vc1)
    path = persist.journal_path(str(tmp_path), "alpha")
    vc2 = make_cache(namespace="beta")
    journal = persist.VerdictJournal(path, namespace="beta")
    rep = journal.load_into(vc2)
    assert rep["file_dropped"] == "namespace_mismatch"
    assert rep["absorbed"] == 0 and vc2.counters["absorbed"] == 0


def test_knob_fingerprint_skew_drops_whole_file(tmp_path, monkeypatch):
    vc1 = make_cache()
    attach(vc1, tmp_path)
    store_some(vc1)
    monkeypatch.setattr(persist, "knob_fingerprint", lambda: "00" * 8)
    vc2 = make_cache()
    journal = attach(vc2, tmp_path)
    assert journal.last_load_report["file_dropped"] == "knob_skew"
    assert vc2.counters["absorbed"] == 0


def test_version_skew_drops_file_and_compaction_heals(tmp_path):
    vc1 = make_cache()
    attach(vc1, tmp_path)
    store_some(vc1)
    path = persist.journal_path(str(tmp_path))
    persist.rewrite_header(path, version=persist.FORMAT_VERSION + 1)
    vc2 = make_cache()
    journal = attach(vc2, tmp_path)
    assert journal.last_load_report["file_dropped"] == "version_skew"
    assert vc2.counters["absorbed"] == 0
    # attach-time compaction rewrote a clean current-version file: the
    # NEXT restart loads whatever vc2 stores from here on.
    store_some(vc2, tags=((b"p-heal", True),))
    vc3 = make_cache()
    journal3 = attach(vc3, tmp_path)
    assert journal3.last_load_report["file_dropped"] is None
    assert vc3.counters["absorbed"] == 1


def test_stale_pin_header_drops_all_records(tmp_path):
    vc1 = make_cache()
    attach(vc1, tmp_path)
    store_some(vc1)
    persist.rewrite_header(persist.journal_path(str(tmp_path)),
                           epoch_bump=1000)
    vc2 = make_cache()
    rep = attach(vc2, tmp_path).last_load_report
    assert rep["file_dropped"] is None
    assert rep["absorbed"] == 0
    assert rep["dropped"]["stale_pins"] == 2


def test_mid_journal_epoch_bump_stales_earlier_records(tmp_path):
    """The max-pin rule: a forfeiture before the crash stays forfeited
    after it — the newest epoch regime in the file wins."""
    vc1 = make_cache()
    attach(vc1, tmp_path)
    store_some(vc1, tags=((b"p-old", True),))
    vc1.bump_epoch("pre-crash forfeiture")
    store_some(vc1, tags=((b"p-new", True),))
    vc2 = make_cache()
    rep = attach(vc2, tmp_path).last_load_report
    assert rep["absorbed"] == 1
    assert rep["dropped"]["stale_pins"] == 1
    assert vc2.lookup(digest_of(b"p-new")) is not None
    assert vc2.lookup(digest_of(b"p-old")) is None


# -- per-record trust gates ------------------------------------------------


def test_torn_tail_drops_suffix_and_keeps_prefix(tmp_path):
    vc1 = make_cache()
    attach(vc1, tmp_path)
    store_some(vc1, tags=((b"p-a", True), (b"p-b", True),
                          (b"p-c", False)))
    path = persist.journal_path(str(tmp_path))
    with open(path, "rb+") as fh:
        fh.truncate(os.path.getsize(path) - 11)
    vc2 = make_cache()
    rep = attach(vc2, tmp_path).last_load_report
    assert rep["absorbed"] == 2
    assert rep["dropped"]["torn_tail"] == 1
    assert vc2.lookup(digest_of(b"p-a")) is not None
    assert vc2.lookup(digest_of(b"p-c", bad=True)) is None


def test_bitrot_in_payload_is_caught_at_load(tmp_path):
    vc1 = make_cache()
    attach(vc1, tmp_path)
    store_some(vc1, tags=((b"p-rot", True),))
    path = persist.journal_path(str(tmp_path))
    with open(path, "rb+") as fh:
        data = bytearray(fh.read())
        data[-7] ^= 0x40  # inside the last record's payload bytes
        fh.seek(0)
        fh.write(data)
    vc2 = make_cache()
    rep = attach(vc2, tmp_path).last_load_report
    assert rep["absorbed"] == 0
    assert (rep["dropped"]["record_hash"]
            + rep["dropped"]["rehash_mismatch"]) == 1
    assert vc2.lookup(digest_of(b"p-rot")) is None


def test_flipped_verdict_with_stale_seal_is_caught(tmp_path):
    """A record whose verdict was flipped and whose frame hash was
    recomputed still dies at the SEAL gate: the seal binds (digest,
    verdict)."""
    vc1 = make_cache()
    attach(vc1, tmp_path)
    store_some(vc1, tags=((b"p-seal", True),))
    entry = vc1.export_entries()[0]
    path = persist.journal_path(str(tmp_path))
    forged = persist._encode_record(
        entry.digest, entry.payload, not entry.verdict, entry.seal,
        entry.tenant, entry.writer_cls,
        (entry.epoch, entry.tenant_epoch, entry.companion_epoch,
         entry.companion_tenant_epoch))
    with open(path, "ab") as fh:
        fh.write(forged)
    vc2 = make_cache()
    rep = attach(vc2, tmp_path).last_load_report
    assert rep["dropped"]["seal_mismatch"] == 1
    hit = vc2.lookup(digest_of(b"p-seal"))
    # the honest record still serves its ORIGINAL verdict
    assert hit is not None and hit.verdict is True


def test_absorb_entry_gate_refuses_bad_payload_and_bad_seal():
    vc = make_cache()
    src = make_cache()
    src.store(verifier_for(b"p-gate"), True)
    entry = src.export_entries()[0]
    assert vc.absorb_entry(entry.digest, entry.payload + b"!",
                           entry.verdict, seal=entry.seal) is False
    assert vc.absorb_entry(entry.digest, entry.payload,
                           not entry.verdict, seal=entry.seal) is False
    assert vc.counters["absorb_refused"] == 2
    assert vc.lookup(entry.digest) is None
    assert vc.absorb_entry(entry.digest, entry.payload, entry.verdict,
                           seal=entry.seal) is True
    assert vc.lookup(entry.digest).verdict is True


# -- fsync policy, bounded size, compaction --------------------------------


def test_fsync_policy_knob_and_flush(tmp_path, monkeypatch):
    path = persist.journal_path(str(tmp_path))
    never = persist.VerdictJournal(path, fsync="never")
    assert never.fsync_policy == "never"
    never.flush()
    assert never.counters["flushes"] == 0
    close = persist.VerdictJournal(path, fsync="close")
    vc = make_cache()
    close.attach_cache(vc)
    vc.attach_journal(close)
    store_some(vc)
    close.flush()
    assert close.counters["flushes"] == 1
    always = persist.VerdictJournal(path, fsync="always")
    assert always.fsync_policy == "always"
    # the knob's default and choices are the JAX package's
    assert persist.VerdictJournal(path).fsync_policy == "close"
    monkeypatch.setenv("ED25519_TPU_PERSIST_FSYNC", "ALWAYS")
    assert persist.VerdictJournal(path).fsync_policy == "always"
    monkeypatch.setenv("ED25519_TPU_PERSIST_FSYNC", "sometimes")
    assert persist.VerdictJournal(path).fsync_policy == "close"
    monkeypatch.setenv("ED25519_TPU_PERSIST_MAX_BYTES", "4096")
    assert persist.VerdictJournal(path).max_bytes == 4096


def test_max_bytes_triggers_compaction(tmp_path):
    path = persist.journal_path(str(tmp_path))
    vc = make_cache()
    journal = persist.VerdictJournal(path, max_bytes=1024)
    journal.attach_cache(vc)
    vc.attach_journal(journal)
    for i in range(8):
        vc.store(verifier_for(b"p-cmp-%d" % i), True)
    assert journal.counters["compactions"] >= 1
    # the compacted snapshot still loads every live entry
    vc2 = make_cache()
    rep = persist.VerdictJournal(path, max_bytes=1024).load_into(vc2)
    assert rep["file_dropped"] is None
    assert rep["absorbed"] == 8


def test_compaction_is_atomic_snapshot_of_live_entries(tmp_path):
    vc = make_cache()
    journal = attach(vc, tmp_path)
    store_some(vc)
    before = os.path.getsize(journal.path)
    # re-storing refreshes (store() returns False) but appends again —
    # compact collapses the duplicates to one record per live entry
    assert vc.store(verifier_for(b"p-acc"), True) is False
    assert vc.store(verifier_for(b"p-rej", bad=True), False) is False
    assert os.path.getsize(journal.path) > before
    journal.compact()
    vc2 = make_cache()
    rep = attach(vc2, tmp_path).last_load_report
    assert rep["records"] == 2 and rep["absorbed"] == 2


# -- the SITE_PERSIST fault seam -------------------------------------------


def test_site_persist_seam_torn_write_storm(tmp_path):
    plan = faults.persist_plan(0x5EED, "torn", at=1, length=1)
    faults.install(plan)
    try:
        vc1 = make_cache()
        attach(vc1, tmp_path)
        store_some(vc1, tags=((b"p-s0", True), (b"p-s1", True),
                              (b"p-s2", False)))
    finally:
        faults.uninstall()
    assert plan.injection_log(), "the storm must actually have fired"
    vc2 = make_cache()
    rep = attach(vc2, tmp_path).last_load_report
    assert rep["absorbed"] < 3
    assert (rep["dropped"]["torn_tail"]
            + rep["dropped"]["record_hash"]) >= 1


def test_persist_plan_rejects_unknown_kind():
    with pytest.raises(ValueError):
        faults.persist_plan(1, "melt")


# -- the service ----------------------------------------------------------


def make_service(tmp_path, **kw):
    fc = health.FakeClock()
    kw.setdefault("auto_start", False)
    kw.setdefault("clock", fc)
    kw.setdefault("capacity_sigs", 4096)
    kw.setdefault("mesh", 0)
    kw.setdefault("health", service._HostOnlyHealth(fc))
    kw.setdefault("verdict_cache", make_cache())
    kw.setdefault("persist_dir", str(tmp_path))
    kw.setdefault("device", "cpu")
    return service.VerifyService(**kw), fc


def test_service_persists_across_restart(tmp_path):
    svc1, _ = make_service(tmp_path)
    t = svc1.submit(verifier_for(b"p-svc"))
    while svc1.process_once():
        pass
    assert t.result(10) is True
    journal = svc1.verdict_cache.journal()
    assert journal is not None and journal.counters["appends"] == 1
    svc1.close()  # drain-close flushes the journal
    assert journal.counters["flushes"] == 1
    svc2, _ = make_service(tmp_path)
    t2 = svc2.submit(verifier_for(b"p-svc"))
    assert t2.done(), "recovered verdict resolves at the front door"
    assert t2.result(0) is True
    assert svc2.totals["verdict_cache_hits"] == 1
    assert svc2.totals["waves"] == 0
    svc2.close()


def test_service_without_persist_dir_keeps_the_memo_in_process(tmp_path):
    svc, _ = make_service(tmp_path, persist_dir=None)
    t = svc.submit(verifier_for(b"p-mem"))
    while svc.process_once():
        pass
    assert t.result(10) is True
    assert svc.verdict_cache.journal() is None
    assert os.listdir(tmp_path) == []
    svc.close()


# -- the codecs and the fault plans, against the JAX package ---------------


_PINS = [{"epoch": 0, "companion_epoch": 0, "tenant_epochs": {},
          "companion_tenant_epochs": {}},
         {"epoch": 7, "companion_epoch": 3,
          "tenant_epochs": {"default": 1, "chain-b": 4},
          "companion_tenant_epochs": {"default": 0, "chain-b": 2}}]


@pytest.mark.parametrize("namespace", ["", "restartlab", "r1"])
@pytest.mark.parametrize("pins", _PINS, ids=["zero", "rotated"])
def test_header_codec_is_byte_identical(namespace, pins):
    assert persist.knob_fingerprint() == jpersist.knob_fingerprint()
    assert persist._encode_header(namespace, pins) == \
        jpersist._encode_header(namespace, pins)
    assert (persist.MAGIC, persist.FORMAT_VERSION) == \
        (jpersist.MAGIC, jpersist.FORMAT_VERSION)


def test_knob_fingerprint_tracks_the_same_knob(monkeypatch):
    for value in ("0", "no", "1", ""):
        monkeypatch.setenv("ED25519_TPU_VERDICT_CACHE_ENABLED", value)
        assert persist.knob_fingerprint() == jpersist.knob_fingerprint()
    on = persist.knob_fingerprint()
    monkeypatch.setenv("ED25519_TPU_VERDICT_CACHE_ENABLED", "0")
    assert persist.knob_fingerprint() != on


@pytest.mark.parametrize("verdict", [True, False])
def test_record_codec_is_byte_identical(verdict):
    vc = make_cache()
    store_some(vc, tags=((b"codec", verdict),))
    e = vc.export_entries()[0]
    for tenant, cls, pins in (("default", "mempool", (0, 0, 0, 0)),
                              ("chain-b", "consensus", (3, 1, 4, 1))):
        args = (e.digest, e.payload, verdict,
                verdictcache.verdict_seal(e.digest, verdict), tenant, cls,
                pins)
        rec = persist._encode_record(*args)
        assert rec == jpersist._encode_record(*args)
        parsed = persist._parse_records(rec, 0)
        assert parsed == jpersist._parse_records(rec, 0)
        assert parsed[0][0]["pins"] == pins


def _decisions(plan, site, n=64):
    return [[f.kind() for f in plan.faults
             if f.site == site and f.fires_on(i)] for i in range(n)]


@pytest.mark.parametrize("seed", [0, 0xC4A05, 0x5EED17])
def test_fault_plans_decide_as_the_reference(seed):
    for period in (1, 2, 5):
        ours = faults.FlappingLink(period=period)
        ref = jfaults.FlappingLink(period=period)
        assert [ours.fires_on(i) for i in range(64)] == \
            [ref.fires_on(i) for i in range(64)]
    for flap in (0, 2, 3):
        for site in (faults.SITE_LANE, faults.SITE_SHARDED):
            kw = dict(error_rate=0.15, stall_rate=0.05,
                      stall_seconds=0.05, corrupt_rate=0.10,
                      flap_period=flap, site=site)
            assert _decisions(faults.randomized_plan(seed, **kw), site) == \
                _decisions(jfaults.randomized_plan(seed, **kw), site)
    for kind in ("torn", "bitrot", "truncate", "version-skew",
                 "stale-pins"):
        kw = dict(at=seed % 7, length=3, frac=0.5, flips=2)
        assert _decisions(faults.persist_plan(seed, kind, **kw),
                          faults.SITE_PERSIST) == \
            _decisions(jfaults.persist_plan(seed, kind, **kw),
                       jfaults.SITE_PERSIST)
    with pytest.raises(ValueError):
        faults.FlappingLink(period=0)


class _FakeJournal:
    """What the storms read off the payload: the path and the last
    record's (offset, length)."""

    def __init__(self, path):
        self.path = path
        self.last_record_span = (300, 700)


@pytest.mark.parametrize("kind", ["torn", "bitrot"])
@pytest.mark.parametrize("seed", [1, 0x5EED])
def test_record_storms_corrupt_a_file_alike(tmp_path, kind, seed):
    data = bytes(random.Random(seed).randrange(256) for _ in range(1200))
    out = {}
    for pkg, (_p, f) in PKGS.items():
        path = str(tmp_path / f"{pkg}.bin")
        with open(path, "wb") as fh:
            fh.write(data)
        plan = f.persist_plan(seed, kind, at=2, length=3, flips=3,
                              frac=0.4)
        for _ in range(8):
            plan.run(f.SITE_PERSIST, lambda: None,
                     payload=_FakeJournal(path))
        with open(path, "rb") as fh:
            out[pkg] = fh.read()
        assert len(plan.injection_log()) == 3
    assert out["port"] == out["jax"] and out["port"] != data


# -- journals cross-read between the packages -------------------------------


def _prime_matrix(pkg, directory):
    """A journaled cache of `pkg` primed with the matrix through a
    host-lane service → the 200 verdicts."""
    vc = make_cache(pkg)
    attach(vc, directory, pkg)
    svc = tvc._service(pkg, vc)
    got = tvc._replay(pkg, svc)
    svc.close()
    return got


def _load(pkg, path):
    vc = make_cache(pkg)
    rep = PKGS[pkg][0].VerdictJournal(path).load_into(vc)
    return vc, {k: v for k, v in rep.items() if k != "path"}


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_a_journal_recovers_in_the_other_package(tmp_path, writer, reader):
    want = [w for *_e, w in tvc.MATRIX]
    assert _prime_matrix(writer, tmp_path / "w") == want
    path = PKGS[writer][0].journal_path(str(tmp_path / "w"))
    _, own = _load(writer, path)
    vc, other = _load(reader, path)
    assert other == own
    assert other["absorbed"] == 200 and other["file_dropped"] is None
    svc = tvc._service(reader, vc)
    assert tvc._replay(reader, svc) == want
    assert svc.totals["verdict_cache_hits"] == 200
    assert svc.totals["waves"] == 0
    svc.close()


# -- the ZIP215 matrix through persist → kill → reload --------------------


def _corrupt(kind, path):
    if kind == "clean":
        return
    if kind == "torn":
        with open(path, "rb+") as fh:
            fh.truncate(os.path.getsize(path) - 13)
    elif kind == "bitrot":
        with open(path, "rb+") as fh:
            data = bytearray(fh.read())
            rnd = random.Random(0x215)
            for _ in range(3):
                data[rnd.randrange(64, len(data))] ^= 0x10
            fh.seek(0)
            fh.write(data)
    elif kind == "version-skew":
        persist.rewrite_header(path, version=persist.FORMAT_VERSION + 1)
    elif kind == "stale-pins":
        persist.rewrite_header(path, epoch_bump=1000)
    else:
        raise ValueError(kind)


def _matrix_restart(pkg, kind, directory):
    """Prime, hard-kill, corrupt, revive, replay → (load report, hits,
    re-hash mismatches of the revived cache)."""
    want = [w for *_e, w in tvc.MATRIX]
    assert _prime_matrix(pkg, directory) == want
    # Hard kill: the primed service's cache abandoned, journal as appended.
    _corrupt(kind, PKGS[pkg][0].journal_path(str(directory)))
    vc2 = make_cache(pkg)
    rep = attach(vc2, directory, pkg).last_load_report
    svc2 = tvc._service(pkg, vc2)
    assert tvc._replay(pkg, svc2) == want, f"{pkg}/{kind}: verdict diverged"
    hits = svc2.totals["verdict_cache_hits"]
    svc2.close()
    return ({k: v for k, v in rep.items() if k != "path"}, hits,
            vc2.counters["rehash_mismatch"])


@pytest.mark.parametrize("kind", ["clean", "torn", "bitrot",
                                  "version-skew", "stale-pins"])
def test_zip215_matrix_bit_identical_through_restart(kind, tmp_path):
    """The 196-case small-order × non-canonical matrix (plus honest and
    tampered signatures) primed into a journaled cache, hard-killed, the
    file corrupted, and replayed through a recovered service: every
    verdict equals the analytic ZIP215 oracle, nothing is served from a
    corrupt record, and the JAX package recovers the same records."""
    rep, hits, mismatches = _matrix_restart("port", kind, tmp_path / "p")
    if kind == "clean":
        assert rep["absorbed"] == 200 and hits == 200
    elif kind == "version-skew":
        assert rep["file_dropped"] == "version_skew"
        assert rep["absorbed"] == 0 and hits == 0
    elif kind == "stale-pins":
        assert rep["absorbed"] == 0 and hits == 0
        assert rep["dropped"]["stale_pins"] == 200
    else:
        assert rep["absorbed"] < 200, "corruption must cost records"
        assert sum(rep["dropped"].values()) > 0, \
            "corruption must be caught at load"
    # a hit can only replay a record the trust ladder absorbed; the rest
    # were re-verified in full and stored fresh by the recovered life
    assert hits <= rep["absorbed"]
    assert mismatches == 0, "nothing corrupt survived to the re-hash"
    assert _matrix_restart("jax", kind, tmp_path / "j") == \
        (rep, hits, mismatches)
