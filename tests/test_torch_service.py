"""The port's verification front door (service.py) held against the JAX
package's on the same seeded submission schedules, on health.FakeClock
with `auto_start=False`, so every admission, shed, route and breaker
decision is deterministic:

* a schedule of seeded submissions — classes, tenants, sizes, tampered
  batches, repeats of earlier content (intra-wave dedup and the memo),
  deadlines, clock advances and dispatcher waves — gives equal ticket
  outcomes (the verdict, or the exception's type), per-class totals,
  service totals and breaker transitions in both packages, host-routed
  (every deadline inside the device-wave estimate) and device-routed
  (the port's waves through `verify_many(device="cpu")`, where every
  kernel runs its plain version; the JAX service runs host-only,
  ED25519_TPU_DISABLE_DEVICE=1 as tests/test_service.py does);
* a wave whose device call fails reaches the port's service as a
  `DeviceError`, which every ticket of that wave carries: the breaker
  transitions equal the JAX service's, whose verify_many re-decides a
  failed chunk on the host and reports the error in its stats (modelled
  here on the JAX side by those stats, so the JAX package needs no
  device program), and so does every other wave's outcome — the failed
  waves' tickets are where the port departs from the JAX service on
  purpose (the host never decides what the device failed to);
* a kernel build failure raises at construction on a CUDA device."""

import random

import pytest
import torch

import ed25519_consensus_tpu as J
from ed25519_consensus_tpu import batch as jbatch
from ed25519_consensus_tpu import devcache as jdevcache
from ed25519_consensus_tpu import health as jhealth
from ed25519_consensus_tpu import service as jservice
from ed25519_consensus_tpu import verdictcache as jverdictcache
import ed25519_consensus_tpu_torch as T
from ed25519_consensus_tpu_torch import (
    batch,
    devcache,
    faults,
    health,
    routing,
    service,
    tenancy,
    verdictcache,
)
from ed25519_consensus_tpu_torch.ops import _cuda

PKGS = {
    "port": (T, batch, devcache, health, service, verdictcache),
    "jax": (J, jbatch, jdevcache, jhealth, jservice, jverdictcache),
}
KEYS = [T.SigningKey.new(random.Random(0x5E7C + i)) for i in range(5)]
# Totals both services keep with the same meaning (the devcache tallies
# read the process caches, which the two packages fill differently).
TOTALS = ("submitted", "resolved", "rejected_overloaded", "shed_deadline",
          "waves", "host_waves", "device_waves", "probe_waves",
          "dedup_fanout", "verdict_cache_hits", "verdict_cache_stores",
          "degraded_waves")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker (the port tests' idiom)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset():
    yield
    for _P, b, dc, h, _s, vc in PKGS.values():
        dc.set_default_cache(None)
        vc.set_default_cache(None)
        b.reset_device_health()
        b.last_run_stats.clear()
    if faults.active_plan() is not None:
        faults.uninstall()


def entries_for(tag: bytes, n: int, bad: bool):
    out = []
    for i in range(n):
        sk = KEYS[(i + len(tag)) % len(KEYS)]
        msg = b"svc-%s-%d" % (tag, i)
        sig = sk.sign(msg)
        if bad and i == n - 1:
            msg += b"!"
        out.append((sk.verification_key_bytes().to_bytes(), sig.to_bytes(),
                    msg))
    return out


def verifier(pkg: str, entries):
    P, b = PKGS[pkg][0], PKGS[pkg][1]
    v = b.Verifier()
    v.queue_bulk([(P.VerificationKeyBytes(vk), P.Signature.from_bytes(s),
                   m) for vk, s, m in entries])
    return v


def schedule(seed: int, n: int, deadlines):
    """Seeded steps: ("submit", spec) with a fifth of them repeating an
    earlier submission's content under a new class, ("process",) and
    ("advance", seconds)."""
    rnd = random.Random(seed)
    steps, made = [], []
    for i in range(n):
        if made and rnd.random() < 0.25:
            spec = dict(rnd.choice(made))
        else:
            spec = {"tag": b"s%d-%d" % (seed, i), "n": rnd.randint(1, 4),
                    "bad": rnd.random() < 0.25,
                    "tenant": rnd.choice(("chain-a", "chain-b", None))}
            made.append(spec)
        spec["cls"] = rnd.choice(tenancy.CLASSES)
        spec["deadline"] = rnd.choice(deadlines)
        steps.append(("submit", spec))
        r = rnd.random()
        if r < 0.3:
            steps.append(("process",))
        elif r < 0.45:
            steps.append(("advance", rnd.choice((0.01, 0.5, 3.0))))
    return steps


def run(pkg: str, steps, **kw):
    """Drive one package's service through `steps`: (outcomes, totals,
    by_class, breaker transitions, memo counters)."""
    _P, _b, dc, h, svc_mod, vc_mod = PKGS[pkg]
    clock = h.FakeClock()
    vc = vc_mod.VerdictCache(budget_bytes=1 << 20, enabled=True,
                             tenant_quota_bytes=0)
    kw.setdefault("capacity_sigs", 12)
    # The scheduler's chunk deadlines on the same virtual clock: a slow
    # CPU chunk on a loaded host never reads as a device stall.
    kw.setdefault("health", h.DeviceHealth(clock=clock))
    svc = svc_mod.VerifyService(
        wave_max_batches=4, auto_start=False, clock=clock,
        breaker_seed=7, rng=random.Random(11), verdict_cache=vc,
        cache=dc.DeviceOperandCache(budget_bytes=1 << 20, enabled=True),
        **kw)
    outcomes, tickets = [], []
    for step in steps:
        if step[0] == "process":
            svc.process_once()
        elif step[0] == "advance":
            clock.advance(step[1])
        else:
            spec = step[1]
            dl = spec["deadline"]
            try:
                t = svc.submit(verifier(pkg, entries_for(
                    spec["tag"], spec["n"], spec["bad"])),
                    deadline=None if dl is None else svc.now() + dl,
                    cls=spec["cls"], tenant=spec["tenant"])
            except svc_mod.Overloaded:
                outcomes.append("Overloaded")
                tickets.append(None)
                continue
            outcomes.append(None)
            tickets.append(t)
    svc.close()
    for i, t in enumerate(tickets):
        if t is None:
            continue
        try:
            outcomes[i] = t.result(0)
        except Exception as exc:  # noqa: BLE001 - the outcome compared
            outcomes[i] = type(exc).__name__
    st = svc.stats()
    return (outcomes, {k: st[k] for k in TOTALS}, st["by_class"],
            svc.breaker.transitions,
            {k: vc.counters[k] for k in ("hits", "misses", "stores")}), st


def truth(steps):
    return [not s[1]["bad"] for s in steps if s[0] == "submit"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_host_routed_schedule_equals_reference(seed, monkeypatch):
    """Every deadline is inside the 2 s device-wave prior: each live wave
    is decided on the host route; expired ones shed."""
    steps = schedule(seed, 40, (0.05, 0.5, 1.5, -1.0))
    monkeypatch.setenv("ED25519_TPU_DISABLE_DEVICE", "1")
    ref, _ = run("jax", steps)
    monkeypatch.delenv("ED25519_TPU_DISABLE_DEVICE")
    port, st = run("port", steps, device="cpu")
    assert port == ref
    assert st["device_waves"] == 0 and st["host_waves"] > 0
    assert st["shed_deadline"] > 0 and st["rejected_overloaded"] > 0
    for got, want in zip(port[0], truth(steps)):
        assert got in (want, "Overloaded", "DeadlineExceeded")


@pytest.mark.parametrize("seed", [4, 5])
def test_device_routed_schedule_equals_reference(seed, monkeypatch):
    """No deadline inside the estimate: live waves go to the device
    route — the port's verify_many on the CPU, device only (hybrid=False)
    with the plain kernels; the JAX service host-only."""
    steps = schedule(seed, 24, (None, None, 120.0, -1.0))
    monkeypatch.setenv("ED25519_TPU_DISABLE_DEVICE", "1")
    ref, _ = run("jax", steps, chunk=2, hybrid=False)
    monkeypatch.delenv("ED25519_TPU_DISABLE_DEVICE")
    batch.last_run_stats.clear()
    port, st = run("port", steps, chunk=2, hybrid=False, device="cpu")
    assert port == ref
    assert st["device_waves"] > 0 and st["host_waves"] == 0
    assert st["device_error_waves"] == 0 and st["crash_fallbacks"] == 0
    assert batch.last_run_stats.get("device") == "cpu"
    assert port[4]["hits"] + st["dedup_fanout"] > 0
    for got, want in zip(port[0], truth(steps)):
        assert got in (want, "Overloaded", "DeadlineExceeded")


def _jax_device_model(monkeypatch, error_waves):
    """The JAX service's view of a device on the JAX side without a device
    program: its verify_many runs host-only (the env knob) and reports,
    for the n-th device-routed wave, what the JAX scheduler reports when
    a chunk errors and it re-decides it on the host (device_errors) or
    when the device decided the wave (device_batches)."""
    real = jbatch.verify_many
    ordinal = [0]

    def model(vs, *a, **kw):
        out = real(vs, *a, **kw)
        if not isinstance(kw.get("health"), jservice._HostOnlyHealth):
            if ordinal[0] in error_waves:
                jbatch.last_run_stats["device_errors"] = 1
            else:
                jbatch.last_run_stats["device_batches"] = len(vs)
            ordinal[0] += 1
        return out

    monkeypatch.setattr(jbatch, "verify_many", model)
    monkeypatch.setenv("ED25519_TPU_DISABLE_DEVICE", "1")


def _error_storm_steps():
    """Two waves that fail on the device, a third routed to the host by
    the open breaker, then, past the backoff, the half-open probe and a
    wave on the closed breaker."""
    steps = []
    for i in range(5):
        steps.append(("submit", {"tag": b"e%d" % i, "n": 2,
                                 "bad": i == 1, "tenant": None,
                                 "cls": tenancy.CLASS_CONSENSUS,
                                 "deadline": None}))
        steps.append(("process",))
        if i == 2:
            steps.append(("advance", 30.0))
    return steps


def test_device_error_wave_gives_the_reference_breaker_and_verdicts(
        monkeypatch):
    steps = _error_storm_steps()
    _jax_device_model(monkeypatch, error_waves={0, 1})
    ref, jst = run("jax", steps, chunk=2, hybrid=False)
    monkeypatch.undo()
    plan = faults.install(faults.storm_plan(3, "error", at=0, length=2))
    try:
        port, st = run("port", steps, chunk=2, hybrid=False, device="cpu")
    finally:
        faults.uninstall()
    assert len(plan.injection_log()) == 2
    # The two failed waves' tickets carry the DeviceError; the JAX
    # service decided them on the host and memoized those verdicts.
    assert ref[0] == truth(steps)
    assert port[0] == ["DeviceError"] * 2 + truth(steps)[2:]
    assert port[1] == dict(ref[1], verdict_cache_stores=ref[1][
        "verdict_cache_stores"] - 2)
    assert port[2] == ref[2]
    assert port[3] == ref[3]
    assert port[4] == dict(ref[4], stores=ref[4]["stores"] - 2)
    assert [s for s, _t in port[3]] == [service.BREAKER_OPEN,
                                        service.BREAKER_HALF_OPEN,
                                        service.BREAKER_CLOSED]
    assert st["device_error_waves"] == 2 and st["crash_fallbacks"] == 0
    assert jst["crash_fallbacks"] == 0
    assert st["probe_waves"] == 1 and st["host_waves"] == 1


def _boom(*a, **kw):
    raise ValueError("not a device error")


def test_other_exceptions_stay_crash_fallbacks(monkeypatch):
    """Only DeviceError takes the device-error rung; anything else out of
    a device wave's verify_many is the supervised executor's crash rung,
    as in the JAX service, and the wave's tickets carry the exception."""
    monkeypatch.setattr(batch, "verify_many", _boom)
    steps = _error_storm_steps()[:2]
    port, st = run("port", steps, device="cpu")
    assert port[0] == ["ValueError"]
    assert st["crash_fallbacks"] == 1 and st["device_error_waves"] == 0
    assert st["device_waves"] == 1 and st["verdict_cache_stores"] == 0


def test_host_route_crash_is_redecided_on_the_host(monkeypatch):
    """A crash on the host route (a deadline inside the device-wave
    estimate) is re-decided on the host, as in the JAX service."""
    monkeypatch.setattr(batch, "verify_many", _boom)
    steps = _error_storm_steps()[:4]
    for _kind, spec in steps[::2]:
        spec["deadline"] = 0.5
    port, st = run("port", steps, device="cpu")
    assert port[0] == truth(steps) == [True, False]
    assert st["crash_fallbacks"] == 2 and st["host_waves"] == 2
    assert st["device_waves"] == 0 and not port[3]


def test_kernel_build_failure_raises_at_construction(monkeypatch):
    """On a CUDA device the constructor builds and loads the verdict
    kernels: a build failure raises there, not on the first wave."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(routing, "_device_count", [1])

    def broken_build():
        raise RuntimeError("nvcc failed:\nwindow_sums.cu: injected")

    monkeypatch.setattr(_cuda, "load_all", broken_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        service.VerifyService(device="cuda:0", auto_start=False)
    # asked for the CPU, or with the device disabled, nothing is built
    service.VerifyService(device="cpu", auto_start=False).close()
    monkeypatch.setenv("ED25519_TPU_DISABLE_DEVICE", "1")
    service.VerifyService(auto_start=False).close()


def test_without_cuda_the_default_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        service.VerifyService(auto_start=False)


def test_threaded_dispatcher_resolves_every_ticket():
    """The real dispatcher thread on the real clock, device="cpu": every
    ticket resolves to the host verdict, and close() drains."""
    with service.VerifyService(device="cpu", chunk=2) as svc:
        tickets = [svc.submit(verifier("port", entries_for(
            b"thr%d" % i, 2, i % 3 == 0)), cls=tenancy.CLASSES[i % 3])
            for i in range(6)]
        assert [t.result(120) for t in tickets] == \
            [i % 3 != 0 for i in range(6)]
    assert svc.stats()["closed"]
