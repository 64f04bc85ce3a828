"""The port stands alone: `ed25519_consensus_tpu_torch` and `chip_smoke.py`
import neither `jax` nor anything of the JAX package `ed25519_consensus_tpu`
(the port keeps its own copies of the host modules and of the host C++
runtime), and its device entry points never fall back to the CPU unasked.
The blocked-import run drives the native runtime, verify_many through
resident tables, the sharded mesh (two shards on the CPU, the sentinel
audit, the affine wire, the sharded backend), the kernel lab's tools
(tools/kernel_lab.py, tools/microbench.py, the probes), and the service
stack — serde, the legacy oracle, tenancy, the verdict memo, VerifyService
and its two tools (tools/replay_lab.py, tools/load_soak.py) — and the
verdict soaks and durable state (persist.py, a journaled service across a
restart, tools/soak.py, device_soak.py, chaos_soak.py and restart_lab.py)
and the gray-failure half of the scheduler (the latency ledger, a
named-chip call, a hedged call, a probation probe, tools/straggler_lab.py
and tools/sentinel_soak.py) as well; the kernel sources in csrc/, probes.cu among them, include
nothing outside the port.

Careful with names: `ed25519_consensus_tpu_torch` starts with
`ed25519_consensus_tpu`, so a blocked name is matched exactly or as a
prefix followed by a dot, never as a bare prefix."""

import ast
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "ed25519_consensus_tpu_torch"
BLOCKED = ("jax", "ed25519_consensus_tpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops.  With several test
    workers on one host, torch's intra-op thread pools oversubscribe the
    cores (a 3 s case took minutes); one thread per worker is about as fast
    alone and keeps the workers out of each other's way."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blocked(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


def test_name_matcher_is_exact():
    assert _blocked("jax") and _blocked("jax.numpy")
    assert _blocked("ed25519_consensus_tpu")
    assert _blocked("ed25519_consensus_tpu.ops.msm")
    assert not _blocked("ed25519_consensus_tpu_torch")
    assert not _blocked("ed25519_consensus_tpu_torch.ops.msm")
    assert not _blocked("jaxlib_like") and not _blocked("numpy")


_SCRIPT = r"""
import sys

BLOCKED = ("jax", "ed25519_consensus_tpu")


class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(name + " is blocked for this test")


sys.meta_path.insert(0, Block())

import random

import ed25519_consensus_tpu_torch as T
from ed25519_consensus_tpu_torch import batch

rng = random.Random(7)
sk = T.SigningKey.new(rng)
sig = sk.sign(b"port without jax")
sk.verification_key().verify(sig, b"port without jax")
bv = batch.Verifier()
entries = []
for i in range(12):
    s = T.SigningKey.new(rng)
    m = b"msg %d" % i
    entries.append((s.verification_key_bytes(), s.sign(m), m))
bv.queue_bulk(entries)
bv.verify(rng=rng, backend="device", device="cpu")
bv.verify(rng=rng, backend="host")

from ed25519_consensus_tpu_torch import (carry, config, devcache, faults,
                                         health, native, routing)
from ed25519_consensus_tpu_torch.utils import metrics

assert native.load() is not None
clock = health.FakeClock()
for rep in range(3):
    vs = []
    for j in range(2):
        v = batch.Verifier()
        v.queue_bulk(entries)
        vs.append(v)
    assert batch.verify_many(vs, rng=rng, chunk=2, hybrid=False,
                             merge="never", device="cpu",
                             health=health.DeviceHealth(clock=clock)) \
        == [True, True]
assert batch.last_run_stats["devcache"]["table_dispatch_hits"] == 1

# The sharded mesh: two shards on the CPU, the sentinel auditing every
# (cold) chunk, the affine wire, and the sharded backend.
from ed25519_consensus_tpu_torch.parallel import sharded_msm

devcache.set_default_cache(devcache.DeviceOperandCache(enabled=False))

for wire in ("compressed", "affine"):
    with config.override(ED25519_TPU_WIRE=wire):
        vs = []
        for j in range(2):
            v = batch.Verifier()
            v.queue_bulk(entries)
            vs.append(v)
        assert batch.verify_many(vs, rng=rng, chunk=2, hybrid=False,
                                 merge="never", mesh=2, device="cpu",
                                 sentinel_rate=1.0,
                                 health=health.DeviceHealth(clock=clock)) \
            == [True, True]
        st = batch.last_run_stats
        assert st["mesh"] == 2 and st["sentinel"]["audits"] >= 1
routing._device_count[0] = 2
bv.verify(rng=rng, backend="sharded", device="cpu")
assert "sharded_msm" in sharded_msm.__name__

# The kernel lab's tools and forms on the CPU: a radix-32 variant against
# the exact host MSM, the stage profile and the probes.
import torch

from ed25519_consensus_tpu_torch.ops import probes
from ed25519_consensus_tpu_torch.tools import kernel_lab, microbench

assert kernel_lab.exp_variant("radix32", device="cpu", sizes=(64, 128),
                              reps=1, window_bits=5, win_chunk=9)
microbench.profile_ledger(1, 64, reps=1, device="cpu")
x = torch.arange(256, dtype=torch.int32).reshape(2, 128)
assert torch.equal(probes.chain(x, "madd", 5),
                   probes.chain_plain(x, "madd", 5))

# The service stack: serde, the legacy oracle, tenancy, the verdict memo,
# VerifyService (a memo hit at the front door) and its two tools.
from ed25519_consensus_tpu_torch import serde, service, tenancy, verdictcache
from ed25519_consensus_tpu_torch.tools import load_soak, replay_lab
from ed25519_consensus_tpu_torch.utils import legacy

vk = sk.verification_key()
assert serde.from_json(serde.to_json(vk)).to_bytes() == vk.to_bytes()
assert legacy.legacy_verify(vk.to_bytes(), sig.to_bytes(),
                            b"port without jax")
assert tenancy.arrivals("burst", 20.0, 5.0, seed=1)
vc = verdictcache.VerdictCache(budget_bytes=1 << 20, enabled=True)
with service.VerifyService(device="cpu", auto_start=False, clock=clock,
                           health=health.DeviceHealth(clock=clock),
                           verdict_cache=vc, chunk=2) as svc:
    t1 = svc.submit(entries, cls="mempool", tenant="t")
    svc.process_once()
    t2 = svc.submit(entries, cls="consensus", tenant="t")
    assert t1.result(0) and t2.done() and t2.result(0)
assert svc.stats()["verdict_cache_hits"] == 1
assert replay_lab.run_lab(replay_lab.parse_args(["--txs", "6",
                                                 "--sigs", "2"]))["ok"]
assert load_soak.soak(load_soak.parse_args([
    "--device", "cpu", "--storm", "error", "--rounds", "1",
    "--submitters", "1", "--requests", "4"]))["ok"]

# The verdict soaks and the durable verdict state: a journaled service
# killed and revived, one round of each soak, one restart-lab scenario.
import tempfile

from ed25519_consensus_tpu_torch import persist
from ed25519_consensus_tpu_torch.tools import (chaos_soak, device_soak,
                                               restart_lab, soak)

pdir = tempfile.mkdtemp()
for life in (1, 2):
    vc = verdictcache.VerdictCache(budget_bytes=1 << 20, enabled=True)
    svc = service.VerifyService(device="cpu", auto_start=False, clock=clock,
                                health=health.DeviceHealth(clock=clock),
                                verdict_cache=vc, persist_dir=pdir)
    t = svc.submit(entries, cls="consensus")
    svc.process_once()
    assert t.result(0) and t.done()
    if life == 2:
        assert vc.journal().last_load_report["absorbed"] == 1
        assert svc.stats()["verdict_cache_hits"] == 1
assert persist.journal_path(pdir).endswith("verdicts-default.vjournal")
assert soak.run(rounds=1, seed=0xD00D, log=lambda m: None)["ok"]
assert device_soak.run(device="cpu", passes=2, batches=1, clock=clock,
                       log=lambda m: None)["ok"]
assert chaos_soak.soak(chaos_soak.parse_args(
    ["--device", "cpu", "--rounds", "1"]),
    clock=health.FakeClock(), log=lambda m: None)["ok"]
run = restart_lab.run_scenario(restart_lab.parse_args(
    ["--txs", "6", "--sigs", "2"]), "clean")
assert run["lost"] == 0 and run["verdict_mismatches"] == 0
assert run["load_report"]["absorbed"] > 0

# The gray-failure half: the latency ledger feeding the ladder, a call on
# a named logical chip, a force-hedged hybrid call, probation probes, and
# a phase of each of the two labs.
from ed25519_consensus_tpu_torch.tools import sentinel_soak, straggler_lab

reg = health.chip_registry()
reg.set_clock(clock)
reg.latency.reset()  # an empty ledger: HEDGE_MIN_MS=0 hedges at once
v1 = batch.Verifier()
v1.queue_bulk(entries)
with config.override(ED25519_TPU_HEDGE_MIN_MS=0):
    assert batch.verify_many([v1.clone()], chunk=2, hybrid=True,
                             merge="never", device="cpu", device_ids=(3,),
                             deadline=clock.monotonic() + 5.0,
                             health=health.DeviceHealth(clock=clock)) \
        == [True]
assert batch.last_run_stats["hedges_won"] == 1
assert reg.record_latency((0,), 0.01) == ()
reg.record_suspicion(2, 3.0, "test")
clock.advance(2000.0)
assert reg.probation_chips() == {2}
for _ in range(3):
    assert batch.run_probation_probe(v1.clone(), 2, device="cpu")
assert not reg.excluded_chips()
assert straggler_lab.run_hedge_phase(1, device="cpu")["ok"]
assert sentinel_soak.run_transient_corruptor(1, devices=2, chip=1,
                                             device="cpu")["ok"]
batch._DeviceLane.reset_all()
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not leaked, leaked
print("OK")
"""


def test_port_runs_with_jax_and_reference_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=str(ROOT),
                       env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().endswith("OK")


def test_host_runtime_is_the_ports_own_copy():
    """The native loader builds the port's own C++ source, never the JAX
    package's."""
    from ed25519_consensus_tpu_torch import native

    assert native.SOURCE.is_relative_to(PORT)
    assert native.SOURCE.read_bytes() == (
        ROOT / "ed25519_consensus_tpu" / "native" / "fe25519.cpp"
    ).read_bytes()


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            fn = node.func
            name = getattr(fn, "attr", getattr(fn, "id", ""))
            if name in ("import_module", "__import__"):
                yield node.args[0].value


def _port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    assert {"mesh.py", "sharded_msm.py"} <= {
        f.name for f in files if f.parent.name == "parallel"}
    assert {"kernel_lab.py", "microbench.py", "soak.py", "device_soak.py",
            "chaos_soak.py", "restart_lab.py", "straggler_lab.py",
            "sentinel_soak.py", "load_soak.py"} <= {
        f.name for f in files if f.parent.name == "tools"}
    assert {"persist.py", "health.py", "faults.py", "batch.py",
            "service.py", "routing.py", "carry.py", "metrics.py"} <= {
        f.name for f in files}
    return files


def _csrc_sources():
    files = sorted(p for p in (PORT / "csrc").rglob("*")
                   if p.suffix in (".cu", ".cuh", ".cpp", ".h"))
    assert {"expand_affine.cu", "fold_partials.cu", "probes.cu",
            "window_sums.cuh", "window_sums_r32.cu", "window_sums_w.cu"} <= {
        f.name for f in files}
    return files


@pytest.mark.parametrize("path", _csrc_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_csrc_includes_stay_in_the_port(path):
    """Every kernel and host source includes system headers (<...>) or its
    own files beside it in csrc/ — nothing of the JAX package's tree."""
    for line in path.read_text(encoding="utf-8").splitlines():
        line = line.strip()
        if not line.startswith("#include"):
            continue
        target = line[len("#include"):].strip()
        if target.startswith("<"):
            continue
        assert target.startswith('"') and target.endswith('"'), line
        name = target.strip('"')
        assert (path.parent / name).resolve().is_relative_to(PORT), line
        assert (path.parent / name).is_file(), line


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_blocked_imports_in_source(path):
    bad = [n for n in _imported_names(path) if _blocked(n)]
    assert not bad, (path, bad)


def test_entry_points_raise_without_cuda(monkeypatch):
    """With no CUDA device, the device entry points raise unless the
    caller asked for the CPU: no silent fallback."""
    from ed25519_consensus_tpu_torch import SigningKey, batch, carry
    from ed25519_consensus_tpu_torch.ops import limbs, msm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    digits = np.zeros((limbs.PACKED_WINDOWS, 64), dtype=np.uint8)
    wire = limbs.identity_wire_batch(64)
    with pytest.raises(RuntimeError, match="CUDA"):
        msm.dispatch_window_sums(digits, wire)
    with pytest.raises(RuntimeError, match="CUDA"):
        msm.dispatch_window_sums_many(digits[None], wire[None])
    with pytest.raises(RuntimeError, match="CUDA"):
        carry.operands_to_device(digits, wire)
    sk = SigningKey.new(random.Random(1))
    bv = batch.Verifier()
    bv.queue((sk.verification_key_bytes(), sk.sign(b"m"), b"m"))
    for call in (bv.verify_gpu, lambda: bv.verify(backend="device"),
                 lambda: bv.verify_async()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # a probation probe with no device named probes a card
    with pytest.raises(RuntimeError, match="CUDA"):
        batch.run_probation_probe(bv, 0)
    # the sharded backend and a mesh without a device need the cards too
    with pytest.raises(RuntimeError, match="CUDA"):
        bv.verify(backend="sharded")
    with pytest.raises(ValueError, match="CUDA devices"):
        batch.verify_many([bv], mesh=2)
    from ed25519_consensus_tpu_torch.parallel import sharded_msm
    with pytest.raises(ValueError, match="CUDA devices"):
        sharded_msm.sharded_window_sums_many(digits[None], wire[None], 2)
    # asked for the CPU, the same batch verifies
    bv.verify(backend="device", device="cpu")
    assert msm.dispatch_window_sums(digits, wire, device="cpu").shape == \
        (1, 4, limbs.NLIMBS, limbs.NWINDOWS)


def test_kernel_wrappers_never_fall_back_for_non_cpu_tensors():
    """A wrapper takes the plain version only for tensors on the CPU; any
    other device launches the kernel (CUDA) or raises."""
    from ed25519_consensus_tpu_torch.ops import limbs, msm
    from ed25519_consensus_tpu_torch.ops import torch_decompress as TD

    meta = torch.device("meta")
    with pytest.raises(ValueError):
        TD.expand_compressed_points(
            torch.zeros((1, 33, 64), dtype=torch.uint8, device=meta))
    with pytest.raises(ValueError):
        msm.window_partials(
            torch.zeros((1, 17, 64), dtype=torch.uint8, device=meta),
            torch.zeros((1, 4, limbs.NLIMBS, 64), dtype=torch.int16,
                        device=meta))
    with pytest.raises(ValueError):
        msm.window_partials(
            torch.zeros((1, 17, 64), dtype=torch.uint8),
            torch.zeros((1, 4, limbs.NLIMBS, 64), dtype=torch.int16,
                        device=meta))
    with pytest.raises(ValueError):
        msm.fold_partials(torch.zeros((1, 1, 33, 4, limbs.NLIMBS),
                                      dtype=torch.int32, device=meta))
    with pytest.raises(ValueError):
        msm.fold_shards(torch.zeros((2, 1, 4, limbs.NLIMBS, 33),
                                    dtype=torch.int32, device=meta))
    with pytest.raises(ValueError):
        msm.expand_affine_points(torch.zeros((1, 2, limbs.NLIMBS, 64),
                                             dtype=torch.int16, device=meta))
