"""Routing for verify_many: the single-device lane or the sharded mesh.

**The crossover model.**  A sharded dispatch over D cards pays a fixed cost
`a` (the per-shard launches, the copy of the D partial sums to the first
card and the K5 fold) and a per-term device cost `b/D`; the single lane
pays `b` per term.  D cards beat one when N·b > a + N·b/D, above

    N*(D) = a / (b · (1 − 1/D))

terms per batch.  Auto routing (`verify_many(mesh=None)`) picks the full
healthy mesh only above N*, only with at least `min_devices` = 2 healthy
cards visible, and only while that mesh's DeviceHealth allows the device;
otherwise the single lane.  On a one-card machine auto routing therefore
never picks the mesh.  An explicit `mesh=D` overrides the policy.

**The constants are the card's own** (the JAX package's TPU constants do
not apply): `b` and `a` below were measured by `chip_smoke.py` on the
machine named beside them.  A caller with other measurements passes them
to `RoutingPolicy(...)` and installs it with `set_default_policy`; that is
the one way to override them.  A resident keyset does not move the
crossover: no such effect has been measured on the card.

Also here: the placement reads — how many CUDA devices exist, how many the
process ChipRegistry still allows, and the reformation rung a failing mesh
steps down to — and, one level above, the federation's replica affinity
(rendezvous hashing over keyset digest and tenant).
"""

import hashlib
import threading

from . import config as _config
from . import health as _health

__all__ = ["RoutingPolicy", "default_policy", "set_default_policy",
           "available_devices", "healthy_device_count", "reform_for",
           "estimate_device_terms", "resolve_mesh", "replica_score",
           "replica_affinity_order", "replica_for"]

# Measured by chip_smoke.py's routing phase on an NVIDIA H100 80GB HBM3 at a
# 700 W power limit (PERF.md §6): `b` is the single lane's device
# seconds per term (a B = 4 chunk's K1 + K2 + K3, slope between two lane
# counts); `a` is the mesh dispatch's fixed cost, the intercept of the
# D = 2 mesh call's time over two lane counts.  That run had one card, so
# the mesh was virtual: `a` holds the launches, the gather and the K5 fold,
# and no peer copy between cards.  Measured: b = 4.6597e-08 s/term (2.660
# and 19.074 ms at 12,544 and 100,608 lanes, B = 4), a = 7.8523e-04 s.
DEFAULT_FIXED_COST_S = 7.8523e-04
DEFAULT_PER_TERM_S = 4.6597e-08

_device_count = [None]


def available_devices() -> int:
    """CUDA device count (torch.cuda.device_count(), memoized — it cannot
    change within a process), 0 when none exists or
    ED25519_TPU_DISABLE_DEVICE is set (re-checked live)."""
    if _config.get("ED25519_TPU_DISABLE_DEVICE"):
        return 0
    if _device_count[0] is None:
        try:
            import torch

            _device_count[0] = (torch.cuda.device_count()
                                if torch.cuda.is_available() else 0)
        except Exception:
            _device_count[0] = 0
    return _device_count[0]


def healthy_device_count(total: "int | None" = None) -> int:
    """The live placeable device count: `total` (default the available
    count) minus the chips the ChipRegistry excludes."""
    d = available_devices() if total is None else int(total)
    if d <= 0:
        return 0
    return _health.chip_registry().healthy_count(d)


def reform_for(width: "int | None" = None, total: "int | None" = None
               ) -> "tuple[int, tuple[int, ...] | None]":
    """The rung the live chip set supports for a requested width:
    ``(rung, device_ids)`` with `rung` the largest power of two ≤
    min(width, live healthy count) — 0 means no healthy device, the host
    is the only rung — and `device_ids` the surviving chips it runs on,
    or None when they are exactly 0..rung−1.  `total` widens the chip
    universe (a caller's logical chips beyond the visible cards)."""
    d = available_devices() if width is None else int(width)
    if d <= 0:
        return 0, None
    # All addressable devices are the substitution universe; an explicit
    # width is the caller's assertion of the device world on hosts where
    # the probe reports fewer (a virtual mesh: chips are shard positions).
    total = max(available_devices(), d, int(total or 0))
    live = min(healthy_device_count(total), d)
    if live <= 0:
        return 0, None
    rung = 1
    while rung * 2 <= live:
        rung *= 2
    ids = _health.chip_registry().surviving(rung, total)
    if ids is None:
        return 0, None
    if ids == tuple(range(rung)):
        ids = None
    return rung, ids


def replica_score(keyset_digest: "bytes | None", tenant: str,
                  rid: int) -> "tuple[bytes, int]":
    """The rendezvous score of replica `rid` for (keyset digest, tenant):
    SHA-256 over the digest and ("replica-affinity", tenant, rid), with the
    replica id breaking ties.  A None digest hashes as the empty one."""
    digest = keyset_digest if keyset_digest is not None else b""
    h = hashlib.sha256(
        digest + repr(("replica-affinity", tenant, int(rid))).encode()
    ).digest()
    return (h, int(rid))


def replica_affinity_order(keyset_digest: "bytes | None", tenant: str,
                           replica_ids) -> "tuple[int, ...]":
    """The federation's consistent-hash keyset/tenant → replica affinity:
    `replica_ids` sorted by descending `replica_score` (rendezvous
    hashing).  A pure function of its inputs with the minimal-disruption
    property: removing a replica moves only the keys it won (each to its
    second choice), adding one moves only the keys the newcomer now wins.
    The order is also the spillover order.  Placement, never math: the
    verdict comes from whichever replica's verify_many ladder decides."""
    return tuple(sorted((int(r) for r in replica_ids),
                        key=lambda r: replica_score(keyset_digest, tenant, r),
                        reverse=True))


def replica_for(keyset_digest: "bytes | None", tenant: str,
                replica_count: int) -> int:
    """The affinity winner among replicas [0, replica_count)."""
    if replica_count <= 0:
        raise ValueError("replica_count must be positive")
    return replica_affinity_order(
        keyset_digest, tenant, range(int(replica_count)))[0]


def estimate_device_terms(verifier) -> int:
    """Estimated device MSM term count for one batch WITHOUT staging it:
    n signature terms + (m+1) coefficient terms + (m+1) split-high terms.
    Reads only `batch_size` and `distinct_key_count`."""
    m = verifier.distinct_key_count
    return verifier.batch_size + 2 * (m + 1)


class RoutingPolicy:
    """Picks the dispatch mode (0 = single-device lane, D = D-shard mesh)
    for a verify_many call from the crossover model and live health.
    Immutable after construction."""

    def __init__(self, fixed_cost_s: float = DEFAULT_FIXED_COST_S,
                 per_term_s: float = DEFAULT_PER_TERM_S, min_devices: int = 2,
                 auto_mesh: bool = True):
        self.fixed_cost_s = float(fixed_cost_s)
        self.per_term_s = float(per_term_s)
        self.min_devices = int(min_devices)
        self.auto_mesh = bool(auto_mesh)

    def crossover_terms(self, n_devices: int) -> float:
        """N*(D): the per-batch term count above which D shards beat one
        device; infinite for D ≤ 1."""
        if n_devices <= 1:
            return float("inf")
        return self.fixed_cost_s / (self.per_term_s * (1.0 - 1.0 / n_devices))

    def choose_mesh(self, est_terms_per_batch: int,
                    n_devices: "int | None" = None,
                    health: "_health.DeviceHealth | None" = None) -> int:
        """The dispatch mode for batches of ~`est_terms_per_batch` terms:
        the widest live rung of `n_devices` cards (default: all visible)
        when it clears N* and its health allows the device, else 0."""
        if not self.auto_mesh:
            return 0
        d_cfg = available_devices() if n_devices is None else int(n_devices)
        if d_cfg < self.min_devices:
            return 0
        d, _ids = reform_for(d_cfg)
        if d < self.min_devices:
            return 0
        # Report only: the latency ledger's measured dispatch median beside
        # the modelled fixed cost the decision below still uses.
        measured_us = _health.chip_registry().latency.mesh_median_us()
        if measured_us:
            from .utils import metrics as _metrics

            _metrics.set_gauges(
                {"routing_measured_wave_overhead_us": measured_us})
        if est_terms_per_batch <= self.crossover_terms(d):
            return 0
        h = health if health is not None else _health.health_for(d)
        return d if h.device_allowed() else 0

    def __repr__(self):
        return (f"RoutingPolicy(fixed_cost_s={self.fixed_cost_s}, "
                f"per_term_s={self.per_term_s}, "
                f"min_devices={self.min_devices}, "
                f"auto_mesh={self.auto_mesh})")


_default = [None]
_default_lock = threading.Lock()


def default_policy() -> RoutingPolicy:
    """The process default RoutingPolicy (the card's constants unless
    `set_default_policy` installed another)."""
    with _default_lock:
        if _default[0] is None:
            _default[0] = RoutingPolicy()
        return _default[0]


def set_default_policy(policy: "RoutingPolicy | None") -> None:
    """Replace the process default policy (None: the card's constants
    again on next use)."""
    with _default_lock:
        _default[0] = policy


def resolve_mesh(mesh, est_terms_per_batch: int = 0,
                 n_devices: "int | None" = None, health=None,
                 policy: "RoutingPolicy | None" = None) -> int:
    """The dispatch mode of a verify_many call: an explicit `mesh` as
    given (0 and 1 are the single lane), None (auto) through the policy
    (`policy`, default the process default)."""
    if mesh is not None:
        return _health.normalize_mesh(mesh)
    pol = policy if policy is not None else default_policy()
    return _health.normalize_mesh(pol.choose_mesh(
        est_terms_per_batch, n_devices=n_devices, health=health))
