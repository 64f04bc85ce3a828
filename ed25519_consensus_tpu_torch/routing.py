"""Placement reads for verify_many's device lane.

The JAX package routes large batches to a sharded mesh above a crossover
model fitted on the TPU.  The port has the single-device lane only: auto
routing (`mesh=None`) resolves to it, and an explicit `mesh > 1` raises
until the port's mesh lands.  The crossover constants come back with the
mesh, measured on the card, not inherited.

What stays is the placement read the single lane needs: how many CUDA
devices exist, how many the process `ChipRegistry` still allows, and which
one a reformed single lane runs on when device 0 is dead.
"""

from . import config as _config
from . import health as _health

__all__ = ["available_devices", "healthy_device_count", "reform_for",
           "estimate_device_terms", "resolve_mesh"]

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


def reform_for(width: "int | None" = None
               ) -> "tuple[int, tuple[int, ...] | None]":
    """The rung the live chip set supports for a requested width:
    ``(rung, device_ids)`` with `rung` the largest power of two ≤
    min(width, live healthy count) — 0 means no healthy device, the host
    is the only rung — and `device_ids` the surviving devices it runs on,
    or None when they are exactly 0..rung−1."""
    d = available_devices() if width is None else int(width)
    if d <= 0:
        return 0, None
    # All addressable devices are the substitution universe; an explicit
    # width is the caller's assertion of the device world on hosts where
    # the probe reports 0.
    total = max(available_devices(), d)
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


def estimate_device_terms(verifier) -> int:
    """Estimated device MSM term count for one batch WITHOUT staging it:
    n signature terms + (m+1) coefficient terms + (m+1) split-high terms.
    Reads only `batch_size` and `distinct_key_count`."""
    m = verifier.distinct_key_count
    return verifier.batch_size + 2 * (m + 1)


def resolve_mesh(mesh) -> int:
    """The dispatch mode for a verify_many call: None (auto) and 0/1 are
    the single-device lane; a wider mesh raises until the port's sharded
    lane exists."""
    mesh = _health.normalize_mesh(mesh)
    if mesh:
        raise NotImplementedError(
            f"mesh={mesh}: the port has no sharded lane yet; use mesh=0 "
            f"(or None) for the single-device lane")
    return 0
