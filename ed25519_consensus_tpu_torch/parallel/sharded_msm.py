"""The sharded MSM: the verification terms split over a mesh of shards, each
shard's window sums folded with the others' in the Edwards group.

The JAX package runs this as one `shard_map` program over the TPU mesh: each
chip computes the window sums of its slice of the term axis, one
`all_gather` collects the D partial sums, and a scan of complete additions
folds them on every chip (never `psum`: an elementwise add of limb tensors
is not the group operation).  The port drives the same data parallelism
from one process (PERF.md says why, against `torch.distributed`):

* shard k of a placement (parallel/mesh.py) takes lanes [k·N/D, (k+1)·N/D)
  of every batch, copies them to its device and runs the port's own
  per-shard dispatch there — K1 (compressed wire) or K6 (affine wire),
  K2, K3 — launched for every shard before anything is copied back, so
  the shards of a multi-card placement run side by side;
* the D per-shard window sums, (B, 4, NLIMBS, 33) int32 each, are copied
  to the placement's first device and folded there by K5
  (`msm.fold_shards`), which reads each in place: nothing is stacked.

The result lives on the first device only; the Horner combine and every
verdict stay on the host.  The audit form also returns the stacked partials
that fed the fold (the sentinel audit recomputes one of them on the host),
and the cached form takes a keyset head resident on every device of the
placement, its digits on shard 0 only.

Each dispatch records two spans (utils/metrics): `mesh.launch` around the
per-shard copies and launches, `mesh.gather` around the copies to the
first device and K5.  Into the caller's `tally` dict, when one is passed,
it adds their host seconds as `mesh_launch_seconds` and
`mesh_gather_seconds`, and the lanes each shard's dispatch carried as
`mesh_lanes` ({chip id: batches × lanes}).

Every dispatch passes the `faults.SITE_SHARDED` seam with the placement's
chip ids as payload, so a fault can corrupt or kill one chip of the mesh.
Chip ids are CUDA indices on cards (a virtual mesh on one card names that
card for every shard) and shard positions on the CPU (mesh.shard_chips).
"""

from contextlib import contextmanager

from .. import config as _config
from .. import faults as _faults
from ..ops import msm as msm_lib
from ..ops.edwards import Point
from ..utils import metrics as _metrics
from . import mesh as mesh_lib


def _per_shard(n_lanes: int, n_shards: int, what: str) -> int:
    if n_shards < 1 or n_lanes % n_shards:
        raise ValueError(f"{what}: {n_lanes} lanes do not split over "
                         f"{n_shards} shards")
    return n_lanes // n_shards


@contextmanager
def _on(dev, placement, chips):
    """Names, on an exception raised while driving `dev`, the chips whose
    shards run there (`err.chips`), unless its raiser named some: a sticky
    CUDA error poisons that device's context only, so the scheduler marks
    that card dead (the CPU's shard positions on a CPU mesh) and reforms
    onto the rest."""
    try:
        yield
    except Exception as err:
        if not getattr(err, "chips", None):
            try:
                err.chips = tuple(dict.fromkeys(
                    c for c, d in zip(chips, placement) if d == dev))
            except AttributeError:
                pass
        raise


@contextmanager
def _timed_span(name: str, tally, key: str):
    """The span `name`, its host seconds added to `tally[key]`."""
    with _metrics.span(name), _metrics.timed(
            {} if tally is None else tally, key):
        yield


def _count_lanes(tally, chip: int, lanes: int) -> None:
    if tally is not None:
        per_chip = tally.setdefault("mesh_lanes", {})
        per_chip[chip] = per_chip.get(chip, 0) + lanes


def _gather_fold(parts, placement, chips, audit: bool):
    """The per-shard window sums copied to the first device and folded by
    K5 in mesh order: (B, 4, NLIMBS, 33), or with `audit` (1 + D, B, 4,
    NLIMBS, 33) — the fold, then the partials that fed it."""
    lead = placement[0]
    moved = []
    for p, dev in zip(parts, placement):
        with _on(dev, placement, chips):
            moved.append(p.to(lead))
    with _on(lead, placement, chips):
        folded = msm_lib.fold_shards(moved)
    if audit:
        import torch

        return torch.stack([folded, *moved])
    return folded


def _seam(fn, n_shards: int, clock, chips):
    return _faults.run_device_call(
        _faults.SITE_SHARDED, fn, mesh=n_shards, clock=clock, payload=chips)


def _sharded(digits, pts, placement, chips, audit: bool, tally):
    """The cold dispatch over `placement`: digits (B, 17 | 33, N), points
    in any wire with the lane axis last."""
    per = _per_shard(digits.shape[-1], len(placement), "digits")
    if pts.shape[-1] != digits.shape[-1]:
        raise ValueError(f"digits have {digits.shape[-1]} lanes, points "
                         f"{pts.shape[-1]}")
    with msm_lib.DEVICE_CALL_LOCK:
        parts = []
        with _timed_span("mesh.launch", tally, "mesh_launch_seconds"):
            for k, dev in enumerate(placement):
                with _on(dev, placement, chips):
                    parts.append(msm_lib.dispatch_window_sums_many(
                        digits[..., k * per:(k + 1) * per],
                        pts[..., k * per:(k + 1) * per], dev))
                _count_lanes(tally, chips[k], digits.shape[0] * per)
        with _timed_span("mesh.gather", tally, "mesh_gather_seconds"):
            return _gather_fold(parts, placement, chips, audit)


def sharded_window_sums_many(digits, pts, n_devices: int, clock=None,
                             device_ids=None, devices=None, tally=None):
    """The mesh lane's cold dispatch: digits (B, 17 | 33, N), points in any
    wire (compressed (B, 33, N), affine (B, 2, NLIMBS, N), extended (B, 4,
    NLIMBS, N)), numpy arrays or tensors, N a multiple of D → (B, 4, NLIMBS,
    33) int32 tensor on the placement's first device.

    `devices` places the shards explicitly (repeats allowed: a virtual
    mesh); otherwise shard k runs on `cuda:device_ids[k]` (a reformed
    mesh) or `cuda:k`.  The fault seam names each shard's chip
    (mesh.shard_chips: `device_ids` name a CPU placement's chips);
    `clock` is the caller's health clock, for clock-aware faults;
    `tally` the caller's dict of the mesh counters (module docstring)."""
    placement = mesh_lib.batch_mesh(n_devices, devices, device_ids)
    chips = mesh_lib.shard_chips(placement, device_ids)
    return _seam(lambda: _sharded(digits, pts, placement, chips, False,
                                  tally),
                 len(placement), clock, chips)


def sharded_window_sums_many_audit(digits, pts, n_devices: int,
                                   clock=None, device_ids=None,
                                   devices=None, tally=None):
    """The sentinel-audit form of `sharded_window_sums_many`: (1 + D, B, 4,
    NLIMBS, 33) — index 0 the folded sums (equal to the plain form's), then
    shard k's window sums in mesh order, the very tensors the fold took."""
    placement = mesh_lib.batch_mesh(n_devices, devices, device_ids)
    chips = mesh_lib.shard_chips(placement, device_ids)
    return _seam(lambda: _sharded(digits, pts, placement, chips, True,
                                  tally),
                 len(placement), clock, chips)


def sharded_window_sums_many_cached(head_digits, r_digits, head, rwire,
                                    n_devices: int, clock=None,
                                    device_ids=None, devices=None,
                                    tally=None):
    """The mesh lane's dispatch for a keyset whose head is resident:

    * head_digits (B, 17 | 33, D·n_head): shard k takes columns
      [k·n_head, (k+1)·n_head), real digits on shard 0 only and zeros
      elsewhere, so every head term counts once (a zero digit adds the
      identity);
    * r_digits (B, 17 | 33, NR) and rwire (B, 33, NR): the per-signature
      lanes, split over the shards like the cold operands;
    * head: the resident (4, NLIMBS, n_head) int16 head — an array or
      tensor, copied once to each distinct device of the placement, or a
      callable device → tensor (the devcache entry's `device_ref`, which
      keeps one copy resident per device).

    Each shard runs the port's head-resident dispatch (K1 on its R wire,
    the head beside it, K2, K3) over n_head + NR/D lanes; the window sums
    fold like the cold form's → (B, 4, NLIMBS, 33) int32."""
    placement = mesh_lib.batch_mesh(n_devices, devices, device_ids)
    chips = mesh_lib.shard_chips(placement, device_ids)
    D = len(placement)
    n_head = _per_shard(head_digits.shape[-1], D, "head digits")
    per_r = _per_shard(r_digits.shape[-1], D, "R digits")
    if rwire.shape[-1] != r_digits.shape[-1]:
        raise ValueError(f"R digits have {r_digits.shape[-1]} lanes, the R "
                         f"wire {rwire.shape[-1]}")
    if callable(head):
        head_on = head
    else:
        copies = {}

        def head_on(dev):
            if dev not in copies:
                copies[dev] = msm_lib.as_tensor(head, dev)
            return copies[dev]

    def run():
        import torch

        with msm_lib.DEVICE_CALL_LOCK:
            parts = []
            with _timed_span("mesh.launch", tally, "mesh_launch_seconds"):
                for k, dev in enumerate(placement):
                    with _on(dev, placement, chips):
                        digits = torch.cat([
                            msm_lib.as_tensor(head_digits[
                                ..., k * n_head:(k + 1) * n_head], dev),
                            msm_lib.as_tensor(r_digits[
                                ..., k * per_r:(k + 1) * per_r], dev)],
                            dim=-1)
                        parts.append(
                            msm_lib.dispatch_window_sums_many_cached(
                                digits, head_on(dev),
                                rwire[..., k * per_r:(k + 1) * per_r],
                                dev))
                    _count_lanes(tally, chips[k],
                                 r_digits.shape[0] * (n_head + per_r))
            with _timed_span("mesh.gather", tally, "mesh_gather_seconds"):
                return _gather_fold(parts, placement, chips, False)

    return _seam(run, D, clock, chips)


def shard_pad(n: int, n_devices: int) -> int:
    """The total lane count for n terms over D shards: D equal shards, each
    a whole number of K2's 64-lane chunks (at least one), the total at
    least ED25519_TPU_MIN_LANES when that knob is set.  Whole chunks keep
    every K2 block inside one shard, and cost no more than a ragged edge.
    (The JAX package's power-of-two pads fit its XLA scan kernel, not K2.)"""
    D = max(1, int(n_devices))
    per = -(-max(n, 1, _config.get("ED25519_TPU_MIN_LANES") or 0) // D)
    return D * (-(-per // msm_lib.CHUNK) * msm_lib.CHUNK)


def shard_pad_cached(n_sigs: int, n_head: int, n_devices: int) -> int:
    """The global R lane count NR of the cached mesh dispatch: each shard's
    n_head + NR/D lanes are a whole number of K2's 64-lane chunks."""
    D = max(1, int(n_devices))
    per_r = -(-max(n_sigs, 1) // D)
    lanes = -(-(n_head + per_r) // msm_lib.CHUNK) * msm_lib.CHUNK
    return (lanes - n_head) * D


def sharded_window_sums(digits, pts, n_devices: int, devices=None):
    """Single-batch form: digits (17 | 33, N), points (33, N) or (2 | 4,
    NLIMBS, N) → (4, NLIMBS, 33) int32 on the placement's first device."""
    return sharded_window_sums_many(
        digits[None], pts[None], n_devices, devices=devices)[0]


def _locked_fold(digits, pts, n_devices: int, devices=None) -> Point:
    """Dispatch and fetch under the device-call lock, then the exact host
    Horner combine."""
    with msm_lib.DEVICE_CALL_LOCK:
        out = sharded_window_sums(digits, pts, n_devices,
                                  devices=devices).cpu().numpy()
    return msm_lib.combine_window_sums(out)


def _width(n_devices, devices) -> int:
    if n_devices is not None:
        return int(n_devices)
    return len(mesh_lib.batch_mesh(devices=devices))


def sharded_device_msm(scalars, points, n_devices: "int | None" = None,
                       devices=None) -> Point:
    """Exact Σ[c_i]P_i with the window sums sharded over `n_devices`
    shards (default: every visible card, or one per entry of `devices`);
    the same semantics as ops.msm.device_msm.  Padding terms are scalar 0
    on the identity."""
    if not len(scalars):
        return Point(0, 1, 1, 0)
    D = _width(n_devices, devices)
    scalars, points = msm_lib.split_terms(scalars, points)
    digits, pts = msm_lib.pack_msm_operands(
        scalars, points, n_lanes=shard_pad(len(scalars), D))
    return _locked_fold(digits, pts, D, devices=devices)


def sharded_staged_msm(staged, n_devices: "int | None" = None,
                       devices=None) -> Point:
    """The sharded MSM of a batch.StagedBatch: its cold-path device
    operands (`device_operands(defer=True)`) padded by `shard_pad`, in the
    wire ED25519_TPU_WIRE selects."""
    D = _width(n_devices, devices)
    digits, pts = staged.device_operands(lambda n: shard_pad(n, D),
                                         defer=True)
    return _locked_fold(digits, pts, D, devices=devices)


__all__ = ["sharded_window_sums_many", "sharded_window_sums_many_audit",
           "sharded_window_sums_many_cached", "sharded_window_sums",
           "sharded_device_msm", "sharded_staged_msm", "shard_pad",
           "shard_pad_cached"]
