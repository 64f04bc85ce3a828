"""Faults planted in the timed path underneath a run, each of which the
comparison must see: `plant(name, monkeypatch)` breaks the port's
`batch` module for the rest of the test."""


def _flip_one(batch):
    real = batch.verify_many

    def fault(verifiers, *a, **kw):
        out = real(verifiers, *a, **kw)
        if out and isinstance(out[0], bool):
            out[0] = not out[0]  # an answer altered where it is produced
        return out
    return "verify_many", fault


def _always_accept(batch):
    real = batch.verify_many

    def fault(verifiers, *a, **kw):
        real(verifiers, *a, **kw)
        return [True] * len(verifiers)  # every answer altered to accept
    return "verify_many", fault


def _half_left_out(batch):
    real = batch.verify_many

    def fault(verifiers, *a, **kw):
        verifiers = list(verifiers)  # the call's second half unverified
        half = len(verifiers) // 2
        out = real(verifiers[:half], *a, **kw) if half else []
        return out + [True] * (len(verifiers) - half)
    return "verify_many", fault


def _batch_half(keep_first: bool):
    def plant(batch):
        real = batch.Verifier.queue_bulk

        def fault(self, entries):
            entries = list(entries)  # half of each batch never queued
            half = len(entries) // 2
            return real(self, entries[:half] if keep_first
                        else entries[half:])
        return "Verifier.queue_bulk", fault
    return plant


FAULTS = {
    "flip_one": _flip_one,
    "always_accept": _always_accept,
    "half_left_out": _half_left_out,
    "batch_first_half_only": _batch_half(True),
    "batch_second_half_only": _batch_half(False),
}


def plant(name: str, monkeypatch) -> None:
    from ed25519_consensus_tpu_torch import batch

    where, fault = FAULTS[name](batch)
    if where == "verify_many":
        monkeypatch.setattr(batch, "verify_many", fault)
    else:
        monkeypatch.setattr(batch.Verifier, "queue_bulk", fault)
