"""The comparison that decides `correct`: the program's verdicts against
the plain reference (reference/ed25519_ref.py), after the window.

Which units the reference decides:

* every unit whose batch the traffic tampered (its verdict must be False);
* every unit the program rejected (a reject of a valid batch is the
  fault a corrupted device result or a wrong rule would show);
* a sample, drawn from the seed, of the units the program accepted.

So a wrong reject and a wrong accept of a tampered batch are always seen,
and a wrong accept elsewhere (a batch the traffic did not tamper, which
the generator made valid) is seen through the sample.  Units that are the
same commit (a replayed pool) are decided once and compared at each
occurrence.  The reference's blinders come from the seed.  Jobs run in up
to `workers` spawned processes that import only the reference, and are
all joined before this returns."""

import concurrent.futures
import multiprocessing
import random

from portbench.reference import ed25519_ref

# At most this many rejected units that the traffic did not tamper get a
# reference verdict: each costs a full batch equation, and one mismatch
# already makes the run incorrect.
SUSPECT_CAP = 8


def _job(args):
    entries, first, seed, cofactored = args
    return ed25519_ref.verify_batch(entries, random.Random(seed),
                                    cofactored=cofactored, first=first)


def _ref_entries(entries):
    return [(A, sig[:32], sig[32:], m) for A, sig, m in entries]


def _run(jobs, workers: int) -> list:
    if workers <= 1 or len(jobs) <= 1:
        return [_job(j) for j in jobs]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(workers, len(jobs)), mp_context=ctx) as pool:
        return list(pool.map(_job, jobs))


def choose(traffic, outcomes, seed: int, sample: int) -> list:
    """The unit keys the reference decides, tampered ones first."""
    by_key = {}
    for u, v in outcomes:
        by_key.setdefault(traffic.unit_key(u), []).append((u, v))
    tampered, rejected, accepted = [], [], []
    for key, occ in by_key.items():
        if traffic.batch(occ[0][0])[1] is not None:
            tampered.append(key)
        elif any(v is False for _, v in occ):
            rejected.append(key)
        elif any(v is True for _, v in occ):
            accepted.append(key)
    rng = random.Random(seed * 7919 + 17)
    return (tampered + rejected[:SUSPECT_CAP]
            + rng.sample(accepted, min(sample, len(accepted)))), by_key


def _control_jobs(traffic, units, control: dict, seed: int):
    """The control's jobs and, per unit, the index of the job that decides
    it.  `cofactorless`: the reference without the [8], which ZIP 215's
    small-order entries fail.  `union`: a unit's verdict is that of the
    union of its group of `size` consecutive units, as if a failed union
    failed every member without bisection."""
    jobs, index, groups = [], [], {}
    for u in units:
        if control["kind"] == "cofactorless":
            entries, bad = traffic.batch(u)
            index.append(len(jobs))
            jobs.append((_ref_entries(entries),
                         [] if bad is None else [bad], seed + u, False))
        elif control["kind"] == "union":
            size = int(control["size"])
            g0 = u - u % size
            if g0 not in groups:
                groups[g0] = len(jobs)
                entries = []
                for m in range(g0, g0 + size):
                    entries += traffic.batch(m)[0]
                jobs.append((_ref_entries(entries), [], seed + g0, True))
            index.append(groups[g0])
        else:
            raise ValueError(f"unknown control {control['kind']!r}")
    return jobs, index


def compare(traffic, outcomes, seed: int, sample: int, workers: int,
            control: "dict | None" = None) -> dict:
    """{"compared", "mismatches", "failed", "tampered"}: `failed` counts
    every unit without a verdict (its call raised).  With `control` the program's verdicts are replaced by the control's
    (see `_control_jobs`)."""
    keys, by_key = choose(traffic, outcomes, seed, sample)
    units = [by_key[k][0][0] for k in keys]
    jobs = []
    for i, u in enumerate(units):
        entries, bad = traffic.batch(u)
        jobs.append((_ref_entries(entries), [] if bad is None else [bad],
                     seed * 104729 + i, True))
    n_ref = len(jobs)
    if control:  # the control decides every occurrence in its own call
        occ = [u for k in keys for u, _ in by_key[k]]
        cjobs, index = _control_jobs(traffic, occ, control, seed * 104723)
        jobs += cjobs
    verdicts = _run(jobs, workers)
    ref = dict(zip(keys, verdicts[:n_ref]))
    got = ({u: verdicts[n_ref + i] for u, i in zip(occ, index)}
           if control else None)
    compared = mismatches = 0
    for k in keys:
        for u, v in by_key[k]:
            if control:
                v = got[u]
            if isinstance(v, bool):
                compared += 1
                mismatches += v != ref[k]
    failed = [v for _, v in outcomes if not isinstance(v, bool)] \
        if not control else []
    return {"compared": compared, "mismatches": mismatches,
            "failed": len(failed),
            "tampered": sum(1 for k in keys
                            if traffic.batch(by_key[k][0][0])[1]
                            is not None)}
