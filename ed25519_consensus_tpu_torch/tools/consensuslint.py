"""consensuslint — the port's consensus-safety analysis, from one front door.

    python -m ed25519_consensus_tpu_torch.tools.consensuslint [PATHS]
        Layer 1: the CL001-CL009 catalog over the port's tree (every .py
        file of ed25519_consensus_tpu_torch/, tools/ included, and the
        float scan of csrc/), every scope list resolved, the committed
        waivers applied.  Exit 0 clean, 1 on an unwaived finding, 2 on a
        waiver, scope or guards error (a stale waiver, a scope symbol
        the tree does not define).

    --guards       verify the field->lock map (analysis/guards.toml)
                   against the source, then run only CL008/CL009.
    --stats        print rule counts, the waiver count and the manifests'
                   hashes as JSON and publish them as utils.metrics gauges.
    --ir-audit [--write-manifest]
                   layer 2 on the CPU: trace every torch twin variant and
                   hold it to analysis/twin_manifest.json.
    --sass-audit [--write-manifest]
                   layer 2 on the card: cuobjdump every built kernel
                   library and hold each function's opcodes to
                   analysis/sass_manifest.json (needs the CUDA toolkit).
    --race-audit [--device cuda:0] [--scenario] [--out PATH]
                   layers 3 and 4: analysis/harness.py in a subprocess,
                   with ED25519_TPU_RACE_AUDIT set for it — the lock-order
                   and write-race audits over the port's threaded suites
                   (default), the short CPU scenario, or the device
                   workload on the card.

Nothing here imports jax or the JAX package.
"""

import argparse
import json
import os
import subprocess
import sys

from ..analysis import linter

CONCURRENCY_RULES = ("CL008", "CL009")


def _race_audit(args) -> int:
    from .. import config
    from ..analysis import harness

    cmd = [sys.executable, harness.__file__]
    if args.device:
        cmd += ["--device", args.device]
        if args.fixture:
            cmd += ["--fixture", args.fixture]
    elif args.scenario:
        cmd += ["--scenario"]
    else:
        cmd += ["--suites", *(args.paths or harness.SUITES)]
    if args.out:
        cmd += ["--out", args.out]
    # The knob arms the harness's monitors; unset, it would run the
    # workload bare.
    with config.override(ED25519_TPU_RACE_AUDIT="1"):
        return subprocess.run(cmd, cwd=harness.REPO_ROOT).returncode


def _stats(findings, waivers) -> int:
    from ..analysis import guards
    from ..utils import metrics

    st = linter.publish_gauges(linter.stats(findings=findings,
                                            waivers=waivers))
    gst = guards.guard_stats()
    st["cl008_guarded_fields"] = gst["guarded_fields"]
    st["cl008_guard_accessors"] = gst["guard_accessors"]
    st["race_audit_fields"] = 0
    from .. import config

    race_out = config.get("ED25519_TPU_RACE_AUDIT_OUT")
    if race_out and os.path.exists(race_out):
        with open(race_out, encoding="utf-8") as f:
            st["race_audit_fields"] = json.load(f).get("fields_tracked", 0)
    metrics.set_gauges({
        "consensuslint_cl008_guarded_fields": st["cl008_guarded_fields"],
        "consensuslint_cl008_guard_accessors": st["cl008_guard_accessors"],
        "race_audit_fields": st["race_audit_fields"],
    })
    print(linter.render_stats(st))
    return 0 if not st["findings_active"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="consensuslint",
        description="the port's consensus-safety analysis (CL001-CL009, "
                    "the twin and SASS audits, the race audit)")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the package); with "
                         "--race-audit, the suites to run")
    ap.add_argument("--waivers", default=linter.WAIVERS_PATH)
    ap.add_argument("--no-waivers", action="store_true",
                    help="report every finding, waived or not")
    ap.add_argument("--stats", action="store_true")
    ap.add_argument("--guards", action="store_true")
    ap.add_argument("--ir-audit", action="store_true")
    ap.add_argument("--sass-audit", action="store_true")
    ap.add_argument("--write-manifest", action="store_true",
                    help="with --ir-audit or --sass-audit: regenerate the "
                         "committed manifest")
    ap.add_argument("--race-audit", action="store_true")
    ap.add_argument("--device", default=None,
                    help="with --race-audit: the device workload here")
    ap.add_argument("--fixture", default=None,
                    help="with --race-audit --device: the stream to run")
    ap.add_argument("--scenario", action="store_true",
                    help="with --race-audit: the short CPU scenario")
    ap.add_argument("--out", default=None,
                    help="with --race-audit: the report's path")
    args = ap.parse_args(argv)

    if args.ir_audit:
        from ..analysis import ir_audit

        return ir_audit.main(write=args.write_manifest)
    if args.sass_audit:
        from ..analysis import sass_audit

        return sass_audit.main(write=args.write_manifest)
    if args.race_audit:
        return _race_audit(args)

    if args.guards:
        from ..analysis import guards

        try:
            guards.verify_mapping()
        except guards.GuardsError as e:
            print(f"consensuslint: guards drift: {e}", file=sys.stderr)
            return 2
        gst = guards.guard_stats()
        print(f"guards mapping ok: {gst['guarded_fields']} field(s) across "
              f"{gst['guarded_classes']} class(es), "
              f"{gst['guard_accessors']} accessor(s)")
    full = not args.paths or [os.path.abspath(p) for p in args.paths] \
        == [linter.PACKAGE_ROOT]
    try:
        findings = (linter.lint_package() if full
                    else linter.lint_paths(args.paths))
        if args.guards:
            findings = [f for f in findings if f.rule in CONCURRENCY_RULES]
        waivers = [] if args.no_waivers else linter.load_waivers(
            args.waivers)
        if args.guards:
            # only the concurrency rules' waivers are in scope here; the
            # full run applies and checks the rest
            waivers = [w for w in waivers if w["rule"] in CONCURRENCY_RULES]
        active, waived = linter.apply_waivers(findings, waivers)
    except (linter.WaiverError, linter.ScopeError) as e:
        print(f"consensuslint: {type(e).__name__}: {e}", file=sys.stderr)
        return 2

    if args.stats:
        return _stats(findings, waivers)
    for f in waived:
        print(f"waived: {f}")
    for f in active:
        print(f)
    if active:
        print(f"consensuslint: {len(active)} finding(s) ({len(waived)} "
              f"waived)", file=sys.stderr)
        return 1
    print(f"consensuslint: clean ({len(waived)} finding(s) waived by "
          f"{len(waivers)} waiver(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
