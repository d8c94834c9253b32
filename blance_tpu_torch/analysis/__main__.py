# Port of blance_tpu/analysis/__main__.py: the same flags and exit
# contract, plus --device for the checks that run on a device (no
# XLA_FLAGS setup: the port has no virtual CPU mesh to force).
"""CLI: ``python -m blance_tpu_torch.analysis [--ci] [--device DEV]``.

Exit status is the contract CI consumes: 0 when every finding is either
fixed or pinned in analysis/baseline.toml, nonzero when any NEW finding
exists (or an analyzer itself crashed).  ``--ci`` is the full gate (AST
lints + the shape audit + the build-budget check + the HBM-budget
check, the last three on ``--device``, the card by default) and
additionally promotes stale baseline entries to hard errors, so a fix
that removes a finding must delete its suppression in the same change;
the default run skips the shape audit and the retrace/membudget checks
so the editor loop stays within seconds and touches no device
(``--shape-audit`` / ``--retrace`` / ``--membudget`` force them back on
individually).  The lints never touch a device.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m blance_tpu_torch.analysis",
        description="blance_tpu_torch static contract checks "
                    "(docs/STATIC_ANALYSIS.md)")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the "
                         "blance_tpu_torch package)")
    ap.add_argument("--ci", action="store_true",
                    help="the full CI gate: AST lints + the shape "
                         "contract audit + the build and HBM budgets")
    ap.add_argument("--shape-audit", action="store_true",
                    help="run the shape audit without the rest of "
                         "the --ci strictness")
    ap.add_argument("--retrace", action="store_true",
                    help="run the device-side build-budget check "
                         "(analysis/retrace.py) without the rest of "
                         "the --ci strictness")
    ap.add_argument("--determinism", action="store_true",
                    help="run ONLY the replay-determinism pass "
                         "(analysis/determinism.py), still folded "
                         "through the baseline")
    ap.add_argument("--donation", action="store_true",
                    help="run ONLY the use-after-donation pass "
                         "(analysis/donation.py), still folded "
                         "through the baseline")
    ap.add_argument("--membudget", action="store_true",
                    help="run the HBM-budget check "
                         "(analysis/membudget.py) without the rest of "
                         "the --ci strictness")
    ap.add_argument("--baseline", default=None, metavar="PATH",
                    help="allowlist file (default: "
                         "blance_tpu_torch/analysis/baseline.toml)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the allowlist")
    ap.add_argument("--device", default="cuda", metavar="DEV",
                    help="where the shape audit, retrace and membudget "
                         "checks run (default: cuda; 'cpu' runs the plain "
                         "PyTorch paths)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output (one JSON object)")
    args = ap.parse_args(argv)

    only_mode = args.determinism or args.donation
    shape = (args.ci or args.shape_audit) and not only_mode
    retrace = (args.ci or args.retrace) and not only_mode
    membudget = (args.ci or args.membudget) and not only_mode

    from . import run_all

    result = run_all(
        paths=args.paths or None,
        baseline_path=("/dev/null" if args.no_baseline else args.baseline),
        shape_audit=shape,
        retrace=retrace,
        membudget=membudget,
        determinism_only=args.determinism,
        donation_only=args.donation,
        device=args.device,
    )

    if args.determinism:
        # Only the determinism pass ran: JIT/ASY/RACE/DON pins are
        # unused by construction, not stale.
        result.unused_baseline = [
            e for e in result.unused_baseline if e.rule.startswith("DET")]
    if args.donation:
        # Only the donation pass ran: every other pass's pins are
        # unused by construction, not stale.
        result.unused_baseline = [
            e for e in result.unused_baseline if e.rule.startswith("DON")]

    # Stale pins are warnings in the editor loop but HARD ERRORS under
    # --ci: a fixed finding must delete its suppression in the same
    # change, or dead entries accumulate and mask the next real finding
    # that happens to match them.
    stale_fails = args.ci and bool(result.unused_baseline)
    failed = bool(result.new) or bool(result.errors) or stale_fails
    if args.json:
        print(json.dumps({
            "new": [f.__dict__ for f in result.new],
            "baselined": [
                {**f.__dict__, "reason": reason}
                for f, reason in result.baselined
            ],
            "unused_baseline": [e.render() for e in result.unused_baseline],
            "checked_files": result.checked_files,
            "shape_entries": result.shape_entries,
            "retrace_entries": result.retrace_entries,
            "membudget_entries": result.membudget_entries,
            "errors": result.errors,
            "pass": not failed,
        }, indent=2, sort_keys=True))
    else:
        for f in result.new:
            print(f.render())
        for e in result.errors:
            print(f"ERROR: {e}")
        for e in result.unused_baseline:
            prefix = "ERROR" if args.ci else "warning"
            print(f"{prefix}: stale baseline entry (matched nothing): "
                  f"{e.render()}"
                  + (" — delete it" if args.ci else ""))
        n_base = len(result.baselined)
        shapes = f"{result.shape_entries} shape contracts"
        if result.shape_entries:
            from .shape_audit import CONTRACTS, HOST_CHECKS

            shapes = (f"{len(CONTRACTS)} shape contracts + "
                      f"{len(HOST_CHECKS)} host checks")
        print(f"blance_tpu_torch.analysis: {result.checked_files} files, "
              f"{shapes}, "
              f"{result.retrace_entries} retrace budgets, "
              f"{result.membudget_entries} HBM budgets, "
              f"{len(result.new)} new finding(s), {n_base} baselined"
              + (" — FAIL" if failed else " — OK"))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
