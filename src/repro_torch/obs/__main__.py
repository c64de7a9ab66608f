"""Observability CLI — artifact validation, calibration, and the
measured-vs-predicted regression sentinel; port of ``python -m repro.obs``:

    python -m repro_torch.obs --validate-snapshot metrics.json
    python -m repro_torch.obs --validate-trace trace.json
    python -m repro_torch.obs --calibrate --plan-cache plans.json \\
        --metrics metrics.json --calibration calibration.json
    python -m repro_torch.obs --validate-calibration calibration.json
    python -m repro_torch.obs --check-regressions --plan-cache plans.json \\
        --calibration calibration.json --report-out report.md

``--calibrate`` fits the perf-model constants (``obs.perfmodel``) from
the measurement sources given (``--plan-cache`` autotune timings,
``--bench`` files of ``kernels.ops.profile_gemm`` rows, ``--metrics``
serve snapshots with ``kernel_gemm_s`` series; the plan cache at its
default path when none is named), in the partition most samples belong
to, and writes a versioned calibration.json.  From the ``shard_variants``
tables of the same plan caches it also fits the collective-time term
(``obs.perfmodel.fit_collective``, the calibration's ``collective``
block; left out when the tables hold too few rows) and prints how many
variant rows the fit used.

``--check-regressions`` reads the same sources and fails (exit 1) when
any timing of the calibration's partition exceeds ``--tolerance`` x the
model's prediction.  Nothing here needs a card: a cache and snapshot
measured on one are checked anywhere.

Exit 0 when every requested action passes; exit 1 with one problem per
line otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.obs import perfmodel as pm
from repro_torch.obs import validate_snapshot_file, validate_trace_file


def _plan_caches(args) -> list:
    """The plan caches the CLI reads (None: the process default, when no
    source is named)."""
    if not args.plan_cache and not args.bench and not args.metrics:
        return [None]
    return list(args.plan_cache)


def _gather_samples(args) -> tuple[list, list]:
    """(samples, source descriptions) from the CLI's source flags."""
    samples: list = []
    sources: list = []
    for p in _plan_caches(args):
        got, untagged = pm.samples_from_plan_cache(p)
        samples += got
        sources.append(f"plan-cache:{p or 'default'}")
        if untagged:
            print(f"note: skipped {untagged} untagged timing row(s) in "
                  f"{p or 'default plan cache'}", file=sys.stderr)
    for p in args.bench:
        samples += pm.samples_from_bench(p)
        sources.append(f"bench:{p}")
    for p in args.metrics:
        samples += pm.samples_from_snapshot(json.loads(Path(p).read_text()))
        sources.append(f"metrics:{p}")
    return samples, sources


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    ap.add_argument("--validate-snapshot", action="append", default=[],
                    metavar="PATH", help="metrics snapshot JSON to check")
    ap.add_argument("--validate-trace", action="append", default=[],
                    metavar="PATH", help="Chrome-trace JSON to check")
    ap.add_argument("--validate-calibration", action="append", default=[],
                    metavar="PATH", help="perf-model calibration to check")
    ap.add_argument("--calibrate", action="store_true",
                    help="fit perf-model constants from the measurement "
                         "sources and write --calibration")
    ap.add_argument("--check-regressions", action="store_true",
                    help="compare measured timings against the calibrated "
                         "model; exit 1 on outliers")
    ap.add_argument("--plan-cache", action="append", default=[],
                    metavar="PATH", help="plan cache JSON with autotune "
                                         "timings (measurement source)")
    ap.add_argument("--bench", action="append", default=[], metavar="PATH",
                    help="JSON list of kernels.ops.profile_gemm rows "
                         "(measurement source)")
    ap.add_argument("--metrics", action="append", default=[],
                    metavar="PATH", help="metrics snapshot with "
                                         "kernel_gemm_s series (source)")
    ap.add_argument("--calibration", default=None, metavar="PATH",
                    help="calibration.json path (default: "
                         "$REPRO_CALIBRATION or the user cache dir)")
    ap.add_argument("--tolerance", type=float,
                    default=pm.DEFAULT_TOLERANCE,
                    help="regression band: measured > tolerance*predicted "
                         "fails (default %(default)s)")
    ap.add_argument("--report-out", default=None, metavar="PATH",
                    help="write the ranked regression report (markdown)")
    args = ap.parse_args(argv)
    if not (args.validate_snapshot or args.validate_trace
            or args.validate_calibration or args.calibrate
            or args.check_regressions):
        ap.error("nothing to do")

    problems: list[str] = []
    for p in args.validate_snapshot:
        problems += [f"{p}: {e}" for e in validate_snapshot_file(p)]
    for p in args.validate_trace:
        problems += [f"{p}: {e}" for e in validate_trace_file(p)]
    for p in args.validate_calibration:
        problems += [f"{p}: {e}" for e in pm.validate_calibration_file(p)]

    calib_path = args.calibration or pm.default_calibration_path()

    if args.calibrate:
        try:
            samples, sources = _gather_samples(args)
            cal = pm.fit(samples, sources=sources)
        except ValueError as e:
            problems.append(f"calibrate: {e}")
        else:
            rows = [r for p in _plan_caches(args)
                    for r in pm.collective_rows_from_plan_cache(p)]
            coll = pm.fit_collective(rows, device=cal.device)
            if coll is not None:
                cal.collective = coll
            out = cal.save(calib_path)
            print(f"calibrated {cal.device} interpret={cal.interpret} "
                  f"from {cal.fit['n_samples']} samples (rms rel err "
                  f"{cal.fit['rms_rel_err']:.2f}, median "
                  f"{cal.fit['median_abs_rel_err']:.2f}, max "
                  f"{cal.fit['max_abs_rel_err']:.2f}); collective term "
                  + (f"from {coll['n_samples']} variant rows (rms err "
                     f"{coll['rms_err_s']:.3e} s)" if coll else
                     f"not fitted ({len(rows)} variant rows)")
                  + f" -> {out}")

    if args.check_regressions and not problems:
        cal = pm.load_calibration(calib_path)
        if cal is None:
            problems.append(f"check-regressions: no valid calibration at "
                            f"{calib_path}; run --calibrate first")
        else:
            try:
                samples, _ = _gather_samples(args)
            except ValueError as e:
                samples = []
                problems.append(f"check-regressions: {e}")
            report = pm.check_regressions(samples, cal,
                                          tolerance=args.tolerance)
            text = pm.render_report(report)
            if args.report_out:
                Path(args.report_out).parent.mkdir(parents=True,
                                                   exist_ok=True)
                Path(args.report_out).write_text(text + "\n")
            print(text)
            if not report["n_samples"]:
                problems.append("check-regressions: no samples in the "
                                "calibration's partition; nothing to "
                                "check")
            elif not report["ok"]:
                problems.append(
                    f"check-regressions: {report['n_outliers']} "
                    f"measurement(s) slower than {args.tolerance:g}x the "
                    "model prediction")

    if problems:
        print("\n".join(problems), file=sys.stderr)
        return 1
    n = (len(args.validate_snapshot) + len(args.validate_trace)
         + len(args.validate_calibration))
    if n:
        print(f"ok: {n} artifact(s) schema-valid")
    return 0


if __name__ == "__main__":
    sys.exit(main())
