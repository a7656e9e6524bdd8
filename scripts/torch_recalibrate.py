"""Calibrate the presets with the PyTorch port (`repro_torch.core.calibration`).

Usage:
  PYTHONPATH=src python scripts/torch_recalibrate.py --check             # freshness gate
  PYTHONPATH=src python scripts/torch_recalibrate.py --out DIR           # all presets
  PYTHONPATH=src python scripts/torch_recalibrate.py --out DIR tpu       # one preset
  PYTHONPATH=src python scripts/torch_recalibrate.py --impl torch --out DIR
  PYTHONPATH=src python scripts/torch_recalibrate.py --measured --out DIR

``--check`` calibrates each preset in the default analytic mode and
compares it with the committed ``CALIBRATION_<preset>.json`` at the repo
root, writing nothing (exit 1 when one is stale or missing).  Otherwise
each artifact is written to ``DIR/CALIBRATION_<preset>.json``; ``--out``
is required and may not be the repo root, whose artifacts this script only
reads.  ``--impl torch`` evaluates on the card (``--device cpu`` for the
CPU); ``--measured`` swaps in real wall-clock CPU test runs of the vision
programs (nondeterministic, recorded in provenance; requires the numpy
impl).  With ``--check``, ``--impl``/``--device`` pick the path that is
compared, which must equal the committed artifact's entries.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import calibration as cal  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("presets", nargs="*", default=None,
                    help=f"presets to calibrate (default: all of {sorted(cal.PRESETS)})")
    ap.add_argument("--impl", choices=("numpy", "torch"), default="numpy")
    ap.add_argument("--device", default=None,
                    help="where --impl torch evaluates (default: the card)")
    ap.add_argument("--measured", action="store_true",
                    help="wall-clock CPU test runs instead of analytic")
    ap.add_argument("--check", action="store_true",
                    help="verify the committed artifacts match a fresh analytic "
                         "calibration; write nothing")
    ap.add_argument("--out", type=pathlib.Path,
                    help="directory to write the artifacts to (required without --check)")
    args = ap.parse_args(argv)
    if args.check and args.measured:
        ap.error("--check compares analytic calibrations; drop --measured")
    names = args.presets or sorted(cal.PRESETS)
    if not args.check:
        if args.out is None:
            ap.error("--out DIR is required without --check")
        if args.out.resolve() == cal.default_artifact_path(names[0]).parent.resolve():
            ap.error("--out may not be the repo root: its CALIBRATION_*.json are read only")
    stale = []
    for name in names:
        preset = cal.PRESETS[name]
        artifact = cal.calibrate(
            preset.catalog_fn(),
            preset.workloads_fn(),
            cpu=preset.cpu,
            roofline=preset.roofline,
            impl=args.impl,
            cpu_mode="measured" if args.measured else "analytic",
            host_cores_fraction=preset.host_cores_fraction,
            device=args.device,
        )
        path = cal.default_artifact_path(name)
        if args.check:
            try:
                on_disk = cal.CalibrationArtifact.load(path)
            except (OSError, ValueError, KeyError):
                on_disk = None
            # The provenance records the impl, so the entries carry the
            # comparison when the torch path is checked.
            fresh = on_disk is not None and (
                on_disk == artifact if args.impl == "numpy"
                else on_disk.entries == artifact.entries
                and on_disk.catalog_signature == artifact.catalog_signature)
            print(f"{path.name}: {'fresh' if fresh else 'STALE'} "
                  f"({len(artifact.entries)} entries, sig {artifact.catalog_signature}, "
                  f"impl {args.impl})")
            if not fresh:
                stale.append(name)
            continue
        args.out.mkdir(parents=True, exist_ok=True)
        out = args.out / path.name
        artifact.save(out)
        print(f"wrote {out}: {len(artifact.entries)} profiles over "
              f"{len(artifact.programs())} programs, catalog sig "
              f"{artifact.catalog_signature}, mode "
              f"{artifact.provenance['cpu_mode']}/{artifact.provenance['impl']}")
        for e in artifact.entries:
            req = ", ".join(f"{x:.4g}" for x in e.requirement)
            print(f"  {e.program_id:24s} {e.device:5s} [{req}] "
                  f"max {e.max_fps:.4g} fps ({e.source})")
    if stale:
        print(f"stale artifacts: {stale}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
