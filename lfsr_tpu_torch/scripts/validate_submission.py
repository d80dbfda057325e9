"""Submission validator (the port of the JAX package's ``validate_submission.py``).

Structural validation of a CodaBench zip or directory with the port's
``tools.submission``: Real/ and Synth/ roots, 16 scenes each, 25
``View_i_j.bmp`` per scene, BMP header checks (24-bpp uncompressed, the
subset's dimensions) and sampled pixel statistics. Exit code 0 when VALID.

    python -m lfsr_tpu_torch.scripts.validate_submission submission.zip
"""

from __future__ import annotations

import argparse

from lfsr_tpu_torch.tools.submission import validate_submission


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("submission", help="zip file or directory")
    p.add_argument("--sample_pixels", type=int, default=3)
    args = p.parse_args(argv)
    rep = validate_submission(args.submission, args.sample_pixels)
    for w in rep.warnings:
        print(f"WARN : {w}")
    for e in rep.errors:
        print(f"ERROR: {e}")
    print(
        f"{'VALID' if rep.ok else 'INVALID'}: {rep.checks} checks, "
        f"{len(rep.errors)} errors, {len(rep.warnings)} warnings"
    )
    return 0 if rep.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
