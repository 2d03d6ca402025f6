"""VCF filter CLI (reference: src/filter.py): overlap removal, plus the
pipeline's genotype-exclusion pass done in-process.

Usage:
    python -m npore_tpu_torch.cli.filter in.vcf out.vcf            # drop overlaps
    python -m npore_tpu_torch.cli.filter in.vcf out.vcf --exclude_gt 0/0

The default mode is the reference's thin wrapper over ``filter_overlaps``
(src/filter.py:5-6). ``--exclude_gt`` replaces the pipeline's external
``bcftools filter --exclude 'GT="0/0"'`` step
(reference: scripts/realign_pipeline.sh:277-279, 409-411) so the retrain
pipeline needs one fewer external tool. ``.gz`` outputs get in-process
bgzip + tabix (io/bgzf.py). The port of ``npore_tpu/cli/filter.py``.
"""
from __future__ import annotations

import argparse
import sys

from ..io.vcf import filter_gt, filter_overlaps


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("vcf", help="Input VCF.")
    p.add_argument("out", help="Output VCF.")
    p.add_argument("--exclude_gt", default=None, metavar="GT",
                   help="Drop records with this genotype (e.g. 0/0) "
                        "instead of removing overlaps.")
    args = p.parse_args(argv)
    if args.exclude_gt is not None:
        n = filter_gt(args.vcf, args.out, args.exclude_gt)
        print(f"    kept {n} records")
    else:
        filter_overlaps(args.vcf, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
