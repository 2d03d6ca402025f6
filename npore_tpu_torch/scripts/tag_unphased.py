"""Add HP:i:0 to reads lacking an HP tag (the port of
``scripts/tag_unphased.py``; reference: scripts/tag_unphased.py).

usage: python -m npore_tpu_torch.scripts.tag_unphased in.{sam,bam} out.sam
"""
import sys

from ..io.bam import open_alignment_file
from ..io.sam import make_header


def main() -> int:
    inp, out = sys.argv[1], sys.argv[2]
    bam = open_alignment_file(inp)
    n = 0
    with open(out, "w") as fh:
        for line in make_header(bam.references, bam.lengths, "tag_unphased"):
            fh.write(line + "\n")
        for rec in bam:
            if not rec.has_tag("HP"):
                rec.tags["HP"] = ("i", 0)
                n += 1
            fh.write(rec.to_line() + "\n")
    print(f"tagged {n} unphased reads")
    return 0


if __name__ == "__main__":
    sys.exit(main())
