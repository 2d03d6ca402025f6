#!/bin/bash
# Pileup purity wrapper (the port of scripts/purity.sh; reference:
# scripts/purity.sh): measures Gini purity for up to four haplotype BAMs
# via the npore_tpu_torch purity CLI. --plot needs matplotlib.
# usage: ./purity.sh <out_prefix> <bam1>[,bam2,...] [names]
set -euo pipefail
out=${1:?out_prefix}
bams=${2:?bam list}
names=${3:-}
cd "$(dirname "$0")/../.."
args=(--bams "$bams" --out_prefix "$out" --plot)
[ -n "$names" ] && args+=(--names "$names")
python3 -m npore_tpu_torch.cli.purity "${args[@]}"
