#!/bin/bash
# n-polymer BED wrapper (the port of scripts/calc_beds.sh; reference:
# scripts/calc_beds.sh), pointed at the npore_tpu_torch bed CLI.
# usage: ./calc_beds.sh <ref.fasta> <regions.bed> <out_prefix>
set -euo pipefail
ref=${1:?ref.fasta}
bed=${2:?regions.bed}
out=${3:?out_prefix}
cd "$(dirname "$0")/../.."
python3 -m npore_tpu_torch.cli.bed --ref "$ref" --bed "$bed" --out_prefix "$out"
