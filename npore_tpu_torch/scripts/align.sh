#!/bin/bash
# Aligner wrapper (reference: scripts/align.sh): minimap2 map-ont with --eqx
# extended CIGARs, then sort + calmd + index. Requires minimap2/samtools on
# PATH (external tools; not bundled in this repo's environment).
#
# usage: ./align.sh <reads.{fastq,sam,bam}> <ref.fasta> <out_prefix> [threads]
set -euo pipefail

reads=$1
ref=$2
out=$3
threads=${4:-$(nproc)}

case "$reads" in
  *.fastq|*.fq|*.fastq.gz|*.fq.gz)
    minimap2 -ax map-ont --eqx -t "$threads" "$ref" "$reads" > "$out.sam"
    ;;
  *.sam|*.bam)
    # re-align existing alignments' reads
    samtools fastq "$reads" > "$out.tmp.fastq"
    minimap2 -ax map-ont --eqx -t "$threads" "$ref" "$out.tmp.fastq" > "$out.sam"
    rm -f "$out.tmp.fastq"
    ;;
  *)
    echo "ERROR: unsupported input '$reads'" >&2; exit 1
    ;;
esac

samtools sort -@ "$threads" -o "$out.sorted.bam" "$out.sam"
samtools calmd -@ "$threads" -b "$out.sorted.bam" "$ref" > "$out.bam" 2>/dev/null
samtools index "$out.bam"
rm -f "$out.sam" "$out.sorted.bam"
echo "wrote $out.bam"
