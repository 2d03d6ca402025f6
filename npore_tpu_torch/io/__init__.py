"""Host-side I/O: SAM/BAM/FASTA codecs and the pileup engine (the port's
copies of ``npore_tpu/io``; VCF I/O is not here yet).

These replace the reference's external native dependencies (pysam/htslib,
samtools mpileup; reference: requirements.txt:1, src/bam.pyx:303) with
self-contained implementations.
"""
