"""Sankey INDEL analysis of hap.py-annotated VCFs (the port of
``scripts/plot_sankey.py``; reference: scripts/plot_sankey.py; flow
rendering in scripts/sankey.py -> ./sankey.py).

Classifies every variant of hap.py output VCFs by variant type
(substitution / insertion / deletion / complex), call type (TP / FN / FP)
and — for true INDELs — copy-number-variant status, testing the ±20bp
reference context with the n-polymer scanner exactly like the reference
(scripts/plot_sankey.py:117-150). Aggregates per n-polymer region stratum
(np_0 .. np_max_n VCFs from hap.py BED-stratified runs), draws the pie
charts and the two 3-column sankey figures (region sizes -> errors by
region -> error types; region sizes -> true INDELs -> CNV vs general).

usage: python -m npore_tpu_torch.scripts.plot_sankey \
           --vcfs 'path/g5-$-eval.vcf' --ref ref.fasta \
           [--beds 'path/$.bed'] [--out_dir img]

``$`` in --vcfs/--beds expands to the stratum name (all, np_0..np_6).
"""
import argparse
import gzip
import multiprocessing as mp
import os
import sys
from functools import partial

import numpy as np

from ..constants import bases_to_int
from ..io.fasta import FastaFile
from ..native import np_info as get_np_info

# variant types (reference :16-31)
SUB, INS, DEL, CPX = 0, 1, 2, 3
VARIANTS = {"substitution": SUB, "insertion": INS, "deletion": DEL,
            "complex": CPX}
TYPES = {"t": "substitution", "i": "insertion", "d": "deletion",
         "c": "complex"}

# call types (reference :34-37)
TP, FN, FP = 0, 1, 2
CALLS = {"TP": TP, "FN": FN, "FP": FP}

# CNV flags (reference :40-43)
FALSE, TRUE = 0, 1
L, L_IDX = 0, 1
CTX = 20


class VcfCounts:
    """Aggregate variant counts by type (reference :46-66)."""

    def __init__(self):
        self.types = np.zeros((4, 3), dtype=int)
        self.cnvs = np.zeros(2, dtype=int)

    def __str__(self):
        t = self.types
        return (
            f"Overview\n"
            f"SUBs:     {t[SUB][TP]:7} TP\t{t[SUB][FN]:5} FN\t{t[SUB][FP]:5} FP\n"
            f"INSs:     {t[INS][TP]:7} TP\t{t[INS][FN]:5} FN\t{t[INS][FP]:5} FP\n"
            f"DELs:     {t[DEL][TP]:7} TP\t{t[DEL][FN]:5} FN\t{t[DEL][FP]:5} FP\n"
            f"COMPLEXs: {t[CPX][TP]:7} TP\t{t[CPX][FN]:5} FN\t{t[CPX][FP]:5} FP\n"
            f"CNVs:     {self.cnvs[TRUE]} INDELs are, "
            f"{self.cnvs[FALSE]} INDELs are not.\n")

    def add(self, variant, call):
        if call and call != ".":
            self.types[VARIANTS[variant], CALLS[call]] += 1


def _open(path):
    return gzip.open(path, "rt") if path.endswith(".gz") else open(path)


def _sample(fmt_keys, col, key):
    """hap.py per-sample field: '.'-> '.', 'a,b' -> tuple (pysam parity)."""
    try:
        v = col[fmt_keys.index(key)]
    except (ValueError, IndexError):
        return "."
    return tuple(v.split(",")) if "," in v else v


def _gt(fmt_keys, col):
    v = _sample(fmt_keys, col, "GT")
    if isinstance(v, tuple):
        v = v[0]
    out = []
    for tok in str(v).replace("|", "/").split("/"):
        out.append(None if tok in (".", "") else int(tok))
    return tuple(out)


def count(vcf_fn, refs):
    """Count call/variant types + CNV status (reference :70-151).

    hap.py VCFs carry two samples, TRUTH then QUERY, with BD (call) and
    BI (type) per sample."""
    data = VcfCounts()
    with _open(vcf_fn) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            f = line.rstrip("\n").split("\t")
            ctg, pos = f[0], int(f[1]) - 1
            alleles = (f[3],) + tuple(a for a in f[4].split(",")
                                      if a != ".")
            fmt_keys = f[8].split(":")
            truth = f[9].split(":")
            query = f[10].split(":") if len(f) > 10 else []
            ref_call = _sample(fmt_keys, truth, "BD")
            query_call = _sample(fmt_keys, query, "BD")
            ref_gt = _gt(fmt_keys, truth)
            query_gt = _gt(fmt_keys, query)
            ref_type = _sample(fmt_keys, truth, "BI")
            query_type = _sample(fmt_keys, query, "BI")

            # call-type counting incl. complex detection (reference :85-103)
            if len(alleles) > 2 or isinstance(ref_type, tuple):
                if ref_type != ".":
                    if isinstance(ref_type, tuple) or \
                            len(set(x for x in ref_gt if x)) > 1:
                        data.add("complex", ref_call)
                    else:
                        data.add(TYPES[ref_type[0]], ref_call)
                if query_type != "." and query_call != "TP":
                    if isinstance(query_type, tuple) or \
                            len(set(x for x in query_gt if x)) > 1:
                        data.add("complex", query_call)
                    else:
                        data.add(TYPES[query_type[0]], query_call)
            else:
                if ref_type != ".":
                    data.add(TYPES[ref_type[0]], ref_call)
                if query_type != "." and query_call != "TP":
                    data.add(TYPES[query_type[0]], query_call)

            # CNV test on true (TP+FN) non-complex INDELs (reference :106-150)
            if ref_type == "." or ctg not in refs:
                continue
            if not ((len(alleles) <= 2 and not isinstance(ref_type, tuple))
                    or (isinstance(ref_type, tuple)
                        and len(set(x for x in ref_gt if x)) == 1)):
                continue
            ref_t = TYPES.get(ref_type[0])
            nz = [x for x in ref_gt if x]
            if not nz or nz[0] >= len(alleles):
                continue
            if ref_t == "insertion":
                ref_al = alleles[0]
                alt = alleles[nz[0]]
                p = pos + len(ref_al)
                ins = alt[len(ref_al):]
                refseq = refs[ctg][p:p + CTX]
                if not refseq or not ins:
                    continue
                info_r = get_np_info(
                    bases_to_int(refseq.upper()).astype(np.uint8))
                info_s = get_np_info(
                    bases_to_int((ins + refseq).upper()).astype(np.uint8))
                cnv = False
                for n in range(1, 7):
                    if info_r[0, L, n - 1] and info_s[0, L, n - 1]:
                        if len(ins) % n == 0 and ins[:n] == refseq[:n]:
                            data.cnvs[TRUE] += 1
                            cnv = True
                            break
                if not cnv:
                    data.cnvs[FALSE] += 1
            elif ref_t == "deletion":
                ref_al = alleles[0]
                alt = alleles[nz[0]]
                p = pos + len(alt)
                dell = ref_al[len(alt):]
                refseq = refs[ctg][p:p + CTX]
                if not refseq or not dell:
                    continue
                info_r = get_np_info(
                    bases_to_int(refseq.upper()).astype(np.uint8))
                cnv = False
                for n in range(1, 7):
                    if info_r[0, L, n - 1] and len(dell) % n == 0:
                        data.cnvs[TRUE] += 1
                        cnv = True
                        break
                if not cnv:
                    data.cnvs[FALSE] += 1
    return data


def pyplot():
    """matplotlib's pyplot on the Agg backend. Only the figures import it:
    counting the calls and ``--help`` run without matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def disc_pie(data, out_dir, suffix=""):
    """True-variant type distribution (reference :155-163)."""
    plt = pyplot()
    plt.subplots()
    plt.pie(data.types[:, TP] + data.types[:, FN],
            labels=list(VARIANTS.keys()), autopct="%1.1f%%", startangle=90)
    plt.suptitle(suffix)
    plt.tight_layout()
    plt.savefig(f"{out_dir}/disc_pie{'_' if suffix else ''}{suffix}.png",
                dpi=300)
    plt.close()


def error_pie(data, out_dir, suffix=""):
    """Per-type call outcome pies (reference :167-178)."""
    plt = pyplot()
    fig, ax = plt.subplots(2, 2)
    for x in range(2):
        for y in range(2):
            i = x * 2 + y
            ax[x, y].pie(data.types[i, :], labels=list(CALLS.keys()),
                         colors=["#12e23f", "#f71b1b", "#f78c1b"],
                         autopct="%1.1f%%", startangle=90)
            ax[x, y].set_title(list(VARIANTS.keys())[i])
    plt.suptitle(suffix)
    plt.tight_layout()
    plt.savefig(f"{out_dir}/call_pie{'_' if suffix else ''}{suffix}.png",
                dpi=300)
    plt.close()


def make_colors(max_n):
    """Reference color scheme incl. n-polymer grayscale (:367-380)."""
    colors = {
        "Substitutions": "#f78c1b", "General INDEL": "#1b7ef7",
        "Copy Number INDEL": "#9912c9", "Insertions": "#9bd937",
        "Deletions": "#f71b1b", "Complex": "#ffff66",
        "False Negative": "#f71b1b", "True Positive": "#12e23f",
        "False Positive": "#f78c1b",
    }
    chars = "0123456789ABCDEF"
    for n in range(max_n + 1):
        colors[f"{n}-Polymer" if n else "Other"] = f"#{chars[12-2*n]*6}"
    return colors


def plot_sankey(np_data, np_sizes, out_dir, max_n=6):
    """The two 3-column flows (reference :182-287)."""
    from .sankey import sankey     # imports matplotlib
    colors = make_colors(max_n)
    strata = ["Other"] + [f"{i}-Polymer" for i in range(1, max_n + 1)]

    # sankey 1: region sizes -> errors by region -> error types
    total_size = sum(np_sizes[f"np_{i}"] for i in range(max_n + 1))
    lw0 = [np_sizes[f"np_{i}"] / total_size for i in range(max_n + 1)]
    total_err = sum(np.sum(np_data[i].types[:, 1:])
                    for i in range(max_n + 1)) or 1
    rw0 = [np.sum(np_data[i].types[:, 1:]) / total_err
           for i in range(max_n + 1)]
    left1 = strata * 4
    right1 = (["Substitutions"] * 7 + ["Insertions"] * 7 +
              ["Deletions"] * 7 + ["Complex"] * 7)
    total = np.sum([x.types[:, 1:] for x in np_data]) or 1
    w1 = [np.sum(np_data[np_idx].types[et, 1:]) / total
          for et in range(4) for np_idx in range(max_n + 1)]
    sankey(lefts=[strata, left1], rights=[strata, right1], colors=colors,
           leftWeights=[lw0, w1], rightWeights=[rw0, w1],
           rightColors=[False, True], gaps=[False, False],
           bottoms=["Relative\nRegion Sizes", "Errors\nby Region",
                    "Variant Call\nError Types"],
           fontsize=12, figureName=f"{out_dir}/sankey1")

    # sankey 2: region sizes -> true INDELs by region -> CNV vs general
    tot_ind = sum(np.sum(np_data[i].types[INS, :2]) +
                  np.sum(np_data[i].types[DEL, :2])
                  for i in range(max_n + 1)) or 1
    rw4 = [(np.sum(np_data[i].types[INS, :2]) +
            np.sum(np_data[i].types[DEL, :2])) / tot_ind
           for i in range(max_n + 1)]
    left5 = ["Other"] * 2 + [f"{n}-Polymer"
                             for i in range(1, max_n + 1) for n in (i, i)]
    right5 = ["General INDEL", "Copy Number INDEL"] * (max_n + 1)
    tot_cnv = np.sum([x.cnvs[:] for x in np_data]) or 1
    w5 = [w / tot_cnv for i in range(max_n + 1)
          for w in (np_data[i].cnvs[FALSE], np_data[i].cnvs[TRUE])]
    sankey(lefts=[strata, left5], rights=[strata, right5], colors=colors,
           leftWeights=[lw0, w5], rightWeights=[rw4, w5],
           rightColors=[False, True], gaps=[False, False],
           bottoms=["Relative\nRegion Sizes", "True INDELs\nby Region",
                    "True INDEL\nVariant Types"],
           fontsize=12, figureName=f"{out_dir}/sankey2")


def get_region_sizes(beds, max_n=6):
    """Total bp per stratum BED (reference :292-309)."""
    sizes = {"all": 0, "np_all": 0}
    for i in range(max_n + 1):
        sizes[f"np_{i}"] = 0
    for name in sizes:
        path = beds.replace("$", name)
        if not os.path.exists(path):
            continue
        with open(path) as fh:
            for line in fh:
                r = line.strip().split()
                if len(r) >= 3:
                    sizes[name] += int(r[2]) - int(r[1])
    return sizes


def main(args) -> int:
    os.makedirs(args.out_dir, exist_ok=True)
    print("> extracting reference contigs")
    fa = FastaFile(args.ref)
    refs = {c: fa.fetch(c) for c in
            (args.contigs.split(",") if args.contigs else fa.references)}

    print("> calculating 'all' stats")
    all_data = count(args.vcfs.replace("$", "all"), refs)
    print("> plotting 'all'")
    disc_pie(all_data, args.out_dir)
    error_pie(all_data, args.out_dir)
    print("ALL")
    print(all_data)

    print("> calculating BED sizes")
    sizes = get_region_sizes(args.beds, args.max_n) if args.beds else {}
    if not sizes or not any(sizes.get(f"np_{i}", 0)
                            for i in range(args.max_n + 1)):
        # reference hardcodes its GRCh38 sizes when BEDs are absent (:331-341)
        sizes = {"all": 2875001522, "np_all": 1050014093,
                 "np_0": 1824987429, "np_1": 960760575, "np_2": 83289186,
                 "np_3": 16369108, "np_4": 9977189, "np_5": 3393943,
                 "np_6": 1162724}
    for name, size in sizes.items():
        print(f"{name}: {size}")

    worker = partial(count, refs=refs)
    vcfs = [args.vcfs.replace("$", f"np_{i}")
            for i in range(args.max_n + 1)]
    if args.serial:
        np_data = [worker(v) for v in vcfs]
    else:
        with mp.Pool() as pool:
            np_data = pool.map(worker, vcfs)

    for i in range(args.max_n + 1):
        disc_pie(np_data[i], args.out_dir, suffix=f"np{i}")
        error_pie(np_data[i], args.out_dir, suffix=f"np{i}")
        print(f"NP {i}")
        print(np_data[i])

    plot_sankey(np_data, sizes, args.out_dir, args.max_n)
    print(f"wrote {args.out_dir}/sankey1.png, {args.out_dir}/sankey2.png")
    return 0


def argparser():
    p = argparse.ArgumentParser()
    p.add_argument("--ref", required=True)
    p.add_argument("--vcfs", required=True,
                   help="hap.py VCF path pattern; $ -> stratum name")
    p.add_argument("--beds", default=None,
                   help="BED path pattern; $ -> stratum name")
    p.add_argument("--contigs", default=None,
                   help="comma-separated contigs (default: all in ref)")
    p.add_argument("--max_n", type=int, default=6)
    p.add_argument("--max_l", type=int, default=100)
    p.add_argument("--out_dir", default="img")
    p.add_argument("--serial", action="store_true")
    return p


if __name__ == "__main__":
    sys.exit(main(argparser().parse_args()))
