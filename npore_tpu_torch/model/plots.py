"""Confusion/score matrix plots (reference: src/bam.pyx:207-296,
src/aln.pyx:100-172). Observability aids; matplotlib is imported lazily so
headless deployments without it still run the compute paths."""
from __future__ import annotations

import os

import numpy as np

from ..constants import BASES, NBASES


def plot_confusion_matrices(subs, nps, inss, dels, stats_dir: str,
                            max_n: int = 6, max_l: int = 10,
                            eps: float = 0.01) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(stats_dir, exist_ok=True)
    for n in range(max_n):
        fig, ax = plt.subplots(figsize=(max_l, max_l))
        block = nps[n, :max_l, :max_l]
        ax.matshow(block / (1 + block.sum(axis=1)[:, None]),
                   cmap=plt.cm.Blues, alpha=0.5)
        for i in range(max_l):
            total = nps[n, i, :max_l].sum()
            for j in range(max_l):
                count = int(nps[n, i, j])
                frac = (count + eps) / (total + eps)
                ax.text(x=j, y=i,
                        s=f"{count}\n{frac*100:.1f}%\n{-np.log(frac):.2f}",
                        va="center", ha="center")
        plt.ylabel("Actual")
        plt.xlabel("Predicted")
        plt.title(f"{n+1}-Polymer Confusion Matrix")
        ax.set_xticks(range(max_l))
        ax.set_yticks(range(max_l))
        plt.tight_layout()
        plt.savefig(f"{stats_dir}/{n+1}-polymer_cm.png", dpi=200)
        plt.close()

    fig, ax = plt.subplots(figsize=(NBASES, NBASES))
    ax.matshow(subs, cmap=plt.cm.Greys, alpha=0.5)
    for i in range(NBASES):
        total = subs[i].sum()
        for j in range(NBASES):
            count = int(subs[i, j])
            frac = (count + eps) / (total + eps)
            ax.text(x=j, y=i,
                    s=f"{count}\n{frac*100:.1f}%\n{-np.log(frac):.2f}",
                    va="center", ha="center")
    plt.ylabel("Actual")
    plt.xlabel("Predicted")
    ax.set_xticks(range(NBASES))
    ax.set_xticklabels(BASES)
    ax.set_yticks(range(NBASES))
    ax.set_yticklabels(BASES)
    plt.title("Substitutions Confusion Matrix")
    plt.tight_layout()
    plt.savefig(f"{stats_dir}/subs_cm.png", dpi=200)
    plt.close()

    fig, ax = plt.subplots(2, 1, figsize=(max_l, 5))
    ax[0].matshow(inss[None, :max_l], cmap=plt.cm.Greens, alpha=0.5)
    ax[1].matshow(dels[None, :max_l], cmap=plt.cm.Reds, alpha=0.5)
    ax[0].set_ylabel("INSs")
    ax[1].set_ylabel("DELs")
    plt.suptitle("INDEL Confusion Matrices")
    plt.tight_layout()
    plt.savefig(f"{stats_dir}/indels_cm.png", dpi=200)
    plt.close()


def plot_np_score_matrices(np_scores, stats_dir: str, max_n: int = 6,
                           med_np_len: int = 20) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(stats_dir, exist_ok=True)
    for n in range(max_n):
        plt.figure(figsize=(med_np_len, med_np_len))
        plt.matshow(np_scores[n, :med_np_len, :med_np_len], cmap="RdYlGn_r")
        for i in range(med_np_len):
            for j in range(med_np_len):
                plt.text(x=j, y=i, s=f"{np_scores[n, i, j]:.1f}", fontsize=5,
                         va="center", ha="center")
        plt.xlabel("Called")
        plt.ylabel("Actual")
        plt.title(f"{n+1}-Polymer Score Matrix")
        plt.savefig(f"{stats_dir}/{n+1}-polymer_scores.png", dpi=150)
        plt.close()
