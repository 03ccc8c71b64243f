"""The paper's figures from measured data: AP against pose noise or delay,
the methods' added parameters against the number of agent types, and AP
against frames a second or training cost.

Counterpart of ``gencomm_tpu/visualization/paper_plots.py``: the curves
come from the ``eval_noise_*`` / ``eval_delay_*`` yamls that
``tools/inference_w_noise.py`` and ``inference_w_delay.py`` write, and
GenComm's added parameters are counted on the port's own message
extractor (``measured_gencomm_added_params``). Every function takes data
and writes a PNG; matplotlib is imported when a function draws.

    python -m gencomm_tpu_torch.visualization.paper_plots \
        [--model_dir <run>] [--out plots]
"""

from __future__ import annotations

import argparse
import glob
import os
import re
from typing import Dict, Mapping, Sequence

import numpy as np

# each method's added parameters a new agent type (M), the poster's #P(M)
# column: the scalability plot's default
ADDED_PARAMS_M = {
    "GenComm": 0.31,
    "STAMP": 1.64,
    "CodeFilling": 0.81,
    "MPDA": 5.75,
    "BackAlign": 31.18,
}


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def ap_curve_series(results: Mapping[float, Mapping[str, float]],
                    keys: Sequence[str] = ("ap50", "ap70")):
    """(levels, {key: APs}) of ``plot_ap_curve``; a missing AP is NaN."""
    levels = sorted(results)
    return levels, {k: [results[lv].get(k, np.nan) for lv in levels]
                    for k in keys}


def plot_ap_curve(results: Mapping[float, Mapping[str, float]], out: str,
                  xlabel: str, keys: Sequence[str] = ("ap50", "ap70")) -> str:
    """AP against a robustness level; ``results`` {level: {"ap50": ..}}."""
    plt = _plt()
    levels, series = ap_curve_series(results, keys)
    fig, ax = plt.subplots(figsize=(5, 3.5))
    for key, ys in series.items():
        ax.plot(levels, ys, marker="o", label=key.replace("ap", "AP@0."))
    ax.set_xlabel(xlabel)
    ax.set_ylabel("AP")
    ax.grid(alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


def scalability_series(added_params_m: Mapping[str, float] | None = None,
                       max_agents: int = 8):
    """(agent types 1..max_agents, {method: added params}) of
    ``plot_scalability``."""
    params = dict(added_params_m or ADDED_PARAMS_M)
    agents = np.arange(1, max_agents + 1)
    return agents, {m: per * agents for m, per in params.items()}


def plot_scalability(out: str,
                     added_params_m: Mapping[str, float] | None = None,
                     max_agents: int = 8) -> str:
    """Added collaboration parameters against the number of agent types,
    log scale."""
    plt = _plt()
    agents, series = scalability_series(added_params_m, max_agents)
    fig, ax = plt.subplots(figsize=(5, 3.5))
    for method, ys in series.items():
        ax.plot(agents, ys, marker="s", label=method)
    ax.set_xlabel("# agent types")
    ax.set_ylabel("added params (M)")
    ax.set_yscale("log")
    ax.grid(alpha=0.3, which="both")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


def plot_scatter(points: Mapping[str, tuple], out: str, xlabel: str,
                 ylabel: str = "AP@0.5") -> str:
    """Methods as points {name: (x, ap)}: AP against fps or training
    cost."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 3.5))
    for name, (x, ap) in points.items():
        ax.scatter([x], [ap], s=60)
        ax.annotate(name, (x, ap), textcoords="offset points",
                    xytext=(5, 5), fontsize=8)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


def measured_gencomm_added_params() -> float:
    """The parameters (M) GenComm adds a new agent type in the port: its
    message extractor on a 128-channel feature (the diffusion and the
    Enhancer are shared)."""
    import torch

    from gencomm_tpu_torch.models.gencomm.message_extractor import (
        MessageExtractor,
    )
    from gencomm_tpu_torch.tools.profiler import param_count

    with torch.device("meta"):
        mod = MessageExtractor(in_ch=128, out_ch=2)
    return param_count(mod) / 1e6


def collect_sweep(model_dir: str, kind: str) -> Dict[float, Dict[str, float]]:
    """{level: APs} from a run's ``eval_{kind}_<level>*.yaml`` files."""
    import yaml

    results: Dict[float, Dict[str, float]] = {}
    for path in glob.glob(os.path.join(model_dir, f"eval_{kind}_*.yaml")):
        m = re.search(rf"eval_{kind}_([0-9]+(?:\.[0-9]+)?)",
                      os.path.basename(path))
        if not m:
            continue
        with open(path) as f:
            results[float(m.group(1))] = yaml.safe_load(f) or {}
    return results


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_dir", default=None,
                    help="read eval_noise_* / eval_delay_* yamls from here")
    ap.add_argument("--out", default="plots")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    wrote = [plot_scalability(os.path.join(args.out, "scalability.png"))]
    if args.model_dir:
        for kind, xlabel in (("noise", "pose noise sigma (m / deg)"),
                             ("delay", "comm delay (ms)")):
            res = collect_sweep(args.model_dir, kind)
            if res:
                wrote.append(plot_ap_curve(
                    res, os.path.join(args.out, f"ap_vs_{kind}.png"), xlabel))
    print("wrote", wrote)
    return wrote


if __name__ == "__main__":
    main()
