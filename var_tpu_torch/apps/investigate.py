"""Post-hoc analysis over per-image JSON records (counterpart of
``var_tpu/apps/investigate.py``; reference ``size_data_investigation.py``):
numpy over the records, no model code and no device::

    python -m var_tpu_torch.apps.investigate --records_dir analysis_out/ [--plot]

Consumes the ``*.json`` records written by ``apps/analysis.py`` for one or
more models and reports:

* per-model accuracy + agreement / disagreement split (ref
  ``analyze_model_differences``, :36-74)
* confusion patterns: most-confused (label -> pred) pairs per model
  (ref ``analyze_confusion_patterns``, :75-136)
* per-scale accuracy gaps between models (ref
  ``analyze_layer_differences``, :137-199)
* margin analysis: score gap between top-1 and the true class.

``--plot`` (matplotlib) draws each model's confusion matrix.
"""

from __future__ import annotations

import collections
import glob
import json
import os
from typing import Dict, List

import numpy as np


def load_records(out_dir: str) -> List[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        if path.endswith(("summary.json", "investigation.json")):
            continue
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def model_names(recs: List[dict]) -> List[str]:
    return [k for k in recs[0] if k != "label"]


def analyze_model_differences(recs: List[dict]) -> dict:
    names = model_names(recs)
    out: Dict[str, dict] = {n: {"acc": float(np.mean([r[n]["correct"] for r in recs]) * 100)}
                            for n in names}
    if len(names) == 2:
        a, b = names
        both = sum(r[a]["correct"] and r[b]["correct"] for r in recs)
        only_a = sum(r[a]["correct"] and not r[b]["correct"] for r in recs)
        only_b = sum(r[b]["correct"] and not r[a]["correct"] for r in recs)
        neither = len(recs) - both - only_a - only_b
        out["agreement"] = {"both_correct": both, f"only_{a}": only_a,
                            f"only_{b}": only_b, "neither": neither}
    return out


def analyze_confusion_patterns(recs: List[dict], top: int = 10) -> dict:
    """The ``top`` most frequent wrong (label, pred) pairs per model, by
    count descending, ties by (label, pred) ascending."""
    out = {}
    for n in model_names(recs):
        pairs = collections.Counter((int(r["label"]), int(r[n]["pred"])) for r in recs
                                    if r["label"] != r[n]["pred"])
        ranked = sorted(pairs.items(), key=lambda kv: (-kv[1], kv[0]))[:top]
        out[n] = {f"{lbl}->{pred}": c for (lbl, pred), c in ranked}
    return out


def analyze_layer_differences(recs: List[dict]) -> dict:
    names = model_names(recs)
    out = {}
    for n in names:
        cps = np.asarray([r[n]["correct_per_scale"] for r in recs], float)
        ccs = np.asarray([r[n]["correct_cumulative"] for r in recs], float)
        out[n] = {"acc_per_scale": (cps.mean(0) * 100).tolist(),
                  "acc_cumulative": (ccs.mean(0) * 100).tolist()}
    if len(names) == 2:
        a, b = names
        out["gap_per_scale"] = (np.asarray(out[b]["acc_per_scale"]) -
                                np.asarray(out[a]["acc_per_scale"])).tolist()
    return out


def analyze_margins(recs: List[dict]) -> dict:
    out = {}
    for n in model_names(recs):
        margins = []
        for r in recs:
            scores = np.asarray(r[n]["per_scale"]).sum(axis=1)  # (C,) total ll
            true = scores[r["label"]] if r["label"] < len(scores) else np.nan
            margins.append(float(np.max(scores) - true))
        m = np.asarray(margins)
        out[n] = {"mean_margin_to_top": float(np.nanmean(m)),
                  "median_margin_to_top": float(np.nanmedian(m))}
    return out


def plot_confusion(recs: List[dict], name: str, num_classes: int, out_path: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cm = np.zeros((num_classes, num_classes), int)
    for r in recs:
        if r["label"] < num_classes and r[name]["pred"] < num_classes:
            cm[r["label"], r[name]["pred"]] += 1
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(cm, cmap="Blues")
    ax.set_xlabel("pred")
    ax.set_ylabel("label")
    ax.set_title(f"confusion: {name}")
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def report(recs: List[dict]) -> dict:
    return {
        "n": len(recs),
        "model_differences": analyze_model_differences(recs),
        "confusion_patterns": analyze_confusion_patterns(recs),
        "layer_differences": analyze_layer_differences(recs),
        "margins": analyze_margins(recs),
    }


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--records_dir", required=True)
    p.add_argument("--out_dir", default="")
    p.add_argument("--num_classes", type=int, default=10)
    p.add_argument("--plot", action="store_true")
    args = p.parse_args(argv)

    recs = load_records(args.records_dir)
    if not recs:
        print("no records found")
        return None
    rep = report(recs)
    out_dir = args.out_dir or args.records_dir
    with open(os.path.join(out_dir, "investigation.json"), "w") as f:
        json.dump(rep, f, indent=2)
    print(json.dumps(rep, indent=2))
    if args.plot:
        for n in model_names(recs):
            plot_confusion(recs, n, args.num_classes,
                           os.path.join(out_dir, f"confusion_{n}.png"))
    return rep


if __name__ == "__main__":
    main()
