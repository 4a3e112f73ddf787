"""The comparison that decides `correct`: the program's results CSV against the plain
reference's scores and activations over the same images and weights.

Numbers read (`limits/<workload>.json` names those compared, each with its limit):
- `structure`: rows missing, extra or out of order, lists of the wrong length,
  concept names not in the concept set, top images out of range or repeated. Exact:
  limit 0.
- `sim_gap`: the widest gap between a similarity the CSV reports and the
  reference's score of the same unit and concept (every unit, all its listed
  concepts); `sim_gap_mean`: each unit's widest, averaged over the units.
- `concept_regret`: the widest gap by which the reference's score of a unit's
  listed first concept lies below the reference's best score for that unit;
  `concept_regret_mean`: averaged over the units.
- `image_regret`: the widest gap by which the reference's activation of a unit's
  j-th listed top image lies below the reference's j-th largest activation of that
  unit, in units of the spread of that unit's activations over the images (its
  standard deviation, at least the median of its layer's); `image_regret_mean`:
  each unit's widest, averaged.
- `top1_concept_miss`, `top1_image_miss`: the share of units whose listed first
  concept (image) is not the reference's.
A tie within rounding costs nothing in the regrets: they read how much worse the
program's choice is by the reference's own numbers, not whether it is the same. The
widest gaps catch one wrong answer; the means and shares are the steadier numbers
that separate a lower precision from the program's own rounding."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def readings(df, scores: np.ndarray, acts: np.ndarray, concepts: Sequence[str],
             layers: Sequence[str], widths: Sequence[int], top_concepts: int,
             top_images: int) -> Dict[str, float]:
    """The numbers compared. scores [U, C] and acts [N, U] are the reference's."""
    index = {c: i for i, c in enumerate(concepts)}
    n_images = acts.shape[0]
    expect = [(layer, u) for layer, w in zip(layers, widths) for u in range(w)]
    structure = abs(len(df) - len(expect))
    rows = list(zip(df["layer"], df["unit"], df["description"], df["similarity"],
                    df["images"]))
    std = acts.std(axis=0)
    floor = np.empty_like(std)
    start = 0
    for w in widths:
        floor[start:start + w] = np.median(std[start:start + w])
        start += w
    scale = np.maximum(std, floor)
    desc = -np.sort(-acts, axis=0)[:top_images]  # [k_i, U], each unit's largest
    best = scores.max(axis=1)
    k_c, k_i = min(top_concepts, scores.shape[1]), min(top_images, n_images)
    sim, regret, img, miss_c, miss_i = [], [], [], [], []
    for u, ((layer, unit), (got_layer, got_unit, names, sims, imgs)) in enumerate(zip(expect, rows)):
        names, sims, imgs = list(names), list(sims), list(imgs)
        if (got_layer, int(got_unit)) != (layer, unit) or len(names) != k_c \
                or len(sims) != k_c or len(imgs) != k_i:
            structure += 1
            continue
        ids = [index.get(n) for n in names]
        if None in ids or len(set(ids)) != len(ids) or len(set(imgs)) != len(imgs) \
                or not all(0 <= int(i) < n_images for i in imgs):
            structure += 1
            continue
        ref = scores[u, ids]
        sim.append(float(np.max(np.abs(np.asarray(sims, np.float64) - ref))))
        regret.append(float(best[u] - ref[0]))
        got = acts[np.asarray(imgs, np.int64), u]
        img.append(float(np.max((desc[:k_i, u] - got) / scale[u])))
        miss_c.append(ids[0] != int(np.argmax(scores[u])))
        miss_i.append(int(imgs[0]) != int(np.argmax(acts[:, u])))
    out = {"structure": float(structure)}
    for name, values in (("sim_gap", sim), ("concept_regret", regret), ("image_regret", img)):
        out[name] = max(values, default=0.0)
        out[name + "_mean"] = float(np.mean(values)) if values else 0.0
    out["top1_concept_miss"] = float(np.mean(miss_c)) if miss_c else 0.0
    out["top1_image_miss"] = float(np.mean(miss_i)) if miss_i else 0.0
    return out


def csv_frame(scores: np.ndarray, acts: np.ndarray, concepts: Sequence[str],
              layers: Sequence[str], widths: Sequence[int], top_concepts: int,
              top_images: int):
    """The results frame {layer, unit, description, similarity, images} of scores
    [U, C] and activations [N, U], ties to the lower index: what the control run
    hands in the program's place."""
    import pandas as pd

    order = np.argsort(-scores, axis=1, kind="stable")[:, :top_concepts]
    vals = np.take_along_axis(scores, order, axis=1)
    imgs = np.argsort(-acts, axis=0, kind="stable")[:top_images].T
    rows: Dict[str, List] = {"layer": [], "unit": [], "description": [], "similarity": [],
                             "images": []}
    u = 0
    for layer, w in zip(layers, widths):
        for unit in range(w):
            rows["layer"].append(layer)
            rows["unit"].append(unit)
            rows["description"].append([concepts[int(i)] for i in order[u]])
            rows["similarity"].append(vals[u].tolist())
            rows["images"].append(imgs[u].tolist())
            u += 1
    return pd.DataFrame(rows)
