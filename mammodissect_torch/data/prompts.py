"""Report generation from findings labels, and the zero-shot prompts (a copy of
`mammodissect/data/prompts.py`).

Same contract as the reference `prompts/prompts.py:generate_report_from_labels(:4-47)`:
findings = [pos_right, pos_left, neg_right, neg_left] finding-name lists; a prompt JSON
maps finding -> {pos_right/pos_left/neg_right/neg_left: [template sentences]}; 'No
Finding' positives suppress all negatives; sentences are sampled (first template when
deterministic), deduped, shuffled (non-deterministic), and joined.

Differences: randomness flows through an explicit numpy Generator instead of the global
`random` module, so reports are reproducible per-sample."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def generate_report_from_labels(
    findings: Sequence[Sequence[str]],
    prompt_json: Dict,
    deterministic: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> str:
    rng = rng or np.random.default_rng()
    pos_right, pos_left, neg_right, neg_left = findings
    if "No Finding" in pos_right or "No Finding" in pos_left:
        neg_right, neg_left = [], []

    report: List[str] = []

    def add(names, key):
        for name in names:
            cand = prompt_json[name][key]
            if not cand:
                continue
            sentence = cand[0] if deterministic else cand[int(rng.integers(len(cand)))]
            if sentence:
                report.append(sentence)

    add(pos_right, "pos_right")
    add(pos_left, "pos_left")
    add(neg_right, "neg_right")
    add(neg_left, "neg_left")

    # dedupe preserving deterministic order (the reference's `list(set(...))` has
    # unstable order; we sort for the deterministic path and use insertion order —
    # stable across PYTHONHASHSEED/processes — before the seeded shuffle otherwise)
    report = sorted(set(report)) if deterministic else list(dict.fromkeys(report))
    if not deterministic:
        rng.shuffle(report)
    return " ".join(report)


def default_zs_prompts() -> Dict[str, Dict[str, List[str]]]:
    """Zero-shot prompt pairs for the mass / calcification tasks
    (reference `configs/zs_clip.yaml:29-36`)."""
    return {
        "Mass": {
            "pos": ["there is a mass in the breast"],
            "neg": ["there is no mass in the breast"],
        },
        "Suspicious_Calcification": {
            "pos": ["there are calcifications in the breast"],
            "neg": ["there are no calcifications in the breast"],
        },
    }
