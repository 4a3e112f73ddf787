"""Label-map utilities (a copy of `mammodissect/data/labelmaps.py`; reference
`concept_vit/data_utils.py:314-350`): Broden label loading and the CIFAR-100 coarse
(superclass) mapping."""
from __future__ import annotations

import csv
from typing import Dict, List

# CIFAR-100 fine-label index -> coarse (superclass) index; standard public mapping
# (the reference hardcodes the same table at `data_utils.py:332-350`).
CIFAR100_FINE_TO_COARSE = [
    4, 1, 14, 8, 0, 6, 7, 7, 18, 3, 3, 14, 9, 18, 7, 11, 3, 9, 7, 11,
    6, 11, 5, 10, 7, 6, 13, 15, 3, 15, 0, 11, 1, 10, 12, 14, 16, 9, 11, 5,
    5, 19, 8, 8, 15, 13, 14, 17, 18, 10, 16, 4, 17, 4, 2, 0, 17, 4, 18, 17,
    10, 3, 2, 12, 12, 16, 12, 1, 9, 19, 2, 10, 0, 1, 16, 12, 9, 13, 15, 13,
    16, 19, 2, 4, 6, 19, 5, 5, 8, 19, 18, 1, 2, 15, 6, 0, 17, 8, 14, 13,
]

CIFAR100_COARSE_NAMES = [
    "aquatic_mammals", "fish", "flowers", "food_containers", "fruit_and_vegetables",
    "household_electrical_devices", "household_furniture", "insects",
    "large_carnivores", "large_man-made_outdoor_things",
    "large_natural_outdoor_scenes", "large_omnivores_and_herbivores",
    "medium_mammals", "non-insect_invertebrates", "people", "reptiles",
    "small_mammals", "trees", "vehicles_1", "vehicles_2",
]


def cifar100_superclass(fine_label: int) -> int:
    return CIFAR100_FINE_TO_COARSE[int(fine_label)]


def load_broden_labels(label_csv: str) -> Dict[int, str]:
    """{number: name} from a Broden-format label.csv (columns incl. number, name,
    category — the dataset's own metadata file, read at runtime like the reference's
    broden label map)."""
    out: Dict[int, str] = {}
    with open(label_csv, newline="") as f:
        for row in csv.DictReader(f):
            try:
                out[int(row["number"])] = row["name"]
            except (KeyError, ValueError):
                continue
    return out


def load_class_list(path: str) -> List[str]:
    """Plain one-name-per-line class list (places365 categories, ImageNet synsets...)."""
    with open(path) as f:
        return [ln.strip().split(" ")[0].split("/")[-1] for ln in f if ln.strip()]
