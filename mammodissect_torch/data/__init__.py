"""Probe datasets (the D_probe side of dissection) and the host loader."""

from mammodissect_torch.data.loader import iter_batches
from mammodissect_torch.data.probes import (
    PROBES,
    ArrayProbe,
    CsvProbe,
    FolderProbe,
    TxtListProbe,
    get_probe,
)

__all__ = [
    "PROBES",
    "get_probe",
    "ArrayProbe",
    "FolderProbe",
    "TxtListProbe",
    "CsvProbe",
    "iter_batches",
]
