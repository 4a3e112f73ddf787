"""Small shared utilities: seeding, meters, paths, registries."""

from mammodissect_torch.utils.meters import AverageMeter, asMinutes, timeSince
from mammodissect_torch.utils.paths import get_Paths
from mammodissect_torch.utils.registry import Registry
from mammodissect_torch.utils.seed import seed_all, seed_everything

__all__ = [
    "seed_all",
    "seed_everything",
    "AverageMeter",
    "timeSince",
    "asMinutes",
    "get_Paths",
    "Registry",
]
