"""Config-driven DataModule (counterpart of `mammodissect/data/datamodule.py`; the
reference's `data/datamodule.py:17-159`).

One object resolves a config dict into train/valid iterables:
- the CSV read with an optional dtype map; the split by the `split` column, else by
  fold, else 90/10 (`datamodule.py:53-62`);
- each dataset built by its `data_type` through `data.imagetext.load_dataset`
  (`:65-98`);
- `train_dataloader(distributed)`: the reference attaches a DistributedSampler over
  the ranks (`:111-136`); here each process takes its slice of the seeded order.
  The rank and world size come from `torch.distributed` when it is initialized,
  else (0, 1);
- `valid_dataloader()`: a dict keyed by dataset name (`:138-159`).
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

from mammodissect_torch.data.imagetext import load_dataset


def host_rank() -> Tuple[int, int]:
    """(rank, world size) of this process: torch.distributed's when initialized, else
    (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DataModule:
    def __init__(self, data_config: Dict, dataloader_config: Optional[Dict] = None,
                 tokenizer=None):
        """data_config: {name: {data_type, csv_file, split_col?, fold?, ...kwargs}}"""
        import pandas as pd

        self.tokenizer = tokenizer
        self.dataloader_config = dataloader_config or {}
        self.datasets: Dict[str, Dict] = {}
        for name, cfg in data_config.items():
            cfg = dict(cfg)
            data_type = cfg.pop("data_type", "imagetext")
            csv_file = cfg.pop("csv_file")
            df = pd.read_csv(csv_file, dtype=cfg.pop("dtype_map", None))
            split_col = cfg.pop("split_col", "split" if "split" in df.columns else None)
            fold = cfg.pop("fold", None)
            if split_col:
                train_tag = "training" if (df[split_col] == "training").any() else "train"
                train_df = df[df[split_col] == train_tag].reset_index(drop=True)
                valid_df = df[df[split_col] != train_tag].reset_index(drop=True)
            elif fold is not None and "fold" in df.columns:
                train_df = df[df["fold"] != fold].reset_index(drop=True)
                valid_df = df[df["fold"] == fold].reset_index(drop=True)
            else:
                cut = int(len(df) * 0.9)
                train_df, valid_df = df.iloc[:cut], df.iloc[cut:]

            def _mk(df_, is_train, data_type=data_type, cfg=cfg):
                kw = dict(cfg)
                if self._takes_split(data_type):
                    kw["split"] = "train" if is_train else "valid"
                elif data_type == "image_classification":
                    # augmentation on the train split only (the reference's per-split
                    # transforms, `data/data_utils.py:25-67`)
                    kw.setdefault("train", is_train)
                return load_dataset(data_type, df=df_, **kw)

            self.datasets[name] = {"train": _mk(train_df, True), "valid": _mk(valid_df, False)}

    @staticmethod
    def _takes_split(data_type: str) -> bool:
        return data_type in ("imagetext", "imagetext_zz", "imagetext_contrastive")

    @staticmethod
    def _host_rank(distributed: bool) -> Tuple[int, int]:
        """(host_index, host_count): (0, 1) unless `distributed`."""
        return host_rank() if distributed else (0, 1)

    def train_dataloader(self, name: Optional[str] = None, distributed: bool = False,
                         epoch: int = 0, seed: int = 0):
        """Pass `epoch` each epoch for a fresh shuffle (the reference's
        `DistributedSampler.set_epoch`)."""
        name = name or next(iter(self.datasets))
        ds = self.datasets[name]["train"]
        bs = int(self.dataloader_config.get("batch_size", 8))
        hi, hc = self._host_rank(distributed)
        if hasattr(ds, "batches"):  # image-text contrastive batching
            return ds.batches(self.tokenizer, bs,
                              max_length=int(self.dataloader_config.get("text_max_length", 256)),
                              seed=seed + epoch, host_index=hi, host_count=hc)
        from mammodissect_torch.train.data import iter_epoch

        return iter_epoch(ds, bs, shuffle=True, seed=seed + epoch, host_index=hi, host_count=hc)

    def valid_dataloader(self, distributed: bool = False) -> Dict[str, Iterator]:
        from mammodissect_torch.train.data import iter_epoch

        out = {}
        bs = int(self.dataloader_config.get("batch_size", 8))
        hi, hc = self._host_rank(distributed)
        for name, pair in self.datasets.items():
            ds = pair["valid"]
            if hasattr(ds, "batches"):
                out[name] = ds.batches(self.tokenizer, bs, shuffle=False, drop_last=False,
                                       host_index=hi, host_count=hc)
            else:
                out[name] = iter_epoch(ds, bs, shuffle=False, host_index=hi, host_count=hc)
        return out
