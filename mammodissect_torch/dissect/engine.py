"""Dissection engine: harvest, cache, score (counterpart of
`mammodissect/dissect/engine.py`).

Two paths write the same CSV.

Resident (fused M-dissect, `DissectConfig.resident`): when the dissection target is
the dissector's own image tower (BreastClip dissecting its EfficientNet `_blocks`),
one forward per probe batch yields both the pooled activations of every requested
block and the projected probe embedding. They are written into fixed-capacity
accumulators that stay on the device; completed chunks spill to the activation
cache on a background thread so an interrupted run resumes. Scoring runs on the
device too (`score_resident`), and only CSV-sized results come back to the host.
Per batch, the only host-to-device traffic is the uint8 batch, assembled by a
prefetch thread into pinned memory and copied with `non_blocking=True`: the plain
canvas, or with the packed wire (`dissect/packing.py`) each row's nonzero span.
Any other target or a probe without uint8 images falls back to the staged path.

Staged (disk cache, the reference's design, `concept_vit/utils.py`):
  1. pooled activations of the target's layers over D_probe   -> .npy per layer
  2. the dissector's image embeddings of D_probe              -> .npy
  3. the dissector's text embeddings of the concept set       -> .npy
  4. clip_feats = image @ text.T, every layer scored in one call, top concepts and
     top images on the host
with the reference's cache names (`get_save_names`, `utils.py:54-62`) and
skip-if-exists, so an interrupted run resumes. When target and dissector are the
same BreastClip, stages 1 and 2 are one fused pass (`_fused_harvest_embed`).

Under a process group (one process per GPU, `parallel.multihost.initialize`) each
rank harvests its contiguous `HostShardedProbe` shard and the results are
all-gathered back into probe order and trimmed to the probe's length, the
reference's DistributedSampler with all_gather-and-trim (`experiments.py:554-564`):
the staged harvest divides the batch by the ranks as JAX does; the resident path
keeps each rank's batch, spills under a per-rank key and gathers its accumulators
(`_gather_resident`). Every rank scores the gathered matrix, as every JAX process
does; only the first rank writes the CSV and args.txt (every rank holds the same
rows), while each rank writes the cache files it reads (atomic renames). The ranks
agree on what the cache holds before they harvest.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import queue
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from mammodissect_torch.data.loader import iter_batches
from mammodissect_torch.data.probes import HostShardedProbe, get_probe
from mammodissect_torch.device import resolve_device, set_fp32_policy
from mammodissect_torch.dissect.capture import canonical_layer_name
from mammodissect_torch.dissect.dissectors import get_dissector
from mammodissect_torch.dissect.packing import (
    native_packer,
    pack_batch_groups_padded,
    sample_pack_fraction,
)
from mammodissect_torch.dissect.results import write_results
from mammodissect_torch.dissect.targets import get_target_model
from mammodissect_torch.ops.pooling import PM_SUFFIX
from mammodissect_torch.ops.similarity import SEGMENTED_FNS, get_similarity_fn
from mammodissect_torch.ops.topk import topk_lowest_index
from mammodissect_torch.parallel.collectives import all_gather, psum
from mammodissect_torch.parallel.mesh import data_group, is_master
from mammodissect_torch.parallel.multihost import comm_device, gather_array
from mammodissect_torch.utils.profiling import current_job, last, new_job, span


@dataclass
class DissectConfig:
    """Flag surface of `describe_broad_neurons.py:15-49`, typed (the JAX package's
    DissectConfig plus `device`, with its defaults but the wire's: the plain uint8
    batch, the H100's choice, PERF.md)."""

    target_model: str = "tiny_cnn"
    target_layers: List[str] = field(default_factory=lambda: ["blocks.0"])
    d_probe: str = "synthetic"
    concept_set: str = ""
    clip_model: str = "random"
    batch_size: int = 200
    pool_mode: str = "avg"
    similarity_fn: str = "soft_wpmi"
    top_k: int = 100
    activation_dir: str = "saved_activations"
    result_dir: str = "results"
    save_prefix: str = ""
    num_top_concepts: int = 10
    num_top_images: int = 5
    breast_clip_ckpt: Optional[str] = None
    finetuned_ckpt: Optional[str] = None
    num_class: int = 1
    probe_kwargs: dict = field(default_factory=dict)
    target_kwargs: dict = field(default_factory=dict)
    dissector_kwargs: dict = field(default_factory=dict)
    # device-resident fused M-dissect: accumulate and score on the device, completed
    # chunks spill to the activation cache; falls back to the staged path when the
    # target is not the dissector's own image tower
    resident: bool = False
    # wall-clock budget (seconds) of a resident run: the harvest stops at a batch
    # boundary, the CSV covers the images harvested so far, a rerun resumes
    deadline_s: Optional[float] = None
    naming: str = "generated"  # "generated" | "og" (results.py)
    # host-to-device wire of the resident harvest (dissect/packing.py): "on" sends each
    # row's nonzero span, "auto" does when a sample of the probe packs to <= 0.85 of
    # the raw bytes, "off" sends the plain uint8 batch. Lossless: results are equal.
    wire_pack: str = "off"
    device: str = "cuda"  # "cpu" is the only way onto the CPU


def _atomic_write(path: str, writer) -> None:
    """Write to a unique temp file, then os.replace: a crash cannot leave a torn
    file behind a resume check, and concurrent writers each land a whole file."""
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    try:
        with open(tmp, "wb") as f:
            writer(f)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(FileNotFoundError):
            os.remove(tmp)
        raise


def _atomic_np_save(path: str, arr) -> None:
    _atomic_write(path, lambda f: np.save(f, arr))


def read_concepts(concept_set: str) -> List[str]:
    with open(concept_set) as f:
        return [w for w in f.read().split("\n") if w.strip()]


def get_save_names(clip_name: str, target_name: str, target_layer: str, d_probe: str,
                   concept_set: str, pool_mode: str, save_dir: str, prefix: str = ""):
    """Cache-file names, the reference's scheme (`utils.py:54-62`) with the
    experiment prefix the drivers prepend (`describe_broad_neurons.py:90-92`):
    (target activations, dissector image embeddings, concept text embeddings). A "/"
    in a model name is dropped ("ViT-B/16" -> "ViT-B16"), for the target as for the
    dissector."""
    layer = canonical_layer_name(target_layer)
    suffix = PM_SUFFIX[pool_mode]
    # probe specs may embed paths ("folder:/data/probe"); flatten for file names
    d_probe = d_probe.replace("/", "_").replace(":", "_")
    target = f"{save_dir}/{prefix}{d_probe}_{target_name.replace('/', '')}_{layer}{suffix}.npy"
    clip = f"{save_dir}/{prefix}{d_probe}_{clip_name.replace('/', '')}.npy"
    stem = os.path.splitext(os.path.basename(concept_set))[0]
    text = f"{save_dir}/{prefix}{stem}_{clip_name.replace('/', '')}.npy"
    return target, clip, text


def _all_saved(paths: Sequence[str]) -> bool:
    return all(os.path.exists(p) for p in paths)


def _has_u8(probe) -> bool:
    """Whether the probe gives uint8 images and their normalization constants."""
    if not (hasattr(probe, "image_u8") and hasattr(probe, "mean")):
        return False
    try:
        probe.image_u8(0)
    except (AttributeError, NotImplementedError):
        return False
    return True


def _dp_shard(probe):
    """(the probe this rank harvests, the probe's true length, the data group): this
    rank's HostShardedProbe under a process group, else the probe itself and None."""
    group = data_group()
    if group is None:
        return probe, len(probe), None
    if not isinstance(probe, HostShardedProbe):
        probe = HostShardedProbe(probe)
    return probe, len(probe.base), group


def _missing_on_any_rank(missing: List[bool], group) -> List[bool]:
    """Each flag set where it is set on some rank: the ranks take the same branches,
    so their collectives meet (a node-local cache may differ between ranks)."""
    if group is None:
        return missing
    flags = psum(torch.tensor(missing, dtype=torch.float32, device=comm_device(group)), group)
    return [bool(f > 0) for f in flags.cpu()]


def _dissector_kwargs(cfg) -> dict:
    dk = dict(cfg.dissector_kwargs)
    if cfg.clip_model.startswith("breastclip"):
        # the dissector loads the same Mammo-CLIP checkpoint (`utils.py:451-454`)
        dk.setdefault("ckpt_path", cfg.breast_clip_ckpt)
    dk.setdefault("device", cfg.device)
    return dk


def _build_dissector(cfg, log):
    dissector = get_dissector(cfg.clip_model, **_dissector_kwargs(cfg))
    log(f"[dissector] built {cfg.clip_model} in {last('build.dissector').seconds:.2f}s")
    return dissector


def save_activations(cfg, probe=None, target=None, dissector=None,
                     log=print) -> Dict[str, str]:
    """Stages 1-3: fill the activation cache (`utils.save_activations`,
    `concept_vit/utils.py:430-564`). Returns {kind: path}: "clip", "text" and
    "target:<layer>" for each layer. A file that exists is not computed again."""
    os.makedirs(cfg.activation_dir, exist_ok=True)
    if probe is None:
        probe = get_probe(cfg.d_probe, **cfg.probe_kwargs)
    layers = [canonical_layer_name(l) for l in cfg.target_layers]
    bs = cfg.batch_size
    paths: Dict[str, str] = {}
    target_paths = {}
    for layer in layers:
        t, c, x = get_save_names(cfg.clip_model, cfg.target_model, layer, cfg.d_probe,
                                 cfg.concept_set, cfg.pool_mode, cfg.activation_dir,
                                 cfg.save_prefix)
        target_paths[layer] = t
        paths["clip"], paths["text"] = c, x
    paths.update({f"target:{k}": v for k, v in target_paths.items()})
    group = data_group()
    *layer_flags, clip_missing, text_missing = _missing_on_any_rank(
        [not os.path.exists(target_paths[l]) for l in layers]
        + [not os.path.exists(paths["clip"]), not os.path.exists(paths["text"])], group)
    missing_layers = [l for l, m in zip(layers, layer_flags) if m]

    # fused M-dissect: the target IS the dissector's image tower, so one forward per
    # batch gives the activations and the probe embeddings (half the compute and
    # half the host-to-device bytes of stages 1 and 2). Another target, target
    # kwargs or a fine-tuned checkpoint go to the separate stages.
    if ((missing_layers or clip_missing) and cfg.target_model == "breastclip"
            and cfg.clip_model == "breastclip" and not cfg.target_kwargs
            and not cfg.finetuned_ckpt and target is None and _has_u8(probe)):
        dissector = dissector or _build_dissector(cfg, log)
        with span("dissect.harvest") as stage:
            acc, embs, n_images = _fused_harvest_embed(dissector, probe, layers, cfg.pool_mode,
                                                       bs)
            with span("dissect.io"):
                for l in layers:
                    _atomic_np_save(target_paths[l], acc[l])
                _atomic_np_save(paths["clip"], embs)
        missing_layers, clip_missing = [], False
        log(f"[fused] harvested {len(layers)} layers + embedded {n_images} images in one "
            f"pass, {stage.seconds:.1f}s")

    # stage 1: the target's activations, every layer from one forward per batch
    if missing_layers:
        if target is None:
            kw = dict(ckpt_path=cfg.breast_clip_ckpt, finetuned_ckpt=cfg.finetuned_ckpt,
                      num_class=cfg.num_class, device=cfg.device)
            kw.update(cfg.target_kwargs)
            target = get_target_model(cfg.target_model, **kw)
            log(f"[target] built {cfg.target_model} in {last('build.target').seconds:.2f}s")
        with span("dissect.harvest") as stage:
            acc, n_images = harvest_probe(target, probe, layers, cfg.pool_mode, bs)
            with span("dissect.io"):
                for l in layers:
                    _atomic_np_save(target_paths[l], acc[l])
        log(f"[harvest] {n_images} images x {len(layers)} layers in {stage.seconds:.1f}s")
    elif _all_saved(list(target_paths.values())):
        log("[harvest] all target activations cached, skipping")

    # stage 2: the dissector's probe embeddings
    if clip_missing:
        dissector = dissector or _build_dissector(cfg, log)
        with span("dissect.embed") as stage:
            shard, n_total, group = _dp_shard(probe)
            use_u8 = hasattr(dissector, "embed_images_u8") and _has_u8(shard)
            feats = []
            if use_u8:
                pin = getattr(dissector, "device", torch.device("cpu")).type == "cuda"
                for u8, n_valid in _prefetch_u8_batches(shard, bs, pin=pin,
                                                        name="embed.assemble"):
                    feats.append(dissector.embed_images_u8(u8, shard.mean, shard.std)[:n_valid])
            else:
                for batch in iter_batches(shard, bs):
                    feats.append(dissector.embed_images(batch.images)[:batch.n_valid])
            feats = np.concatenate(feats, axis=0)
            if group is not None:
                feats = gather_array(feats, group)[:n_total]
            with span("dissect.io"):
                _atomic_np_save(paths["clip"], feats)
        log(f"[clip-img] embedded D_probe in {stage.seconds:.1f}s"
            + (" (uint8 wire)" if use_u8 else ""))
    else:
        log("[clip-img] probe embeddings cached, skipping")

    # stage 3: the concepts' text embeddings
    if text_missing:
        dissector = dissector or _build_dissector(cfg, log)
        with span("dissect.text") as stage:
            words = read_concepts(cfg.concept_set)
            text = dissector.embed_texts(words)
            with span("dissect.io"):
                _atomic_np_save(paths["text"], text)
        log(f"[clip-txt] embedded {len(words)} concepts in {stage.seconds:.2f}s")
    return paths


def _prefetch(assemble: Callable, n: int, batch_size: int, start: int, depth: int = 2,
              name: str = "harvest.assemble"):
    """Generator over `assemble(start_, stop)` items built on a producer thread, so
    host-side batch assembly overlaps the device work of the previous batch; each item
    is a span `name` of the consumer's job. Producer exceptions surface in the
    consumer; closing the generator stops the producer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    job = current_job()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for start_ in range(start, n, batch_size):
                with span(name, job=job):
                    item = assemble(start_, min(start_ + batch_size, n))
                if not put(item):
                    return
        except Exception as e:  # surfaced to the consumer
            put(e)
            return
        put(None)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        thread.join()


def _prefetch_u8_batches(probe, batch_size: int, start: int = 0, pin: bool = False,
                         name: str = "harvest.assemble"):
    """uint8 batches [batch_size, H, W, C] (the tail batch zero-padded) as CPU tensors,
    in pinned memory when `pin`, with their count of valid images, each assembled in a
    span `name`. PyTorch's pinned allocator does not reuse a block until the copy that
    reads it has finished."""
    h, w, c = probe.image_shape

    def assemble(start_, stop):
        u8 = torch.empty((batch_size, h, w, c), dtype=torch.uint8, pin_memory=pin)
        arr = u8.numpy()
        for j, i in enumerate(range(start_, stop)):
            arr[j] = probe.image_u8(i)
        arr[stop - start_:] = 0
        return u8, stop - start_

    yield from _prefetch(assemble, len(probe), batch_size, start, name=name)


def _prefetch_packed_batches(probe, batch_size: int, quantum: int, cap_bytes: int,
                             start: int = 0, pin: bool = False):
    """Packed-wire batches (dissect/packing.py): the producer thread assembles the
    uint8 batch, scans its row spans and packs them into a [1, bucket] payload in
    pinned memory when `pin`, with the [B, H, 2] int32 span metadata. Yields
    (payload, meta, n_valid, pack_s), pack_s the host's packing seconds."""
    h, w, c = probe.image_shape
    use_spans = hasattr(probe, "image_spans")
    zero_span = (np.zeros(h, np.int32), np.zeros(h, np.int32))

    def assemble(start_, stop):
        u8 = np.zeros((batch_size, h, w, c), np.uint8)
        spans = [] if use_spans else None
        for j, i in enumerate(range(start_, stop)):
            u8[j] = probe.image_u8(i)
            if use_spans:
                spans.append(probe.image_spans(i))
        if use_spans:  # tail padding rows are all zero: empty spans, no rescan
            spans.extend(zero_span for _ in range(stop - start_, batch_size))
        t0 = time.perf_counter()
        held = []

        def alloc(shape):
            held.append(torch.zeros(shape, dtype=torch.uint8, pin_memory=pin))
            return held[-1].numpy()

        _, meta, _ = pack_batch_groups_padded(u8, 1, spans=spans, quantum=quantum,
                                              cap=cap_bytes, alloc=alloc)
        meta_t = torch.from_numpy(meta)
        if pin:
            meta_t = meta_t.pin_memory()
        return held[0], meta_t, stop - start_, time.perf_counter() - t0

    yield from _prefetch(assemble, len(probe), batch_size, start)


def _decide_wire_pack(wire_pack: str, probe) -> bool:
    """Resolve "auto"/"on"/"off" against the probe's sampled packed fraction."""
    if wire_pack not in ("auto", "on", "off"):
        raise ValueError(f"wire_pack must be 'auto', 'on' or 'off', got {wire_pack!r}")
    if wire_pack == "off" or not _has_u8(probe):
        return False
    return wire_pack == "on" or sample_pack_fraction(probe) <= 0.85


def _pipelined(batches, dispatch, drain, depth: int) -> int:
    """Queue `dispatch(item)` for each batch while at most `depth` dispatched batches
    wait to be read by `drain(result, n_valid)`: the device works on the next batches
    while the host reads an earlier one. Returns the count of valid images."""
    pending: deque = deque()
    n_images = 0
    try:
        for item, n_valid in batches:
            pending.append((dispatch(item), n_valid))
            n_images += n_valid
            if len(pending) > depth:
                drain(*pending.popleft())
        while pending:
            drain(*pending.popleft())
    finally:
        batches.close()
    return n_images


def _to_host(t: torch.Tensor, wait: str) -> np.ndarray:
    """`t` as numpy, read back in a span `wait` (a name ending in ".wait"): the host
    waits there for the device."""
    with span(wait):
        return t.cpu().numpy()


def _split_columns(acc: Dict[str, list], packed: torch.Tensor, n_valid: int, names, widths):
    """Append the valid rows of each layer's columns of a [B, U_total] device result
    to acc[layer] as numpy."""
    packed = _to_host(packed, "harvest.wait")
    off = 0
    for name, w in zip(names, widths):
        acc[name].append(packed[:n_valid, off:off + w])
        off += w


def harvest_probe(target, probe, layers, pool_mode: str, batch_size: int,
                  pipeline_depth: int = 2):
    """Pooled activations of `layers` over the whole probe (stage 1).

    A probe with uint8 images and a target that normalizes on the device take the
    uint8 wire (4x fewer bytes than float32), from pinned memory, with up to
    `pipeline_depth` batches queued on the device ahead of the one the host reads.
    Other probes go through float32 batches (`iter_batches`). Under a process group
    each rank harvests its HostShardedProbe shard at batch_size // ranks, and the
    layers are gathered in probe order and trimmed to the probe's length.

    Returns ({layer: [N, C] float32}, n_images)."""
    probe, n_total, group = _dp_shard(probe)
    if group is not None:
        batch_size = max(batch_size // dist.get_world_size(group), 1)
    local, n_images = _harvest_local(target, probe, layers, pool_mode, batch_size,
                                     pipeline_depth)
    if group is None:
        return local, n_images
    return {l: gather_array(local[l], group)[:n_total] for l in layers}, n_total


def _harvest_local(target, probe, layers, pool_mode: str, batch_size: int,
                   pipeline_depth: int):
    acc: Dict[str, list] = {l: [] for l in layers}
    if not (hasattr(target, "harvest_u8_dispatch") and _has_u8(probe)):
        n_images = 0
        for batch in iter_batches(probe, batch_size):
            captured = target.harvest(batch.images, layers, pool_mode)
            for l in captured:
                acc[canonical_layer_name(l)].append(captured[l][:batch.n_valid])
            n_images += batch.n_valid
        return {l: np.concatenate(acc[l], axis=0) for l in layers}, n_images

    def drain(result, n_valid):
        packed, names, widths = result
        _split_columns(acc, packed, n_valid, names, widths)

    pin = getattr(target, "device", torch.device("cpu")).type == "cuda"
    n_images = _pipelined(
        _prefetch_u8_batches(probe, batch_size, pin=pin),
        lambda u8: target.harvest_u8_dispatch(u8, layers, pool_mode, probe.mean, probe.std),
        drain, pipeline_depth)
    return {l: np.concatenate(acc[l], axis=0) for l in layers}, n_images


def _fused_harvest_embed(dissector, probe, layers, pool_mode: str, batch_size: int,
                         pipeline_depth: int = 2):
    """The fused stages 1 and 2 (see save_activations), pipelined and sharded over
    the ranks as harvest_probe. Returns ({layer: [N, C]}, embeddings [N, D], n_images)."""
    probe, n_total, group = _dp_shard(probe)
    if group is not None:
        batch_size = max(batch_size // dist.get_world_size(group), 1)
    acc: Dict[str, list] = {l: [] for l in layers}
    emb_acc: list = []

    def drain(result, n_valid):
        packed_dev, emb_dev, names, widths = result
        _split_columns(acc, packed_dev, n_valid, names, widths)
        emb_acc.append(_to_host(emb_dev, "harvest.wait")[:n_valid])

    pin = dissector.device.type == "cuda"
    n_images = _pipelined(
        _prefetch_u8_batches(probe, batch_size, pin=pin),
        lambda u8: dissector.harvest_and_embed_u8_dispatch(u8, layers, pool_mode,
                                                           probe.mean, probe.std),
        drain, pipeline_depth)
    acts = {l: np.concatenate(acc[l], axis=0) for l in layers}
    embs = np.concatenate(emb_acc, axis=0)
    if group is None:
        return acts, embs, n_images
    return ({l: gather_array(acts[l], group)[:n_total] for l in layers},
            gather_array(embs, group)[:n_total], n_total)


class _ChunkSpiller:
    """Background writer: copies completed resident chunks to the host and saves them
    to the activation cache off the harvest loop's critical path, so an interrupted
    run resumes from the last harvested batch (the reference's skip-if-exists
    restartability, `utils.py:648-657`)."""

    def __init__(self, cache_dir: str, key: str):
        os.makedirs(cache_dir, exist_ok=True)
        self.cache_dir, self.key = cache_dir, key
        self._job = current_job()  # the writer's spans belong to the job that spills
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def paths(self, i: int):
        stem = os.path.join(self.cache_dir, f"{self.key}_chunk{i:04d}")
        return stem + "_act.npy", stem + "_emb.npy"

    @property
    def partial_path(self):
        return os.path.join(self.cache_dir, f"{self.key}_partial.npz")

    def load_existing(self, cap: int, u_total: int, emb_dim: int):
        """Consecutive complete spilled chunks with the expected geometry (numpy)."""
        chunks = []
        i = 0
        while True:
            pa, pe = self.paths(i)
            if not (os.path.exists(pa) and os.path.exists(pe)):
                break
            try:
                a, e = np.load(pa), np.load(pe)
            except (OSError, ValueError):
                break  # torn write from a killed run: harvest again from here
            if a.shape != (cap, u_total) or e.shape != (cap, emb_dim):
                break
            chunks.append((a, e))
            i += 1
        return chunks

    def load_partial(self, chunk_index: int, cap: int, u_total: int, emb_dim: int,
                     batch_size: int):
        """(act, emb, offset, n_images) of the in-progress chunk an earlier run spilled,
        or None; checked against the geometry and the expected chunk index."""
        p = self.partial_path
        if not os.path.exists(p):
            return None
        try:
            z = np.load(p)
            a, e = z["act"], z["emb"]
            idx, offset, n_img = int(z["chunk_index"]), int(z["offset"]), int(z["n_images"])
        except (OSError, ValueError, KeyError):
            return None
        if (idx != chunk_index or a.shape != (cap, u_total)
                or e.shape != (cap, emb_dim) or not 0 < offset <= cap
                or offset % batch_size != 0):
            return None
        return a, e, offset, n_img

    def submit(self, i: int, acc_a: torch.Tensor, acc_e: torch.Tensor):
        self._q.put(("chunk", i, acc_a, acc_e))

    def submit_partial(self, chunk_index: int, acc_a, acc_e, offset: int, n_images: int):
        self._q.put(("partial", chunk_index, acc_a, acc_e, offset, n_images))

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                with span("harvest.spill", job=self._job):
                    self._write(item)
            except Exception as e:  # re-raised by close()
                self._err = e

    def _write(self, item):
        if item[0] == "chunk":
            _, i, acc_a, acc_e = item
            for path, dev in zip(self.paths(i), (acc_a, acc_e)):
                host = dev.cpu().numpy()  # the device-to-host copy happens here
                _atomic_write(path, lambda f, h=host: np.save(f, h))
        else:
            _, idx, acc_a, acc_e, offset, n_img = item
            a, e = acc_a.cpu().numpy(), acc_e.cpu().numpy()
            _atomic_write(
                self.partial_path,
                lambda f: np.savez(f, act=a, emb=e, chunk_index=idx,
                                   offset=offset, n_images=n_img),
            )

    def close(self):
        self._q.put(None)
        self._t.join()
        if self._err is not None:
            raise self._err


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fused_harvest_embed_resident(dissector, probe, layers, pool_mode: str, batch_size: int,
                                 sync_every: int = 16, chunk_batches: int = 16, log=None,
                                 cache_dir: Optional[str] = None, cache_key: str = "",
                                 deadline: Optional[float] = None,
                                 timing: Optional[list] = None, wire_pack: str = "off"):
    """Device-resident fused M-dissect harvest (see BreastClip.fused_resident_step).

    Accumulators are fixed-capacity chunks of `chunk_batches * batch_size` rows on
    the dissector's device. Every `sync_every` batches the host waits for the device,
    which bounds how far it runs ahead. cache_dir/cache_key enable chunk spill and
    resume. `deadline` (a time.monotonic() value) stops the harvest at a batch
    boundary once less than ~1.5 batch times remain; the rows harvested so far stay
    valid. `wire_pack` ("off"/"on"/"auto", `_decide_wire_pack`) sends each row's
    nonzero span instead of the whole canvas (dissect/packing.py); the canvas the
    step rebuilds is bit-identical. `timing`, if a list, collects per-batch
    {"assemble_s", "put_s", "step_s", "sync_s", "pack_s", "wire_bytes"} (host clock,
    from the spans `harvest.batch`, `harvest.put`, `harvest.step` and `harvest.wait`
    that each batch records; the step is asynchronous on the GPU, so step_s is its
    enqueue time and sync_s the wait of every `sync_every`-th batch; pack_s is the
    producer thread's packing time).

    Returns (act_chunks, emb_chunks, names, widths, n_images): the chunks concatenate
    to [>= n_images, U_total] / [>= n_images, D] float32 on the device."""
    device = dissector.device
    h, w, c = probe.image_shape
    shape = (batch_size, h, w, c)
    packed = _decide_wire_pack(wire_pack, probe)
    make_step = dissector.fused_resident_step_packed if packed else dissector.fused_resident_step
    step, names, widths = make_step(shape, layers, pool_mode, probe.mean, probe.std)
    u_total = int(sum(widths))
    cap = chunk_batches * batch_size
    emb_dim = int(dissector.module.proj_dim)

    def zeros(n_cols):
        return torch.zeros((cap, n_cols), dtype=torch.float32, device=device)

    spiller = _ChunkSpiller(cache_dir, cache_key) if cache_dir else None
    act_chunks: List[torch.Tensor] = []
    emb_chunks: List[torch.Tensor] = []
    acc_a = acc_e = None
    offset = 0
    consumed = 0  # probe images dispatched (batch_size granularity)
    n_images = 0  # valid images harvested
    if spiller is not None:
        for a, e in spiller.load_existing(cap, u_total, emb_dim):
            act_chunks.append(torch.from_numpy(a).to(device))
            emb_chunks.append(torch.from_numpy(e).to(device))
        consumed = len(act_chunks) * cap
        # a short final batch can end exactly on a chunk boundary: that chunk then
        # carries padding rows, and valid images never exceed the probe length
        n_images = min(consumed, len(probe))
        part = spiller.load_partial(len(act_chunks), cap, u_total, emb_dim, batch_size)
        if part is not None:
            pa, pe, offset, n_images = part
            n_images = min(n_images, len(probe))
            acc_a, acc_e = torch.from_numpy(pa).to(device), torch.from_numpy(pe).to(device)
            consumed = len(act_chunks) * cap + offset
        if consumed and log is not None:
            log(f"[resident] resumed {len(act_chunks)} cached chunks"
                + (f" + a partial chunk at row {offset}" if part else "")
                + f" ({n_images} images) from {cache_dir}")

    pin = device.type == "cuda"
    if packed:
        raw_bytes = batch_size * h * w * c
        batches = _prefetch_packed_batches(probe, batch_size, max(raw_bytes // 16, 1),
                                           raw_bytes, start=consumed, pin=pin)
        if log is not None:
            log(f"[resident] packed uint8 wire ({native_packer()} packer)")
    else:
        batches = ((u8, None, n_valid, 0.0) for u8, n_valid in
                   _prefetch_u8_batches(probe, batch_size, start=consumed, pin=pin))
    i_batch = 0
    try:
        for payload, meta, n_valid, pack_s in batches:
            waited = None
            with span("harvest.batch") as batch:
                if acc_a is None:
                    acc_a, acc_e = zeros(u_total), zeros(emb_dim)
                with span("harvest.put") as put:
                    wire = [payload.to(device, non_blocking=True)]
                    if packed:
                        wire.append(meta.to(device, non_blocking=True))
                with span("harvest.step") as stepped:
                    step(acc_a, acc_e, *wire, offset)
                n_images += n_valid
                consumed += batch_size
                offset += batch_size
                i_batch += 1
                if offset == cap:
                    act_chunks.append(acc_a)
                    emb_chunks.append(acc_e)
                    if spiller is not None:
                        spiller.submit(len(act_chunks) - 1, acc_a, acc_e)
                    acc_a = acc_e = None
                    offset = 0
                if i_batch % sync_every == 0:
                    with span("harvest.wait") as waited:
                        _sync(device)
                    if log is not None:
                        log(f"[resident] {n_images}/{len(probe)} images")
            # the batch's host seconds, from its spans' stamps
            last_ns = waited.end if waited is not None else stepped.end
            if timing is not None:
                wire_bytes = payload.numel() + (meta.numel() * meta.element_size() if packed else 0)
                timing.append({"assemble_s": (put.start - batch.start) / 1e9,
                               "put_s": put.seconds, "step_s": stepped.seconds,
                               "sync_s": (last_ns - stepped.end) / 1e9, "pack_s": pack_s,
                               "wire_bytes": wire_bytes})
            if deadline is not None:
                margin = min(1.5 * (last_ns - batch.start) / 1e9, 120.0)
                if time.monotonic() >= deadline - margin:
                    if log is not None:
                        log(f"[resident] deadline reached at {n_images}/{len(probe)} "
                            f"images; finalizing with the partial harvest")
                    break
        if acc_a is not None:
            act_chunks.append(acc_a)
            emb_chunks.append(acc_e)
            if spiller is not None:
                # the in-progress chunk spills too: an interruption resumes at batch
                # granularity, a completed harvest resumes straight to scoring
                spiller.submit_partial(len(act_chunks) - 1, acc_a, acc_e, offset, n_images)
    finally:
        batches.close()
        if spiller is not None:
            spiller.close()
    return act_chunks, emb_chunks, names, widths, n_images


@torch.inference_mode()
def score_resident(act_chunks, emb_chunks, n_images: int, text_features: np.ndarray,
                   widths, similarity_name: str, top_k: int = 100,
                   num_top_concepts: int = 10, num_top_images: int = 5):
    """Stage 4 on the device of the accumulators: normalize both sides, clip_feats =
    emb @ text.T in true float32, all layers scored in one segmented call, each
    unit's top concepts and top activating images (ties to the lowest index).

    Returns numpy (top_vals [U, k_c], top_concept_idx [U, k_c], top_image_idx [U, k_i])."""
    acts = torch.cat(list(act_chunks), dim=0)[:n_images]
    emb = torch.cat(list(emb_chunks), dim=0)[:n_images]
    device = acts.device
    emb = emb / torch.linalg.vector_norm(emb, dim=1, keepdim=True).clamp(min=1e-12)
    txt = torch.as_tensor(text_features, dtype=torch.float32).to(device)
    txt = txt / torch.linalg.vector_norm(txt, dim=1, keepdim=True).clamp(min=1e-12)
    clip_feats = emb @ txt.T

    widths = [int(w) for w in widths]
    k_c = min(num_top_concepts, int(txt.shape[0]))
    k_i = min(num_top_images, n_images)
    if similarity_name in SEGMENTED_FNS:
        segment_ids = np.repeat(np.arange(len(widths), dtype=np.int64), widths)
        kwargs = {"top_k": min(top_k, n_images)} if similarity_name == "soft_wpmi" else {}
        sim = SEGMENTED_FNS[similarity_name](clip_feats, acts, segment_ids, len(widths), **kwargs)
    else:
        sim = get_similarity_fn(similarity_name)(clip_feats, acts)
    top_vals, top_idx = topk_lowest_index(sim, k_c, dim=1)
    _, img_idx = topk_lowest_index(acts.T, k_i, dim=1)
    return tuple(_to_host(t, "score.wait") for t in (top_vals, top_idx, img_idx))


def get_target_activations(target_save_name: str, neuron_idx=None) -> np.ndarray:
    """Cached activations, or one neuron's column (the reference's
    `get_dist_from_target_activations`, `concept_vit/utils.py:613-617`)."""
    target_feats = np.load(target_save_name)
    return target_feats[:, neuron_idx] if neuron_idx is not None else target_feats


def _load_clip_feats(clip_save_name: str, text_save_name: str) -> np.ndarray:
    """clip_feats = image @ text.T [N, C] float32 of the L2-normalized cached
    embeddings (`utils.py:566-612`)."""
    with span("dissect.io"):
        image_features = np.load(clip_save_name).astype(np.float32)
        text_features = np.load(text_save_name).astype(np.float32)
    image_features /= np.clip(np.linalg.norm(image_features, axis=1, keepdims=True), 1e-12, None)
    text_features /= np.clip(np.linalg.norm(text_features, axis=1, keepdims=True), 1e-12, None)
    return image_features @ text_features.T


def get_similarity_from_activations(target_save_name: str, clip_save_name: str,
                                    text_save_name: str, similarity_fn,
                                    return_target_feats: bool = True, top_k: int = 100,
                                    device=None):
    """Stage 4 of one layer (reference `utils.py:566-612`): load the cached features,
    score them on `device` (default CUDA, `resolve_device`). Returns similarity
    [U, C] (and the activations) as numpy."""
    clip_feats = _load_clip_feats(clip_save_name, text_save_name)
    target_feats = np.load(target_save_name).astype(np.float32)
    kwargs = {}
    if getattr(similarity_fn, "__name__", "") == "soft_wpmi":
        kwargs["top_k"] = min(top_k, target_feats.shape[0])
    dev = resolve_device(device)
    similarity = _to_host(similarity_fn(torch.from_numpy(clip_feats).to(dev),
                                        torch.from_numpy(target_feats).to(dev), **kwargs),
                          "score.wait")
    return (similarity, target_feats) if return_target_feats else similarity


@torch.inference_mode()
def score_all_layers(feats_by_layer: Dict[str, np.ndarray], clip_save_name: str,
                     text_save_name: str, similarity_name: str, top_k: int = 100,
                     device=None) -> Dict[str, np.ndarray]:
    """Stage 4 over all layers in one call on `device` (default CUDA,
    `resolve_device`): the per-layer [N, U_l]
    activations are concatenated into [N, U_total]; soft_wpmi/wpmi score it with
    their segmented forms (log p(d) per layer, the math of the reference's
    layer-by-layer loop, `describe_broad_neurons.py:83-119`), the others are per
    unit. Returns {layer: similarity [U_l, C]} as numpy."""
    clip_feats = _load_clip_feats(clip_save_name, text_save_name)
    layers = list(feats_by_layer)
    widths = [feats_by_layer[l].shape[1] for l in layers]
    target_cat = np.concatenate([feats_by_layer[l].astype(np.float32) for l in layers], axis=1)
    dev = resolve_device(device)
    clip_t, target_t = torch.from_numpy(clip_feats).to(dev), torch.from_numpy(target_cat).to(dev)
    kwargs = {"top_k": min(top_k, target_cat.shape[0])} if similarity_name == "soft_wpmi" else {}
    if similarity_name in SEGMENTED_FNS:
        segment_ids = np.repeat(np.arange(len(layers), dtype=np.int64), widths)
        sim = SEGMENTED_FNS[similarity_name](clip_t, target_t, segment_ids, len(layers), **kwargs)
    else:
        sim = get_similarity_fn(similarity_name)(clip_t, target_t, **kwargs)
    sim_cat = _to_host(sim, "score.wait")
    out, off = {}, 0
    for layer, w in zip(layers, widths):
        out[layer] = sim_cat[off:off + w]
        off += w
    return out


def _gather_resident(act_chunks, emb_chunks, n_local: int, probe: HostShardedProbe, group):
    """The ranks' resident accumulators in probe order (JAX's
    `_gather_resident_multihost`): each rank harvested its contiguous shard and may
    stop at another batch under a deadline, so all trim to the common minimum,
    all-gather (tiled: the shards concatenate in probe order) and drop the shards'
    wrap-padding rows (indices past the probe's length).

    Returns (act_chunks, emb_chunks, n_images, index_map): index_map[i] is the probe
    index of gathered row i, which the CSV's top-image ids pass through."""
    device = act_chunks[0].device
    acts = torch.cat(list(act_chunks), dim=0)[:n_local]
    embs = torch.cat(list(emb_chunks), dim=0)[:n_local]
    counts = all_gather(torch.tensor([n_local], device=device), group).cpu().numpy()
    n_min = int(counts.min())
    acts, embs = all_gather(acts[:n_min], group), all_gather(embs[:n_min], group)
    idx = np.concatenate([np.arange(h * probe.per_host, h * probe.per_host + n_min)
                          for h in range(len(counts))])
    keep = idx < len(probe.base)
    keep_t = torch.from_numpy(keep).to(device)
    return [acts[keep_t]], [embs[keep_t]], int(keep.sum()), idx[keep]


def _run_dissection_resident(cfg: DissectConfig, probe, target=None, dissector=None,
                             log=print, timing=None):
    """Fully device-resident M-dissect. Returns (DataFrame, csv_path), or None when
    the configuration cannot run resident (another target, target kwargs, a
    fine-tuned checkpoint, a target object, or a probe without uint8 images).
    Under a process group each rank harvests its shard (batch cfg.batch_size) and
    the accumulators are gathered for scoring (`_gather_resident`)."""
    if not (cfg.target_model == "breastclip" and cfg.clip_model == "breastclip"
            and not cfg.target_kwargs and not cfg.finetuned_ckpt and target is None
            and _has_u8(probe)):
        return None
    probe, _, group = _dp_shard(probe)
    dissector = dissector or _build_dissector(cfg, log)
    bs = cfg.batch_size

    words = read_concepts(cfg.concept_set)
    layers = [canonical_layer_name(l) for l in cfg.target_layers]
    os.makedirs(cfg.activation_dir, exist_ok=True)
    d_probe_key = cfg.d_probe.replace("/", "_").replace(":", "_")
    # the wire is resolved here so that the resume key names the wire that ran
    wire_mode = "on" if _decide_wire_pack(cfg.wire_pack, probe) else "off"
    # the resume key covers everything that changes chunk contents: geometry checks
    # alone would resume stale chunks after a pool_mode / layer / weight change
    sig = hashlib.sha1(repr((tuple(layers), cfg.pool_mode, sorted(cfg.probe_kwargs.items()),
                             cfg.breast_clip_ckpt, wire_mode, "torch",
                             sorted(cfg.dissector_kwargs.items()))).encode()).hexdigest()[:8]
    cache_key = f"{cfg.save_prefix}{d_probe_key}_{cfg.clip_model}_resident_b{bs}_{sig}"
    if group is not None:  # each rank spills its own shard's chunks
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        cache_key += f"_host{rank}of{size}"
    deadline = time.monotonic() + cfg.deadline_s if cfg.deadline_s is not None else None
    with span("dissect.harvest") as harvest:
        act_chunks, emb_chunks, names, widths, n_images = fused_harvest_embed_resident(
            dissector, probe, layers, cfg.pool_mode, bs, cache_dir=cfg.activation_dir,
            cache_key=cache_key, log=log, deadline=deadline, timing=timing,
            wire_pack=wire_mode)
        if n_images < len(probe):
            log(f"[resident] PARTIAL dissection: {n_images}/{len(probe)} images within "
                f"the {cfg.deadline_s}s budget; rerun to resume and complete")
        index_map = None
        if group is not None:
            act_chunks, emb_chunks, n_images, index_map = _gather_resident(
                act_chunks, emb_chunks, n_images, probe, group)
            log(f"[resident] gathered {n_images} rows from {dist.get_world_size(group)} "
                f"rank shards for scoring")
    with span("dissect.text"):
        text_feats = dissector.embed_texts(words)
    with span("dissect.score") as scored:
        top_vals, top_idx, img_idx = score_resident(
            act_chunks, emb_chunks, n_images, text_feats, widths, cfg.similarity_fn,
            top_k=cfg.top_k, num_top_concepts=cfg.num_top_concepts,
            num_top_images=cfg.num_top_images)
        if index_map is not None:  # the gathered rows' top images as probe indices
            img_idx = index_map[img_idx]
    log(f"[resident] dissected {n_images} images x {len(names)} layers on "
        f"{dissector.device} in {(scored.end - harvest.start) / 1e9:.1f}s")

    with span("dissect.results"):
        row_slices, off = {}, 0
        for name, w in zip(names, widths):
            row_slices[name] = slice(off, off + w)
            off += w
        outputs = {"layer": [], "unit": [], "description": [], "similarity": [], "images": []}
        for layer in layers:  # CSV rows follow the requested layer order
            sl = row_slices[layer]
            w = sl.stop - sl.start
            outputs["layer"].extend([layer] * w)
            outputs["unit"].extend(range(w))
            outputs["description"].extend([[words[int(i)] for i in row] for row in top_idx[sl]])
            outputs["similarity"].extend([row.tolist() for row in top_vals[sl]])
            outputs["images"].extend([row.tolist() for row in img_idx[sl]])
            log(f"[score] {layer}: {w} units scored")
        return write_results(outputs, cfg, write=is_master())


def run_dissection(cfg: DissectConfig, probe=None, target=None, dissector=None, log=print,
                   timing: Optional[list] = None):
    """The whole dissection (reference `describe_broad_neurons.py.__main__`): harvest and
    score every layer, write the results CSV {layer, unit, description, similarity,
    images} and args.txt. Returns (DataFrame, csv_path).

    Runs on `cfg.device` (default CUDA; raises without a GPU unless "cpu").
    `timing`, if a list, collects the resident harvest's per-batch timing
    (`fused_harvest_embed_resident`). The call is a span `dissect.job` with a job id
    of its own, which its stages' spans share: `dissect.harvest`, `dissect.embed`,
    `dissect.text`, `dissect.score`, `dissect.results`, the staged path's `dissect.io`,
    and the `*.wait` spans of the host's reads from the device."""
    with span("dissect.job", job=new_job()):
        return _run_dissection(cfg, probe, target, dissector, log, timing)


def _run_dissection(cfg: DissectConfig, probe, target, dissector, log, timing):
    device = resolve_device(cfg.device)
    if device.type == "cuda":
        set_fp32_policy()
    if probe is None:  # built once: a fallback hands the same probe to the staged path
        probe = get_probe(cfg.d_probe, **cfg.probe_kwargs)
    if cfg.resident:
        out = _run_dissection_resident(cfg, probe, target=target, dissector=dissector,
                                       log=log, timing=timing)
        if out is not None:
            return out
        log("[resident] not applicable (non-fused target/probe); using the staged path")

    paths = save_activations(cfg, probe=probe, target=target, dissector=dissector, log=log)
    words = read_concepts(cfg.concept_set)
    layer_names = [canonical_layer_name(l) for l in cfg.target_layers]
    with span("dissect.io"):
        feats_by_layer = {l: np.load(paths[f"target:{l}"]).astype(np.float32)
                          for l in layer_names}
    with span("dissect.score") as stage:
        sims = score_all_layers(feats_by_layer, paths["clip"], paths["text"], cfg.similarity_fn,
                                top_k=cfg.top_k, device=device)
    log(f"[scoring] {sum(s.shape[0] for s in sims.values())} units x {len(words)} concepts "
        f"in {stage.seconds:.2f}s")

    with span("dissect.results") as stage:
        outputs = {"layer": [], "unit": [], "description": [], "similarity": [], "images": []}
        for layer in layer_names:
            sim, target_feats = sims[layer], feats_by_layer[layer]
            k_c = min(cfg.num_top_concepts, sim.shape[1])
            k_i = min(cfg.num_top_images, target_feats.shape[0])
            # stable sorts: ties go to the lowest index, as on the resident path
            top_concepts = np.argsort(-sim, axis=1, kind="stable")[:, :k_c]  # [U, k_c]
            top_vals = np.take_along_axis(sim, top_concepts, axis=1)
            top_images = np.argsort(-target_feats, axis=0, kind="stable")[:k_i].T  # [U, k_i]
            n_units = sim.shape[0]
            outputs["layer"].extend([layer] * n_units)
            outputs["unit"].extend(range(n_units))
            outputs["description"].extend([[words[int(i)] for i in row] for row in top_concepts])
            outputs["similarity"].extend([row.tolist() for row in top_vals])
            outputs["images"].extend([row.tolist() for row in top_images])
            log(f"[score] {layer}: {n_units} units scored")
        df, csv_path = write_results(outputs, cfg, write=is_master())
    log(f"[results] top concepts and images of {len(df)} units, CSV written in "
        f"{stage.seconds:.2f}s")
    return df, csv_path
