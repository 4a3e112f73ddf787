"""The yardstick's arithmetic: the H100's peaks, the model FLOPs of a job or a step
counted from the configuration's shapes, and the least time of each hand kernel.

Peaks (NVIDIA's data sheet, H100 SXM, dense): 989 TFLOP/s bf16 on the tensor cores,
495 TFLOP/s TF32 (the fastest any float32-input product runs, so the float32 work is
counted at it), 67 TFLOP/s float32 on the CUDA cores, 3.35 TB/s of HBM. FLOPs are 2 a
multiply-add. A kernel's least time is the larger of its operations over the peak
and its bytes over the bandwidth, each input read once and each output written once.
Nothing here reads the program: the numbers are a function of the shapes alone."""
from __future__ import annotations

from typing import Dict, List

from benchmark.reference.efficientnet import block_table, head_width, paddings, stem_width

BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12
PEAK = {"bfloat16": BF16_FLOPS, "float32": TF32_FLOPS}


def tower_flops(cfg: dict) -> float:
    """One image's forward through the EfficientNet at the configured size: stem,
    each block's expand, depthwise, SE and project, and the head."""
    h, w = cfg["image_height"], cfg["image_width"]
    stem_pad, _, sizes = paddings(cfg, (h, w))
    sh = (h + sum(stem_pad[0]) - 3) // 2 + 1
    sw = (w + sum(stem_pad[1]) - 3) // 2 + 1
    macs = sh * sw * stem_width(cfg) * cfg["image_in_channels"] * 9
    in_hw = sh * sw
    for b, (oh, ow) in zip(block_table(cfg), sizes):
        if b["expand"] != 1:
            macs += in_hw * b["cin"] * b["cexp"]
        out_hw = oh * ow
        macs += out_hw * b["cexp"] * b["k"] ** 2
        macs += 2 * b["cexp"] * b["se"]
        macs += out_hw * b["cexp"] * b["cout"]
        in_hw = out_hw
    macs += in_hw * block_table(cfg)[-1]["cout"] * head_width(cfg)
    return 2.0 * macs


def bert_flops(cfg: dict, n_texts: int) -> float:
    """The text tower over n_texts sequences of max_length tokens (the reference pads
    every concept to max_length): the dense layers and the attention products."""
    t, h, f = cfg["max_length"], cfg["hidden_size"], cfg["intermediate_size"]
    per_token_layer = 4 * h * h + 2 * h * f + 2 * t * h
    return 2.0 * n_texts * t * cfg["num_hidden_layers"] * per_token_layer


def scoring_flops(units: int, concepts: int, top_k: int, n_images: int) -> float:
    """Soft-WPMI at 4 operations a term (u, k, c), and the image-concept products."""
    return 4.0 * units * min(top_k, n_images) * concepts


def dissect_job_seconds(target_cfg: dict, dissector_cfg: dict, n_images: int,
                        n_concepts: int, top_k: int, staged: bool) -> float:
    """The least time of one dissection job's model FLOPs, each part at the peak of
    the dtype its configuration states: the target tower (once more for the
    dissector's embed when the target is another model), the image and text
    projections, BERT over the concepts once, and the scoring (float32)."""
    d = dissector_cfg
    units = sum(b["cout"] for b in block_table(target_cfg)[:target_cfg["dissected_blocks"]])
    secs = n_images * tower_flops(target_cfg) / PEAK[target_cfg["dtype"]]
    if staged:
        secs += n_images * tower_flops(d) / PEAK[d["dtype"]]
    proj = 2.0 * (n_images * head_width(d) + n_concepts * d["hidden_size"]) * d["proj_dim"]
    secs += (proj + bert_flops(d, n_concepts)) / PEAK[d["dtype"]]
    secs += (scoring_flops(units, n_concepts, top_k, n_images)
             + 2.0 * n_images * n_concepts * d["proj_dim"]) / PEAK["float32"]
    return secs


def train_step_seconds(cfg: dict, batch: int) -> float:
    """One training step's least time: 3x the forward (the backward is two products
    a forward product) of the tower and the head, at the bf16 peak."""
    fwd = batch * (tower_flops(cfg) + 2.0 * head_width(cfg) * cfg["n_class"])
    return 3.0 * fwd / BF16_FLOPS


def kernel2_shapes(cfg: dict) -> List[dict]:
    """The blocks whose front half kernel 2 computes (stride 1 with an expansion), with
    their output H x W, in forward order."""
    _, _, sizes = paddings(cfg, (cfg["image_height"], cfg["image_width"]))
    return [dict(b, h=oh, w=ow) for b, (oh, ow) in zip(block_table(cfg), sizes)
            if b["stride"] == 1 and b["expand"] != 1]


def kernel2_bound(batch: int, h: int, w: int, cin: int, cexp: int, k: int, bf16: bool) -> Dict:
    """Kernel 2 (1x1 expand, BatchNorm, SiLU, k x k depthwise, BatchNorm, SiLU, and
    the SE's sum over H x W) on one block: bytes of x, both weights, both
    BatchNorms' (mean, mul, bias), the output and the squeeze; operations of the
    expand (bf16 at 989 TFLOP/s; float32 as 3xTF32, three products at 495) beside the
    depthwise (67 TFLOP/s float32), whichever is longer."""
    size = 2 if bf16 else 4
    pix = batch * h * w
    nbytes = (pix * (cin + cexp) * size + (cin * cexp + k * k * cexp) * size
              + 6 * cexp * 4 + batch * cexp * 4)
    expand, dw = 2.0 * pix * cin * cexp, 2.0 * k * k * pix * cexp
    t_ops = max(expand / BF16_FLOPS if bf16 else 3 * expand / TF32_FLOPS, dw / FP32_FLOPS)
    t_bytes = nbytes / HBM_BYTES
    return {"seconds": max(t_ops, t_bytes), "by": "bytes" if t_bytes >= t_ops else "operations"}


def kernel2_forward(cfg: dict, batch: int, bf16: bool) -> Dict:
    """The least time of one forward's kernel-2 launches, and what bounds most of it."""
    rows = [kernel2_bound(batch, s["h"], s["w"], s["cin"], s["cexp"], s["k"], bf16)
            for s in kernel2_shapes(cfg)]
    by_ops = sum(r["seconds"] for r in rows if r["by"] == "operations")
    total = sum(r["seconds"] for r in rows)
    return {"seconds": total, "launches": len(rows),
            "by": "operations" if by_ops >= total - by_ops else "bytes"}


def kernel1_bound(units: int, concepts: int, k: int, n_images: int) -> Dict:
    """Kernel 1 (soft-WPMI's gather and log-sum): bytes of softmax(clip) [N, C], the
    indices [U, k], p [k] and the output [U, C]; 4 float32 operations a term."""
    nbytes = (n_images * concepts + units * k + k + units * concepts) * 4
    t_bytes, t_ops = nbytes / HBM_BYTES, 4.0 * units * k * concepts / FP32_FLOPS
    return {"seconds": max(t_bytes, t_ops), "by": "bytes" if t_bytes >= t_ops else "operations"}
