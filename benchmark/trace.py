"""A bounded slice of a run under `torch.profiler`, read in memory.

The slice's device events (kernels, copies, memsets) are classified by a frozen
table: the port's own kernels by name, every other kernel by the ATen op that
launched it (the innermost op open on the launching thread around the CUDA runtime
call that the kernel's correlation id names), as
`tools/profile_split.py` did when this table was copied from it. Attributing by
kernel name is fragile: a renamed kernel drops out of its class silently, which is
why the roofline readers return nothing when they count no launch.

The busy time is the union of the device intervals; the idle share is taken against
the slice's wall time on the harness's clock, not the span from the first device
event to the last."""
from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from benchmark.flops import kernel2_forward

# the port's kernels, by name; kernel 2's squeeze partials belong to the launch
# that precedes them on the stream
OWN_KERNELS = (("kernel2.fp32", r"expand_dw_f32|split_weights_kernel"),
               ("kernel2.bf16", r"expand_dw_bf16|sigmoid_bf16"),
               ("kernel2.squeeze", r"squeeze_tiles_kernel"),
               ("kernel1", r"gather_logsum"))
KERNEL2_MAIN = {"kernel2.fp32": r"expand_dw_f32", "kernel2.bf16": r"expand_dw_bf16"}
# every other kernel by its ATen op
OP_CLASSES = (
    ("copies and casts", ("aten::copy_", "aten::_to_copy", "aten::clone", "aten::cat",
                          "aten::index_copy_", "aten::contiguous", "aten::fill_",
                          "aten::zero_", "aten::index_select", "aten::index",
                          "aten::expand", "aten::pad", "aten::constant_pad_nd")),
    ("BatchNorm (sub, addcmul)", ("aten::sub", "aten::addcmul", "aten::rsub")),
    ("SiLU and sigmoid chains", ("aten::neg", "aten::exp", "aten::reciprocal", "aten::where",
                                 "aten::silu", "aten::sigmoid", "aten::silu_backward",
                                 "aten::sigmoid_backward", "aten::erfc", "aten::gelu",
                                 "aten::gelu_backward", "aten::log_sigmoid_forward",
                                 "aten::log_sigmoid_backward")),
    ("products and sums", ("aten::mul", "aten::add", "aten::div", "aten::mul_", "aten::add_",
                           "aten::div_", "aten::lt", "aten::masked_fill")),
    ("convolutions (cuDNN)", ("aten::cudnn_convolution", "aten::_convolution",
                              "aten::convolution_backward", "aten::cudnn_convolution_backward",
                              "aten::cudnn_convolution_backward_input",
                              "aten::cudnn_convolution_backward_weight")),
    ("BatchNorm (cuDNN)", ("aten::cudnn_batch_norm", "aten::native_batch_norm",
                           "aten::cudnn_batch_norm_backward",
                           "aten::native_batch_norm_backward", "aten::var_mean")),
    ("matrix products", ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")),
    ("reductions", ("aten::sum", "aten::mean", "aten::amax", "aten::amin",
                    "aten::linalg_vector_norm", "aten::_softmax", "aten::native_layer_norm",
                    "aten::logsumexp", "aten::sort", "aten::topk", "aten::max", "aten::min")),
    ("optimizer (AdamW)", ("aten::_fused_adamw_", "aten::_foreach_mul_", "aten::_foreach_add_",
                           "aten::_foreach_addcmul_", "aten::_foreach_addcdiv_",
                           "aten::_foreach_sqrt", "aten::_foreach_div_", "aten::_foreach_lerp_")),
)
ELEMENTWISE = ("copies and casts", "BatchNorm (sub, addcmul)", "SiLU and sigmoid chains",
               "products and sums")
CONVOLUTIONS = ("convolutions (cuDNN)",)
_CLASS_OF_OP = {op: cls for cls, ops in OP_CLASSES for op in ops}
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Slice:
    wall_s: float
    busy_s: float = 0.0
    classes: Dict[str, float] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    events: int = 0

    def seconds(self, names) -> float:
        return sum(self.classes.get(n, 0.0) for n in names)


def union_seconds(intervals: List[Tuple[int, int]]) -> float:
    """The length of the union of [start, end) intervals in ns, in seconds."""
    busy, end = 0, None
    for t0, t1 in sorted(intervals):
        if end is None or t0 > end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    return busy / 1e9


def activity(e) -> str:
    """A kineto event's kind as the Chrome trace names it ("cpu_op", "cuda_runtime",
    "kernel", "gpu_memcpy", "gpu_memset", or an annotation), told from the event's
    device and name."""
    on_device = str(e.device_type()).endswith("CUDA")
    if e.is_user_annotation():
        return "gpu_user_annotation" if on_device else "user_annotation"
    name = e.name()
    if on_device:
        return ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    return "cuda_runtime" if name.startswith("cu") and "::" not in name else "cpu_op"


def rows(events) -> List[tuple]:
    """Each event once as (kind, name, start ns, end ns, correlation id, linked
    correlation id, thread): the profiler's accessors are slow, so they are read
    once."""
    out = []
    for e in events:
        start = e.start_ns()
        out.append((activity(e), e.name(), start, start + e.duration_ns(), e.correlation_id(),
                    e.linked_correlation_id(), e.start_thread_id()))
    return out


def launching_ops(table) -> Dict[int, str]:
    """{correlation id of each CUDA runtime call: the innermost ATen op open around it
    on its thread}, by a sweep over each thread's events in time order (the op stack
    of the thread)."""
    threads: Dict[int, list] = {}
    for kind, name, start, end, corr, _, tid in table:
        if kind == "cpu_op":
            threads.setdefault(tid, []).append((start, -end, False, name))
        elif kind == "cuda_runtime":
            threads.setdefault(tid, []).append((start, -end, True, corr))
    out: Dict[int, str] = {}
    for items in threads.values():
        stack: List[Tuple[int, str]] = []
        for start, neg_end, runtime, payload in sorted(items):
            while stack and stack[-1][0] <= start:
                stack.pop()
            if runtime:
                if stack:
                    out[payload] = stack[-1][1]
            else:
                stack.append((-neg_end, payload))
    return out


def classify(events, wall_s: float, gaps: int = 10) -> Slice:
    """The slice of a profiler's kineto events."""
    table = rows(events)
    op_of = launching_ops(table)
    host = [(start, end, name) for kind, name, start, end, *_ in table if kind == "cpu_op"]
    dev = []
    for kind, name, start, end, corr, linked, _ in table:
        if kind in _DEVICE:
            op = op_of.get(corr) or op_of.get(linked)
            dev.append((start, end, name, op or f"{kind} (no op)"))
    dev.sort()
    out = Slice(wall_s=wall_s, events=len(dev))
    classes: Dict[str, float] = {}
    last_main = None
    for t0, t1, name, op in dev:
        cls = next((c for c, pat in OWN_KERNELS if re.search(pat, name)), None)
        if cls is not None:
            main = next((c for c, pat in KERNEL2_MAIN.items() if re.search(pat, name)), None)
            if main is not None:
                last_main = main
                out.launches[main] = out.launches.get(main, 0) + 1
            if cls == "kernel2.squeeze":
                cls = last_main or cls
            if cls == "kernel1":
                out.launches["kernel1"] = out.launches.get("kernel1", 0) + 1
        else:
            cls = _CLASS_OF_OP.get(op, op)
        classes[cls] = classes.get(cls, 0.0) + (t1 - t0) / 1e9
    out.classes = dict(sorted(classes.items(), key=lambda kv: -kv[1]))
    out.busy_s = union_seconds([(t0, t1) for t0, t1, _, _ in dev])
    out.idle_gaps = _gaps(dev, host, gaps)
    return out


def _gaps(dev, host, n: int) -> List[Tuple[str, float]]:
    """The n longest stretches with nothing on the device, each named by the host's
    innermost ATen op at the stretch's midpoint ("host" when none ran)."""
    spans, end = [], None
    for t0, t1, _, _ in dev:
        if end is not None and t0 > end:
            spans.append((t0 - end, end, t0))
        end = t1 if end is None else max(end, t1)
    spans = sorted(spans, reverse=True)[:n]
    named = []
    for length, g0, g1 in spans:
        mid = (g0 + g1) // 2
        inner = [(h0, name) for h0, h1, name in host if h0 <= mid < h1]
        named.append((max(inner)[1] if inner else "host", length / 1e9))
    return named


def ms_per_image(run, classes) -> Optional[float]:
    """Device ms an image of the traced slice in the classes `classes`, over the images
    of the window's traced units; None without a trace."""
    sl = run.trace
    if sl is None or not sl.events:
        return None
    return 1e3 * sl.seconds(classes) / sum(u.work for u in run.window.units if u.traced)


def idle_share(run) -> Optional[float]:
    """100 x (1 - the union of the device's kernel, copy and memset intervals / the
    traced slice's wall time on the harness's clock); None without a trace."""
    sl = run.trace
    if sl is None or not sl.events or sl.wall_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.wall_s)


def kernel2_roofline(run, cls: str, cfg: dict, bf16: bool) -> Optional[dict]:
    """Kernel 2's least time over its measured device time, in %, for the launches of
    class `cls` in the traced slice: the B5 blocks' bounds (`flops.kernel2_forward` of
    `cfg` at the cell's batch) once for each forward seen, a forward being as many
    launches as the tower has kernel-2 blocks; None when the trace shows no whole
    forward of launches (a renamed kernel, or none launched)."""
    sl = run.trace
    if sl is None:
        return None
    n, secs = sl.launches.get(cls, 0), sl.classes.get(cls, 0.0)
    bound = kernel2_forward(cfg, run.ctx.traffic["batch_size"], bf16)
    if n == 0 or n % bound["launches"] or secs <= 0:
        return None
    least = n // bound["launches"] * bound["seconds"]
    return {"value": 100.0 * least / secs, "bound_by": bound["by"], "card": run.power}


def profile(fn: Callable, sync: Callable):
    """(fn(), the profiler's events, the wall seconds of the call): the profiler on
    CPU and CUDA activity around one call, the device synchronized inside. The events
    stay in memory; `classify` reads them once the window has closed."""
    from torch.profiler import ProfilerActivity, profile as _profile

    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
    return out, prof.profiler.kineto_results.events(), wall
