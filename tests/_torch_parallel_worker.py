"""Worker of tests/test_torch_parallel.py: one rank of a 2-rank gloo process group on
the CPU. Imports torch and the PyTorch port only (no jax, no conftest).

    python tests/_torch_parallel_worker.py <rank> <world> <port> <workdir>

Reads <workdir>/inputs.pt (weights carried from the JAX package, batches, data
paths), runs every multi-process scenario once, in order, and writes its results to
<workdir>/rank<rank>.pt:
  * the staged harvest (uint8 and float32 paths) over an uneven probe;
  * the resident dissection of a tiny BreastClip on an odd probe;
  * three data-parallel fine-tune steps, and two with drop-connect (EfficientNet-B0);
  * a data-parallel and a tensor-parallel (1, 2) pretraining step;
  * gather_predictions on an odd length, all_gather_with_grad's gradient, the
    drop-connect masks of a data-parallel step;
  * do_experiments at model_parallel=2 and cli.pretrain with --model-parallel 2.
"""
import os
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
# torch.utils.tensorboard imports TensorFlow where it is installed (tens of seconds a
# process); the loggers are no-ops without it
sys.modules["torch.utils.tensorboard"] = None

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

rank, world, port, workdir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
torch.set_num_threads(2)

from mammodissect_torch.parallel.multihost import initialize  # noqa: E402

initialize(coordinator_address=f"localhost:{port}", num_processes=world, process_id=rank,
           backend="gloo", device="cpu")

from mammodissect_torch.data.probes import ArrayProbe, get_probe  # noqa: E402
from mammodissect_torch.dissect.dissectors import get_dissector  # noqa: E402
from mammodissect_torch.dissect.engine import (  # noqa: E402
    DissectConfig,
    harvest_probe,
    run_dissection,
)
from mammodissect_torch.dissect.targets import EfficientNetTarget  # noqa: E402
from mammodissect_torch.models.breastclip import BreastClipModule  # noqa: E402
from mammodissect_torch.models.classifier import BreastClipClassifierModule  # noqa: E402
from mammodissect_torch.models.efficientnet import EfficientNet  # noqa: E402
from mammodissect_torch.models.layers import drop_connect_mask, init_weights  # noqa: E402
from mammodissect_torch.parallel.collectives import all_gather_with_grad  # noqa: E402
from mammodissect_torch.parallel.mesh import data_parallel, make_mesh  # noqa: E402
from mammodissect_torch.parallel.multihost import gather_predictions  # noqa: E402
from mammodissect_torch.parallel.sharding import (  # noqa: E402
    apply_tensor_parallel,
    full_state_dict,
    shard_batch,
)
from mammodissect_torch.train.clip_trainer import (  # noqa: E402
    batch_to_device,
    make_clip_train_step,
)
from mammodissect_torch.train.trainer import Trainer, make_optimizer  # noqa: E402

inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
out = {}
cpu = torch.device("cpu")


def ft_steps(model, batches, optimizer, scheduler=None, **kw):
    """Train steps on this rank's half of each global batch; (losses, state)."""
    tr = Trainer(model, optimizer, scheduler, loss_kind="bce", input_wire="u8",
                 norm_mean=inp["mean"], norm_std=inp["std"], device="cpu", **kw)
    losses = []
    for u8, y, n_valid in batches:
        half = len(y) // world
        sl = slice(rank * half, (rank + 1) * half)
        losses.append(tr.train_batch(u8[sl], y[sl], min(max(n_valid - rank * half, 0), half)))
    return losses, {k: v.clone() for k, v in model.state_dict().items()}


def shift_invariant(name):
    return name.endswith("_bn2.bias") or name.endswith("attention.self.key.bias")


def pretrain_model():
    model = BreastClipModule(vocab_size=inp["pt_vocab"], **inp["pt_narrow"])
    model.load_state_dict(inp["pt_state"])
    return model


def pretrain_step(model, batch, mesh=None):
    labels = {k: "frozen" if shift_invariant(k) else "train" for k, _ in model.named_parameters()}
    optimizer, scheduler = make_optimizer(model, 1e-3, 1e-4, 0, 10, param_labels=labels)
    step = make_clip_train_step(model, optimizer, scheduler, label_smoothing=0.1,
                                input_wire="u8", norm_mean=inp["mean"], norm_std=inp["std"],
                                generator=torch.Generator().manual_seed(3), mesh=mesh)
    return float(step(batch_to_device(batch, cpu)))


def run():
    # -- the staged harvest over an uneven probe, both wires
    target = EfficientNetTarget(EfficientNet("efficientnet-test", in_channels=1), cpu)
    target.model.load_state_dict(inp["tower"])
    for spec in ("synthetic_u8", "synthetic"):
        got, n = harvest_probe(target, get_probe(spec, **inp["harvest_kw"]), inp["harvest_layers"],
                               "avg", 5, pipeline_depth=1)
        out[f"harvest_{spec}"] = (got, n)

    # -- the resident dissection of an odd probe
    dissector = get_dissector("breastclip", device="cpu", **inp["small"])
    dissector.module.load_state_dict(inp["small_state"])
    cfg = DissectConfig(activation_dir=os.path.join(workdir, f"acts{rank}"),
                        result_dir=os.path.join(workdir, "results"), device="cpu",
                        **inp["resident_cfg"])
    logs = []
    df, csv_path = run_dissection(cfg, probe=ArrayProbe(inp["resident_images"], mean=0.3, std=0.25),
                                  dissector=dissector, log=logs.append)
    out["resident"] = {"df": df.to_dict("list"), "csv_path": csv_path, "logs": logs,
                       "spills": sorted(os.listdir(cfg.activation_dir))}

    # -- three data-parallel fine-tune steps, the JAX test's weights and batches
    model = BreastClipClassifierModule("efficientnet-test", n_class=1, bn_momentum=0.9,
                                       pad_mode="same")
    model.load_state_dict(inp["ft_state"])
    labels = {k: "frozen" if k.endswith("_bn2.bias") else "train"
              for k, _ in model.named_parameters()}
    optimizer, scheduler = make_optimizer(model, 1e-3, 1e-4, 2, 10, param_labels=labels)
    out["finetune"] = ft_steps(model, inp["ft_batches"], optimizer, scheduler,
                               pos_weight=inp["pos_weight"])

    # -- two steps of a tower with drop-connect (EfficientNet-B0's residual blocks)
    model = BreastClipClassifierModule("efficientnet-b0", n_class=1, bn_momentum=0.9,
                                       pad_mode="same")
    init_weights(model, torch.Generator().manual_seed(0))
    out["dropconnect"] = ft_steps(model, inp["b0_batches"],
                                  torch.optim.SGD(model.parameters(), lr=0.01), seed=5)

    # -- a data-parallel pretraining step: this rank's half of the global batch
    model = pretrain_model()
    loss = pretrain_step(model, shard_batch(inp["pt_batch"], rank=rank, size=world))
    out["pretrain_dp"] = {"loss": loss, "state": model.state_dict(),
                          "grads": {k: p.grad.clone() for k, p in model.named_parameters()
                                    if p.grad is not None}}

    # -- a tensor-parallel step on a (1, 2) mesh: every rank the whole batch
    mesh = make_mesh(model_parallel=2)
    model = pretrain_model()
    plan = apply_tensor_parallel(model, mesh)
    loss = pretrain_step(model, inp["pt_batch"], mesh=mesh)
    out["pretrain_tp"] = {"loss": loss, "state": full_state_dict(model), "plan": plan,
                          "local_shapes": {k: tuple(v.shape)
                                           for k, v in model.state_dict().items()}}

    # -- the collectives
    local = np.arange(4, dtype=np.float32) + 4 * rank
    out["gather_predictions"] = gather_predictions(local, 7)
    x = (torch.arange(6.0).reshape(3, 2) * (rank + 1)).requires_grad_(True)
    gathered = all_gather_with_grad(x)
    (gathered * torch.arange(12.0).reshape(6, 2)).sum().backward()
    out["all_gather_with_grad"] = (gathered.detach(), x.grad.clone())
    with data_parallel(dist.group.WORLD):
        out["masks"] = drop_connect_mask(4, 0.5, cpu, torch.Generator().manual_seed(7))

    # -- model_parallel=2 trains under the process group
    from mammodissect_torch.train.experiments import FinetuneConfig, do_experiments

    ft_dir = inp["finetune_dir"]
    oof = do_experiments(FinetuneConfig(
        csv_file=os.path.join(ft_dir, "meta.csv"), data_dir=ft_dir, label="Mass",
        arch="t_test_ft", img_size=(32, 24), pad_mode="same", dtype="float32", epochs=1,
        batch_size=2, checkpoints=os.path.join(workdir, "ft_ck"),
        output_path=os.path.join(workdir, "ft_out"), tensorboard_path=os.path.join(workdir, "tb"),
        model_parallel=2, device="cpu"), log=lambda *_: None)
    out["do_experiments"] = oof.to_dict("list")

    from mammodissect_torch.cli.pretrain import main as pretrain_main

    os.chdir(workdir)  # the tensorboard directory's default is relative
    rc = pretrain_main(inp["pretrain_argv"] + ["--model-parallel", "2", "--device", "cpu"])
    out["pretrain_cli"] = rc


try:
    t0 = time.perf_counter()
    run()
    out["seconds"] = time.perf_counter() - t0
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
except Exception:
    traceback.print_exc()
    sys.exit(1)
