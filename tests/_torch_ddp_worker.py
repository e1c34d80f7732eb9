"""One rank of the 2-process CPU runs of ``tests/test_torch_ddp.py``
(underscore-prefixed so pytest does not collect it).

    python tests/_torch_ddp_worker.py <rank> <world> <port> <spec.pt> <out_dir>

Joins a gloo group on the CPU through
``stego_torch.parallel.dist.maybe_initialize_distributed``, runs every
scenario of the spec (written by the test with ``torch.save``) and writes
``<out_dir>/<scenario>_<rank>.pt``. Imports torch and stego_torch only.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from stego_torch.config import Config  # noqa: E402
from stego_torch.models.vit import ViTConfig  # noqa: E402
from stego_torch.parallel import dist  # noqa: E402


def trainable(seg):
    return {n: p.detach().clone() for n, p in seg.named_parameters()
            if p.requires_grad and not n.startswith("net.model.")}


def train_state(seg):
    return {"modules": {k: v.clone() for k, v in seg.state_dict().items()
                        if not k.startswith("net.model.")},
            "opts": {k: o.state_dict() for k, o in seg.optimizers().items()},
            "step": seg.step}


def load_state(seg, state):
    seg.load_state_dict(state["modules"], strict=False)
    for k, o in seg.optimizers().items():
        o.load_state_dict(state["opts"][k])
    seg.step = state["step"]


def segmenter(sc):
    from stego_torch.train.segmenter import UnsupervisedSegmenter

    seg = UnsupervisedSegmenter(sc["n_classes"], Config.from_dict(sc["cfg"]),
                                vit_cfg=ViTConfig(**sc["vit"]))
    if "backbone" in sc:
        seg.net.model.load_state_dict(sc["backbone"])
    if "state" in sc:
        load_state(seg, sc["state"])
    return seg


def run_steps(sc):
    """Image steps on this rank's rows of each global batch, with the
    global batch's draws."""
    from stego_torch.train.segmenter import make_train_step

    seg = segmenter(sc)
    step = make_train_step(seg, with_hist=sc.get("hist", True))
    out = {"metrics": [], "params": []}
    for batch, rand in zip(sc["batches"], sc["rands"]):
        rows = dist.local_rows(batch["img"].shape[0])
        out["metrics"].append(step({k: v[rows] for k, v in batch.items()},
                                   rand))
        out["params"].append(trainable(seg))
    out["state"] = train_state(seg)
    return out


class Items:
    """A contrastive dataset's ``.dataset`` of (img, label) arrays."""

    def __init__(self, imgs, labels):
        self.dataset = list(zip(imgs, labels))


def run_cached(sc):
    """The feature cache of the items built over the ranks (replicated, or
    row-sharded with ``feat_cache_sharded``), cached steps on this rank's
    rows of each global index batch, then a cached val epoch whose index
    batches hold -1 pads, its confusion matrices summed over the ranks by
    ``UnsupervisedMetrics.merge_stats``."""
    from stego_torch.train.feat_cache import build_feat_cache
    from stego_torch.train.segmenter import (make_cached_train_step,
                                             make_cached_val_epoch)
    from stego_torch.utils.metrics import UnsupervisedMetrics

    seg = segmenter(sc)
    cache = build_feat_cache(seg, Items(sc["imgs"], sc["labels"]), seg.cfg,
                             batch_size=sc["chunk"])
    step = make_cached_train_step(seg, with_hist=True)
    out = {"metrics": [], "params": [], "cache_rows": cache["feats"].shape[0]}
    for batch, rand in zip(sc["batches"], sc["rands"]):
        rows = dist.local_rows(batch["ind"].shape[0])
        out["metrics"].append(step(cache, {k: v[rows]
                                           for k, v in batch.items()}, rand))
        out["params"].append(trainable(seg))
    inds = sc["val_inds"]
    rows = dist.local_rows(inds.shape[1])
    conf = make_cached_val_epoch(seg)(cache, inds[:, rows])
    out["val"] = {}
    for k, extra in (("conf_linear", 0),
                     ("conf_cluster", seg.cfg.extra_clusters)):
        # the ranks' matrices summed, as a validation's metrics take them
        metrics = UnsupervisedMetrics("", seg.n_classes, extra, False)
        metrics.merge_stats(conf[k])
        out["val"][k] = torch.from_numpy(metrics.stats)
    out["state"] = train_state(seg)
    return out


def run_collectives(sc):
    """gather_rows forward and backward, row_take with -1 indices,
    average_grads with metrics, and the masked cross-entropy's rank share."""
    from stego_torch.ops.probe_ce import upsampled_masked_cross_entropy

    r = dist.rank()
    g = torch.Generator().manual_seed(100 + r)
    x = torch.randn(3, 4, generator=g, requires_grad=True)
    weight = torch.randn(3 * dist.world(), 4, generator=g)
    y = dist.gather_rows(x)
    (y * weight).sum().backward()
    block = sc["table"][dist.local_rows(sc["table"].shape[0])]
    taken = dist.row_take(block, sc["take"][r])
    p = torch.nn.Parameter(torch.zeros(5))
    p.grad = torch.full((5,), float(r + 1))
    means = dist.average_grads([p], {"m": torch.tensor(float(10 * r))})
    rows = dist.local_rows(sc["logits"].shape[0])
    logits = sc["logits"][rows].clone().requires_grad_(True)
    ce = upsampled_masked_cross_entropy(logits, sc["labels"][rows],
                                        sc["n_classes"])
    ce.backward()
    return {"x": x.detach(), "y": y.detach(), "x_grad": x.grad,
            "weight": weight, "taken": taken, "p_grad": p.grad,
            "m": means["m"], "ce": ce.detach(), "ce_grad": logits.grad}


def record_rank(out_dir):
    """``dist.launch``'s test function: in the group it joined, writes
    ``<rank>_of_<world>`` holding the sum of the ranks' rank + 1."""
    total = dist.all_reduce_(torch.tensor([dist.rank() + 1]))
    with open(os.path.join(out_dir, f"{dist.rank()}_of_{dist.world()}"),
              "w") as f:
        f.write(str(int(total)))


KINDS = {"steps": run_steps, "cached": run_cached,
         "collectives": run_collectives}


def main(rank, world, port, spec_path, out_dir):
    # two threads a rank: the suite runs several test files at once
    torch.set_num_threads(2)
    assert dist.maybe_initialize_distributed(
        backend="gloo", device="cpu", rank=rank, world_size=world,
        init_method=f"tcp://localhost:{port}", timeout_s=120)
    try:
        torch.manual_seed(0)
        spec = torch.load(spec_path, weights_only=False)
        for name, sc in spec.items():
            out = KINDS[sc["kind"]](sc)
            torch.save(out, os.path.join(out_dir, f"{name}_{rank}.pt"))
    finally:
        dist.destroy()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
