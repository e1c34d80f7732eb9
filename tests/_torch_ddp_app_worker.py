"""One rank of the 2-process CPU runs of ``tests/test_torch_ddp_app.py``
(underscore-prefixed so pytest does not collect it).

    python tests/_torch_ddp_app_worker.py <rank> <world> <port> \
        <spec.json> <out_dir>

Joins a gloo group on the CPU, then on the spec's directory dataset: the
KNN caches (``precompute_knns``), training runs of the app (straight, cut
and resumed, and one that rank 1 sends itself a SIGTERM in, then its
resume), the validation's summed confusion matrices of the trained
segmenter, and a dataset evaluation of its checkpoint and of the spec's
feature-pyramid checkpoint. Writes
``<out_dir>/app_<rank>.pt``; works in ``<out_dir>``, where the evaluation
writes its PNG trees. Imports torch and stego_torch only.
"""

import json
import os
import signal
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stego_torch.config import Config  # noqa: E402
from stego_torch.models.vit import ViTConfig  # noqa: E402
from stego_torch.parallel import dist  # noqa: E402

CPU = torch.device("cpu")


def state_of(seg):
    return {k: v.clone() for k, v in seg.state_dict().items()
            if not k.startswith("net.model.")}


def val_stats(trainer):
    """The validation's confusion matrices of the trainer's segmenter,
    summed over the ranks."""
    from stego_torch.data.loader import pad_batch
    from stego_torch.train.app import _to_device
    from stego_torch.utils.metrics import UnsupervisedMetrics

    seg = trainer.seg
    conf = None
    for batch in trainer.val_loader:
        out = trainer.val_step(_to_device(pad_batch(batch, trainer.val_bs),
                                          ("img", "label"), CPU))
        pair = (out["conf_linear"], out["conf_cluster"])
        conf = pair if conf is None else (conf[0] + pair[0],
                                          conf[1] + pair[1])
    stats = []
    for c, extra in zip(conf, (0, seg.cfg.extra_clusters)):
        m = UnsupervisedMetrics("", seg.n_classes, extra, False)
        m.merge_stats(c)
        stats.append(torch.from_numpy(m.stats))
    return stats


def sigterm_after(trainer, steps):
    """SIGTERM to this process once ``trainer`` has started ``steps``
    steps."""
    def watch():
        while len(trainer.step_starts) < steps:
            time.sleep(0.01)
        os.kill(os.getpid(), signal.SIGTERM)

    threading.Thread(target=watch, daemon=True).start()


def main(rank, world, port, spec_path, out_dir):
    from stego_torch.eval.evaluate import Evaluator
    from stego_torch.train.app import Trainer
    from stego_torch.train.knn_app import precompute_knns

    # two threads a rank: the suite runs several test files at once
    torch.set_num_threads(2)
    assert dist.maybe_initialize_distributed(
        backend="gloo", device="cpu", rank=rank, world_size=world,
        init_method=f"tcp://localhost:{port}", timeout_s=120)
    try:
        with open(spec_path) as f:
            spec = json.load(f)
        os.chdir(out_dir)
        vit = ViTConfig(**spec["vit"])
        cfg = Config.from_dict(spec["cfg"])
        out = {"knn": precompute_knns(
            cfg, dataset_names=["directory"], crop_types=[None],
            vit_cfg=vit, res=cfg.res, batch_size=spec["knn_batch"],
            device=CPU)}

        straight = Trainer(cfg.replace(experiment_name="a"), vit, device=CPU)
        out["straight_metrics"] = straight.run()
        out["straight"] = state_of(straight.seg)
        out["val"] = val_stats(straight)
        out["ckpt"] = straight.mgr.checkpoint_path()
        cut = cfg.replace(experiment_name="b", max_steps=cfg.max_steps // 2)
        Trainer(cut, vit, device=CPU).run()
        resumed = Trainer(cut.replace(max_steps=cfg.max_steps, resume=True),
                          vit, device=CPU)
        resumed.run()
        out["resumed_start"] = resumed.start_step
        out["resumed"] = state_of(resumed.seg)

        long = cfg.replace(experiment_name="c", max_steps=10_000,
                           val_freq=10_000, checkpoint_freq=10_000)
        stopped = Trainer(long, vit, device=CPU)
        if rank == 1:
            sigterm_after(stopped, 3)
        stopped.run()
        out["stopped_at"] = stopped.seg.step
        again = Trainer(long.replace(resume=True,
                                     max_steps=stopped.seg.step + 2),
                        vit, device=CPU)
        again.run()
        out["again_start"], out["again_step"] = (again.start_step,
                                                 again.seg.step)

        ev = Evaluator(cfg.replace(experiment_name="ev", batch_size=2),
                       out["ckpt"], CPU, vit_cfg=vit)
        out["eval_metrics"] = ev.run(save_outputs=True)
        out["eval"] = [torch.from_numpy(np.array(m.stats)) for m in
                       (ev.linear_metrics, ev.cluster_metrics)]
        fpn = Evaluator(cfg.replace(experiment_name="ev_fpn", batch_size=2),
                        spec["fpn_ckpt"], CPU)
        out["fpn_eval_metrics"] = fpn.run(save_outputs=False)
        out["fpn_eval"] = [torch.from_numpy(np.array(m.stats)) for m in
                           (fpn.linear_metrics, fpn.cluster_metrics)]
        torch.save(out, os.path.join(out_dir, f"app_{rank}.pt"))
    finally:
        dist.destroy()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
