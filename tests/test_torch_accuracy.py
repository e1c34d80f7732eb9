"""The port's accuracy gate on the synthetic mosaic, the counterpart of
``tests/test_accuracy.py``: the sensitive instrument
(``stego_torch.data.synthetic.tiny_benchmark_setup``: the tiny ViT, res 64,
f32, 40 steps) trained through the port's KNN precompute and training app
on the CPU, held to the JAX test's bands. ``jax.random`` streams cannot be
reproduced in torch, so the bands, not the JAX package's numbers, are the
gate. A random trunk is one draw whose cluster probe lands anywhere from
~15 to ~45 mIoU, so the row is run twice: on the port's own seeded trunk,
and on the JAX package's, the trunks ``tests/test_accuracy.py`` trains on
(the KNN app's from ``PRNGKey(0)``, the train app's from the first key of
``split(PRNGKey(seed), 3)``), carried over as ``pretrained_weights``:
there the row measures the port's numerics on the JAX test's trunks."""

import dataclasses
import os

import numpy as np
import torch

from stego_torch.data.synthetic import tiny_benchmark_setup
from stego_torch.train.app import train
from stego_torch.train.knn_app import precompute_knns


def check_bands(m):
    print(m)
    assert np.isfinite(list(m.values())).all()
    assert m["test/linear/mIoU"] >= 61.0, m
    assert m["test/linear/Accuracy"] >= 73.0, m
    assert m["test/cluster/mIoU"] >= 18.5, m
    assert m["test/cluster/Accuracy"] >= 39.0, m
    # the task must stay non-trivial: the cluster probe below its ceiling
    assert m["test/cluster/mIoU"] <= 95.0, m


def test_synthetic_mosaic_accuracy(tmp_path):
    cfg, vit = tiny_benchmark_setup(str(tmp_path), experiment_name="acc_test")
    precompute_knns(cfg, dataset_names=["directory"], crop_types=[None],
                    vit_cfg=vit, res=64, batch_size=8, device="cpu")
    check_bands(train(cfg, vit_cfg=vit, device="cpu"))


def test_synthetic_mosaic_accuracy_on_jax_trunks(tmp_path):
    import jax

    from stego_torch.models.convert import vit_state_dict
    from stego_tpu.models.vit import ViTConfig as JaxViTConfig
    from stego_tpu.models.vit import init_vit_params

    cfg, vit = tiny_benchmark_setup(str(tmp_path), experiment_name="acc_jax")
    jvit = JaxViTConfig(**dataclasses.asdict(vit))
    keys = {"knn": jax.random.PRNGKey(0),
            "train": jax.random.split(jax.random.PRNGKey(cfg.seed), 3)[0]}
    weights = {}
    for name, key in keys.items():
        weights[name] = os.path.join(str(tmp_path), f"{name}_trunk.pth")
        torch.save(vit_state_dict(jax.device_get(init_vit_params(key, jvit))),
                   weights[name])
    precompute_knns(cfg.replace(pretrained_weights=weights["knn"]),
                    dataset_names=["directory"], crop_types=[None],
                    vit_cfg=vit, res=64, batch_size=8, device="cpu")
    check_bands(train(cfg.replace(pretrained_weights=weights["train"]),
                      vit_cfg=vit, device="cpu"))
