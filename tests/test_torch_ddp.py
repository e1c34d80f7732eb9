"""Data parallelism (``stego_torch/parallel/dist.py``) on 2 CPU processes
over gloo: the 2-rank train step against the JAX package's step on the
global batch, with the same weights and the JAX step's own draws (global
negatives through C2, sampled and full-field, against one JAX process;
local negatives through C1 against JAX on a 2-device mesh); the cached
step, replicated and ``feat_cache_sharded``, against one port process; and
the collectives. Both ranks of each run start once (``tests/
_torch_ddp_worker.py``) while the parent computes the references.

Batch 4 (2 images a rank), res 32 (4 x 4 feature maps), the labels' ignore
pixels spread unevenly over the two shards, so that a per-shard mean of the
linear probe's loss fails the gates."""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from stego_tpu.ops.math import block_local_super_perm as jax_block_perm
from stego_tpu.parallel.mesh import make_mesh
from stego_tpu.train.segmenter import \
    UnsupervisedSegmenter as JaxUnsupervisedSegmenter
from stego_tpu.train.segmenter import _split_step_keys
from stego_tpu.train.segmenter import make_train_step as jax_make_train_step
from stego_torch.config import Config
from stego_torch.ops.probe_ce import upsampled_masked_cross_entropy
from stego_torch.train.feat_cache import build_feat_cache
from stego_torch.train.segmenter import (draw_step_randomness,
                                         make_cached_train_step,
                                         make_cached_val_epoch)
from tests._torch_ddp_worker import Items, load_state, train_state
from tests.test_torch_config import torch_config
from tests.test_torch_train_step import (N_CLASSES, STATE_TOL,
                                         assert_state_close, jax_step_draws,
                                         make_cfg, setup)
from tests.test_torch_vit import SMALL
from tests._torch_cpu import child_env, one_intra_op_thread  # noqa: F401

B, RES, STEPS = 4, 32, 2
WORLD = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(worker, *args, world=WORLD):
    """Popen one process a rank of ``tests/<worker>``, each given its rank,
    the world size, a free port and ``args``."""
    port = free_port()
    env = {k: v for k, v in child_env().items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    return [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", worker), str(r),
         str(world), str(port), *map(str, args)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]


def wait_ranks(procs, timeout=180):
    """Every rank's exit; a rank that fails or hangs fails the test."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


def cfg_dict(cfg):
    return json.loads(cfg.to_json())


def ddp_batch(seed):
    """A global batch of B images at RES; rank 0's labels are 60% ignore
    pixels, rank 1's 10%."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((B, RES, RES, 3)).astype(np.float32)
    pos = img + 0.05 * rng.standard_normal(img.shape).astype(np.float32)
    out = {"img": img, "img_pos": pos}
    for key in ("label", "label_pos"):
        label = rng.integers(0, N_CLASSES, (B, RES, RES))
        share = np.repeat([0.6, 0.1], B // WORLD)[:, None, None]
        label[rng.random(label.shape) < share] = -1
        out[key] = label.astype(np.int32)
    return out


def mesh_draws(jseg, key, blocks):
    """jax_step_draws with the negatives' ``block_local_super_perm`` of
    ``blocks`` blocks (negatives_scope=local on a mesh of that size)."""
    rand = jax_step_draws(jseg, key, B)
    k_neg = jax.random.split(_split_step_keys(key)["corr"], 3)[2]
    rand["perms"] = [torch.from_numpy(np.array(jax_block_perm(B, nk, blocks)))
                     .long() for nk in jax.random.split(
                         k_neg, jseg.cfg.neg_samples)]
    return rand


STEP_CASES = {
    # global negatives (the default), sampled: C2 over gathered maps
    "global": dict(fused_sampling="auto"),
    "full_field": dict(full_field_loss=True, fused_sampling="auto"),
    # local negatives: C1 on each rank, JAX on a 2-device mesh
    "local": dict(negatives_scope="local", fused_sampling="on"),
}


def step_case(name):
    """The JAX config, segmenter (a 2-device mesh for local negatives),
    backbone and train state, the port's segmenter holding them, the
    batches and each step's JAX key and draws."""
    cfg = make_cfg(res=RES, **STEP_CASES[name])
    jseg, bb, jstate, seg = setup(cfg)
    blocks = 1
    if name == "local":
        jseg = JaxUnsupervisedSegmenter(N_CLASSES, cfg, vit_cfg=jseg.vit_cfg,
                                        mesh=make_mesh(WORLD))
        blocks = WORLD
    keys = [jax.random.PRNGKey(200 + i) for i in range(STEPS)]
    rands = [mesh_draws(jseg, k, blocks) for k in keys]
    batches = [ddp_batch(10 + i) for i in range(STEPS)]
    return cfg, jseg, bb, jstate, seg, keys, rands, batches


def cached_inputs(seed=4, n=9):
    rng = np.random.default_rng(seed)
    imgs = rng.standard_normal((n, RES, RES, 3)).astype(np.float32)
    labels = rng.integers(-1, N_CLASSES, (n, RES, RES)).astype(np.int32)
    batches = [{"ind": torch.from_numpy(rng.permutation(n)[:B]),
                "ind_pos": torch.from_numpy(rng.integers(0, n, B))}
               for _ in range(STEPS)]
    # val batches of the global batch, the last with -1 pads
    nb = -(-n // B)
    val = np.concatenate([np.arange(n), -np.ones(nb * B - n, np.int64)])
    return imgs, labels, batches, torch.from_numpy(val.reshape(nb, B))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start both ranks on every scenario, compute the references while
    they run, and return {scenario: (per-rank outputs, reference)}."""
    tmp = tmp_path_factory.mktemp("ddp")
    spec, cases = {}, {}
    for name in STEP_CASES:
        cfg, jseg, bb, jstate, seg, keys, rands, batches = step_case(name)
        cases[name] = (jseg, bb, jstate, keys, batches)
        spec[name] = dict(
            kind="steps", cfg=cfg_dict(torch_config(cfg)), vit=SMALL,
            n_classes=N_CLASSES, backbone=seg.net.model.state_dict(),
            state=train_state(seg), rands=rands, hist=False,
            batches=[{k: torch.from_numpy(v) for k, v in b.items()}
                     for b in batches])
    imgs, labels, ind_batches, val_inds = cached_inputs()
    for name, sharded in (("cached", False), ("cached_sharded", True)):
        cfg = torch_config(make_cfg(res=RES, fused_sampling="auto",
                                    feat_cache_sharded=sharded))
        seg = setup(make_cfg(res=RES))[3]
        seg.cfg = cfg
        gen = torch.Generator().manual_seed(7)
        spec[name] = dict(
            kind="cached", cfg=cfg_dict(cfg), vit=SMALL, n_classes=N_CLASSES,
            backbone=seg.net.model.state_dict(), state=train_state(seg),
            imgs=imgs, labels=labels, chunk=2, batches=ind_batches,
            rands=[draw_step_randomness(seg, B, gen) for _ in ind_batches],
            val_inds=val_inds)
    g = torch.Generator().manual_seed(3)
    labels = torch.randint(0, N_CLASSES, (B, 8, 8), generator=g)
    labels[:B // 2][torch.rand((B // 2, 8, 8), generator=g) < 0.7] = -1
    spec["collectives"] = dict(
        kind="collectives", n_classes=N_CLASSES,
        table=torch.randn(6, 3, generator=g),
        take=torch.tensor([[5, -1, 0], [2, 3, 6]]),
        logits=torch.randn(B, 4, 4, N_CLASSES, generator=g), labels=labels)
    spec_path = tmp / "spec.pt"
    torch.save(spec, spec_path)
    procs = start_ranks("_torch_ddp_worker.py", spec_path, tmp)

    refs = {}
    try:
        for name, (jseg, bb, jstate, keys, batches) in cases.items():
            step = jax.jit(jax_make_train_step(jseg, with_hist=False))
            states, metrics = [], []
            for key, batch in zip(keys, batches):
                jstate, m = step(bb, jstate, batch, key)
                jstate = jax.tree.map(np.asarray, jstate)
                states.append(jstate)
                metrics.append({k: float(v) for k, v in m.items()})
            refs[name] = (states, metrics)
        for name in ("cached", "cached_sharded"):
            refs[name] = one_process_cached(spec[name])
        refs["collectives"] = spec["collectives"]
    finally:
        wait_ranks(procs)
    return {name: ([torch.load(tmp / f"{name}_{r}.pt", weights_only=False)
                    for r in range(WORLD)], refs.get(name))
            for name in spec}


def one_process_cached(sc):
    """The cached scenario of ``sc`` in this process, on the whole global
    batches."""
    from stego_torch.train.segmenter import UnsupervisedSegmenter
    from stego_torch.models.vit import ViTConfig

    seg = UnsupervisedSegmenter(sc["n_classes"], Config.from_dict(sc["cfg"]),
                                vit_cfg=ViTConfig(**sc["vit"]))
    seg.net.model.load_state_dict(sc["backbone"])
    load_state(seg, sc["state"])
    cache = build_feat_cache(seg, Items(sc["imgs"], sc["labels"]), seg.cfg,
                             batch_size=sc["chunk"])
    step = make_cached_train_step(seg, with_hist=True)
    metrics = [step(cache, batch, rand)
               for batch, rand in zip(sc["batches"], sc["rands"])]
    return {"metrics": metrics, "state": train_state(seg),
            "val": make_cached_val_epoch(seg)(cache, sc["val_inds"]),
            "cache_rows": cache["feats"].shape[0]}


def assert_ranks_equal(outs):
    """Both ranks' trainable parameters equal bit for bit after every
    step."""
    for step, (a, b) in enumerate(zip(outs[0]["params"],
                                      outs[1]["params"])):
        for k in a:
            assert torch.equal(a[k], b[k]), (step, k)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_two_rank_step_matches_jax(runs, name):
    """Each of STEPS 2-rank steps: both ranks' metrics are the JAX step's
    on the global batch (gates of the card's phase ddp), both ranks'
    parameters are equal bit for bit, and the updated parameters and Adam
    moments are JAX's within STATE_TOL (rtol 2e-4, atol 1e-5)."""
    outs, (states, metrics) = runs[name]
    assert_ranks_equal(outs)
    for r in range(WORLD):
        for got, want in zip(outs[r]["metrics"], metrics):
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_allclose(float(got[k]), want[k],
                                           **METRIC_TOL, err_msg=(r, k))
    cfg = make_cfg(res=RES, **STEP_CASES[name])
    seg = setup(cfg)[3]
    load_state(seg, outs[0]["state"])
    assert seg.step == STEPS
    assert_state_close(seg, states[-1])


@pytest.mark.parametrize("name", ["cached", "cached_sharded"])
def test_two_rank_cached_step_matches_one_process(runs, name):
    """The cached steps of 2 ranks (cache replicated, or row-sharded with
    the padded row and -1 indices read through row_take) against the same
    steps in one process: metrics, the summed cd histograms, the train
    state, and the cached val epoch's confusion matrices exactly."""
    outs, ref = runs[name]
    assert_ranks_equal(outs)
    want_rows = 5 if name == "cached_sharded" else 9
    assert [o["cache_rows"] for o in outs] == [want_rows] * WORLD
    for got, want in zip(outs[0]["metrics"], ref["metrics"]):
        assert got.keys() == want.keys()
        for k in want:
            if k.startswith("hist/"):
                assert int(got[k].sum()) == int(want[k].sum()), k
                assert int((got[k] - want[k]).abs().sum()) <= 2, k
            else:
                np.testing.assert_allclose(float(got[k]), float(want[k]),
                                           **METRIC_TOL, err_msg=k)
    for k, want in ref["state"]["modules"].items():
        np.testing.assert_allclose(outs[0]["state"]["modules"][k].numpy(),
                                   want.numpy(), **STATE_TOL, err_msg=k)
    for k in ("conf_linear", "conf_cluster"):
        for r in range(WORLD):
            assert torch.equal(outs[r]["val"][k], ref["val"][k]), (r, k)


def test_gather_rows_forward_and_backward(runs):
    """gather_rows stacks the ranks' rows bit for bit; the gradient of a
    rank's rows is the sum of every rank's loss's gradient there."""
    outs, _ = runs["collectives"]
    want = torch.cat([o["x"] for o in outs])
    total = sum(o["weight"] for o in outs)
    for r, o in enumerate(outs):
        assert torch.equal(o["y"], want)
        torch.testing.assert_close(o["x_grad"], total[3 * r:3 * (r + 1)],
                                   rtol=0, atol=1e-6)


def test_row_take_serves_owned_rows_and_zero_rows(runs):
    """row_take of a table block-distributed over the ranks: each rank's
    indices, from either block; -1 gives a zero row."""
    outs, sc = runs["collectives"]
    table = sc["table"]
    for r, o in enumerate(outs):
        ind = sc["take"][r]
        want = torch.where(((ind >= 0) & (ind < 6))[:, None],
                           table[ind.clamp(0, 5)], torch.zeros(()))
        assert torch.equal(o["taken"], want)


def test_average_grads_and_metric_means(runs):
    """average_grads leaves every rank the mean gradient and the metrics'
    means, in one all_reduce."""
    outs, _ = runs["collectives"]
    for o in outs:
        assert torch.equal(o["p_grad"], torch.full((5,), 1.5))
        assert float(o["m"]) == 5.0


def test_masked_cross_entropy_takes_the_global_count(runs):
    """Shards with uneven ignore pixels: the ranks' mean of their shares of
    the probe's cross-entropy is the one-process loss of the whole batch,
    and each rank's logits' gradient is W times the one-process
    gradient's rows (average_grads divides by W)."""
    outs, sc = runs["collectives"]
    labels = sc["labels"]
    logits = sc["logits"].clone().requires_grad_(True)
    want = upsampled_masked_cross_entropy(logits, labels, N_CLASSES)
    want.backward()
    got = sum(float(o["ce"]) for o in outs) / WORLD
    np.testing.assert_allclose(got, float(want.detach()), rtol=1e-6)
    per_shard = [float(upsampled_masked_cross_entropy(
        logits[s].detach(), labels[s], N_CLASSES))
        for s in (slice(0, 2), slice(2, 4))]
    assert abs(sum(per_shard) / 2 - float(want.detach())) > 1e-3
    for r, o in enumerate(outs):
        torch.testing.assert_close(o["ce_grad"] / WORLD,
                                   logits.grad[2 * r:2 * (r + 1)],
                                   rtol=1e-5, atol=1e-7)
