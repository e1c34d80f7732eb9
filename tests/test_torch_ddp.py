"""Data parallelism (``stego_torch/parallel/dist.py``) on 2 CPU processes
over gloo: the 2-rank train step against the JAX package's step on the
global batch, with the same weights and the JAX step's own draws (global
negatives through C2, sampled and full-field, against one JAX process;
local negatives through C1 against JAX on a 2-device mesh); the
feature-pyramid arch's 2-rank step, its BatchNorms on the global batch's
statistics, against the JAX step on a 2-device mesh (global negatives
through C2's gather route, local ones through C1), and the same ranks on
their own statistics as a control that fails; the cached step, replicated
and ``feat_cache_sharded``, against one port process; and the collectives.
Both ranks of each run start once (``tests/_torch_ddp_worker.py``) while
the parent computes the references.

Batch 4 (2 images a rank), res 32 (4 x 4 feature maps; the feature-pyramid
cases at res 64), the labels' ignore pixels spread unevenly over the two
shards, so that a per-shard mean of the linear probe's loss fails the
gates."""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from stego_tpu.models import resnet as jax_resnet
from stego_tpu.ops.math import block_local_super_perm as jax_block_perm
from stego_tpu.parallel.mesh import make_mesh
from stego_tpu.train.segmenter import \
    UnsupervisedSegmenter as JaxUnsupervisedSegmenter
from stego_tpu.train.segmenter import _split_step_keys
from stego_tpu.train.segmenter import make_train_step as jax_make_train_step
from stego_torch.config import Config
from stego_torch.models.convert import (from_jax_params, jax_train_state,
                                        load_jax_train_state)
from stego_torch.ops.probe_ce import upsampled_masked_cross_entropy
from stego_torch.train.feat_cache import build_feat_cache
from stego_torch.train.segmenter import (UnsupervisedSegmenter,
                                         draw_step_randomness,
                                         make_cached_train_step,
                                         make_cached_val_epoch)
from tests._torch_ddp_worker import Items, load_state, train_state
from tests.test_fpn import make_torch_resnet50_sd
from tests.test_torch_config import torch_config
from tests.test_torch_fpn import assert_fpn_state_close
from tests.test_torch_train_step import METRIC_TOL as FPN_METRIC_TOL
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


def ddp_batch(seed, res=RES):
    """A global batch of B images at ``res``; rank 0's labels are 60%
    ignore pixels, rank 1's 10%."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((B, res, res, 3)).astype(np.float32)
    pos = img + 0.05 * rng.standard_normal(img.shape).astype(np.float32)
    out = {"img": img, "img_pos": pos}
    for key in ("label", "label_pos"):
        label = rng.integers(0, N_CLASSES, (B, res, res))
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


# the feature-pyramid arch at granularity 2 and res 64 (layer4 2 x 2, code
# 56 x 56): the smallest res at which one process's step holds
# tests/test_torch_fpn.py's parameter gate against JAX's (at res 32,
# layer4 is 1 x 1, its upsampled map constant over each image, and
# conv2's kernel gradients near ADAM_LIVE differ past it in one process
# too); the control: the global case with each rank's BatchNorms on its
# own batch
FPN_RES = 64
FPN_CASES = {"fpn_global": {}, "fpn_local": dict(negatives_scope="local")}
FPN_CONTROL = "fpn_own_stats"
FPN_STATE_TOL = dict(rtol=2e-4, atol=1e-5)  # assert_fpn_state_close's


def fpn_cfg(name):
    return make_cfg(res=FPN_RES, arch="feature-pyramid",
                    model_type="resnet50", granularity=2, dim=6,
                    feature_samples=3, fused_sampling="auto",
                    **FPN_CASES.get(name, FPN_CASES["fpn_global"]))


def fpn_case(name):
    """The feature-pyramid step case: the JAX segmenter on a 2-device mesh
    (whose CPU sampler is the gather form), a torchvision-layout ResNet-50
    folded by both packages, the JAX train state, the port's segmenter
    holding them, and each step's batch, key and draws."""
    cfg = fpn_cfg(name)
    jseg = JaxUnsupervisedSegmenter(N_CLASSES, cfg, mesh=make_mesh(WORLD))
    bb = jax_resnet.resnet50_params_from_torch(make_torch_resnet50_sd(2))
    jstate = jax.tree.map(np.asarray, jseg.init_state(jax.random.PRNGKey(4)))
    seg = from_jax_params(bb, jstate["params"], torch_config(cfg))
    load_jax_train_state(seg, jstate)
    blocks = WORLD if name == "fpn_local" else 1
    keys = [jax.random.PRNGKey(300 + i) for i in range(STEPS)]
    rands = [mesh_draws(jseg, k, blocks) for k in keys]
    batches = [ddp_batch(20 + i, FPN_RES) for i in range(STEPS)]
    return cfg, jseg, bb, jstate, seg, keys, rands, batches


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
    for name in list(STEP_CASES) + list(FPN_CASES) + [FPN_CONTROL]:
        fpn = name.startswith("fpn_")
        cfg, jseg, bb, jstate, seg, keys, rands, batches = (
            fpn_case if fpn else step_case)(name)
        spec[name] = dict(
            kind="steps", cfg=cfg_dict(torch_config(cfg)),
            vit=None if fpn else SMALL, n_classes=N_CLASSES,
            state=train_state(seg), rands=rands, hist=False,
            batches=[{k: torch.from_numpy(v) for k, v in b.items()}
                     for b in batches])
        if fpn:
            path = tmp / "resnet50.pt"
            torch.save(seg.net.model.state_dict(), path)
            spec[name].update(backbone_path=str(path), states=True,
                              own_stats=name == FPN_CONTROL)
        else:
            spec[name]["backbone"] = seg.net.model.state_dict()
        if name != FPN_CONTROL:  # the control's reference is fpn_global's
            cases[name] = (jseg, bb, jstate, keys, batches)
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
            states, metrics, mus = [], [], []
            for key, batch in zip(keys, batches):
                mus.append(jstate["opt"]["net"][0].mu)
                jstate, m = step(bb, jstate, batch, key)
                jstate = jax.tree.map(np.asarray, jstate)
                states.append(jstate)
                metrics.append({k: float(v) for k, v in m.items()})
            refs[name] = (states, metrics, mus)
        refs[FPN_CONTROL] = refs["fpn_global"]
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
    """Both ranks' trainable parameters (and the feature-pyramid head's
    running statistics) equal bit for bit after every step."""
    for step, (a, b) in enumerate(zip(outs[0]["params"],
                                      outs[1]["params"])):
        for k in a:
            assert torch.equal(a[k], b[k]), (step, k)


def fpn_segmenter(name, state):
    """The port's feature-pyramid segmenter holding a rank's train
    ``state`` (its trunk is not part of it)."""
    seg = UnsupervisedSegmenter(N_CLASSES, torch_config(fpn_cfg(name)))
    load_state(seg, state)
    return seg


def running_var_excess(seg, jstate):
    """The largest excess of the head's running variances (JAX's
    ``ema_var``) over assert_fpn_state_close's gate."""
    got = jax_train_state(seg, like=jstate)["params"]["head"]
    want = jstate["params"]["head"]
    return max(float((np.abs(got[c][n]["ema_var"] - p["ema_var"])
                      - FPN_STATE_TOL["atol"] - FPN_STATE_TOL["rtol"]
                      * np.abs(p["ema_var"])).max())
               for c in want if c.startswith("conv")
               for n, p in want[c].items() if n.startswith("norm"))


@pytest.mark.parametrize("name", list(STEP_CASES) + list(FPN_CASES))
def test_two_rank_step_matches_jax(runs, name):
    """Each of STEPS 2-rank steps: both ranks' metrics are the JAX step's
    on the global batch (gates of the card's phase ddp), both ranks'
    parameters are equal bit for bit, and the updated parameters and Adam
    moments are JAX's within STATE_TOL (rtol 2e-4, atol 1e-5). The
    feature-pyramid cases (the JAX step on a 2-device mesh) are held after
    every step at tests/test_torch_fpn.py's gates: metrics within its
    METRIC_TOL, and assert_fpn_state_close's on the parameters, Adam
    moments and BatchNorm running statistics (running means within rtol
    2e-4 of their channel's running std), whose bits the ranks share."""
    outs, (states, metrics, mus) = runs[name]
    assert_ranks_equal(outs)
    if name in FPN_CASES:
        for r in range(WORLD):
            for got, want in zip(outs[r]["metrics"], metrics):
                assert got.keys() == want.keys()
                for k in want:
                    np.testing.assert_allclose(float(got[k]), want[k],
                                               **FPN_METRIC_TOL,
                                               err_msg=(r, k))
        dead = {}
        for i, (state, jstate) in enumerate(zip(outs[0]["states"], states)):
            seg = fpn_segmenter(name, state)
            assert seg.step == i + 1
            assert_fpn_state_close(seg, jstate, mus[i], i + 1,
                                   seg.cfg.lr, dead)
            assert running_var_excess(seg, jstate) <= 0
        return
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


def test_two_rank_fpn_on_own_statistics_fails(runs):
    """The control: the same two ranks with each rank's BatchNorms on its
    own batch's statistics (the collective left out of batch_stats) fail
    the running-statistics gate against the JAX mesh step after its first
    step, and the ranks' running statistics part."""
    outs, (states, _, _) = runs[FPN_CONTROL]
    seg = fpn_segmenter(FPN_CONTROL, outs[0]["states"][0])
    assert running_var_excess(seg, states[0]) > 0
    a, b = outs[0]["params"][0], outs[1]["params"][0]
    assert any(not torch.equal(a[k], b[k]) for k in a if "running" in k)


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
