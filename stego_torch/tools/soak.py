"""``python -m stego_torch.tools.soak [output_root=...] [steps=5000]
[resume_at=2400] [device=cuda] [size=full]``: the training app at the
reference's own schedule, soaked.

STEGO trains 5,000 steps at batch 16 and res 224, validates every 100
steps at res 320, saves every 400 and keeps the best 2 by cluster mIoU
(src/configs/train_config.yml, which the port's ``Config`` defaults copy).
This runs that schedule through ``train/app.py:Trainer`` on the synthetic
mosaic (``data/synthetic.py``: 1024 train and 128 val scenes at res 224,
64 steps an epoch, so 5,000 steps cross 78 epochs) and its KNN table, with
the probes reset once, at step ``steps // 2``, twice, each run under its
own output root:

* ``straight``: to ``steps``;
* ``cut_resumed``: to ``resume_at``, then a fresh Trainer with
  ``resume=true`` to ``steps``, as a user restarts; top-k may have
  evicted ``resume_at``, so it starts at the newest kept step.

Each run prints one JSON line with the device, the card and its power
limit (``nvidia-smi``), its wall and loop seconds, images/s over the loop
(validation and saves inside), the median step, the loader's wait share,
the batch copy, the validation and checkpoint seconds, device memory and
host RSS at each validation, and the validation and loss trajectories
(read back from ``metrics.jsonl``), and at each validation the head's
code on the first validation batch (one more trunk call): its mean
norm, the mean cosine of its vectors' pairs and its variance's share
along one direction (:func:`code_stats`). Then every gate of :func:`gates`
(finite and falling loss, the schedule's rows and histogram sets, the
kept checkpoints, the probe reset, the accuracy bands at 5,000 steps,
flat device memory and host RSS, exact kernel launches a step and a
validation batch, and resume bit for bit) is checked; a miss exits
nonzero, naming the gate and its numbers.

It runs on the first CUDA device and exits with an error without one;
``device=cpu`` runs the kernels' plain versions. ``size=tiny`` runs the
CPU form: the sensitive instrument's tiny net at res 64 (:func:`tiny`),
40 steps, validation, checkpoints and histograms every 10, the reset at
20 and a resume from 10. Without ``output_root`` it writes under a new
temporary directory.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import os
import statistics
import subprocess
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from stego_torch.config import Config
from stego_torch.tools.accuracy_bench import DEFAULT_BANDS, device_name
from stego_torch.train.app import Trainer
from stego_torch.train.checkpoint import top_k_steps
from stego_torch.utils.logging import MetricLogger

VAL_KEYS = tuple(f"test/{probe}/{m}" for probe in ("linear", "cluster")
                 for m in ("mIoU", "Accuracy"))
# fields of a metrics.jsonl row that a run's timing sets, not its numbers
TIMING_KEYS = ("time", "imgs_per_sec")
MIB = 2 ** 20


@dataclasses.dataclass(frozen=True)
class Limits:
    """The gates' parameters. Memory is held from the first validation at
    or after ``mem_from``: ``max_memory_allocated`` may rise by
    ``peak_growth`` of itself, ``memory_allocated`` move by
    ``allocated_drift`` bytes, host RSS grow by ``rss_growth`` bytes (None:
    not gated). The mean ``loss/total`` of the last ``loss_window`` steps
    must be below that of the first; the final linear mIoU at least its
    value at the last validation before the reset less ``probe_drop``;
    the final validation at or above ``bands`` (None: not gated)."""
    mem_from: int = 1000
    loss_window: int = 500
    probe_drop: float = 3.0
    bands: Optional[Dict[str, float]] = None
    peak_growth: float = 0.01
    allocated_drift: int = MIB
    rss_growth: Optional[int] = 256 * MIB
    warmup: int = 20


@dataclasses.dataclass
class Run:
    """One Trainer's run: its JSON record, the rows it appended to
    ``metrics.jsonl``, the histogram sets its writer thread delivered
    ({step: {name: count}}), its final state on the host, what the probe
    reset left (None without one), the kept files of its checkpoint
    directory, the launches of its steps and validation epochs that were
    not the expected ones, and its memory samples."""
    record: Dict[str, Any]
    rows: List[Dict[str, Any]]
    hist_sets: Dict[int, Dict[str, float]]
    state: Dict[str, Any]
    at_reset: Optional[Dict[str, Any]]
    ckpt_files: List[str]
    launch_faults: List[Tuple[str, int, Dict[str, int]]]
    memory: List[Dict[str, float]]


def rss_bytes() -> int:
    """This process's resident set (``VmRSS`` of /proc/self/status)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


def card(device: torch.device) -> Optional[str]:
    """``nvidia-smi``'s name and power limit of ``device``, as
    ``--query-gpu=name,power.limit --format=csv,noheader`` gives them;
    None on the CPU."""
    if device.type != "cuda":
        return None
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return lines[device.index or 0]


def launch_counts() -> Dict[str, int]:
    """The kernels' launch counts: A in all and by entry point, L, C1's
    forward and backward, C2's forward and backward."""
    from stego_torch.ops import corr_fused_sampling as c1
    from stego_torch.ops import corr_stream as c2
    from stego_torch.ops import flash_attention as fa
    from stego_torch.ops import layer_norm as ln

    out = {"attention": fa.LAUNCHES, "layer_norm": ln.LAUNCHES,
           "corr_sampled_fwd": c1.FWD_LAUNCHES,
           "corr_sampled_bwd": c1.BWD_LAUNCHES,
           "corr_stream_fwd": c2.FWD_LAUNCHES,
           "corr_stream_bwd": c2.BWD_LAUNCHES}
    out.update({f"attention_{e}": n for e, n in fa.ENTRY_LAUNCHES.items()})
    return out


def _minus(a: Dict[str, int], b: Dict[str, int]) -> Dict[str, int]:
    return {k: a[k] - b[k] for k in a}


def trunk_launches(trunk, res: int, on_card: bool) -> Dict[str, int]:
    """One call of a bf16 ViT trunk with the kernels at ``res``: A once a
    block at the JAX trunk's entry, L twice a block and once after; on the
    CPU nothing."""
    from stego_torch.ops.flash_attention import attention_entry

    out = dict.fromkeys(launch_counts(), 0)
    if on_card:
        depth = len(trunk.blocks)
        vit = trunk.cfg
        entry = attention_entry(vit.num_heads, vit.head_dim,
                                (res // vit.patch_size) ** 2 + 1)
        out.update({"attention": depth, f"attention_{entry}": depth,
                    "layer_norm": 2 * depth + 1})
    return out


class HistogramRecorder(MetricLogger):
    """``MetricLogger`` that also records, into ``sets``, each histogram the
    writer thread delivers: ``sets[step][name]`` is its total count."""

    def __init__(self, log_dir: str, sets: Dict[int, Dict[str, float]]):
        super().__init__(log_dir)
        self.sets = sets

    def log_histogram_counts(self, step, name, counts, lo=-1.0, hi=1.0):
        self.sets.setdefault(int(step), {})[name] = float(
            np.asarray(counts, np.float64).sum())
        super().log_histogram_counts(step, name, counts, lo, hi)


def host_state(seg) -> Dict[str, Any]:
    """``seg``'s state dict and its optimizers' states, copied to the
    host."""
    def host(v):
        return v.detach().cpu().clone() if isinstance(v, torch.Tensor) else v

    return {"modules": {k: host(v) for k, v in seg.state_dict().items()},
            "optimizers": {
                name: {"state": {i: {k: host(v) for k, v in st.items()}
                                 for i, st in sd["state"].items()},
                       "param_groups": sd["param_groups"]}
                for name, opt in seg.optimizers().items()
                for sd in [opt.state_dict()]},
            "step": int(seg.step)}


def state_differences(a: Dict[str, Any], b: Dict[str, Any]) -> List[str]:
    """What differs between two host states, bit for bit: module tensors
    and optimizer state entries by name, with the largest difference."""
    out = []

    def cmp(name, x, y):
        tensors = [isinstance(t, torch.Tensor) for t in (x, y)]
        if not all(tensors):
            if any(tensors) or x != y:
                out.append(f"{name} ({x!r:.40} vs {y!r:.40})")
        elif x.shape != y.shape or x.dtype != y.dtype:
            out.append(f"{name} ({x.dtype}{tuple(x.shape)} vs "
                       f"{y.dtype}{tuple(y.shape)})")
        elif not torch.equal(x, y):
            gap = float((x.double() - y.double()).abs().max())
            out.append(f"{name} (max abs diff {gap:.3e})")

    if a["step"] != b["step"]:
        out.append(f"step ({a['step']} != {b['step']})")
    for k in sorted(set(a["modules"]) | set(b["modules"])):
        cmp(f"modules.{k}", a["modules"].get(k), b["modules"].get(k))
    for name in sorted(set(a["optimizers"]) | set(b["optimizers"])):
        sa, sb = (s["optimizers"].get(name, {}).get("state", {})
                  for s in (a, b))
        for i in sorted(set(sa) | set(sb)):
            for k in sorted(set(sa.get(i, {})) | set(sb.get(i, {}))):
                cmp(f"optimizers.{name}.{i}.{k}", sa.get(i, {}).get(k),
                    sb.get(i, {}).get(k))
    return out


@torch.no_grad()
def code_stats(seg, img: torch.Tensor) -> List[float]:
    """The head's code of ``img`` (one trunk call, a validation batch's
    launches): its mean norm, the mean cosine of every pair of its code
    vectors, and the share of the centred code's variance along its first
    principal direction. A code that collapses onto one direction takes
    the cosine and the share to 1."""
    _, code = seg.net(img)
    c = code.reshape(-1, code.shape[-1]).double()
    unit = torch.nn.functional.normalize(c, dim=-1)
    var = torch.linalg.svdvals(c - c.mean(0)) ** 2
    return [float(c.norm(dim=-1).mean()),
            float((unit.mean(0) ** 2).sum()),
            float(var[0] / var.sum())]


class SoakTrainer(Trainer):
    """The Trainer, recording as it goes: each step's and each validation
    epoch's kernel launches that differ from the expected ones, device
    memory and host RSS after each validation, then the head's code
    statistics (:func:`code_stats`) on the first validation batch, the
    histogram sets the writer thread delivers and the state the probe
    reset leaves."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.on_card = self.device.type == "cuda"
        self.hist_sets: Dict[int, Dict[str, float]] = {}
        self.metric_logger = functools.partial(HistogramRecorder,
                                               sets=self.hist_sets)
        trunk = self.seg.net.model
        self.want_step = trunk_launches(trunk, self.cfg.res, self.on_card)
        if self.on_card:
            self.want_step.update(corr_sampled_fwd=1, corr_sampled_bwd=1)
        batch = trunk_launches(trunk, self.cfg.val_res, self.on_card)
        n = len(self.val_loader)
        self.want_val = {k: v * n for k, v in batch.items()}
        self.launch_faults: List[Tuple[str, int, Dict[str, int]]] = []
        self.memory: List[Dict[str, float]] = []
        self.code: List[List[float]] = []
        self.val_img = torch.from_numpy(np.stack([
            np.asarray(self.val_dataset[i]["img"])
            for i in range(min(self.val_bs, len(self.val_dataset)))
        ])).to(self.device)
        self.resets: List[int] = []
        self.at_reset: Optional[Dict[str, Any]] = None

    def _step(self, batch, step_idx, gen):
        before = launch_counts()
        out = super()._step(batch, step_idx, gen)
        got = _minus(launch_counts(), before)
        if got != self.want_step:
            self.launch_faults.append(("step", step_idx + 1, got))
        return out

    def validate(self, step):
        before = launch_counts()
        out = super().validate(step)
        got = _minus(launch_counts(), before)
        if got != self.want_val:
            self.launch_faults.append(("validation", step, got))
        sample = {"step": step, "rss": rss_bytes()}
        if self.on_card:
            sample["allocated"] = torch.cuda.memory_allocated(self.device)
            sample["max_allocated"] = torch.cuda.max_memory_allocated(
                self.device)
        self.memory.append(sample)
        self.code.append([step] + code_stats(self.seg, self.val_img))
        return out

    def reset_probes(self, step):
        before = host_state(self.seg)
        super().reset_probes(step)
        self.resets.append(step)
        self.at_reset = {"step": step, "before": before,
                         "after": host_state(self.seg)}


def read_rows(log_dir: str) -> List[Dict[str, Any]]:
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _median(xs) -> Optional[float]:
    return float(statistics.median(xs)) if len(xs) else None


def run_once(cfg: Config, vit_cfg=None, train_dataset=None,
             val_dataset=None, device=None, warmup: int = 20) -> Run:
    """One SoakTrainer run of ``cfg``, timed from construction to return.
    ``warmup`` steps are left out of the step and loader figures."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    log_path = os.path.join(cfg.output_root, "logs",
                            f"{cfg.dataset_name}_{cfg.experiment_name}",
                            "metrics.jsonl")
    rows_before = 0
    if os.path.exists(log_path):
        with open(log_path) as f:
            rows_before = sum(1 for _ in f)
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    tr = SoakTrainer(cfg, vit_cfg, train_dataset, val_dataset, device)
    tr.run()
    if on_card:
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    rows = read_rows(tr.log_dir)[rows_before:]
    start, end = tr.start_step, tr.seg.step
    starts = tr.step_starts
    w = min(warmup, max(len(starts) - 2, 0))
    loop_s = t1 - starts[0]
    steady_s = t1 - starts[w]
    record = {
        "steps": [start, end], "wall_s": t1 - t0, "loop_s": loop_s,
        "images_per_s": (end - start) * cfg.batch_size / loop_s,
        "median_step_ms": _median(np.diff(starts)[w:] * 1e3),
        "loader_wait_share": sum(tr.loader_wait[w:]) / steady_s,
        "copy_ms_median": _median([s * 1e3 for s in tr.copy_seconds[w:]]),
        "val_s": {"n": len(tr.val_seconds), "sum": sum(tr.val_seconds),
                  "median": _median(tr.val_seconds)},
        "ckpt_s": {"n": len(tr.ckpt_seconds), "sum": sum(tr.ckpt_seconds),
                   "median": _median(tr.ckpt_seconds)},
        "memory_mib": [[m["step"]] + [m[k] / MIB for k in (
            "allocated", "max_allocated") if k in m] + [m["rss"] / MIB]
            for m in tr.memory],
        "validation": [[r["step"]] + [r[k] for k in VAL_KEYS]
                       for r in rows if VAL_KEYS[0] in r],
        "loss": [[r["step"], r["loss/total"]] for r in rows
                 if "loss/total" in r],
        "code": tr.code,
        "resets": tr.resets,
        "launch_faults": len(tr.launch_faults),
    }
    out = Run(record=record, rows=rows, hist_sets=tr.hist_sets,
              state=host_state(tr.seg), at_reset=tr.at_reset,
              ckpt_files=sorted(os.listdir(tr.ckpt_dir)),
              launch_faults=tr.launch_faults, memory=tr.memory)
    del tr
    gc.collect()  # a trainer in a reference cycle keeps its device memory
    if on_card:
        torch.cuda.empty_cache()
    return out


def soak(cfg: Config, resume_at: int, limits: Limits = Limits(),
         vit_cfg=None, train_dataset=None, val_dataset=None, device=None
         ) -> Tuple[Dict[str, Run], List[str]]:
    """Both runs of ``cfg`` (``max_steps``, ``reset_probe_steps`` and the
    schedule's frequencies are its), under ``<output_root>/straight`` and
    ``<output_root>/cut_resumed``: {"straight", "cut", "resumed": Run} and
    the gates' failures (:func:`gates`)."""
    if cfg.reset_probe_steps is None or \
            not 0 < resume_at < cfg.reset_probe_steps <= cfg.max_steps:
        raise ValueError(f"the soak resumes before its probe reset: need 0 "
                         f"< resume_at ({resume_at}) < reset_probe_steps "
                         f"({cfg.reset_probe_steps}) <= max_steps "
                         f"({cfg.max_steps})")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and (cfg.backbone_dtype != "bfloat16"
                                  or cfg.arch != "dino"
                                  or cfg.full_field_loss):
        raise ValueError("the soak's launch gates count a bf16 ViT trunk "
                         "and the sampled loss (kernel C1)")
    root = cfg.output_root
    kw = dict(vit_cfg=vit_cfg, train_dataset=train_dataset,
              val_dataset=val_dataset, device=device, warmup=limits.warmup)
    runs = {"straight": run_once(cfg.replace(
        output_root=os.path.join(root, "straight")), **kw)}
    cut = cfg.replace(output_root=os.path.join(root, "cut_resumed"))
    runs["cut"] = run_once(cut.replace(max_steps=resume_at), **kw)
    runs["resumed"] = run_once(cut.replace(resume=True), **kw)
    return runs, gates(runs, cfg, resume_at, limits, device)


def schedule(cfg: Config, start: int, end: int
             ) -> Tuple[List[Tuple[int, str]], List[int], List[int]]:
    """What a run from ``start`` to ``end`` steps writes: its
    metrics.jsonl rows in order, as (step, "scalars" or "validation"), its
    histogram steps and its save steps."""
    rows, hists, saves = [], [], []
    for s in range(start + 1, end + 1):
        if s % cfg.scalar_log_freq == 0:
            rows.append((s, "scalars"))
        if cfg.hist_freq and s % cfg.hist_freq == 0:
            hists.append(s)
        if s % cfg.val_freq == 0 or s == end:
            rows.append((s, "validation"))
        if s % cfg.checkpoint_freq == 0 or s == end:
            saves.append(s)
    return rows, hists, saves


def _kind(row) -> str:
    return ("validation" if VAL_KEYS[0] in row else
            "scalars" if "loss/total" in row else "other")


def _untimed(row) -> Dict[str, Any]:
    return {k: v for k, v in row.items() if k not in TIMING_KEYS}


def gates(runs: Dict[str, Run], cfg: Config, resume_at: int,
          limits: Limits, device: torch.device) -> List[str]:
    """Every gate's misses, each naming the gate and its numbers:

    * loss: every logged ``loss/*`` and validation value finite; the mean
      ``loss/total`` of the last ``loss_window`` steps below the first's;
    * logs: each run's metrics.jsonl rows are exactly its schedule's
      (:func:`schedule`), scalar rows all of one key set, validation rows
      of VAL_KEYS; a histogram set, of the same names, at exactly each
      ``hist_freq``-th step;
    * checkpoints: the directory holds the top ``save_top_k`` of the
      saves by their logged metrics (``top_k_steps``), ``backbone.pt``
      and ``config.json``;
    * probe reset: at ``reset_probe_steps``; the final linear mIoU at
      least its value at the last validation before it, less
      ``probe_drop``;
    * accuracy: the final validation at or above ``bands``;
    * memory: from ``mem_from``, flat device memory and host RSS (Limits);
    * launches: every step and validation epoch launched exactly its
      kernels;
    * resume: the resumed run starts at the newest step top-k kept by
      ``resume_at``, ends in the straight run's state bit for bit (every
      module and optimizer state) and appends its rows, timings aside."""
    fails: List[str] = []
    steps, reset = cfg.max_steps, cfg.reset_probe_steps
    straight, cut, resumed = runs["straight"], runs["cut"], runs["resumed"]
    logs = {"straight": straight.rows, "cut_resumed": cut.rows
            + resumed.rows}
    segments = {"straight": (straight, 0, steps), "cut": (cut, 0, resume_at),
                "resumed": (resumed, resumed.record["steps"][0], steps)}

    # the rows each run appended, against its schedule
    scalar_keys = None
    for name, (run, start, end) in segments.items():
        want_rows, want_hists, _ = schedule(cfg, start, end)
        got = [(r.get("step"), _kind(r)) for r in run.rows]
        if got != want_rows:
            first = next((i for i, (g, w) in enumerate(zip(got, want_rows))
                          if g != w), min(len(got), len(want_rows)))
            fails.append(f"logs, {name}: {len(got)} metrics.jsonl rows "
                         f"where the schedule gives {len(want_rows)}; the "
                         f"first that differs, #{first}: "
                         f"{got[first:first + 1]} vs "
                         f"{want_rows[first:first + 1]}")
        for r in run.rows:
            keys = set(r) - {"step", *TIMING_KEYS}
            if _kind(r) == "scalars":
                scalar_keys = keys if scalar_keys is None else scalar_keys
                if keys != scalar_keys:
                    fails.append(f"logs, {name}: step {r['step']}'s scalar "
                                 f"keys {sorted(keys ^ scalar_keys)} differ")
                    break
            elif _kind(r) == "validation" and keys != set(VAL_KEYS):
                fails.append(f"logs, {name}: step {r['step']}'s validation "
                             f"keys {sorted(keys)}")
                break
            logged = {k: v for k, v in r.items()
                      if k.startswith(("loss/", "test/"))}
            if not all(math.isfinite(v) for v in logged.values()):
                fails.append(f"loss, {name}: step {r['step']} logged a "
                             f"value that is not finite: {logged}")
                break
        names = [set(v) for v in run.hist_sets.values()]
        if sorted(run.hist_sets) != want_hists or any(
                n != names[0] or not n for n in names) or any(
                c <= 0 for v in run.hist_sets.values() for c in v.values()):
            fails.append(f"logs, {name}: histogram sets at steps "
                         f"{sorted(run.hist_sets)[:6]}... "
                         f"({len(run.hist_sets)}; the schedule gives "
                         f"{len(want_hists)}), names "
                         f"{sorted(names[0]) if names else []}")
        for kind, step, got_l in run.launch_faults[:3]:
            fails.append(f"launches, {name}: {kind} {step} launched "
                         f"{ {k: v for k, v in got_l.items() if v} }")
        if len(run.launch_faults) > 3:
            fails.append(f"launches, {name}: {len(run.launch_faults)} "
                         f"steps or validations in all")

    # each log, by step (a replayed step's later rows win)
    _, _, all_saves = schedule(cfg, 0, steps)
    for name, rows in logs.items():
        vals = {r["step"]: r for r in rows if _kind(r) == "validation"}
        loss = {r["step"]: r["loss/total"] for r in rows
                if _kind(r) == "scalars"}
        w = limits.loss_window
        head = [v for s, v in loss.items() if s <= w]
        tail = [v for s, v in loss.items() if s > steps - w]
        if not (head and tail and statistics.mean(tail)
                < statistics.mean(head)):
            fails.append(f"loss, {name}: mean loss/total over the last {w} "
                         f"steps {statistics.mean(tail) if tail else None} "
                         f"is not below the first {w} steps' "
                         f"{statistics.mean(head) if head else None}")
        run = straight if name == "straight" else resumed
        at_save = {}
        for s in all_saves:
            before = [v for v in vals if v <= s]
            at_save[s] = ({k: vals[max(before)][k] for k in VAL_KEYS}
                          if before else {})
        kept = top_k_steps(at_save, cfg.save_top_k)
        want_files = sorted([str(s) for s in kept]
                            + ["backbone.pt", "config.json"])
        if run.ckpt_files != want_files:
            fails.append(f"checkpoints, {name}: the directory holds "
                         f"{run.ckpt_files}; top_k_steps of the "
                         f"{len(all_saves)} saves' logged metrics gives "
                         f"{want_files}")
        if steps not in vals:
            continue
        final = vals[steps]
        before = [s for s in vals if s < reset]
        if before:
            was = vals[max(before)]["test/linear/mIoU"]
            if final["test/linear/mIoU"] < was - limits.probe_drop:
                fails.append(f"probe reset, {name}: linear mIoU "
                             f"{final['test/linear/mIoU']:.2f} at step "
                             f"{steps} is below {was:.2f} at step "
                             f"{max(before)} less {limits.probe_drop}")
        low = {k: (round(final[k], 2), b)
               for k, b in (limits.bands or {}).items() if final[k] < b}
        if low:
            fails.append(f"accuracy, {name}: at step {steps} below the "
                         f"bands (value, band): {low}")

    for name, run, want in (("straight", straight, [reset]),
                            ("cut", cut, []), ("resumed", resumed, [reset])):
        if run.record["resets"] != want:
            fails.append(f"probe reset, {name}: the probes were reset at "
                         f"steps {run.record['resets']}, not {want}")

    # memory, from the first validation at or after mem_from
    for name, (run, _, _) in segments.items():
        held = [m for m in run.memory if m["step"] >= limits.mem_from]
        if len(held) < 2:
            continue
        ref = held[0]
        if device.type == "cuda":
            peak = max(m["max_allocated"] for m in held)
            drift = max(abs(m["allocated"] - ref["allocated"]) for m in held)
            if peak > ref["max_allocated"] * (1 + limits.peak_growth):
                fails.append(f"device memory, {name}: max_memory_allocated "
                             f"rose from {ref['max_allocated'] / MIB:.3f} "
                             f"MiB at step {ref['step']} to "
                             f"{peak / MIB:.3f} MiB (more than "
                             f"{limits.peak_growth:.0%})")
            if drift > limits.allocated_drift:
                fails.append(f"device memory, {name}: memory_allocated "
                             f"moved {drift / MIB:.3f} MiB from its "
                             f"{ref['allocated'] / MIB:.3f} MiB at step "
                             f"{ref['step']} (at most "
                             f"{limits.allocated_drift / MIB:.3f})")
        grow = held[-1]["rss"] - ref["rss"]
        if limits.rss_growth is not None and grow >= limits.rss_growth:
            fails.append(f"host memory, {name}: RSS grew {grow / MIB:.1f} "
                         f"MiB from step {ref['step']} to "
                         f"{held[-1]['step']} (under "
                         f"{limits.rss_growth / MIB:.0f})")

    # resume: its start, its state and its rows against the straight run's
    cut_vals = {r["step"]: {k: r[k] for k in VAL_KEYS} for r in cut.rows
                if _kind(r) == "validation"}
    _, _, cut_saves = schedule(cfg, 0, resume_at)
    cut_kept = top_k_steps({s: cut_vals.get(s, {}) for s in cut_saves},
                           cfg.save_top_k)
    start = resumed.record["steps"][0]
    if start != max(cut_kept):
        fails.append(f"resume: the resumed run started at step {start}, the "
                     f"newest step top-k kept by step {resume_at} is "
                     f"{max(cut_kept)} (kept {cut_kept})")
    diffs = state_differences(straight.state, resumed.state)
    if diffs:
        fails.append(f"resume: the resumed run's final state differs from "
                     f"the straight run's in {len(diffs)} entries: "
                     f"{diffs[:4]}")
    want = [_untimed(r) for r in straight.rows if r["step"] > start]
    got = [_untimed(r) for r in resumed.rows]
    if got != want:
        first = next((i for i, (g, w) in enumerate(zip(got, want))
                      if g != w), min(len(got), len(want)))
        g, w = got[first:first + 1], want[first:first + 1]
        fails.append(f"resume: metrics.jsonl rows after step {start} differ "
                     f"from the straight run's ({len(got)} vs {len(want)} "
                     f"rows); the first at step "
                     f"{(g or w or [{}])[0].get('step')}: "
                     + (", ".join(f"{k} {g[0].get(k)} vs {w[0].get(k)}"
                                  for k in sorted(set(g[0]) | set(w[0]))
                                  if g[0].get(k) != w[0].get(k))
                        if g and w else f"{g} vs {w}"))
    return fails


def lines(runs: Dict[str, Run], device: torch.device) -> List[Dict]:
    """The JSON lines: one a run, each naming the device and the card."""
    name, smi = device_name(device), card(device)
    return [{"soak": "straight", "device": name, "card": smi,
             **runs["straight"].record},
            {"soak": "cut_resumed", "device": name, "card": smi,
             "segments": [runs["cut"].record, runs["resumed"].record]}]


def full(out_root: str, steps: int = 5000,
         resume_at: Optional[int] = None, device=None
         ) -> Tuple[Config, int, Limits]:
    """The reference's schedule on the mosaic at res 224 (1024 train, 128
    val scenes, written under ``<out_root>/data`` with their KNN table):
    the Config defaults but for the directory dataset's keys, the center
    crop and the probe reset at ``steps // 2``; returns (cfg, resume_at,
    limits)."""
    from stego_torch.data.synthetic import write_synthetic_benchmark
    from stego_torch.train.knn_app import precompute_knns

    data_root = os.path.join(out_root, "data")
    write_synthetic_benchmark(data_root, n_train=1024, n_val=128, res=224)
    cfg = Config(
        output_root=out_root, pytorch_data_dir=data_root,
        dataset_name="directory", dir_dataset_name="synthbench",
        dir_dataset_n_classes=4, experiment_name="soak",
        crop_type=None, loader_crop_type="center", max_steps=steps,
        reset_probe_steps=steps // 2)
    precompute_knns(cfg, dataset_names=["directory"], crop_types=[None],
                    res=cfg.res, batch_size=cfg.batch_size, device=device)
    resume_at = cfg.reset_probe_steps - cfg.val_freq if resume_at is None \
        else resume_at
    limits = Limits(mem_from=steps // 5, loss_window=steps // 10,
                    bands=DEFAULT_BANDS if steps == 5000 else None)
    return cfg, resume_at, limits


def tiny(out_root: str, device=None):
    """The CPU form: ``tiny_benchmark_setup``'s net (2 blocks, width 32)
    on its res-64 mosaic, 40 steps, validation, checkpoints and histograms
    every 10, the loss logged every 2, the reset at 20 and a resume from
    10; returns (cfg, vit_cfg, resume_at, limits)."""
    from stego_torch.data.synthetic import tiny_benchmark_setup
    from stego_torch.train.knn_app import precompute_knns

    cfg, vit = tiny_benchmark_setup(
        out_root, experiment_name="soak", val_freq=10, checkpoint_freq=10,
        hist_freq=10, scalar_log_freq=2, reset_probe_steps=20)
    precompute_knns(cfg, dataset_names=["directory"], crop_types=[None],
                    vit_cfg=vit, res=cfg.res, batch_size=8, device=device)
    return cfg, vit, 10, Limits(mem_from=10, loss_window=4, warmup=2)


def main(argv=None):
    from stego_torch.config import prep_args

    args = prep_args(argv)
    out_root = args.pop("output_root", None) or tempfile.mkdtemp(
        prefix="soak_")
    steps = int(args.pop("steps", 5000))
    resume_at = args.pop("resume_at", None)
    device = torch.device(args.pop("device", "cuda"))
    size = args.pop("size", "full")
    if args:
        raise SystemExit(f"unknown args: {sorted(args)}")
    if size not in ("full", "tiny"):
        raise SystemExit(f"size must be full or tiny, not {size}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("stego_torch.tools.soak runs on a CUDA device and "
                         "found none (device=cpu runs the kernels' plain "
                         "versions)")
    if device.type == "cuda":
        from stego_torch.kernels import build

        build.build()
        device = torch.device("cuda", torch.cuda.current_device())
    print(f"writing under {out_root}", flush=True)
    vit = None
    if size == "tiny":
        cfg, vit, cut, limits = tiny(out_root, device)
    else:
        cfg, cut, limits = full(out_root, steps, None if resume_at is None
                                else int(resume_at), device)
    runs, fails = soak(cfg, cut, limits, vit_cfg=vit, device=device)
    for line in lines(runs, device):
        print(json.dumps(line), flush=True)
    if fails:
        raise SystemExit("SOAK GATES MISSED:\n  " + "\n  ".join(fails))
    print(json.dumps({"soak_gate": "pass", "device": device_name(device),
                      "steps": cfg.max_steps, "resume_at": cut,
                      "reset_probe_steps": cfg.reset_probe_steps}))


if __name__ == "__main__":
    main()
