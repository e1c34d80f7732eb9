"""What the tools that hold this checkout's kernels against another
checkout's share: the device time of a call, and the code that runs a
tool's ``--produce`` in each checkout, each run in a process of its own.

A tool (``loss_kernels_diff.py``, ``attention_narrow_diff.py``) runs its
``--produce`` as a script of this checkout with the other checkout's root
on ``PYTHONPATH``: ``stego_torch`` is then that checkout's, and this module
is imported from beside the script, so a checkout without it can be
measured too.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def kernel_ms(fn, iters: int = 20, match: str = "") -> tuple:
    """Device ms per call of ``fn`` from the profiler's trace, after one
    warm-up call: (in the kernels whose names hold ``match``, in all its
    kernels). Raises when the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    every = sum(e.time_range.elapsed_us() for e in events)
    if every == 0:
        raise RuntimeError("the profiler's trace held no device time")
    matched = sum(e.time_range.elapsed_us() for e in events
                  if match in e.name)
    return matched / iters / 1e3, every / iters / 1e3


def run_checkouts(script: str, other: str,
                  turns: tuple = ("other", "this")) -> dict:
    """``python <script> --produce <file>`` once a turn, each in the
    checkout the turn names (this one, or ``other``: its root on
    ``PYTHONPATH`` and the working directory); returns each checkout's
    loaded files in turn order, ``{"other": [...], "this": [...]}``."""
    roots = {"other": os.path.abspath(other), "this": HERE}
    runs = {name: [] for name in roots}
    with tempfile.TemporaryDirectory() as tmp:
        for turn, name in enumerate(turns):
            out = os.path.join(tmp, f"{turn}.pt")
            env = dict(os.environ, PYTHONPATH=roots[name])
            subprocess.run([sys.executable, os.path.abspath(script),
                            "--produce", out], check=True, env=env,
                           cwd=roots[name])
            runs[name].append(torch.load(out))
    return runs
