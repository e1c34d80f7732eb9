"""Full f32 arithmetic for an f32 trunk on the card.

PyTorch runs an f32 convolution through cuDNN in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), and TF32 keeps about three
decimal digits. The trunk's patch embedding is such a convolution: on an
H100, an f32 ViT-S/8 eval step with the default flags moved the flip-TTA
code by up to 6.5e-4 from the same step in full f32, outside the f32
trunk's gates (rtol 1e-4, atol 1e-5; ``chip_smoke.py:phase_tf32_eval``).
The JAX package computes an f32 trunk in f32. So every entry point that
runs an f32 trunk turns TF32 off for the process, for cuDNN and for the
matrix products (off by default, kept off): the training app
(``train/app.py:Trainer``, and with it ``tools/accuracy_bench.py``), the
KNN precompute (``train/knn_app.py``), the dataset eval, the demo and
serving's packaging (``eval/evaluate.py:load_model_for_eval``) and the
serving side (``serve.py:ServingModel.load``). A bf16 trunk changes
nothing: its convolution and products run in bf16.

The feature-pyramid arch trains convolutions, and with TF32 off cuDNN
picks algorithms that add in no fixed order: on an H100 its app cut and
resumed ended 12.0 apart from the straight run in a BatchNorm's running
variance (``chip_smoke.py:fpn_resume``). The JAX package's steps are
deterministic, so its train step asks cuDNN for deterministic algorithms
(``deterministic_convolutions_for``), and chip_smoke holds the resumed
run to the straight one bit for bit.
"""

from __future__ import annotations

import torch


def full_f32_for(backbone_dtype: str) -> None:
    """Turn TF32 off for the process when ``backbone_dtype`` is
    "float32"."""
    if backbone_dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def deterministic_convolutions_for(arch: str) -> None:
    """Ask cuDNN for deterministic algorithms for the process when
    ``arch`` is the feature-pyramid arch, whose train step trains
    convolutions."""
    if arch == "feature-pyramid":
        torch.backends.cudnn.deterministic = True
