"""Flat configuration; the port's own copy of ``stego_tpu/config.py``.

``Config``, ``PRESETS``, ``apply_preset``, ``prep_args`` and ``_coerce`` are
the JAX package's, field for field and default for default
(``tests/test_torch_config.py`` keeps the two from drifting). The port keeps
a copy so that it imports nothing of the JAX package. Checkpoints carry the
config as a plain dict (``Config.to_dict``), so a ``.ckpt`` written by
either package loads in the other.

Key names follow the reference Hydra YAML (reference
`src/configs/train_config.yml`), and the CLI accepts both ``--key value``
and ``key=value`` styles (reference `src/utils.py:149-162` ``prep_args``).
Some fields only steer the JAX package (its mesh, Pallas and feature-cache
options); the port reads the ones its ported paths use.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Config:
    """Flat config covering train / eval / demo / preprocessing entry points."""

    # Run metadata
    output_root: str = "./output"
    pytorch_data_dir: str = "./data"
    experiment_name: str = "exp1"
    log_dir: str = "stego"
    # azureml_logging / submitting_to_aml / use_ddp are accepted for
    # reference-CLI key parity but are inert here: there is no AzureML
    # integration, and device parallelism comes from the sharded-jit mesh
    # rather than a DDP flag (parallel/mesh.py). num_workers IS live: it sets
    # the loader's decode thread count (capped at host cores —
    # data/loader.py:effective_threads; the native decoder releases the GIL
    # so threads scale like the reference's worker processes).
    azureml_logging: bool = False
    submitting_to_aml: bool = False
    full_name: str = ""
    seed: int = 0

    # Loader params (reference train_config.yml:8-24)
    num_workers: int = 4
    max_steps: int = 5000
    batch_size: int = 16
    num_neighbors: int = 7
    dataset_name: str = "cocostuff27"
    dir_dataset_name: Optional[str] = None
    dir_dataset_n_classes: int = 5
    has_labels: bool = False
    crop_type: Optional[str] = "five"
    crop_ratio: float = 0.5
    res: int = 224
    loader_crop_type: Optional[str] = "center"

    # Model params (reference train_config.yml:26-47)
    extra_clusters: int = 0
    use_true_labels: bool = False
    use_recalibrator: bool = False
    model_type: str = "vit_small"
    arch: str = "dino"
    use_fit_model: bool = False
    dino_feat_type: str = "feat"
    projection_type: Optional[str] = "nonlinear"
    dino_patch_size: int = 8
    granularity: int = 1
    continuous: bool = True
    dim: int = 70
    dropout: bool = True
    zero_clamp: bool = True
    lr: float = 5e-4
    pretrained_weights: Optional[str] = None
    use_salience: bool = False
    # Beyond-reference: keep Potsdam's 4th (near-IR) channel (the reference
    # drops it, data.py:153 TODO). Feeds a 4-channel ViT patch embed; DINO
    # weights are expanded with a mean-RGB IR slice (models/convert.py).
    potsdam_ir: bool = False
    stabalize: bool = False  # sic — reference spelling kept for key parity
    stop_at_zero: bool = True

    # Feature contrastive params (reference train_config.yml:49-64)
    pointwise: bool = True
    feature_samples: int = 11
    neg_samples: int = 5
    aug_alignment_weight: float = 0.0
    # compute the augmented view (flip+crop+jitter+blur) inside the step on
    # the device instead of on the host; device_augs=false takes the host
    # PIL/numpy path (the JAX package's ops/augment.py)
    device_augs: bool = True
    correspondence_weight: float = 1.0
    neg_inter_weight: float = 0.63
    pos_inter_weight: float = 0.25
    pos_intra_weight: float = 0.67
    neg_inter_shift: float = 0.46
    pos_inter_shift: float = 0.12
    pos_intra_shift: float = 0.18

    rec_weight: float = 0.0
    repulsion_weight: float = 0.0

    # CRF loss params (reference train_config.yml:150-159)
    crf_weight: float = 0.0
    alpha: float = 0.5
    beta: float = 0.15
    gamma: float = 0.05
    w1: float = 10.0
    w2: float = 3.0
    shift: float = 0.0
    crf_samples: int = 1000
    color_space: str = "rgb"

    reset_probe_steps: Optional[int] = None

    # Logging params (reference train_config.yml:163-168)
    n_images: int = 5
    scalar_log_freq: int = 10
    checkpoint_freq: int = 400
    val_freq: int = 100
    hist_freq: int = 100

    # Eval / demo params (reference eval_config.yml / demo_config.yml)
    run_picie: bool = False
    run_crf: bool = True
    run_prediction: bool = True
    dark_mode: bool = True
    use_ddp: bool = False
    model_paths: List[str] = field(default_factory=list)
    model_path: str = ""
    image_dir: str = ""

    # --- TPU-native additions (no reference equivalent) ---
    # Compute dtype for the frozen backbone forward ("bfloat16" | "float32").
    backbone_dtype: str = "bfloat16"
    # Use the fused correspondence-loss kernels instead of the einsum path;
    # cd histograms stay available in sampled mode (return_cd_tensors).
    use_pallas_loss: bool = True
    # Run the streamed loss's code-side products in bfloat16 (f32
    # accumulation; primals/grads stay f32); tolerances in
    # tests/test_pallas.py.
    pallas_loss_bf16: bool = False
    # Fuse the loss's coordinate sampling INTO the correlation kernel
    # instead of sampling first and feeding the streamed kernel. "auto"
    # lets each package pick; "on"/"off" force it.
    fused_sampling: str = "auto"
    # Scope of the correlation loss's negative derangements on a >1-device
    # mesh. "global": each negative may come from any image in the global
    # batch (the single-process reference's semantics; the fused-sampling
    # kernel then falls back to the streamed path on meshes, whose gathers
    # cross shards via GSPMD collectives). "local": each device draws its
    # negatives from its OWN batch shard — exactly the reference's
    # per-process DDP behavior (src/modules.py:291-295 runs per GPU under
    # train_segmentation.py:476) — which keeps the fused-sampling kernel's
    # measured wins live on any mesh (shard-local scalar-prefetch indices,
    # zero collectives in the loss). Single-device runs are identical under
    # both. Requires >=2 images per shard (a 1-image shard has no
    # derangement — ops/math.py raises rather than silently pairing every
    # image with itself). A/B on the synthetic accuracy proxy: BASELINE.md.
    negatives_scope: str = "global"
    # Pallas attention kernel for the frozen trunk (unrolls the block scan).
    # None = auto: on for bfloat16 backbones, off for float32 (parity/tests).
    use_flash_attention: Optional[bool] = None
    # Full-field correspondence loss (HW x HW) instead of sampled coords; the
    # blockwise Pallas kernel makes this tractable (SURVEY.md §5 "long-context").
    full_field_loss: bool = False
    # Data-parallel processes, one a GPU; 0 = every visible GPU (the JAX
    # package: the mesh size, 0 = all local devices).
    num_devices: int = 0
    # jax debug toggles (SURVEY.md §5 sanitizers)
    debug_nans: bool = False
    checkify: bool = False
    # checkpointing
    save_top_k: int = 2
    # resume=true restores the latest orbax step from the run's checkpoint dir
    # and continues training from there (the reference relies on manual
    # Lightning restarts; SURVEY.md §5 failure recovery)
    resume: bool = False
    # profiling trace dir ("" = disabled)
    profile_dir: str = ""
    # validation resolution (reference hard-codes 320, train_segmentation.py:446)
    val_res: int = 320
    # 0 = use batch_size (reference uses 16 under AML else batch_size, :455-458)
    val_batch_size: int = 0
    # neighbors stored in the KNN cache (reference precompute_knns.py topk(30))
    knn_k: int = 30
    # dense-CRF backend at eval: "grid" (on-device, coarse bilateral) or
    # "exact" (host-side native permutohedral lattice, pydensecrf-equivalent)
    crf_backend: str = "grid"
    # cache decoded+transformed base-dataset items in RAM. Only valid when
    # the base transform is deterministic per index (loader_crop_type !=
    # random).
    cache_dataset: bool = False
    # allow DCT-scaled JPEG decode in the native loader's TRAIN transform:
    # decode at the largest 1/2^k scale that still covers the resize
    # target. Pixel values are no longer
    # PIL-bit-identical (the IDCT's area downscale replaces part of the
    # NEAREST subsample); labels and eval paths always decode exactly.
    fast_decode: bool = False
    # persist decoded+transformed items as uint8 .npz under this directory
    # (survives process restarts: the crop/knn/train/eval stages otherwise
    # re-decode everything; see data/loader.py:DiskCachedDataset). Same
    # determinism requirement as cache_dataset. Empty = off.
    cache_dataset_dir: str = ""
    # run the FROZEN backbone once over the train split and keep its features
    # (+ labels/masks) resident in HBM: each step then gathers from the cache
    # by int32 index — no decode, no image transfer, no backbone forward
    # (train/feat_cache.py). Requires a deterministic loader transform and
    # image-free losses; the step math is identical to the uncached path.
    cache_backbone_feats: bool = False
    # refuse to build a feature cache larger than this many GiB of HBM
    # (PER DEVICE: a sharded cache divides its footprint by the mesh size)
    feat_cache_max_gb: float = 12.0
    # row-shard the feature cache over the data mesh instead of replicating
    # it: capacity scales with the mesh (d x feat_cache_max_gb) and each
    # step's gathers become an embedding-lookup-style
    # all_gather(indices) + reduce_scatter(rows) over ICI
    # (parallel/mesh.py:sharded_row_take). Identical numerics to the
    # replicated cache.
    feat_cache_sharded: bool = False
    # cached mode only: run this many train steps per device dispatch
    # (lax.scan over stacked index batches — segmenter.make_cached_multi_step).
    # Amortizes host->device dispatch latency; step semantics, key sequence,
    # and logging cadence are unchanged. 1 = one dispatch per step.
    steps_per_dispatch: int = 1
    # SIGTERM -> checkpoint after the in-flight step, then exit cleanly
    # (TPU-pod preemption safety; pairs with resume=true). Handlers install
    # only on the main thread.
    graceful_shutdown: bool = True

    def __post_init__(self):
        if self.arch not in ("dino", "feature-pyramid"):
            raise ValueError(f"Unknown arch {self.arch}")
        if self.dino_feat_type not in ("feat", "KK"):
            raise ValueError(f"Unknown dino_feat_type {self.dino_feat_type}")
        if self.projection_type not in (None, "linear", "nonlinear"):
            raise ValueError(f"Unknown projection_type {self.projection_type}")
        if self.model_type.startswith("vit") and self.model_type not in (
            "vit_tiny", "vit_small", "vit_base"
        ):
            raise ValueError(f"Unknown model_type {self.model_type}")
        if self.res % self.dino_patch_size != 0 and self.arch == "dino":
            raise ValueError(
                f"res={self.res} must be divisible by patch={self.dino_patch_size}"
            )
        if self.fused_sampling not in ("on", "off", "auto"):
            raise ValueError(
                f"fused_sampling must be 'on'/'off'/'auto', got "
                f"{self.fused_sampling!r}")
        if self.negatives_scope not in ("global", "local"):
            raise ValueError(
                f"negatives_scope must be 'global'/'local', got "
                f"{self.negatives_scope!r}")
        if self.steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        if self.steps_per_dispatch > 1 and not self.cache_backbone_feats:
            raise ValueError(
                "steps_per_dispatch>1 requires cache_backbone_feats=true "
                "(only index-only cached batches can stack into one dispatch;"
                " image batches are host-wire-bound, not dispatch-bound)")
        if self.potsdam_ir and not str(self.dataset_name).startswith("potsdam"):
            raise ValueError(
                "potsdam_ir=true requires dataset_name=potsdam/potsdamraw "
                "(only the Potsdam .mat tiles carry a 4th near-IR channel)"
            )

    # ------------------------------------------------------------------
    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any], strict: bool = False) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown and strict:
            raise ValueError(f"Unknown config keys: {sorted(unknown)}")
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_yaml(cls, path: str, **overrides) -> "Config":
        import yaml

        with open(path) as f:
            d = yaml.safe_load(f) or {}
        d.pop("hydra", None)
        d.update(overrides)
        return cls.from_dict(d)


# ----------------------------------------------------------------------
# Named presets: the per-dataset weight/shift sextuples the reference keeps
# as comment blocks (reference src/configs/train_config.yml:58-144).
PRESETS: Dict[str, Dict[str, Any]] = {
    # IAROA vit small 1/31/22 (the active values in the reference config)
    "iaroa_vit_small": dict(
        neg_inter_weight=0.63, pos_inter_weight=0.25, pos_intra_weight=0.67,
        neg_inter_shift=0.46, pos_inter_shift=0.12, pos_intra_shift=0.18,
    ),
    # Potsdam vit small 1/31/22
    "potsdam": dict(
        dataset_name="potsdam", crop_type=None, model_type="vit_small",
        neg_inter_weight=0.63, pos_inter_weight=0.25, pos_intra_weight=0.67,
        neg_inter_shift=0.46, pos_inter_shift=0.02, pos_intra_shift=0.08,
    ),
    # Cocostuff27 vit small 1/31/22
    "cocostuff27_vit_small": dict(
        dataset_name="cocostuff27", model_type="vit_small",
        neg_inter_weight=0.63, pos_inter_weight=0.25, pos_intra_weight=0.67,
        neg_inter_shift=0.66, pos_inter_shift=0.02, pos_intra_shift=0.08,
    ),
    # Cocostuff27 10/3 vit_base
    "cocostuff27_vit_base": dict(
        dataset_name="cocostuff27", model_type="vit_base",
        neg_inter_weight=0.1538476246415498, pos_inter_weight=1.0,
        pos_intra_weight=0.1,
        neg_inter_shift=1.0, pos_inter_shift=0.2, pos_intra_shift=0.12,
    ),
    # Cityscapes 10/3
    "cityscapes": dict(
        dataset_name="cityscapes", model_type="vit_base",
        neg_inter_weight=0.9058762625226623, pos_inter_weight=0.577453483136995,
        pos_intra_weight=1.0,
        neg_inter_shift=0.31361241889448443, pos_inter_shift=0.1754346515479633,
        pos_intra_shift=0.45828472207,
    ),
}


def check_batch_split(cfg: Config, world: int) -> None:
    """The checks of a run on ``world`` processes
    (``stego_tpu/train/app.py:475-481``, ``ops/math.py:50-56``): the train
    and validation batches, which are global, split evenly over the
    processes, and local negatives have at least 2 images a process to
    draw from."""
    val_bs = cfg.val_batch_size or cfg.batch_size
    if cfg.batch_size % world or val_bs % world:
        raise ValueError(f"batch sizes ({cfg.batch_size}, val {val_bs}) "
                         f"must be divisible by the {world} processes")
    if (world > 1 and cfg.negatives_scope == "local"
            and cfg.correspondence_weight > 0 and cfg.neg_samples > 0
            and cfg.batch_size // world < 2):
        raise ValueError(
            f"negatives_scope=local needs >=2 images per process to draw a "
            f"negative from; got batch {cfg.batch_size} over {world} "
            f"processes. Raise batch_size or use negatives_scope=global.")


def apply_preset(cfg: Config, name: str) -> Config:
    if name not in PRESETS:
        raise ValueError(f"Unknown preset {name!r}; have {sorted(PRESETS)}")
    return cfg.replace(**PRESETS[name])


def prep_args(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Parse ``--key value`` / ``key=value`` CLI args into an override dict.

    Mirrors the reference's arg rewriting (reference src/utils.py:149-162)
    but returns a dict instead of mutating sys.argv.
    """
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    if any(a in ("--help", "-h", "help") for a in args):
        print(__doc__)
        print("Config keys (key=value or --key value; 'config=<yaml>' loads "
              "a base file first):\n")
        defaults = Config()
        for f in dataclasses.fields(Config):
            print(f"  {f.name} (default: {getattr(defaults, f.name)!r})")
        raise SystemExit(0)
    out: Dict[str, Any] = {}
    while args:
        arg = args.pop(0)
        if "=" in arg and not arg.startswith("--"):
            key, val = arg.split("=", 1)
        elif arg.startswith("--"):
            if not args:
                raise ValueError(f"Flag {arg} missing a value")
            key, val = arg[2:], args.pop(0)
        else:
            raise ValueError(f"Unexpected arg style {arg}")
        out[key] = _coerce(val)
    return out


def _coerce(v: str) -> Any:
    if v.startswith("[") and v.endswith("]"):
        # Hydra/YAML-style inline list a reference user types on the CLI:
        # model_paths='[a, b]' (quotes around elements optional)
        body = v[1:-1].strip()
        if not body:
            return []
        return [_coerce(e.strip().strip("'\"")) for e in body.split(",")]
    if v in ("~", "null", "None"):
        return None
    if v in ("true", "True"):
        return True
    if v in ("false", "False"):
        return False
    for typ in (int, float):
        try:
            return typ(v)
        except ValueError:
            pass
    return v
