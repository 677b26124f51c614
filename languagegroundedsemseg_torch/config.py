"""Framework configuration: one dataclass serving API and CLI.

Counterpart of ``languagegroundedsemseg_tpu/config.py`` (:21-304), copied
field for field so one command line or YAML overlay configures either
package. Field names and defaults mirror the reference flag surface
(reference config/config.py:48-287); the knobs of the JAX package's own
(capacity buckets, dtype, device count) sit at the end and keep their names.
``yaml`` is imported inside ``load_yaml_overlay`` only, so the module loads
where PyYAML is not installed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class Config:
    # Network
    model: str = "Res16UNet34C"
    conv1_kernel_size: int = 3
    weights: str = "None"
    weights_for_inner_model: bool = False
    dilations: Tuple[int, ...] = (1, 1, 1, 1)

    # Wrappers (CRF)
    wrapper_type: str = "None"
    wrapper_region_type: int = 1
    wrapper_kernel_size: int = 3
    wrapper_lr: float = 1e-1
    meanfield_iterations: int = 10
    crf_spatial_sigma: int = 1
    crf_chromatic_sigma: int = 12

    # Optimizer
    optimizer: str = "SGD"
    lr: float = 0.05
    sgd_momentum: float = 0.9
    sgd_dampening: float = 0.1
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    weight_decay: float = 1e-4
    iter_size: int = 1
    bn_momentum: float = 0.02
    classifier_only: bool = False
    # Classifier stage on precomputed frozen-backbone features with
    # per-epoch class-balanced resampling (train/classifier.py — the
    # reference's pl_ClassifierTrainer.py:120 resample_features() contract,
    # whose dataset class the reference itself lacks).
    classifier_resample_features: bool = False
    classifier_samples_per_class: int = 256

    # Loss
    loss_type: str = "cross_entropy"  # cross_entropy | focal | weighted_ce
    focal_alpha: float = 1.0
    focal_gamma: float = 2.0

    # Scheduler
    scheduler: str = "MultiStepLR"
    max_iter: float = 10e6
    max_epoch: int = 400
    step_size: float = 2e4
    multi_step_milestones: Tuple[int, ...] = (120, 150)
    step_gamma: float = 0.3
    poly_power: float = 0.9
    exp_gamma: float = 0.95
    exp_step_size: float = 445
    scheadule_monitor: str = "val_miou"
    scheduler_min_lr: float = 10e-4
    reduce_patience: float = 20

    # Directories / aux data
    log_dir: str = "outputs/default"
    data_dir: str = "data"
    scannet_path: str = ""
    category_weights: str = "feature_data/scannet200_category_weights.pkl"
    category_frequencies_path: str = "feature_data/dataset_frequencies.pkl"
    weighted_cross_entropy: bool = False
    instance_sampling_weights: str = "feature_data/tail_split_inst_sampling_weights.pkl"
    sample_tail_instances: bool = False
    bounding_boxes_path: str = "feature_data/full_train_bbs_with_rels.pkl"
    max_instance_placing_iterations: int = 50
    num_instances_to_add: int = 5
    language_features_path: str = "feature_data/clip_feats_scannet_200.pkl"
    projection_model_path: str = "feature_data/scannet200_attribute_projection_model.ckpt"

    # Metric learning (language grounding)
    use_embedding_loss: Optional[str] = None  # None | 'contrastive'/'l2' | 'both'
    embedding_loss_type: str = "contrast"
    num_pos_samples: int = 1
    num_negative_samples: int = 3
    clip_uniform_sampling: bool = True
    contrast_pos_thresh: float = 0.0
    contrast_neg_thresh: float = 0.6
    contrast_neg_weight: float = 1.0
    embedding_loss_lambda: float = 1.0
    representation_distance_type: str = "cos"  # cos | l2 | l1
    normalize_features: bool = False
    feat_norm_loss_max: float = 0.2
    learned_projection: bool = False

    # Data
    dataset: str = "Scannet200Voxelization2cmDataset"
    point_lim: int = -1
    pre_point_lim: int = -1
    batch_size: int = 16
    val_batch_size: int = 1
    test_batch_size: int = 1
    cache_data: bool = False
    num_workers: int = 4
    num_val_workers: int = 4
    ignore_label: int = -1
    return_transformation: bool = False
    partial_crop: float = 0.0
    train_limit_numpoints: int = 1_800_000
    instance_augmentation: Optional[str] = None  # None | raw | latent
    instance_augmentation_color_aug_prob: float = 0.5
    instance_augmentation_scale_aug_prob: float = 0.2

    # Training
    is_train: bool = True
    stat_freq: int = 40
    visualize_freq: int = 0
    # Observability: TensorBoard event files (reference main.py:178) and
    # profiler trace capture (written under <log_dir>/plugins)
    tensorboard: bool = True
    profile: bool = False
    profile_start_step: int = 10
    profile_num_steps: int = 5
    val_freq: int = 400
    train_phase: str = "train"
    val_phase: str = "val"
    resume: Optional[str] = None
    resume_optimizer: bool = True
    eval_upsample: bool = False
    lenient_weight_loading: bool = True

    # Augmentation
    train_augmentation: bool = True
    elastic_distortion: bool = True
    use_feat_aug: bool = True
    data_aug_color_trans_ratio: float = 0.10
    data_aug_color_jitter_std: float = 0.05
    data_aug_color_scaling_factor: float = 1.0
    normalize_color: bool = True
    data_aug_scale_min: float = 0.9
    data_aug_scale_max: float = 1.1
    data_aug_hue_max: float = 0.5
    data_aug_saturation_max: float = 0.20
    data_aug_patch_dropout_ratio: float = 0.35

    # Test
    visualize: bool = False
    visualize_path: str = "outputs/visualize"
    save_prediction: bool = False
    save_pred_dir: str = "outputs/pred"
    test_phase: str = "test"
    test_original_pointcloud: bool = False
    evaluate_original_pointcloud: bool = False

    # Misc
    overfit_batches: float = 0.0
    seed: int = 42
    num_gpu: int = 1  # kept for script compat; the device count is read at run time

    # Balancing
    balanced_category_sampling: bool = True
    balanced_sample_head_ratio: float = -1
    balanced_sample_common_ratio: float = -1

    # ---- the JAX package's own knobs (no reference analog) ----
    compute_dtype: str = "float32"  # float32 | bfloat16
    fixed_capacity: int = 0  # 0 = bucketed (power-of-2 buckets)
    level_capacity_ratios: Optional[Tuple[float, ...]] = None
    num_devices: int = 0  # 0 = all visible devices
    remat: bool = False  # recompute the encoder/decoder stages in the backward

    def __post_init__(self):
        # These flags exist for CLI compatibility but have NO consumer in the
        # reference either (defined at reference config/config.py:178-210 and
        # never read); fail loudly instead of silently ignoring a non-default.
        dead = {
            "point_lim": -1,
            "pre_point_lim": -1,
            "partial_crop": 0.0,
            "eval_upsample": False,
        }
        for name, default in dead.items():
            if getattr(self, name) != default:
                raise ValueError(
                    f"--{name} is accepted for reference-CLI compatibility "
                    f"but implemented nowhere (the reference never reads it "
                    f"either); remove the flag or leave it at {default!r}"
                )

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


def _coerce(f: dataclasses.Field, v: str):
    t = f.type
    if v == "None":
        return None
    if t in ("bool", bool):
        return v.lower() in ("true", "1")
    if t in ("int", int):
        return int(float(v))
    if t in ("float", float):
        return float(v)
    if "Tuple[int" in str(t):
        return tuple(int(x) for x in v.split(","))
    if "Tuple[float" in str(t):
        return tuple(float(x) for x in v.split(","))
    return v


def _fields_by_name():
    return {f.name: f for f in dataclasses.fields(Config)}


def load_yaml_overlay(path: str, strict: bool = False) -> dict:
    """Flatten a reference-style nested YAML (sections like ``net:``,
    ``optimizer:``, ``data:`` — reference downstream/insseg/config/
    default.yaml) onto Config field names. Section names are dropped:
    ``optimizer.lr`` -> ``lr``. Unknown keys warn (or raise when strict)."""
    import logging

    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    fields = _fields_by_name()
    out: dict = {}

    def visit(prefix, node):
        for k, v in node.items():
            if isinstance(v, dict):
                visit(f"{prefix}{k}.", v)
                continue
            if k not in fields:
                msg = f"yaml key {prefix}{k} has no Config field"
                if strict:
                    raise KeyError(msg)
                logging.warning("%s (ignored)", msg)
                continue
            if v is None:
                continue
            f_ = fields[k]
            out[k] = _coerce(f_, str(v)) if isinstance(v, str) else (
                tuple(v) if isinstance(v, list) else v
            )

    visit("", doc)
    return out


def parse_dot_overrides(items: List[str], strict: bool = True) -> dict:
    """Hydra-style ``section.key=value`` (or ``key=value``) CLI overrides
    (the reference's insseg scripts pass ``optimizer.lr=0.1`` style args,
    scripts/train_scannet_slurm.sh)."""
    fields = _fields_by_name()
    out = {}
    for item in items:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not key=value")
        key, _, val = item.partition("=")
        name = key.split(".")[-1]
        if name not in fields:
            if strict:
                raise KeyError(f"override {key} has no Config field")
            continue
        out[name] = _coerce(fields[name], val)
    return out


def get_config(argv: Optional[List[str]] = None) -> Config:
    """CLI entry: every Config field becomes a --flag (reference
    config/config.py:285 get_config equivalent). Also accepts
    ``--config overrides.yaml`` (nested reference-style YAML) and
    positional ``section.key=value`` dot-overrides; precedence:
    defaults < yaml < dot-overrides < explicit --flags."""
    parser = argparse.ArgumentParser("languagegroundedsemseg_torch")
    parser.add_argument("--config", type=str, default=None,
                        help="nested YAML overlay (insseg default.yaml style)")
    parser.add_argument("dot_overrides", nargs="*", default=[],
                        help="section.key=value overrides")
    for f in dataclasses.fields(Config):
        parser.add_argument(f"--{f.name}", type=str, default=None)
    args = parser.parse_args(argv)
    overrides = {}
    if args.config:
        overrides.update(load_yaml_overlay(args.config))
    overrides.update(parse_dot_overrides(args.dot_overrides))
    for f in dataclasses.fields(Config):
        v = getattr(args, f.name)
        if v is not None:
            overrides[f.name] = _coerce(f, v)
    return Config(**overrides)
