"""k-NN and linear-probe evaluation of a backbone, normally the EMA
teacher (``dinov3_tpu/evals/harness.py``).

``do_eval`` extracts the CLS features of a train and a val split (the
classification train and eval transforms at the global crop size, epoch
samplers seeded with ``train.seed`` and ``train.seed + 1``, full batches
only, capped sample counts) and scores them. The defaults are the cheap
signal a training run takes every ``evaluation.eval_period_iterations``
(k-NN at k = 10 and one probe); ``protocol=True`` is the certification
mode of ``python -m dinov3_tpu_torch.evals`` (k-NN at k = 10 and 20, the
probe's lr sweep). One process on one card: a data-parallel world or a
device mesh waits (ROADMAP M7), and with it the JAX package's
cross-process feature gather.
"""

from __future__ import annotations

import logging

from dinov3_tpu_torch.data.collate import collate_eval
from dinov3_tpu_torch.data.loaders import (
    SamplerType,
    make_data_loader,
    make_dataset,
    resolve_dataset_str,
)
from dinov3_tpu_torch.data.transforms import (
    make_classification_eval_transform,
    make_classification_train_transform,
)
from dinov3_tpu_torch.evals.features import extract_features
from dinov3_tpu_torch.evals.knn import knn_eval, knn_eval_multi
from dinov3_tpu_torch.evals.linear import linear_probe_eval, linear_probe_sweep
from dinov3_tpu_torch.logging_utils import LOGGER_NAME

logger = logging.getLogger(LOGGER_NAME)


def _loader(dataset_str, transform, batch_size, num_workers, seed, max_samples):
    """(loader, the number of batches to take) over one split."""

    def wrap(samples):
        return collate_eval([{"image": img, "label": t} for img, t in samples])

    ds = make_dataset(dataset_str, transform=transform, seed=seed)
    loader = make_data_loader(
        ds, batch_size=batch_size, collate_fn=wrap, num_workers=num_workers,
        shuffle=True, seed=seed, sampler_type=SamplerType.EPOCH, drop_last=True)
    n = len(ds) if max_samples is None else min(len(ds), max_samples)
    return loader, max(1, n // batch_size)


def _features(model, loader, max_batches):
    """Features of the loader's first ``max_batches`` batches; its threads
    are stopped on return, and on a raise."""
    batches = iter(loader)
    try:
        return extract_features(model, batches, max_batches=max_batches)
    finally:
        batches.close()


def do_eval(cfg, model, *, train_dataset_str: str | None = None,
            val_dataset_str: str | None = None, n_classes: int = 1000,
            batch_size: int = 64, max_train_samples: int | None = 10_000,
            max_val_samples: int | None = 2_000, knn_k: int = 10,
            probe_epochs: int = 10, protocol: bool = False,
            data_world: int | None = None, mesh=None) -> dict:
    """{"knn_top1", "linear_top1"} of ``model``'s CLS features; with
    ``protocol`` also "knn10_top1", "knn20_top1" and "linear_sweep" (the
    accuracy of each lr). The scores run on the model's device."""
    if mesh is not None or (data_world or 1) > 1:
        raise NotImplementedError(
            "evals over a data-parallel world or a mesh wait (ROADMAP M7)")
    device = next(model.parameters()).device
    ev = cfg.get("evaluation") or {}
    # the train pipeline's rooting rule: the evals see the trainer's dataset
    train_str = resolve_dataset_str(
        cfg, train_dataset_str or ev.get("train_dataset_path") or None)
    val_raw = val_dataset_str or ev.get("val_dataset_path")
    val_str = resolve_dataset_str(cfg, val_raw) if val_raw else train_str
    size = cfg.crops.global_crops_size
    if isinstance(size, (list, tuple)):
        size = int(size[0])
    num_workers = cfg.train.get("num_workers", 8)
    train_loader, train_batches = _loader(
        train_str, make_classification_train_transform(crop_size=size),
        batch_size, num_workers, cfg.train.seed, max_train_samples)
    val_loader, val_batches = _loader(
        val_str, make_classification_eval_transform(
            resize_size=int(size * 256 / 224), crop_size=size),
        batch_size, num_workers, cfg.train.seed + 1, max_val_samples)
    train_feats, train_labels = _features(model, train_loader, train_batches)
    val_feats, val_labels = _features(model, val_loader, val_batches)
    n_classes = int(max(n_classes, train_labels.max() + 1, val_labels.max() + 1))
    if protocol:
        best, grid = linear_probe_sweep(train_feats, train_labels, val_feats,
                                        val_labels, n_classes, epochs=probe_epochs,
                                        device=device)
        results = {**knn_eval_multi(train_feats, train_labels, val_feats, val_labels,
                                    n_classes, device=device),
                   "linear_top1": best, "linear_sweep": grid}
        results["knn_top1"] = max(v for k, v in results.items() if k.startswith("knn"))
    else:
        results = {
            "knn_top1": knn_eval(train_feats, train_labels, val_feats, val_labels,
                                 n_classes, k=knn_k, device=device),
            "linear_top1": linear_probe_eval(train_feats, train_labels, val_feats,
                                             val_labels, n_classes,
                                             epochs=probe_epochs, device=device),
        }
    logger.info("eval: knn_top1=%.4f linear_top1=%.4f (%d train / %d val feats)",
                results["knn_top1"], results["linear_top1"], len(train_feats),
                len(val_feats))
    return results
