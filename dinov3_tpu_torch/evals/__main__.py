"""Standalone evaluation of a training run's EMA teacher.

    python -m dinov3_tpu_torch.evals --ckpt build/run/ckpt \\
        --config-file configs/train/vitl16_im1k.yaml \\
        evaluation.train_dataset_path=ImageNet:split=TRAIN \\
        evaluation.val_dataset_path=ImageNet:split=VAL data.root=/data/in1k

Restores the EMA teacher's backbone of the latest finalized checkpoint
under ``--ckpt`` (this package's, or the JAX package's local-npz kind), or
loads Meta's released backbone weights with ``--meta-weights
dinov3_vitg14.pth`` instead (``interop/torch_convert.py``; the config must
name the same architecture), extracts the features of the train and val sets (capped by
``--max-*-samples``; 0 takes the whole set), runs k-NN at k = 10 and 20
and the linear probe's lr sweep, and prints one JSON line (also written
to ``--output``). ``MODEL.DEVICE=cpu`` runs on the CPU with the kernels'
plain versions; any other value runs on the card.
"""

from __future__ import annotations

import argparse
import json
import sys


def get_args_parser():
    p = argparse.ArgumentParser("dinov3_tpu_torch standalone evaluation")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt", default="",
                     help="checkpoint directory (the trainer's <output-dir>/ckpt)")
    src.add_argument("--meta-weights", default="",
                     help="a Meta release backbone state_dict file (.pth)")
    p.add_argument("--config-file", default="", help="run recipe YAML")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--probe-epochs", type=int, default=10)
    p.add_argument("--max-train-samples", type=int, default=0,
                   help="0 = the whole dataset")
    p.add_argument("--max-val-samples", type=int, default=0,
                   help="0 = the whole dataset")
    p.add_argument("--output", default="", help="also write the JSON here")
    p.add_argument("opts", nargs="*", default=[],
                   help="key.path=value config overrides")
    return p


def main(argv=None) -> dict:
    args = get_args_parser().parse_args(argv)

    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.evals.harness import do_eval
    from dinov3_tpu_torch.models import build_model_for_eval
    from dinov3_tpu_torch.ops._cuda import build_kernels
    from dinov3_tpu_torch.ops.flash_attention import FLASH_FWD
    from dinov3_tpu_torch.ops.fused_norm import LAYERNORM_FWD
    from dinov3_tpu_torch.train.train import train_device

    cfg = load_config(args.config_file or None, overrides=list(args.opts), n_devices=1)
    device = train_device(cfg)
    model = build_model_for_eval(cfg, args.ckpt or None, device=device,
                                 meta_weights=args.meta_weights or None)
    if device == "cuda":
        build_kernels([FLASH_FWD, LAYERNORM_FWD])  # one nvcc each, in parallel
    results = do_eval(cfg, model, batch_size=args.batch_size,
                      probe_epochs=args.probe_epochs,
                      max_train_samples=args.max_train_samples or None,
                      max_val_samples=args.max_val_samples or None, protocol=True)
    line = json.dumps(results)
    print(line, flush=True)
    if args.output:
        with open(args.output, "w") as f:
            f.write(line + "\n")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
