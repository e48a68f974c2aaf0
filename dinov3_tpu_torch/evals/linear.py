"""Linear probe: logistic regression on frozen features
(``dinov3_tpu/evals/linear.py``).

``train_probes`` trains C probes at once, one ``[C, d, K]`` weight and
``[C, K]`` bias, with batched products (the counterpart of the JAX vmap):
zero init; each step a minibatch of ``batch_size`` rows in the epoch's
order, the mean softmax cross-entropy's gradient, plus ``wd * w`` (and
``wd * b`` with ``decay_bias``); SGD with momentum 0.9 (``m = 0.9 m + g``,
``p -= lr_t m``) and the cosine decay ``lr_t = lr * (1 + cos(pi t / T)) /
2`` over the T steps of all epochs. ``linear_probe_eval`` is one probe
with the decayed-weight term on both ``w`` and ``b`` (the JAX function
runs ``optax.add_decayed_weights`` over the whole tree);
``linear_probe_sweep`` the DINOv2 lr grid, decaying ``w`` only (as the
JAX sweep does).

Each epoch's order is ``torch.randperm`` from a CPU ``torch.Generator``
seeded with ``seed`` (the same orders on the card and on the CPU); its
numbers are not JAX's ``jax.random.permutation``: ``orders`` ([epochs,
n] int64) hands orders in, so tests can hand the JAX ones across. A
probe step is a plain product, as in the JAX package (no Pallas kernel):
``torch.matmul`` runs it, in full fp32 on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dinov3_tpu_torch.ops.common import resolve_device

# the DINOv2-protocol grid: the published linear-probe numbers take the
# best probe of a grid of learning rates; weight decay stays 0 there
DEFAULT_PROBE_LRS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1)
DEFAULT_PROBE_WDS = (0.0,)
MOMENTUM = 0.9


def epoch_orders(n: int, epochs: int, seed: int = 0) -> torch.Tensor:
    """[epochs, n] int64: one ``randperm`` an epoch from a CPU generator."""
    gen = torch.Generator().manual_seed(seed)
    return torch.stack([torch.randperm(n, generator=gen) for _ in range(epochs)])


def train_probes(train_feats, train_labels, n_classes: int, lrs, wds, *,
                 epochs: int = 10, batch_size: int = 256, seed: int = 0,
                 orders=None, decay_bias: bool = False,
                 device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """(w [C, d, K], b [C, K]) of the C = len(lrs) probes, lr ``lrs[c]``
    and weight decay ``wds[c]``, trained jointly on ``device``."""
    dev = resolve_device(device)
    x = torch.as_tensor(train_feats, dtype=torch.float32, device=dev)
    y = torch.as_tensor(train_labels, device=dev).long()
    n, d = x.shape
    batch_size = min(batch_size, n)
    steps_per_epoch = max(1, n // batch_size)
    total = epochs * steps_per_epoch
    if orders is None:
        orders = epoch_orders(n, epochs, seed)
    orders = torch.as_tensor(orders, device=dev).long()
    if tuple(orders.shape) != (epochs, n):
        raise ValueError(f"orders of shape {tuple(orders.shape)}, need ({epochs}, {n})")
    C = len(lrs)
    lr = torch.tensor(list(lrs), dtype=torch.float32, device=dev)
    wd = torch.tensor(list(wds), dtype=torch.float32, device=dev)
    w = torch.zeros((C, d, n_classes), dtype=torch.float32, device=dev)
    b = torch.zeros((C, n_classes), dtype=torch.float32, device=dev)
    mw, mb = torch.zeros_like(w), torch.zeros_like(b)
    rows = torch.arange(batch_size, device=dev)
    t = 0
    for e in range(epochs):
        for i in range(steps_per_epoch):
            idx = orders[e, i * batch_size:(i + 1) * batch_size]
            xb, yb = x[idx], y[idx]
            # d(mean CE)/d(logits) = (softmax - onehot) / B
            g = torch.softmax(torch.matmul(xb, w).add_(b[:, None]), dim=-1)  # [C, B, K]
            g[:, rows, yb] -= 1.0
            g /= batch_size
            gw = torch.matmul(xb.T, g).add_(wd[:, None, None] * w)
            gb = g.sum(dim=1)
            if decay_bias:
                gb.add_(wd[:, None] * b)
            lr_t = lr * (0.5 * (1.0 + math.cos(math.pi * t / total)))
            mw.mul_(MOMENTUM).add_(gw)
            mb.mul_(MOMENTUM).add_(gb)
            w.sub_(lr_t[:, None, None] * mw)
            b.sub_(lr_t[:, None] * mb)
            t += 1
    return w, b


def _top1s(w, b, test_feats, test_labels) -> list[float]:
    """Top-1 accuracy of each probe."""
    te = torch.as_tensor(test_feats, dtype=torch.float32, device=w.device)
    preds = torch.matmul(te, w).add_(b[:, None]).argmax(dim=-1).cpu().numpy()
    labels = torch.as_tensor(test_labels).cpu().numpy()
    return [float(v) for v in (preds == labels[None]).mean(axis=1)]


def linear_probe_eval(train_feats, train_labels, test_feats, test_labels,
                      n_classes: int, epochs: int = 10, batch_size: int = 256,
                      lr: float = 1e-2, weight_decay: float = 0.0, seed: int = 0,
                      *, orders=None, device="cuda") -> float:
    """Test top-1 accuracy of one trained probe."""
    w, b = train_probes(train_feats, train_labels, n_classes, (lr,), (weight_decay,),
                        epochs=epochs, batch_size=batch_size, seed=seed,
                        orders=orders, decay_bias=True, device=device)
    return _top1s(w, b, test_feats, test_labels)[0]


def linear_probe_sweep(train_feats, train_labels, test_feats, test_labels,
                       n_classes: int, lrs=DEFAULT_PROBE_LRS, wds=DEFAULT_PROBE_WDS,
                       epochs: int = 10, batch_size: int = 256, seed: int = 0,
                       *, orders=None, device="cuda") -> tuple[float, dict]:
    """The lr x wd grid trained jointly: (best accuracy, {"lr=..,wd=..":
    accuracy})."""
    combos = [(lr, wd) for lr in lrs for wd in wds]
    w, b = train_probes(train_feats, train_labels, n_classes,
                        [c[0] for c in combos], [c[1] for c in combos],
                        epochs=epochs, batch_size=batch_size, seed=seed,
                        orders=orders, device=device)
    accs = {f"lr={lr:g},wd={wd:g}": acc
            for (lr, wd), acc in zip(combos, _top1s(w, b, test_feats, test_labels))}
    return max(accs.values()), accs
