"""Weighted k-NN classification, the DINO evaluation protocol
(``dinov3_tpu/evals/knn.py``).

Cosine similarity on L2-normalized fp32 features, the k most similar
train rows voting for their labels with weight ``exp(sim / T)``, T =
0.07, k = 10 and 20. Test rows go in chunks of 1024, so the [N_test,
N_train] similarity matrix never exists whole (one chunk at ImageNet-1k
size is [1024, 1,281,167] fp32, 5.2 GB). The train features live on
``device``. ``torch.topk`` on continuous features has no ties to order;
the vote's argmax takes the first maximum, as ``jnp.argmax`` does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dinov3_tpu_torch.ops.common import resolve_device


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def knn_predict(train_feats, train_labels, test_feats, n_classes: int,
                ks=(10,), temperature: float = 0.07, chunk: int = 1024, *,
                device="cuda") -> dict[int, np.ndarray]:
    """{k: predicted labels [N_test]} for each k in ``ks``, from one pass
    over the similarities: the top max(ks) neighbours, sorted, whose first
    k vote for k."""
    dev = resolve_device(device)
    tr = _normalize(torch.as_tensor(train_feats, dtype=torch.float32, device=dev))
    labels = torch.as_tensor(train_labels, device=dev).long()
    te = torch.as_tensor(test_feats, dtype=torch.float32, device=dev)
    kk = {k: min(k, tr.shape[0]) for k in ks}
    k_max = max(kk.values())
    preds = {k: [] for k in ks}
    for start in range(0, te.shape[0], chunk):
        sims = _normalize(te[start:start + chunk]) @ tr.T  # [C, N_train]
        top_sims, top_idx = torch.topk(sims, k_max, dim=1)
        del sims
        votes = F.one_hot(labels[top_idx], n_classes).float()  # [C, k, K]
        weights = torch.exp(top_sims / temperature)[..., None]
        for k, kc in kk.items():
            scores = (votes[:, :kc] * weights[:, :kc]).sum(dim=1)
            preds[k].append(scores.argmax(dim=-1))
    return {k: torch.cat(p).cpu().numpy() for k, p in preds.items()}


def knn_classify(train_feats, train_labels, test_feats, n_classes: int,
                 k: int = 10, temperature: float = 0.07, chunk: int = 1024, *,
                 device="cuda") -> np.ndarray:
    """Predicted labels [N_test]."""
    return knn_predict(train_feats, train_labels, test_feats, n_classes, (k,),
                       temperature, chunk, device=device)[k]


def _top1(preds: np.ndarray, labels) -> float:
    return float((preds == torch.as_tensor(labels).cpu().numpy()).mean())


def knn_eval(train_feats, train_labels, test_feats, test_labels, n_classes: int,
             k: int = 10, temperature: float = 0.07, *, device="cuda") -> float:
    """Top-1 accuracy."""
    return _top1(knn_classify(train_feats, train_labels, test_feats, n_classes, k,
                              temperature, device=device), test_labels)


def knn_eval_multi(train_feats, train_labels, test_feats, test_labels,
                   n_classes: int, ks=(10, 20), temperature: float = 0.07, *,
                   device="cuda") -> dict:
    """{"knn10_top1": .., "knn20_top1": ..}: the protocol reports both
    (its headline is the best k), from one pass over the similarities."""
    preds = knn_predict(train_feats, train_labels, test_feats, n_classes, ks,
                        temperature, device=device)
    return {f"knn{k}_top1": _top1(preds[k], test_labels) for k in ks}
