"""Dataset adapters (``dinov3_tpu/data/adapters.py``).

``DatasetWithEnumeratedTargets`` makes each target an (index, target)
pair, and may pad the length up to a multiple of the replicas of a
data-parallel eval; a padding sample repeats an earlier one with index -1.
"""

from __future__ import annotations

from typing import Any


class DatasetWithEnumeratedTargets:
    def __init__(self, dataset, pad_dataset: bool = False, num_replicas: int = 1):
        self._dataset = dataset
        n = len(dataset)
        if pad_dataset and num_replicas > 1:
            self._size = -(-n // num_replicas) * num_replicas
        else:
            self._size = n

    def get_image_relpath(self, index: int) -> Any:
        return self._dataset.get_image_relpath(index % len(self._dataset))

    def get_target(self, index: int) -> tuple[int, Any]:
        if index >= len(self._dataset):
            return (-1, None)
        return (index, self._dataset.get_target(index))

    def __getitem__(self, index: int):
        n = len(self._dataset)
        image, target = self._dataset[index % n]
        return image, (-1 if index >= n else index, target)

    def __len__(self) -> int:
        return self._size
