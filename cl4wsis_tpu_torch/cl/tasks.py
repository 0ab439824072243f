"""Continual-learning task registry (a copy of ``cl4wsis_tpu/cl/tasks.py``,
kept here so that the port imports nothing of the JAX package).

The incremental protocol — which class ids arrive at which step, for each
dataset/task name — is static data. Parity target: reference ``tasks.py:1-118``
(the class-id tables are protocol data shared with the reference, not code).

Class id 0 is always background for VOC; COCO tables use raw COCO category ids
with 0 as background.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# fmt: off
_COCO_VOC_STEP0 = [
    0, 8, 10, 11, 13, 14, 15, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36,
    37, 38, 39, 40, 41, 42, 43, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56,
    57, 58, 59, 60, 61, 65, 70, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84,
    85, 86, 87, 88, 89, 90,
]
_COCO_VOC_STEP1 = [1, 2, 3, 4, 5, 6, 7, 9, 16, 17, 18, 19, 20, 21, 44, 62, 63, 64, 67, 72]

TASKS: Dict[str, Dict[str, Dict[int, List[int]]]] = {
    "coco": {
        "offline": {
            0: [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18,
                19, 20, 21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37,
                38, 39, 40, 41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54,
                55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74,
                75, 76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87, 88, 89, 90],
        },
        "voc": {0: list(_COCO_VOC_STEP0), 1: list(_COCO_VOC_STEP1)},
    },
    "voc": {
        "offline": {0: list(range(21))},
        "19-1": {0: list(range(20)), 1: [20]},
        "19-1b": {0: [0, 1, 2, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20], 1: [5]},
        "15-5": {0: list(range(16)), 1: [16, 17, 18, 19, 20]},
        "15-1": {0: list(range(16)), 1: [16], 2: [17], 3: [18], 4: [19], 5: [20]},
        "10-5": {0: list(range(11)), 1: [11, 12, 13, 14, 15], 2: [16, 17, 18, 19, 20]},
        "10-2": {0: list(range(11)), 1: [11, 12], 2: [13, 14], 3: [15, 16], 4: [17, 18], 5: [19, 20]},
        "10-10": {0: list(range(11)), 1: [11, 12, 13, 14, 15, 16, 17, 18, 19, 20]},
    },
    "coco-voc": {
        "voc": {0: list(_COCO_VOC_STEP0), 1: list(_COCO_VOC_STEP1)},
    },
}
# fmt: on


def get_task_list() -> List[str]:
    return [task for ds in TASKS for task in TASKS[ds]]


def _task_dict(dataset: str, name: str) -> Dict[int, List[int]]:
    try:
        return TASKS[dataset][name]
    except KeyError as e:
        raise NotImplementedError(f"unknown task {dataset}/{name}") from e


def get_task_labels(dataset: str, name: str, step: int) -> Tuple[List[int], List[int], str]:
    """New-class ids at `step`, all old-class ids before it, and the task path."""
    td = _task_dict(dataset, name)
    if step not in td:
        raise ValueError(f"step {step} out of range for {dataset}/{name}")
    labels = list(td[step])
    labels_old = [lab for s in range(step) for lab in td[s]]
    return labels, labels_old, f"{dataset}/{name}"


def get_task_dict(dataset: str, name: str, step: int) -> Dict[int, List[int]]:
    td = _task_dict(dataset, name)
    if step not in td:
        raise ValueError(f"step {step} out of range for {dataset}/{name}")
    return {s: td[s] for s in range(step + 1)}


def get_per_task_classes(dataset: str, name: str, step: int) -> List[int]:
    """Number of classes introduced at each step 0..step (step 0 includes bg)."""
    td = _task_dict(dataset, name)
    if step not in td:
        raise ValueError(f"step {step} out of range for {dataset}/{name}")
    return [len(td[s]) for s in range(step + 1)]
