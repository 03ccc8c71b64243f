"""World-level data augmentation (numpy, host side).

Counterpart of ``gencomm_tpu/data/augmentor.py``: a queue of
``random_world_flip`` (y -> -y), ``random_world_rotation`` (a yaw in
``WORLD_ROT_ANGLE``) and ``random_world_scaling``, applied to points and
GT boxes together, for early and late fusion training only. Each
primitive also returns its 4 x 4 point transform, which early fusion folds
into the agent -> ego matrices. The same ``RandomState`` gives the same
draws as the JAX package.
"""

from __future__ import annotations

import numpy as np


def random_world_flip(points, boxes, rng, prob: float = 0.5):
    """Flip along x (y -> -y); boxes (K, 7) [x y z dims yaw]."""
    A = np.eye(4)
    if rng.rand() < prob:
        points = points.copy()
        boxes = boxes.copy()
        points[:, 1] = -points[:, 1]
        boxes[:, 1] = -boxes[:, 1]
        boxes[:, 6] = -boxes[:, 6]
        A[1, 1] = -1.0
    return points, boxes, A


def random_world_rotation(points, boxes, rng,
                          rot_range=(-0.78539816, 0.78539816)):
    angle = rng.uniform(rot_range[0], rot_range[1])
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s], [s, c]])
    points = points.copy()
    boxes = boxes.copy()
    points[:, :2] = points[:, :2] @ rot.T
    boxes[:, :2] = boxes[:, :2] @ rot.T
    boxes[:, 6] += angle
    A = np.eye(4)
    A[:2, :2] = rot
    return points, boxes, A


def random_world_scaling(points, boxes, rng, scale_range=(0.95, 1.05)):
    s = rng.uniform(scale_range[0], scale_range[1])
    points = points.copy()
    boxes = boxes.copy()
    points[:, :3] *= s
    boxes[:, :6] *= s
    return points, boxes, np.diag([s, s, s, 1.0])


class DataAugmentor:
    """The queue of the hypes' ``data_augment`` list; an unknown name
    raises ``KeyError``."""

    _KNOWN = {
        "random_world_flip": random_world_flip,
        "random_world_rotation": random_world_rotation,
        "random_world_scaling": random_world_scaling,
    }

    def __init__(self, config: list | None, train: bool = True,
                 seed: int = 303):
        self.train = train
        self.rng = np.random.RandomState(seed)
        self.queue = []
        for item in config or []:
            name = item["NAME"] if isinstance(item, dict) else item
            kwargs = ({k.lower(): v for k, v in item.items() if k != "NAME"}
                      if isinstance(item, dict) else {})
            fn = self._KNOWN.get(name.lower())
            if fn is None:
                raise KeyError(f"unknown augmentation '{name}'. known: "
                               f"{sorted(self._KNOWN)}")
            self.queue.append((fn, kwargs))

    def transform(self, points: np.ndarray, boxes: np.ndarray):
        """points (P, >=3), boxes (K, 7) -> (points', boxes', A), A the
        accumulated 4 x 4 point transform (identity in eval or with an empty
        queue)."""
        A = np.eye(4)
        if not self.train:
            return points, boxes, A
        for fn, kwargs in self.queue:
            mapped = {}
            if "world_rot_angle" in kwargs:
                mapped["rot_range"] = kwargs["world_rot_angle"]
            if "world_scale_range" in kwargs:
                mapped["scale_range"] = kwargs["world_scale_range"]
            points, boxes, Ai = fn(points, boxes, self.rng, **mapped)
            A = Ai @ A
        return points, boxes, A

    def __call__(self, points: np.ndarray, boxes: np.ndarray):
        """points (P, >=3), boxes (K, 7) -> augmented copies."""
        points, boxes, _ = self.transform(points, boxes)
        return points, boxes
